"""frames_per_dispatch (frames): the stream's frames whose results reached
the host over the window, per batch the analyzer sent to the card in it
(its ``dispatches``, read before and after the window)."""


def read(r):
    n = r.counters.get("dispatches")
    return r.frames_done / n if n else None
