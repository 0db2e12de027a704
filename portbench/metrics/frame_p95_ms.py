"""frame_p95_ms (ms): the 95th percentile, over every frame of the window, of
the time from the frame's due time in the open loop until its statistics
are on the host (host clock)."""

from portbench.core.readings import p95


def read(r):
    v = p95([d - u for u, d in zip(r.frame_due, r.frame_done)])
    return None if v is None else v * 1e3
