"""mpix_per_s (MPix/s): the pixels of every frame whose results reached the
host in the window, over the window's seconds (host clock, first call to
last result)."""


def read(r):
    return r.pixels_done / 1e6 / r.window_s if r.window_s > 0 and r.frames_done else None
