"""device_idle_pct (%): the share of the traced sub-window in which no device
record (kernel, memcpy, memset) ran: 1 less the union of their intervals
over the window."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
