"""copy_ms_per_call (ms): the device time of every memcpy record (the frames'
copy in, the graph's copies of its static input and outputs, the
read-back) in the traced sub-window, per analysis call."""


def read(r):
    t = r.trace
    if t is None or not t.memcpys or not r.calls_traced:
        return None
    return 1e3 * t.memcpy_s / r.calls_traced
