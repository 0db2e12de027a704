"""call_p95_ms (ms): the 95th percentile, over every call of the window, of
one analysis call's wall (host clock): from handing over the pinned host
batch until the results the caller reads are on the host."""

from portbench.core.readings import p95


def read(r):
    v = p95([b - a for a, b in r.calls])
    return None if v is None else v * 1e3
