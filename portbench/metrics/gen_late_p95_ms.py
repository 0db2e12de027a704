"""gen_late_p95_ms (ms): the 95th percentile of how late the open loop handed
each frame to StreamAnalyzer.submit against its due time (host clock,
before the traced sub-window)."""

from portbench.core.readings import p95


def read(r):
    v = p95([late for _, late in r.late])
    return None if v is None else v * 1e3
