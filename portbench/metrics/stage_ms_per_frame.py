"""stage_ms_per_frame (ms): the host's mean time in StreamAnalyzer.submit per
frame (host clock around each call, before the traced sub-window): the
copy into the pinned staging slot and, every batch, the dispatch."""


def read(r):
    if not r.stage:
        return None
    return 1e3 * sum(d for _, d in r.stage) / len(r.stage)
