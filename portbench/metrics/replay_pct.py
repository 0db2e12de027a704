"""replay_pct (%): the share of the window's analysis calls that
rgnir_torch.kernels.pipeline.GRAPHS served by replaying a captured graph:
its replays against its eager calls, captures and replays (the program's
counters, read before and after the window)."""


def read(r):
    c = r.counters
    total = c.get("eager_calls", 0) + c.get("captures", 0) + c.get("replays", 0)
    return 100.0 * c["replays"] / total if total else None
