"""pinned_mb_per_pass (MB): the program's ``mosaic.pinned_bytes`` counter over
a traced run's window (pinned staging memory the session newly
allocated), per ``mosaic.pass`` span; 0 once a session has run a survey
of the window's band size."""


def read(r):
    passes = r.values.get("mosaic.pass")
    pinned = r.values.get("mosaic.pinned_bytes")
    if not passes or pinned is None:
        return None
    return sum(pinned) / 1e6 / len(passes)
