"""copy_in_gbps (GB/s): the bytes the surveys traced send to the card (the
entry's ``copy_in_bytes`` a survey, times the surveys traced) over the
summed device time of the host-to-device memcpy records in the traced
sub-window."""


def read(r):
    t = r.trace
    per_call = r.values.get("copy_in_bytes")
    if t is None or not per_call or not r.calls_traced:
        return None
    s = sum(sec for name, sec in t.device_ops if name.startswith("Memcpy HtoD"))
    if not s:
        return None
    return per_call[0] * r.calls_traced / s / 1e9
