"""jointhist_roofline (%): the ``jointhist`` kernel's share of its HBM
roofline: the least bytes its launches of one survey move (each band's
bytes read once, each pair's 256 x 256 int32 counts written once, from
the cell's shapes: ``Readings.bytes_per_call``) times the surveys traced,
over the card's published HBM rate, over the summed device time of the
kernels named ``jointhist`` in the traced sub-window. None where the card
is not in the table of peaks or the trace holds no such kernel."""

from portbench.core.roofline import hbm_peak


def read(r):
    peak = hbm_peak(r.device_name)
    t = r.trace
    if peak is None or t is None or not r.calls_traced:
        return None
    s = sum(sec for name, sec in t.device_ops if "jointhist" in name)
    if not s:
        return None
    return 100.0 * r.bytes_per_call * r.calls_traced / peak / s
