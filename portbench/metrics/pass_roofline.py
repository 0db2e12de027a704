"""pass_roofline (%): the analysis pass's share of its HBM roofline: the
least bytes one call needs (portbench.core.roofline.pass_bytes, from the
cell's shapes) times the calls traced, over the card's published HBM
rate, over the summed device time of every kernel in the traced
sub-window (memcpys and memsets left out; the harness launches no kernel
of its own). None where the card is not in the table of peaks or the
trace holds no kernel."""

from portbench.core.roofline import hbm_peak


def read(r):
    peak = hbm_peak(r.device_name)
    t = r.trace
    if peak is None or t is None or not t.kernel_s or not r.calls_traced:
        return None
    return 100.0 * r.bytes_per_call * r.calls_traced / peak / t.kernel_s
