"""Timing of a kernel on one CUDA card, shared by ``chip_smoke.py`` and
``tools/kernel_variants.py`` and ``tools/profile_torch_path.py``.

``Timer().kernel(fn)`` is the median device time of ``fn`` over repeats;
``card_rates`` and ``bound`` give a kernel's least time from the card's
data-sheet rates; ``ptxas_report`` reads nvcc's register and spill
report from a kernel's build log. Needs a CUDA device to time.
"""

from __future__ import annotations

import statistics

import torch

REPS = 20


def card_rates(name: str):
    """(memory bytes/s, float32 operations/s) of the card, from NVIDIA's
    data sheets: H100 SXM 3.35 TB/s and 67 TFLOP/s; H100 PCIe 2.0 TB/s
    and 51 TFLOP/s; H100 NVL 3.9 TB/s and 60 TFLOP/s."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


class Timer:
    """Median milliseconds of a callable's device work over repeats.

    A spin kernel (``torch.cuda._sleep``) holds the stream while the host
    queues every repeat, so no host gap falls between a repeat's two CUDA
    events. The 50 MB L2 cache is flushed by a read of a larger buffer
    before each repeat, as a caller reading fresh frames would find it.
    """

    SPIN_CYCLES = 50_000_000  # about 25 ms at the H100's clocks

    def __init__(self):
        self.flush = torch.ones(128 << 20, dtype=torch.uint8, device="cuda")

    def kernel(self, fn, reps: int = REPS, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(self.SPIN_CYCLES)
        for a, b in events:
            self.flush.amax()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes, nops, rates):
    """The least time of a kernel, ms: its bytes over the card's bandwidth
    or its operations over its float32 rate, whichever is longer, and
    which."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, nops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(name):
    """The lines of nvcc's -Xptxas -v report on the kernels of
    ``csrc/<name>.cu`` (registers, shared memory, spills), from its build log."""
    from rgnir_torch.kernels import _build

    log_path = _build.library_path(name).with_suffix(".log")
    if not log_path.exists():
        return "no build log"
    keep = [ln.split("ptxas info    :")[-1].strip() for ln in log_path.read_text().splitlines()
            if "Used" in ln or "spill" in ln]
    return "; ".join(keep)
