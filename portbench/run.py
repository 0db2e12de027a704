#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Resolves the cell in ``BENCHMARK.json``: its configuration, traffic mix,
metric readers, reference and the entry module that drives it
(``portbench/entries/<entry>.py``, named by the configuration; see
``portbench/core/spec.py`` for what an entry has). It builds the kernels
the entry lists into ``build/`` in the checkout (the first run there
compiles; later runs load), and the entry makes its inputs from the seed,
warms the cell's own shapes and measures for ``--seconds``. With
``--trace 0`` it reports the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, the device's busy and traced seconds and a
breakdown, from ``torch.profiler`` over the last seconds of the window.
After the window the entry runs the plain reference on the same inputs,
and its numbers, each held to the configuration's limits, decide
``correct``.

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
It exits with another code than 0, and prints no result, where there is no
CUDA card (or fewer than the cell asks for), or where the process has
loaded JAX or the JAX package by the time the window has closed.
"""

import time

T0 = time.perf_counter()  # as near to the process's start as the script can take it

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "rgnir_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds
    its CUDA libraries into ``build/rgnir_torch_kernels`` there itself;
    Triton's and ``torch.utils.cpp_extension``'s caches are fixed here too,
    so that a kernel a later change adds that way is built once a checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def run_cell(cell, seed: int, seconds: float, traced: bool, device, setup_t0: float) -> dict:
    """The result object of one run of ``cell`` (a ``spec.Cell``, whose
    entry and reference were loaded from its checkout) on ``device``."""
    import torch

    from portbench.core import check
    from portbench.core import device as devinfo

    entry = cell.entry
    st = entry.settings(cell.config, cell.traffic)
    t = time.perf_counter()
    if device.type == "cuda":
        from rgnir_torch.kernels import _build

        _build.build(entry.KERNELS)
    build_s = time.perf_counter() - t
    readings, rec = entry.run(st, seed, seconds, traced, device, setup_t0)
    readings.counters["build_s"] = build_s
    readings.counters["to_build_s"] = t - setup_t0
    dev = devinfo.describe(device, cell.chips)
    readings.device_name = dev["kind"]
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = m.read(readings)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    result = {"correct": False, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": dev}
    if traced:
        tr = readings.trace
        if tr is None:
            raise RuntimeError("the traced window holds no device record")
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["counters"] = readings.counters
    del readings
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = entry.compare(st, rec, cell.reference, device)
    result["correct"], result["checks"] = check.judge(numbers, cell.config["limits"],
                                                      rec.attempted)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    import torch

    from portbench.core import spec

    t_torch = time.perf_counter() - T0
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        t_cuda = time.perf_counter() - T0
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T0)
    result["counters"].update(import_torch_s=t_torch, cuda_checked_s=t_cuda)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} {'<=' if ok else 'NOT <='} {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
