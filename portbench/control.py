#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
bfloat16 (the precision below the configuration's float32), put in the
program's place, has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 2]

For each seed it runs the cell as ``run.py`` does, for a short window at
the cell's own load, with the kernel pass under
``rgnir_torch.pipeline.dispatch.analyze_image_auto`` replaced by
:func:`portbench.reference.analysis.analyze` in bfloat16, and prints one
JSON line: the seed, ``correct`` and every number compared beside its
limit. The benchmark's own runs never run it. :func:`patched_pass` also
lets the tests plant faults under the harness.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def as_result(out: dict, batched: bool):
    """The reference's output dict as the program's ``AnalyzeResult``."""
    import torch

    from rgnir_torch.ops.stats import IndexStats
    from rgnir_torch.pipeline.fused import AnalyzeResult

    one = (lambda t: t) if batched else (lambda t: t[0])
    stats = {}
    for k, s in out["stats"].items():
        n = out["indices"][k].shape[-1] * out["indices"][k].shape[-2]
        hist = s.get("histogram")
        stats[k] = IndexStats(
            mean=one(s["mean"]), median=one(s["median"]), std=one(s["std"]),
            min=one(s["min"]), max=one(s["max"]), coverage_pct=one(s["coverage_pct"]),
            histogram=None if hist is None else one(hist.to(torch.int32)),
            n=one(torch.full_like(s["mean"], n, dtype=torch.int32)))
    return AnalyzeResult(wb=one(out["wb"]), indices={k: one(v) for k, v in out["indices"].items()},
                         stats=stats, renders={k: one(v) for k, v in out["renders"].items()})


def reference_pass(precision):
    """A stand-in for ``analyze_image_kernel``: the plain reference in
    ``precision``."""
    from portbench.reference import analysis
    from rgnir_torch.config import IndexKind

    def body(img, kinds, with_renders=True, with_hist=True, select_onepass=None, with_wb=True):
        batched = img.dim() == 4
        frames = img if batched else img[None]
        names = [IndexKind.parse(k).value for k in kinds]
        return as_result(analysis.analyze(frames, names, with_renders, with_hist, precision),
                         batched)
    return body


@contextlib.contextmanager
def patched_pass(body):
    """Put ``body`` in the place of the kernel pass that every call of
    ``analyze_image_auto`` (the batch's and the stream's) runs."""
    from rgnir_torch.pipeline import dispatch

    saved = dispatch.analyze_image_kernel
    dispatch.analyze_image_kernel = body
    try:
        yield
    finally:
        dispatch.analyze_image_kernel = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    import run
    from portbench.core import spec

    run.cache_dirs(ROOT)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    with patched_pass(reference_pass(torch.bfloat16)):
        for seed in args.seeds:
            with contextlib.redirect_stdout(sys.stderr):
                res = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                   time.perf_counter())
            print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
