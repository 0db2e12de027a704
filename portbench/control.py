#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
bfloat16 (the precision below the configuration's float32), put in the
program's place, has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 2]

For each seed it runs the cell as ``run.py`` does, for a short window at
the cell's own load, under the cell's entry's ``control(reference,
torch.bfloat16)`` (``portbench/entries/<entry>.py``), which puts the
cell's reference in bfloat16
where the program computes, and prints one JSON line: the seed,
``correct`` and every number compared beside its limit. The benchmark's
own runs never run it.
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
    with cell.entry.control(cell.reference, torch.bfloat16):
        for seed in args.seeds:
            with contextlib.redirect_stdout(sys.stderr):
                res = run.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                   time.perf_counter())
            print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
