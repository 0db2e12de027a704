"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one entry
or one metric is a file of its own under ``portbench/``, found by its
name, so that a new cell comes in as new files and new entries in
``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (its sizes, the ``entry`` it
  drives, the ``reference`` that judges it, the ``limits`` of the
  comparison), as named by the configuration's ``file``;
- ``traffic/<mix>.json``: the parameters of a traffic mix, which the
  configuration's entry reads;
- ``entries/<entry>.py``: the module that drives one entry of the program, named
  by the configuration's ``entry`` (below);
- ``reference/<reference>.py``: the plain reference that the entry's
  comparison runs, named by the configuration's ``reference``;
- ``metrics/<metric>.py``: a reader with ``read(readings)``, which returns
  the metric's value or None where the run has nothing to read. A metric
  split by a suffix, such as ``mpix_per_s.stats`` beside ``mpix_per_s``,
  takes the reader of the unsuffixed name unless it has a file of its own.

A configuration file and a traffic file each hold, under ``cpu_small``,
the keys that the CPU tests change to run the cell at a size the CPU
holds; :func:`resolve` takes that key out of what the entry reads.

An entry module has:

- ``KERNELS``: the names of the port's CUDA sources that set-up builds
  (``rgnir_torch.kernels._build.SOURCES``);
- ``settings(config, traffic)``: the entry's settings, read from the
  configuration's and the mix's keys;
- ``run(st, seed, seconds, traced, device, setup_t0)``: makes the inputs
  from the seed, warms up, measures for ``seconds`` (profiling the last
  part of the window where ``traced``, through ``portbench.core.drive``'s
  ``Tracer``) and returns ``(Readings, records)``; ``records`` has
  ``attempted`` and ``failed`` and whatever the comparison reads;
- ``compare(st, records, reference, device)``: runs the reference module
  after the window and returns ``{number: value}``, each held to the
  configuration's ``limits`` by :func:`portbench.core.check.judge`;
- ``control(reference, precision)``: a context manager that puts the
  cell's reference module, in ``precision``, in the program's place under
  this entry;
- ``faults(reference)``: ``{name: factory}``, each factory giving a
  context manager that plants one fault the entry's cells can have (built
  on the cell's reference module where the fault needs one).

The reference module is the one :func:`resolve` loads from the
configuration's ``reference``, the same for the comparison, the control
and the faults.

A cell is ``<config>.<mix>``'s entry in ``workloads``; it reports every
end-to-end metric whose ``workloads`` list names it (every one, where a
metric has no such list) and, in a traced run, every per-layer metric
that names it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH_DIR = "portbench"                         # BENCHMARK.json's one path
CPU_SMALL = "cpu_small"


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    entry: ModuleType
    reference: ModuleType
    # what the CPU tests change: {"config": {...}, "traffic": {...}}
    cpu_small: dict


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load(path: Path, name: str) -> ModuleType:
    """The module in file ``path``, loaded anew under ``name`` (its dots
    and dashes made underscores)."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass in the module looks itself up there
    spec.loader.exec_module(mod)
    return mod


def reader_path(name: str, root: Path = ROOT) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    metric split by a suffix (``mpix_per_s.stats``) that has no file of
    its own, the reader of the name with its last suffix taken off, in
    turn."""
    stem = name
    while True:
        path = root / BENCH_DIR / "metrics" / f"{stem}.py"
        if path.is_file() or "." not in stem:
            return path
        stem = stem.rsplit(".", 1)[0]


def entry_path(name: str, root: Path = ROOT) -> Path:
    return root / BENCH_DIR / "entries" / f"{name}.py"


def reference_path(name: str, root: Path = ROOT) -> Path:
    return root / BENCH_DIR / "reference" / f"{name}.py"


def traffic_path(mix: str, root: Path = ROOT) -> Path:
    return root / BENCH_DIR / "traffic" / f"{mix}.json"


def _metrics(entries: List[dict], cell: str, root: Path) -> List[Metric]:
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is None or cell in cells:
            mod = _load(reader_path(m["name"], root), f"portbench_metric_{m['name']}")
            out.append(Metric(m["name"], m["unit"], mod.read))
    return out


def resolve(cell_name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``root``'s ``BENCHMARK.json`` with its
    files read and its entry, reference and readers loaded from ``root``."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(there are {', '.join(sorted(cells))})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(traffic_path(w["traffic"], root).read_text())
    small = {"config": config.pop(CPU_SMALL, {}), "traffic": traffic.pop(CPU_SMALL, {})}
    entry = _load(entry_path(config["entry"], root), f"portbench_entry_{config['entry']}")
    reference = _load(reference_path(config["reference"], root),
                      f"portbench_reference_{config['reference']}")
    return Cell(cell_name, int(w["chips"]), config, traffic,
                _metrics(bench["end_to_end"], cell_name, root),
                _metrics(bench["per_layer"], cell_name, root), entry, reference, small)
