"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by its name:

- ``configs/<config>.json``: the deployment (frame shape, batch, kinds,
  the entry it drives, the limits of the comparison), as named by the
  configuration's ``file``;
- ``traffic/<mix>.json``: the parameters of a traffic mix, read by
  :mod:`portbench.traffic.generator`;
- ``metrics/<metric>.py``: a reader with ``read(readings)``, which returns
  the metric's value or None where the run has nothing to read. A metric
  split by a suffix, such as ``mpix_per_s.stats`` beside ``mpix_per_s``,
  takes the reader of the unsuffixed name unless it has a file of its own.

A cell is ``<config>.<mix>``'s entry in ``workloads``; it reports every
end-to-end metric whose ``workloads`` list names it (every one, where a
metric has no such list) and, in a traced run, every per-layer metric
that names it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

BENCH = Path(__file__).resolve().parents[1]       # portbench/
ROOT = BENCH.parent                               # the checkout


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


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reader_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    metric split by a suffix (``mpix_per_s.stats``) that has no file of
    its own, the reader of the name with its last suffix taken off, in
    turn."""
    stem = name
    while True:
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file() or "." not in stem:
            return path
        stem = stem.rsplit(".", 1)[0]


def _reader(name: str) -> Callable:
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: List[dict], cell: str) -> List[Metric]:
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is None or cell in cells:
            out.append(Metric(m["name"], m["unit"], _reader(m["name"])))
    return out


def traffic_path(mix: str) -> Path:
    return BENCH / "traffic" / f"{mix}.json"


def resolve(cell_name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``cell_name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(there are {', '.join(sorted(cells))})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(traffic_path(w["traffic"]).read_text())
    return Cell(cell_name, int(w["chips"]), config, traffic,
                _metrics(bench["end_to_end"], cell_name),
                _metrics(bench["per_layer"], cell_name))
