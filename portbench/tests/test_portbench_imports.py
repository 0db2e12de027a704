"""Nothing a run imports is JAX or the JAX package: a run of each cell on
the CPU, in a fresh process, then the harness's own check of the top-level
module names (the whole name before the first dot, so ``rgnir_torch`` is
not ``rgnir_tpu``)."""

import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {root!r} + "/portbench", {root!r} + "/portbench/tests"]
import conftest, run
res = conftest.run_small({cell!r}, seconds=0.2)
assert res["correct"], res
print("FORBIDDEN", run.forbidden_modules())
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "rgnir_tpu_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
