"""The harness's comparison against the faults a cell can have, each
planted by the cell's own entry (``faults(reference)`` in
``portbench/entries/<entry>.py``), at a size the CPU holds. Each run skips
only the harness's look for a card: the inputs, the loop, the read-back,
the reference and the comparison run as on the card. A run with no fault
is correct; each fault makes ``correct`` false.

The control, the entry's ``control(reference, torch.bfloat16)``, comes out as not
correct too, on three seeds."""

import pytest
import torch

from conftest import CELLS, run_small, small_cell
from portbench.core import spec

FAULTS = [(cell, fault) for cell in CELLS
          for c in [spec.resolve(cell)] for fault in c.entry.faults(c.reference)]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    c = small_cell(cell)
    with c.entry.faults(c.reference)[fault]():
        res = run_small(c)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [3, 2**31 + 99, 2**32 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell, seed):
    c = small_cell(cell)
    with c.entry.control(c.reference, torch.bfloat16):
        res = run_small(c, seed=seed)
    assert not res["correct"], res["checks"]
