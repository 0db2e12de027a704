"""The harness's comparison against the faults a cell can have, planted
under the harness in the program's kernel pass (every call of
``analyze_image_auto``, the batch's and the stream's, runs it), at a size
the CPU holds. Each run skips only the harness's look for a card: the
frames, the loop, the read-back, the reference and the comparison run as
on the card. A run with no fault is correct; each fault makes ``correct``
false. (A cell on one card has no exchange between cards to leave out.)

The control, the reference in bfloat16 put in the program's place, comes
out as not correct too, on three seeds."""

import pytest
import torch

from conftest import CELLS, run_small
from portbench import control


def _stale():
    """A step that returns its state unchanged: every call gives the first
    call's results."""
    first = {}

    def body(img, kinds, **kw):
        key = tuple(img.shape)
        if key not in first:
            first[key] = control.reference_pass(torch.float32)(img, kinds, **kw)
        return first[key]
    return body


def _half():
    """Half of the batch left out: only the first half of the frames is
    analysed, and its results stand for the rest."""
    def body(img, kinds, **kw):
        b = img.shape[0]
        idx = torch.arange(b) % max(1, b // 2)
        return control.reference_pass(torch.float32)(img[idx], kinds, **kw)
    return body


def _altered():
    """An answer altered where it is produced: the first frame's NDVI
    median one float32 step up."""
    def body(img, kinds, **kw):
        res = control.reference_pass(torch.float32)(img, kinds, **kw)
        m = res.stats["NDVI"].median
        m[0] = torch.nextafter(m[0], torch.tensor(2.0))
        return res
    return body


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    with control.patched_pass(fault()):
        res = run_small(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [3, 2**31 + 99, 2**32 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell, seed):
    with control.patched_pass(control.reference_pass(torch.bfloat16)):
        res = run_small(cell, seed=seed)
    assert not res["correct"], res["checks"]
