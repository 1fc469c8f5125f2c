"""The comparison that decides ``correct`` fails the configuration's
control and every fault a cell can have, at a size a test run holds: the
harness's look for a card is skipped (``--device cpu``) and the rest of a
run is driven with the timed path broken underneath."""

from __future__ import annotations

import pytest

from conftest import run_cell


@pytest.mark.parametrize("cell", ["tiny.sea", "tiny.seg"])
def test_control_is_not_correct(tiny_tree, cell):
    rc, out, err = run_cell(tiny_tree, cell, "--control")
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.sea", "unchanged"), ("tiny.sea", "half_batch"),
    ("tiny.sea", "altered"), ("tiny.seg", "unchanged"),
    ("tiny.seg", "half_batch")])
def test_fault_is_not_correct(tiny_tree, cell, fault):
    rc, out, err = run_cell(tiny_tree, cell, "--fault", fault)
    assert rc == 0, err[-3000:]
    assert out["correct"] is False, out["checks"]
