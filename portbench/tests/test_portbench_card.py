"""Each real cell on the card, a short window: ``run.py`` exits 0 and the
run is correct. Run on the card with ``python -m pytest -p
no:cacheprovider portbench/tests/test_portbench_card.py``."""

from __future__ import annotations

import json

import pytest

from conftest import REPO, run_cell

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    rc, out, err = run_cell(REPO, cell, seconds=10, device=None)
    assert rc == 0, err[-3000:]
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
