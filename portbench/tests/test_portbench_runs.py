"""Tiny cells end to end through ``run.py`` on the program's plain CPU
path, the shape of the result, and cells, configurations and metrics found
by name from new files alone."""

from __future__ import annotations

import json
import shutil

import pytest

from conftest import REPO, add_cell, run_cell


def cell_metrics(bench: dict, cell: str, kind: str) -> set:
    return {m["name"] for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", ["tiny.sea", "tiny.seg"])
def test_tiny_cell_end_to_end(tiny_tree, cell):
    rc, out, err = run_cell(tiny_tree, cell)
    assert rc == 0, err[-3000:]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) == cell_metrics(bench, cell, "end_to_end")
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
    assert out["attempted"] > 0 and out["failed"] == 0
    # the program's plain path agrees with the reference within the limits
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert f"check {name}: {c['value']!r} limit {c['limit']!r}" in err
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_per_layer_metrics(tiny_tree):
    rc, out, err = run_cell(tiny_tree, "tiny.sea", "--trace", "1")
    assert rc == 0, err[-3000:]
    bench = json.loads((tiny_tree / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) <= cell_metrics(bench, "tiny.sea",
                                               "per_layer")
    # no device on the CPU: only what the window itself gives
    assert {"attack_iter_ms.p50", "mfu.attack"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert out["correct"]


def test_new_files_are_found_by_name(tiny_tree, tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    and new BENCHMARK.json entries, with no other edit."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_tree, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench" / "configs" /
                      "segmenter-vit-s-ade20k.json").read_text())
    cfg["name"] = "segmenter-copy"
    (root / "portbench" / "configs" / "segmenter-copy.json").write_text(
        json.dumps(cfg))
    bench["configs"].append({"name": "segmenter-copy", "source": "x",
                             "file": "portbench/configs/segmenter-copy.json",
                             "reduced": [], "why": "a test"})
    add_cell(root, bench, "sea.upernet-convnext-t.voc473", "tiny.new",
             dict(batch=2, hw=[48, 48], n_iter=3, batches=1,
                  warmup_iters=3), config="segmenter-copy")
    (root / "portbench" / "metrics" / "calls_seen.attack.py").write_text(
        "def read(obs):\n    return float(len(obs.intervals_ms))\n")
    bench["per_layer"].append({
        "name": "calls_seen.attack", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "Attack", "moves":
        "attack_rate", "workloads": ["tiny.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run_cell(root, "tiny.new", "--trace", "1", seconds=5)
    assert rc == 0, err[-3000:]
    assert out["metrics"]["calls_seen.attack"]["value"] > 0
    rc, out, err = run_cell(root, "tiny.new", seconds=5)
    assert rc == 0 and "attack_rate" in out["metrics"], err[-3000:]


def test_no_card_exits_without_a_result(tiny_tree):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    rc, out, err = run_cell(tiny_tree, "tiny.sea", device=None)
    assert rc == 3 and out is None


def test_alone_without_the_program_fails(tmp_path):
    root = tmp_path / "alone"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "portbench", root / "portbench")
    rc, out, err = run_cell(root, "sea.upernet-convnext-t.voc473",
                            pythonpath="")
    assert rc != 0 and out is None
