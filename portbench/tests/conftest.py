"""The harness's own tests, on the CPU at tiny sizes (the card's through
the ``cuda`` marker, which skips without one).

``tiny_tree`` is a copy of ``portbench/`` beside a ``BENCHMARK.json`` that
adds tiny cells (the configurations at 64 x 64 crops, batch 2, a few
iterations; ``tiny.seg`` runs the Segmenter configuration, which no cell of
``BENCHMARK.json`` runs yet, under the same traffic) with limits of their
own where the tiny size reads otherwise; ``run_cell`` runs
``run.py`` there in a subprocess with ``--device cpu``, the program taken
from this checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEA = "sea.upernet-convnext-t.voc473"
TRAFFIC = dict(batch=2, hw=[64, 64], n_iter=6, batches=2, warmup_iters=3)
TINY = {"tiny.sea": None, "tiny.seg": "segmenter-vit-s-ade20k"}
# the tiny cells' own limits: the program's plain CPU path computes what the
# reference does in float32 (grad_rel_err 1.1e-6 / 2.1e-6 at tiny.sea /
# tiny.seg, pred_logit_gap_mean 0), and the bf16 control at this size reads
# 0.103 / 0.027 and 1.6e-5 / 6.1e-5; the real cell's limits sit above the
# TF32 and bf16 rounding of the card's default path
TINY_LIMITS = {"grad_rel_err": 1e-3, "pred_logit_gap_mean": 1e-6}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")


def add_cell(root: Path, bench: dict, src: str, name: str, traffic: dict,
             config: str = None) -> dict:
    """A cell made from the real cell ``src`` with ``traffic`` changed,
    written under ``root/portbench/workloads`` and added to ``bench``
    wherever ``src`` is named."""
    w = json.loads((root / "portbench" / "workloads" / f"{src}.json")
                   .read_text())
    w["name"] = name
    w["traffic"].update(traffic)
    if config:
        w["config"] = config
    w["check"].update(call_range=[0, 12], model_calls=3, steps=3, images=1)
    w["trace"] = {"start": 2, "calls": 3}
    (root / "portbench" / "workloads" / f"{name}.json").write_text(
        json.dumps(w))
    bench["workloads"].append({"name": name, "config": w["config"],
                               "traffic": "tiny", "chips": 1,
                               "why": "a tiny test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and src in m["workloads"]:
            m["workloads"].append(name)
    return w


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, config in TINY.items():
        w = add_cell(root, bench, SEA, name, TRAFFIC, config)
        w["limits"].update(TINY_LIMITS)
        (root / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(w))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root: Path, workload: str, *extra, seconds: float = 10,
             pythonpath: str = str(REPO), device: str = "cpu"):
    """(exit code, last stdout line parsed or None, stderr) of one run."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    cmd = [sys.executable, str(root / "portbench" / "run.py"), "--workload",
           workload, "--seed", "3000000019", "--seconds", str(seconds),
           *extra]
    if device:
        cmd += ["--device", device]
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
