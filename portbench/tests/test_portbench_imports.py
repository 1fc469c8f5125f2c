"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: each checked in a subprocess by
the top-level module names it holds, compared whole."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import REPO

JAX = {"jax", "jaxlib", "flax", "robseg_tpu"}


def top_level_after(code: str, cwd) -> set:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "list(sys.modules)})))"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_the_program(tmp_path):
    code = (
        "import json, torch\n"
        "from portbench import flops, inputs\n"
        "from portbench.reference import attack, metrics, nets\n"
        "cfg = json.load(open('portbench/configs/"
        "upernet-convnext-t-voc.json'))\n"
        "net = nets.build(cfg)\n"
        "net.load_state_dict(inputs.state_dict(cfg, 1, 'cpu'))\n"
        "net.eval()(torch.rand(1, 3, 32, 32))\n"
        "flops.attack_pass(cfg, 1, (32, 32))\n")
    mods = top_level_after(code, REPO)
    assert not mods & (JAX | {"robseg_torch"}), mods & (JAX | {
        "robseg_torch"})


def test_a_run_imports_no_jax(tiny_tree):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['run.py', '--workload', 'tiny.seg', '--seed', '5', "
        "'--seconds', '3', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_path('portbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n")
    mods = top_level_after(code, tiny_tree)
    assert "robseg_torch" in mods
    assert not mods & JAX, mods & JAX
