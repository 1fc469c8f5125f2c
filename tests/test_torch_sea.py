"""The slice as a whole: robseg_torch's run_sea against robseg_tpu's on the
tiny model of tests/test_sea.py, and the port's CLI on a fixture VOC tree.

run_sea runs at float64 in both packages (JAX with x64 on, reset in
``finally``), so the sign of a near-zero gradient cannot split the two
trajectories; every reported number must agree within 1e-6.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import yaml

from robseg_tpu.attacks import sea as j_sea
from robseg_tpu.attacks.sea import run_sea as j_run_sea
from robseg_torch.attacks import sea
from robseg_torch.attacks.sea import run_sea

C = 4
HW = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, tol=1e-6):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _close(u, v, tol)
    else:
        assert abs(float(a) - float(b)) <= tol, (a, b)


def test_run_sea_matches_jax_f64(rng):
    wk = rng.normal(size=(3, C)) * 2.0
    batches = []
    for _ in range(2):
        x = rng.random((2, HW, HW, 3))
        y = rng.integers(0, C, (2, HW, HW))
        y[0, :2, :2] = -1
        batches.append((x, y))
    weights = (rng.random(C) + 0.5).astype(np.float32)
    kw = dict(num_classes=C, eps=8 / 255, n_iter=10, weights=weights,
              seed=1, use_rs=False, wc_engine="python")

    jax.config.update("jax_enable_x64", True)
    try:
        want = j_run_sea(
            lambda x: jnp.einsum("bhwc,cd->bhwd", x, jnp.asarray(wk)),
            lambda: iter([(x, y.astype(np.int32)) for x, y in batches]),
            **kw)
    finally:
        jax.config.update("jax_enable_x64", False)

    wt = torch.tensor(wk)
    got = run_sea(
        lambda x: torch.einsum("bchw,cd->bdhw", x, wt),
        lambda: iter([(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y)
                      for x, y in batches]), **kw)
    for key in ("clean", "worst_Acc", "worst_Acc_indiv", "loss-wise_stats",
                "loss-wise_miou", "final_miou"):
        _close(got[key], want[key])
    assert got["final_miou"] <= min(got["loss-wise_miou"]) + 1e-6


def test_eval_functions_match_jax(rng):
    """eval_performance (with a padded trailing batch), evaluate and
    check_imgs against the JAX package on the same data."""
    wk = rng.normal(size=(3, C)) * 2.0
    x = rng.random((3, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, C, (3, HW, HW))
    y[1, :3, :3] = -1
    nhwc = [(x[:2], y[:2]), (x[2:], y[2:])]
    nchw = [(np.ascontiguousarray(a.transpose(0, 3, 1, 2)), b)
            for a, b in nhwc]
    jfn = lambda z: jnp.einsum("bhwc,cd->bhwd", z,                # noqa
                               jnp.asarray(wk, jnp.float32))
    wt = torch.tensor(wk, dtype=torch.float32)
    tfn = lambda z: torch.einsum("bchw,cd->bdhw", z, wt)          # noqa

    j_stats, j_preds = j_sea.eval_performance(
        jfn, [(a, b.astype(np.int32)) for a, b in nhwc], num_classes=C)
    stats, preds = sea.eval_performance(tfn, nchw, num_classes=C)
    _close(stats.as_dict(), j_stats.as_dict())
    assert np.array_equal(preds, j_preds)

    want = j_sea.evaluate(jfn, [(a, b.astype(np.int32)) for a, b in nhwc],
                          num_classes=C)
    got = sea.evaluate(tfn, nchw, num_classes=C)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, equal_nan=True)

    adv = np.clip(x + rng.uniform(-0.02, 0.02, x.shape), 0, 1)
    assert sea.check_imgs(adv, x, "Linf") == j_sea.check_imgs(adv, x, "Linf")


def test_run_sea_resumes_from_cache(rng, tmp_path):
    wt = torch.tensor(rng.normal(size=(3, C)) * 2.0, dtype=torch.float32)
    data = [(rng.random((2, 3, HW, HW)).astype(np.float32),
             rng.integers(0, C, (2, HW, HW)))]
    fn = lambda x: torch.einsum("bchw,cd->bdhw", x, wt)   # noqa: E731
    kw = dict(num_classes=C, eps=8 / 255, n_iter=5, seed=3,
              resume_dir=str(tmp_path), cache_tag="t")
    first = run_sea(fn, lambda: iter(data), **kw)
    assert len(list(tmp_path.glob("argmax_t_*.npz"))) == 3
    again = run_sea(fn, lambda: iter(data), **kw)
    assert again == first


def _cli_clean_eval(tmp_path, *flags):
    """``robseg_torch.infer --no-adversarial`` on one fixture VOC image;
    returns the clean stats and the kernel launch counts it logged."""
    root = tmp_path / "voc"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_fixture_dataset.py"),
                    "--root", str(root), "--n_train", "0", "--n_val", "1",
                    "--hw", "120", "160"], check=True, timeout=120)
    with open(os.path.join(REPO, "configs", "rig_voc_demo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DEVICE"] = "cpu"
    cfg["DATASET"]["ROOT"] = str(root)
    cfg["SAVE_DIR"] = str(tmp_path / "out")
    cfg["EVAL"]["BATCH_SIZE"] = 1
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))

    from robseg_torch import infer
    infer.main(["--cfg", str(cfg_path), "--no-adversarial",
                "--n_batches", "1", *flags])
    log = (tmp_path / "out" / "sea_eval_log.txt").read_text()
    clean = [ln for ln in log.splitlines()
             if ln.startswith("Clean performance: ")]
    assert len(clean) == 1
    stats = ast.literal_eval(clean[0][len("Clean performance: "):])
    launches = [ln for ln in log.splitlines()
                if ln.startswith("kernel launches: ")]
    return stats, json.loads(launches[0][len("kernel launches: "):])


def test_infer_cli_clean_eval(tmp_path):
    """``robseg_torch.infer --no-adversarial`` end to end on the CPU: the
    full-width UperNet at the VOC crop (473^2), one image."""
    stats, launches = _cli_clean_eval(tmp_path)
    assert set(stats) == {"mAcc", "aAcc", "mIoU"}
    assert all(0.0 <= v <= 1.0 for v in stats.values())
    # CPU tensors never launch a kernel
    assert launches == {
        "convnext_block_fwd": 0, "convnext_block_dx": 0,
        "apgd_linf_step": 0, "confusion_matrix": 0,
        "fpn_concat_conv_fwd": 0, "fpn_concat_conv_dx": 0,
        "convnext_mlp_fwd": 0, "convnext_mlp_dx": 0,
        "convnext_block_fwd_bf16": 0, "convnext_block_dx_bf16": 0,
        "fpn_concat_conv_fwd_bf16": 0, "fpn_concat_conv_dx_bf16": 0}


def test_infer_cli_bf16_clean_eval(tmp_path):
    """``--precision bf16`` end to end on the CPU (bf16 parameters and
    activations through the plain versions); it replaces the refusal this
    flag met before the bf16 path was ported."""
    stats, launches = _cli_clean_eval(tmp_path, "--precision", "bf16")
    assert set(stats) == {"mAcc", "aAcc", "mIoU"}
    assert all(0.0 <= v <= 1.0 for v in stats.values())
    assert not any(launches.values())


@pytest.mark.parametrize("flags,why", [
    ("--shard", "without --shard"), ("--fused", "always on")],
    ids=["--shard", "--fused"])
def test_infer_refuses_unported_flags(flags, why, capsys, monkeypatch):
    """The JAX CLI's TPU-only flag ``--fused`` is a parser error with its
    reason: under CUDA the port's kernels are always on, so it has nothing
    to turn on. ``--shard`` met the same refusal until data parallelism
    was ported (``robseg_torch/parallel``; its runs:
    tests/test_torch_parallel.py): it parses now, and what is refused is a
    launch on several ranks without it, where every rank would evaluate
    everything. (``--msf`` ran into this refusal until it was ported;
    tests/test_torch_msf.py runs it.)"""
    from robseg_torch import infer
    if flags == "--shard":
        assert infer.parse_args(["--cfg", "x.yaml", "--shard"]).shard
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert infer.parse_args(["--cfg", "x.yaml", "--shard"]).shard
        flags = ""
    with pytest.raises(SystemExit):
        infer.parse_args(["--cfg", "x.yaml", *flags.split()])
    err = capsys.readouterr().err
    assert why in err and "later slice" not in err


def test_infer_refuses_f32_precision(capsys):
    """``--precision f32`` is a parser error, as in the JAX CLI with its
    block kernel (tools/infer.py:93-100): the kernel's matmul operands are
    bf16."""
    from robseg_torch import infer
    with pytest.raises(SystemExit):
        infer.parse_args(["--cfg", "x.yaml", "--precision", "f32"])
    err = capsys.readouterr().err
    assert "rounds its matmul operands to bf16" in err
    assert "cannot honor --precision f32" in err
    assert "--precision default" in err
