"""Multi-scale + flip and sliding-window inference against the JAX
package, and the SEA CLI's ``--no-adversarial --msf`` on the CPU.

The two sliding-window functions run the tiny conv model of
tests/test_torch_apgd.py in both frameworks on the same numpy image, in
float32: atol 1e-5 on the summed probabilities and the averaged logits
(float32 resize matmuls and softmax in another order). The CLI runs on
a fixture VOC image with UperNet cut small (tests/test_torch_train_models.
py's ``narrow_upernet``) and the eval crop cut from 473^2 to 64^2 (scaled
sizes 32, 64, 64, 96, 96): its logged MSF stats must equal the same
evaluation made here on the same seeded model.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
import jax  # noqa: F401  (pinned to the CPU by conftest)
import jax.numpy as jnp

from robseg_tpu.utils import sliding_window as jsw
from robseg_torch.utils import sliding_window as tsw
from test_torch_apgd import C, _models
from test_torch_train_models import narrow_upernet, two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hw,window,stride", [((20, 26), 16, 12),
                                              ((10, 12), 16, 16),
                                              ((33, 17), 16, 10)])
def test_sliding_window_matches_jax(hw, window, stride):
    rng = np.random.default_rng(0)
    jfn, tfn = _models(rng)
    img = rng.random(hw + (3,)).astype(np.float32)
    want = np.asarray(jsw.sliding_window_logits(
        jfn, jnp.asarray(img), window=window, stride=stride, num_classes=C))
    got = tsw.sliding_window_logits(
        tfn, torch.tensor(np.moveaxis(img, -1, 0)), window=window,
        stride=stride, num_classes=C)
    assert tuple(got.shape) == (C,) + hw
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 0),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw,flip", [((40, 40), True), ((37, 50), False)])
def test_multi_scale_flip_matches_jax(hw, flip):
    rng = np.random.default_rng(1)
    jfn, tfn = _models(rng)
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    scales = (0.5, 0.75, 1.0, 1.25, 1.5)
    want = np.asarray(jsw.multi_scale_flip_logits(
        jfn, jnp.asarray(x), scales=scales, flip=flip, num_classes=C))
    got = tsw.multi_scale_flip_logits(
        tfn, torch.tensor(np.moveaxis(x, -1, 1)), scales=scales, flip=flip,
        num_classes=C)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1),
                               rtol=0, atol=1e-5)
    # probabilities: each pixel sums to the number of passes
    n = len(scales) * (2 if flip else 1)
    np.testing.assert_allclose(got.sum(1).numpy(), n, rtol=1e-5)


def test_infer_cli_msf_on_cpu(tmp_path, monkeypatch):
    """``python -m robseg_torch.infer --no-adversarial --msf`` in this
    process on a narrowed UperNet at a 64^2 crop; it replaces the refusal
    ``--msf`` met before this slice."""
    narrow_upernet(monkeypatch)
    from robseg_torch import infer
    from robseg_torch.attacks.sea import eval_performance
    from robseg_torch.data import (get_segmentation_dataset,
                                   simple_eval_loader)
    from robseg_torch.models import ModelBundle
    monkeypatch.setattr(infer, "dataset_eval_geometry",
                        lambda name: (64, (64, 64)))
    root = tmp_path / "voc"
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_fixture_dataset.py"),
                    "--root", str(root), "--n_train", "0", "--n_val", "2",
                    "--hw", "60", "80"], check=True, timeout=120)
    with open(os.path.join(REPO, "configs", "rig_voc_demo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DEVICE"] = "cpu"
    cfg["DATASET"]["ROOT"] = str(root)
    cfg["SAVE_DIR"] = str(tmp_path / "out")
    cfg["EVAL"]["BATCH_SIZE"] = 2
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    infer.main(["--cfg", str(cfg_path), "--no-adversarial", "--msf"])
    log = (tmp_path / "out" / "sea_eval_log.txt").read_text().splitlines()
    msf = [ln for ln in log if ln.startswith("MSF clean performance: ")]
    assert len(msf) == 1 and not any(
        ln.startswith("Clean performance") for ln in log)
    got = ast.literal_eval(msf[0][len("MSF clean performance: "):])

    torch.manual_seed(infer.SEED)
    module = infer.build_eval_model(cfg, 21, (64, 64))
    logits_fn = ModelBundle(module).logits_fn
    ds = get_segmentation_dataset("pascalvoc", root=str(root), split="val",
                                  crop_size=(64, 64))
    want, _ = eval_performance(
        lambda x: tsw.multi_scale_flip_logits(
            logits_fn, x, scales=infer.MSF_SCALES, flip=True,
            num_classes=21), simple_eval_loader(ds, 2), num_classes=21)
    assert infer.MSF_SCALES == (0.5, 0.75, 1.0, 1.25, 1.5)
    for k, v in want.as_dict().items():
        assert abs(got[k] - v) <= 1e-7, (k, got[k], v)
