"""The PSPNet, PSPNet-DDCAT and Segmenter families in train mode against
the JAX modules, on the CPU; the conventions, helpers and tolerances of
tests/test_torch_train_models.py (split off so the two files run on two
test workers).
"""

import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from robseg_tpu.models import pspnet as jpsp
from robseg_tpu.models.segmenter import SegMenter as JSeg
from robseg_tpu.ops.losses import segmentation_cross_entropy as j_ce
from robseg_torch.convert import (ddcat_state_dict_from_jax,
                                  pspnet_state_dict_from_jax,
                                  segmenter_state_dict_from_jax)
from robseg_torch.models import PSPNet, PSPNetDDCAT, SegMenter
from robseg_torch.models import pspnet as tpsp
from robseg_torch.models.layers import Dropout
from robseg_torch.ops.losses import segmentation_cross_entropy as t_ce
from test_torch_train_models import (  # noqa: F401
    DDCAT, K, SEG, _f64, _init, _inputs, _np, two_threads)


def test_pspnet_main_and_aux_losses(monkeypatch):
    # one bottleneck a stage at the full widths in both packages, which
    # keeps XLA's float64 compile short
    for mod in (jpsp, tpsp):
        monkeypatch.setattr(mod, "ResNetStages", functools.partial(
            mod.ResNetStages, layers=(1, 1, 1, 1)))
    hw = (17, 17)
    jm = jpsp.PSPNet(classes=K, dropout=0.0)
    xj, yj, xt, yt = _inputs(np.random.default_rng(2), 2, hw, K)
    params, stats = _init(jm, hw, labels=jnp.zeros((1,) + hw, jnp.int32))
    jax.config.update("jax_enable_x64", True)
    try:
        (mj, aj, _), mut = jax.jit(lambda p, s: jm.apply(
            {"params": p, "batch_stats": s}, jnp.asarray(xj, jnp.float64),
            labels=yj, train=True, mutable=["batch_stats"]))(
                _f64(params), _f64(stats))
        mj, aj, new_stats = float(mj), float(aj), _np(mut["batch_stats"])
    finally:
        jax.config.update("jax_enable_x64", False)
    m = PSPNet(classes=K, dropout=0.0)
    m.load_state_dict(pspnet_state_dict_from_jax(params, stats, True))
    main, aux, logits = m.train()(xt, yt)
    np.testing.assert_allclose(main.item(), mj, rtol=1e-5)
    np.testing.assert_allclose(aux.item(), aj, rtol=1e-5)
    m.load_state_dict(pspnet_state_dict_from_jax(params, stats, True))
    m.double()(xt.double(), yt)
    want = pspnet_state_dict_from_jax(params, new_stats, True)
    for name, b in m.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_segmenter_train_ce(monkeypatch):
    hw = (32, 32)
    monkeypatch.setattr(fnn, "Dropout",
                        lambda rate: (lambda y, deterministic=True: y))
    jm = JSeg(n_cls=K, drop_path_rate=0.0, **SEG)
    params, _ = _init(jm, hw)
    xj, yj, xt, yt = _inputs(np.random.default_rng(3), 2, hw, K)
    want = jax.jit(lambda p: j_ce(jm.apply({"params": p}, xj, train=True),
                                  yj, -1))(params)
    m = SegMenter(K, drop_path_rate=0.0, **SEG)
    m.load_state_dict(segmenter_state_dict_from_jax(params, 2))
    for d in m.modules():
        if isinstance(d, Dropout):
            d.rate = 0.0
    got = t_ce(m.train()(xt), yt, -1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ddcat_train_tuple():
    hw = (33, 33)
    jm = jpsp.PSPNetDDCAT(classes=K, dropout=0.0, **DDCAT)
    params, stats = _init(jm, hw)
    xj, _, xt, _ = _inputs(np.random.default_rng(4), 2, hw, K)
    outs, _ = jax.jit(lambda p, s: jm.apply(
        {"params": p, "batch_stats": s}, xj, train=True,
        mutable=["batch_stats"]))(params, stats)
    m = PSPNetDDCAT(classes=K, dropout=0.0, **DDCAT)
    m.load_state_dict(ddcat_state_dict_from_jax(params, stats))
    got = m.train()(xt)
    assert len(got) == 4
    for g, w in zip(got, outs):  # final, aux, mask, normal
        np.testing.assert_allclose(g.detach().numpy(),
                                   np.moveaxis(np.asarray(w), -1, 1),
                                   atol=1e-4, rtol=1e-4)
    m.eval()
    torch.testing.assert_close(m(xt, indicate=1)[3], m(xt))
