"""The train CLI's bf16 products (``robseg_torch/ops/precision.py``, the
port's form of ``jax_default_matmul_precision=bfloat16``), on the CPU.

JAX on the CPU ignores the bfloat16 matmul precision (its products equal
``precision="highest"`` there), so the oracle is the definition XLA applies
on the TPU and the GPU (``DotAlgorithm`` BF16_BF16_F32): JAX at
``precision="highest"`` on operands rounded to bf16, the gradients by
``jax.vjp`` with the cotangent rounded too. Tolerance 1e-5 of the largest
entry of the reference (float32 sums in another order); the bias, added
after the product, takes the unrounded gradient.

Also: under the mode a ``TorchDispatchMode`` sees only bf16-representable
floating operands in every convolution, convolution backward and matmul
of a forward and backward through the plain UperNet (narrowed), PSPNet
(one bottleneck a stage), the Segmenter (2 layers) and the resizes, and
the same run with the mode off trips that check; the kernels' plain
versions are unchanged by the mode; a trainer step under the mode moves
every parameter, its loss within 5e-2 relative of the float32 step's;
and the train CLI resolves ``--precision`` with ``TRAIN.AMP`` as
``tools/train.py:98-111`` does.
"""

import copy
import functools
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax
from torch.utils._python_dispatch import TorchDispatchMode

from robseg_torch.kernels import convnext_block as cb
from robseg_torch.kernels import convnext_mlp as cm
from robseg_torch.kernels import fpn_conv as fc
from robseg_torch.models import PSPNet, SegMenter, build_model
from robseg_torch.models import pspnet as tpsp
from robseg_torch.ops import precision
from robseg_torch.ops.losses import segmentation_cross_entropy
from robseg_torch.ops.resize import adaptive_avg_pool, resize_bilinear
from robseg_torch.train import (AttackConfig, Trainer, get_scheduler,
                                make_optimizer)
from test_torch_train_io import _cfg, _train
from test_torch_train_models import (  # noqa: F401
    K, SEG, narrow_upernet, two_threads)

HI = lax.Precision.HIGHEST
UPERNET = ("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST")


def _bf(a: np.ndarray) -> np.ndarray:
    """Rounded to bf16 (nearest even) by JAX, as float32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _close(got: torch.Tensor, want, tol: float = 1e-5):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().double().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# --------------------------------------------- the products against JAX

@pytest.mark.parametrize("n,c,hw,co,k,stride,pad,dil,groups", [
    (2, 3, 17, 8, 3, 2, 1, 1, 1),      # the CvSt stem's 3x3/s2 on RGB
    (2, 16, 13, 16, 7, 1, 3, 1, 16),   # a ConvNeXt depthwise 7x7
    (1, 8, 11, 6, 3, 1, 2, 2, 1),      # a dilated ResNet 3x3
    (2, 12, 6, 5, 1, 1, 0, 1, 1),      # a 1x1 head
])
def test_conv2d_is_the_bf16_definition(n, c, hw, co, k, stride, pad, dil,
                                       groups):
    rng = np.random.default_rng(0)
    x, w, b = (_rand(rng, n, c, hw, hw), _rand(rng, co, c // groups, k, k),
               _rand(rng, co))

    def conv(x, w):
        return lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad)] * 2,
            rhs_dilation=(dil, dil), feature_group_count=groups,
            dimension_numbers=("NCHW", "OIHW", "NCHW"), precision=HI)
    y, vjp = jax.vjp(conv, _bf(x), _bf(w))
    g = _rand(rng, *y.shape)
    dx, dw = vjp(jnp.asarray(_bf(g)))

    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    with precision.bf16_products():
        yt = precision.conv2d(xt, wt, bt, stride, pad, dil, groups)
    yt.backward(torch.tensor(g))
    _close(yt, np.asarray(y) + b[None, :, None, None])
    _close(xt.grad, dx)
    _close(wt.grad, dw)
    _close(bt.grad, g.sum((0, 2, 3)))
    # the unrounded float32 product misses the definition by far more
    y32 = torch.nn.functional.conv2d(xt, wt, None, stride, pad, dil, groups)
    with pytest.raises(AssertionError):
        _close(y32, y, tol=1e-4)


def test_linear_is_the_bf16_definition():
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 2, 5, 24), _rand(rng, 40, 24), _rand(rng, 40)
    y, vjp = jax.vjp(lambda x, w: jnp.matmul(x, w.T, precision=HI),
                     _bf(x), _bf(w))
    g = _rand(rng, *y.shape)
    dx, dw = vjp(jnp.asarray(_bf(g)))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    with precision.bf16_products():
        yt = precision.linear(xt, wt, bt)
    yt.backward(torch.tensor(g))
    _close(yt, np.asarray(y) + b)
    _close(xt.grad, dx)
    _close(wt.grad, dw)
    _close(bt.grad, g.sum((0, 1)))


@pytest.mark.parametrize("sa,sb", [
    ((2, 3, 17, 8), (2, 3, 8, 17)),    # attention scores q @ k^T
    ((9, 5), (2, 3, 5, 7)),            # a resize along H
    ((2, 3, 9, 7), (7, 11)),           # a resize along W
    ((4, 1, 6, 5), (3, 5, 2)),         # broadcast batch dimensions
])
def test_matmul_is_the_bf16_definition(sa, sb):
    rng = np.random.default_rng(2)
    a, b = _rand(rng, *sa), _rand(rng, *sb)
    y, vjp = jax.vjp(lambda a, b: jnp.matmul(a, b, precision=HI),
                     _bf(a), _bf(b))
    g = _rand(rng, *y.shape)
    da, db = vjp(jnp.asarray(_bf(g)))
    at, bt = (torch.tensor(v, requires_grad=True) for v in (a, b))
    with precision.bf16_products():
        yt = precision.matmul(at, bt)
    yt.backward(torch.tensor(g))
    assert yt.shape == y.shape
    _close(yt, y)
    _close(at.grad, da)
    _close(bt.grad, db)


def test_mode_off_is_the_plain_call():
    """Off (the default, and after the context), each function is its
    torch call bit for bit; ``bf16_products(False)`` inside the mode
    leaves it on; cuDNN's TF32 flag is on inside and restored after."""
    rng = np.random.default_rng(3)
    x, w, b = (torch.tensor(_rand(rng, *s)) for s in ((1, 4, 9, 9),
                                                       (6, 4, 3, 3), (6,)))
    lw = torch.tensor(_rand(rng, 6, 9))
    F = torch.nn.functional
    flag = torch.backends.cudnn.allow_tf32
    with precision.bf16_products():
        assert torch.backends.cudnn.allow_tf32
        with precision.bf16_products(False):
            assert not torch.equal(precision.linear(x, lw, b),
                                   F.linear(x, lw, b))
    assert torch.backends.cudnn.allow_tf32 == flag
    assert torch.equal(precision.conv2d(x, w, b, 1, 1),
                       F.conv2d(x, w, b, 1, 1))
    assert torch.equal(precision.linear(x, lw, b), F.linear(x, lw, b))
    assert torch.equal(precision.matmul(x, x), torch.matmul(x, x))


# -------------------------------------------------- coverage of the models

PRODUCTS = ("convolution", "convolution_backward", "mm", "bmm", "addmm",
            "baddbmm")


class ProductOperands(TorchDispatchMode):
    """Counts the product calls and names those with a floating operand
    that is not bf16-representable."""

    def __init__(self):
        super().__init__()
        self.calls, self.bad = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in PRODUCTS:
            self.calls += 1
            for a in list(args) + list(kwargs.values()):
                if (isinstance(a, torch.Tensor) and a.is_floating_point()
                        and not torch.equal(a, precision.round_bf16(a))):
                    self.bad.append(str(func))
                    break
        return func(*args, **kwargs)


def _upernet(monkeypatch):
    narrow_upernet(monkeypatch)
    torch.manual_seed(0)
    m = build_model(*UPERNET, K, fused=False)
    x, y = torch.rand(2, 3, 64, 64), torch.randint(0, K, (2, 64, 64))

    def run():
        m.train()(x, y)[0].backward()        # the update
        xg = x.clone().requires_grad_(True)  # the attack, eval mode
        m.eval()(xg).logsumexp(1).sum().backward()
    return run


def _pspnet(monkeypatch):
    monkeypatch.setattr(tpsp, "ResNetStages", functools.partial(
        tpsp.ResNetStages, layers=(1, 1, 1, 1)))
    torch.manual_seed(0)
    m = PSPNet(classes=K, dropout=0.0)
    x, y = torch.rand(2, 3, 17, 17), torch.randint(0, K, (2, 17, 17))

    def run():
        main, aux, _ = m.train()(x, y)
        (main + 0.4 * aux).backward()
    return run


def _segmenter(monkeypatch):
    torch.manual_seed(0)
    m = SegMenter(K, drop_path_rate=0.0, **SEG)
    x, y = torch.rand(2, 3, 32, 32), torch.randint(0, K, (2, 32, 32))

    def run():
        segmentation_cross_entropy(m.train()(x), y, -1).backward()
    return run


def _resize(monkeypatch):
    x = torch.rand(2, 3, 11, 13, requires_grad=True)

    def run():
        (resize_bilinear(x, (23, 19)).square().sum()
         + resize_bilinear(x, (5, 6), align_corners=True).sum()
         + adaptive_avg_pool(x, (3, 3)).square().sum()).backward()
    return run


@pytest.mark.parametrize("make", [_upernet, _pspnet, _segmenter, _resize],
                         ids=["upernet", "pspnet", "segmenter", "resize"])
def test_every_product_takes_bf16_operands(make, monkeypatch):
    run = make(monkeypatch)
    with precision.bf16_products(), ProductOperands() as seen:
        run()
    assert seen.calls > 0 and not seen.bad, sorted(set(seen.bad))
    with ProductOperands() as off:
        run()
    assert off.calls == seen.calls and off.bad


def test_kernel_plain_versions_ignore_the_mode():
    """The plain versions stay their kernel's function (the kernels round
    their own operands): equal bit for bit with the mode on and off."""
    rng = np.random.default_rng(4)
    c = 32
    p = [torch.tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=(c, 1, 7, 7)) * 0.1, rng.normal(size=c) * 0.1,
        rng.random(c) + 0.5, rng.normal(size=c) * 0.1,
        rng.normal(size=(4 * c, c)) / c ** 0.5, rng.normal(size=4 * c) * 0.1,
        rng.normal(size=(c, 4 * c)) / (2 * c), rng.normal(size=c) * 0.1,
        rng.random(c))]
    x = torch.tensor(_rand(rng, 2, 9, 11, c))
    dy = torch.tensor(_rand(rng, 2, 9, 11, c))
    xs = [torch.tensor(_rand(rng, 2, 6, 7, 8)) for _ in range(4)]
    w = torch.tensor(_rand(rng, 4, 3, 3, 8, 16)) * 0.1
    s, t = torch.rand(16) + 0.5, torch.tensor(_rand(rng, 16))
    gy = torch.tensor(_rand(rng, 2, 6, 7, 16))

    def outs():
        out = fc.fpn_concat_conv_fwd_plain(xs, w, s, t)
        y, h = cm.convnext_mlp_fwd_plain(x, *p[2:], save_h=True)
        return [cb.convnext_block_plain(x, *p),
                cb.convnext_block_dx_plain(x, dy, *p), y, h,
                cm.convnext_mlp_dx_plain(x, dy, *p[2:7], p[8], h=h),
                out, *fc.fpn_concat_conv_dx_plain(gy, out, w, s)]
    off = outs()
    with precision.bf16_products():
        on = outs()
    assert all(torch.equal(a, b) for a, b in zip(on, off))


# ------------------------------------------------------------ the trainer

def test_trainer_step_under_bf16_products(monkeypatch):
    """One PIR-AT step (PGD through the fused twin, AdamW) under the mode
    against the same step in float32 from the same weights: every
    parameter moves, the loss within 5e-2 relative and not equal."""
    narrow_upernet(monkeypatch)
    torch.manual_seed(0)
    base = build_model(*UPERNET, K, fused=False)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((2, 3, 64, 64), generator=g)
    y = torch.randint(0, K, (2, 64, 64), generator=g)

    def step(bf16):
        m = copy.deepcopy(base)
        with torch.device("meta"):
            twin = build_model(*UPERNET, K, fused=True)
        opt = make_optimizer("adamw", m, get_scheduler(
            "warmuppolylr", 1e-4, 10, 1.0, 0, 1e-5), weight_decay=0.05)
        tr = Trainer(m, UPERNET[0], opt, AttackConfig(eps=4 / 255,
                                                      n_iters=2), twin=twin,
                     generator=torch.Generator().manual_seed(0))
        p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
        with precision.bf16_products(bf16):
            loss = float(tr.train_step(x, y))
        still = [n for n, p in m.named_parameters()
                 if torch.equal(p.detach(), p0[n])]
        return loss, still
    loss32, _ = step(False)
    loss16, still = step(True)
    assert not still, still
    assert np.isfinite(loss16) and loss16 != loss32
    assert abs(loss16 - loss32) <= 5e-2 * abs(loss32), (loss16, loss32)


# ------------------------------------------------ the CLI's precedence

@pytest.mark.parametrize("flag,amp,want", [
    ("bf16", False, "bf16"), ("bf16", True, "bf16"),
    ("default", False, "default"), ("default", True, "bf16"),
    ("f32", False, "f32"), ("f32", True, "f32"),
])
def test_train_cli_precision_follows_jax(flag, amp, want, tmp_path,
                                         monkeypatch, capsys):
    """``tools/train.py:98-111``: bf16 products under ``--precision
    bf16``, and under ``default`` with ``TRAIN.AMP``; ``f32`` trains in
    float32 with ``TRAIN.AMP`` ignored. The run logs what it resolved
    and its convolutions go through the bf16 products exactly when it
    says bf16."""
    narrow_upernet(monkeypatch)
    calls = []
    apply = precision._Conv2d.apply
    monkeypatch.setattr(precision._Conv2d, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    out = _train(monkeypatch, capsys, "--cfg", _cfg(tmp_path, AMP=amp),
                 "--max_iters", "1", "--precision", flag, "--run_dir",
                 str(tmp_path / "run"))
    m = re.search(r"precision: (\w+) \(([^;]*);", out)
    assert m and m.group(1) == want, out[-2000:]
    assert m.group(2) == {
        "bf16": "bf16 products (float32 parameters and accumulation, every "
                "product's operands rounded to bf16)",
        "default": "float32, TF32 in cuBLAS and cuDNN",
        "f32": "float32, TF32 off"}[want]
    assert bool(calls) == (want == "bf16")
    losses = [float(v) for v in re.findall(r"Loss: ([0-9.]+)", out)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "full mIoU" in out
