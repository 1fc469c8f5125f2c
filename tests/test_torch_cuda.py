"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. This file imports no JAX, so it also runs where JAX is absent; there,
skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the block kernels round matmul operands to bf16 (as the TPU
kernel does), the plain version runs float32 without TF32, so the forward
is held to atol = rtol = 2e-2 and the input gradient to a max error of
2e-2 relative to its largest entry (the bounds of tests/test_kernels.py).
The APGD step and the confusion histogram are held to exact equality.

The bf16 I/O forms of the block and FPN kernels against their float32
forms on the upcast inputs, the result rounded once to bf16: bit for bit
(the forms compute the same float32 values and round once at the store).

The FPN concat-conv and the bf16-operand MLP-tail kernels against plain
versions that round where they round: input gradient max error <= 2e-3
of its largest entry; forward max abs error <= 1e-3 for the FPN, and max
error <= 2e-3 of its largest entry for the MLP tail, where the rounding
of gelu(h) to bf16 can go the other way when the two float32 sums for h
differ in the last bit. Against the float32 plain version without the
rounding, the JAX package's bounds for bf16 operands against a float32
reference: FPN forward atol = rtol = 5e-2 (tests/test_kernels.py:394-395),
MLP forward atol = rtol = 2e-2 (:294-295) and gradient atol = rtol = 5e-2
(:235-236). The float32-operand
MLP-tail kernels against the float32 plain version: forward atol 2e-5,
gradient atol 5e-4 / rtol 1e-3 (:81-104, :142-145).
"""

import numpy as np
import pytest
import torch

from robseg_torch import kernels
from robseg_torch.kernels import convnext_block as cb
from robseg_torch.kernels import convnext_mlp as cm
from robseg_torch.kernels import fpn_conv as fc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def block_params(rng, c, device):
    """Torch-layout block parameters. At C=96 these are the scales of
    tests/test_kernels.py::_params; the matmul weights scale with
    1/sqrt(fan-in) (0.05 at C=96), so the output, and with it the bf16
    rounding error, keeps the same size at every width."""
    arrs = (rng.normal(size=(c, 1, 7, 7)) * 0.1,     # dw
            rng.normal(size=c) * 0.1,                # dwb
            rng.random(c) + 0.5,                     # ls
            rng.normal(size=c) * 0.1,                # lb
            rng.normal(size=(4 * c, c)) * 0.5 / c ** 0.5,      # w1
            rng.normal(size=4 * c) * 0.1,                      # b1
            rng.normal(size=(c, 4 * c)) * 1.0 / (4 * c) ** 0.5,  # w2
            rng.normal(size=c) * 0.1,                # b2
            rng.random(c))                           # gamma
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrs]


def rel_max_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


# the model's widths and ragged VOC stage sizes; a map smaller than one
# 128-token tile (15 tokens) and one a token past a tile multiple (129
# tokens) in each MLP form (fused at C <= 192, two GEMMs above); and the
# other supported widths 128, 256 and 512
@pytest.mark.parametrize("shape", [(2, 37, 20, 96), (2, 119, 119, 96),
                                   (2, 60, 60, 192), (2, 30, 30, 384),
                                   (1, 15, 15, 768), (1, 8, 9, 1024),
                                   (1, 3, 5, 96), (1, 3, 43, 96),
                                   (1, 16, 16, 128), (1, 3, 43, 256),
                                   (1, 9, 9, 512)])
def test_block_kernels_match_plain(dev, shape):
    rng = np.random.default_rng(11)
    p = block_params(rng, shape[-1], dev)
    x = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)
    dy = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                      device=dev)
    got = cb.convnext_block_fwd_cuda(x, *p)
    want = cb.convnext_block_plain(x, *p)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    dx = cb.convnext_block_dx_cuda(x, dy, *p)
    dx_want = cb.convnext_block_dx_plain(x, dy, *p)
    torch.cuda.synchronize()
    assert rel_max_err(dx, dx_want) <= 2e-2


def test_block_fn_gradient_goes_through_kernels(dev):
    rng = np.random.default_rng(3)
    p = block_params(rng, 96, dev)
    x = torch.tensor(rng.normal(size=(1, 16, 16, 96)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    kernels.reset_launch_counts()
    (cb.convnext_block(x, *p) ** 2).sum().backward()
    counts = kernels.launch_counts()
    assert counts["convnext_block_fwd"] == 1
    assert counts["convnext_block_dx"] == 1


@pytest.mark.parametrize("a", [1.0, 0.75])
def test_apgd_step_exact(dev, a):
    rng = np.random.default_rng(0)
    shape = (4, 3, 33, 47)
    t = lambda arr: torch.tensor(arr, dtype=torch.float32,        # noqa
                                 device=dev)
    x = t(rng.random(shape))
    x_adv = torch.clamp(x + t(rng.uniform(-0.03, 0.03, shape)), 0, 1)
    x_old = torch.clamp(x + t(rng.uniform(-0.03, 0.03, shape)), 0, 1)
    grad = t(rng.normal(size=shape))
    grad[0, 0, 0, :5] = 0.0
    step = t(rng.uniform(0.01, 0.05, (4, 1, 1, 1)))
    eps = 8 / 255
    got = kernels.apgd_linf_step_cuda(x, x_adv, x_old, grad, step, eps, a)
    want = kernels.apgd_linf_step_plain(x, x_adv, x_old, grad, step, eps, a)
    assert torch.equal(got, want)


@pytest.mark.parametrize("per_image", [False, True])
def test_confusion_exact(dev, per_image):
    rng = np.random.default_rng(1)
    k = 21
    t = torch.tensor(rng.integers(0, k, (3, 41, 37)), device=dev)
    p = torch.tensor(rng.integers(-1, k + 2, (3, 41, 37)), device=dev)
    t[rng.random((3, 41, 37)) < 0.05] = -1
    got = kernels.confusion_matrix_cuda(p, t, num_classes=k,
                                        per_image=per_image)
    want = kernels.confusion_matrix_plain(p, t, num_classes=k,
                                          per_image=per_image)
    assert torch.equal(got, want)


# the kernel's edges: C = 96 (a channel tail against 64-channel K-steps),
# Co = 160 (an output tail against 256-wide tiles), 1 to 4 sources, 8 x 9
# maps smaller than one 16 x 8 box, and (8, 64, 64) with 256 tiles, more
# than the 132 persistent blocks
@pytest.mark.parametrize("n,shape,co", [(4, (2, 19, 16, 128), 128),
                                        (4, (1, 33, 37, 96), 96),
                                        (2, (1, 8, 9, 64), 160),
                                        (1, (2, 19, 16, 96), 160),
                                        (3, (1, 8, 9, 96), 160),
                                        (3, (3, 40, 72, 96), 160),
                                        (1, (8, 64, 64, 64), 64)])
def test_fpn_kernels_match_plain(dev, n, shape, co):
    rng = np.random.default_rng(13)
    t = lambda a: torch.tensor(a, dtype=torch.float32,            # noqa
                               device=dev)
    xs = [t(rng.normal(size=shape)) for _ in range(n)]
    w = t(rng.normal(size=(n, 3, 3, shape[-1], co)) / 30)
    s, b = t(1 + 0.1 * rng.normal(size=co)), t(0.1 * rng.normal(size=co))
    out = fc.fpn_concat_conv_fwd_cuda(xs, w, s, b)
    want = fc.fpn_concat_conv_fwd_plain(xs, w, s, b)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-3
    x32 = torch.cat(xs, -1).permute(0, 3, 1, 2)
    f32 = torch.relu(torch.nn.functional.conv2d(
        x32, fc._full_weight(w), padding=1) * s[:, None, None]
        + b[:, None, None]).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, f32, atol=5e-2, rtol=5e-2)
    dy = t(rng.normal(size=out.shape))
    got = fc.fpn_concat_conv_dx_cuda(dy, out, w, s)
    want = fc.fpn_concat_conv_dx_plain(dy, out, w, s)
    torch.cuda.synchronize()
    assert len(got) == n
    for a, e in zip(got, want):
        assert rel_max_err(a, e) <= 2e-3


def mlp_params(rng, c, device):
    """Torch-layout MLP-tail parameters (ls, lb, w1, b1, w2, b2, gamma),
    the scales of block_params."""
    p = block_params(rng, c, device)
    return p[2:]


@pytest.mark.parametrize("mode", list(cm.MODES))
# every width; ragged token counts: 722, 225, 99 and 273 (2 x 128 + 17)
# tokens, 129 (a 128-token tile and one row)
@pytest.mark.parametrize("shape", [(2, 19, 19, 96), (1, 16, 16, 128),
                                   (1, 129, 1, 128), (1, 15, 15, 192),
                                   (1, 8, 8, 256), (1, 9, 11, 384),
                                   (3, 7, 13, 384)])
def test_mlp_kernels_match_plain(dev, mode, shape):
    save_h, bf16 = cm.MODES[mode]
    rng = np.random.default_rng(5)
    ls, lb, w1, b1, w2, b2, g = mlp_params(rng, shape[-1], dev)
    y = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                     device=dev)
    dy = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                      device=dev)
    fwd = (y, ls, lb, w1, b1, w2, b2, g)
    out, h = cm.convnext_mlp_fwd_cuda(*fwd, save_h=save_h,
                                      bf16_operands=bf16)
    want, h_want = cm.convnext_mlp_fwd_plain(*fwd, save_h=save_h,
                                             bf16_operands=bf16)
    dxa = (y, dy, ls, lb, w1, b1, w2, g)
    dx = cm.convnext_mlp_dx_cuda(*dxa, h=h, bf16_operands=bf16)
    dx_want = cm.convnext_mlp_dx_plain(*dxa, h=h_want, bf16_operands=bf16)
    torch.cuda.synchronize()
    assert (h is None) == (not save_h)
    err = {"fwd": float((out - want).abs().max()),
           "dx": rel_max_err(dx, dx_want)}
    if save_h:
        err["h"] = rel_max_err(h, h_want)
    if bf16:
        want32, _ = cm.convnext_mlp_fwd_plain(*fwd)
        dx32 = cm.convnext_mlp_dx_plain(*dxa)
        ok = {"fwd": rel_max_err(out, want) <= 2e-3,
              "dx": err["dx"] <= 2e-3,
              "fwd32": bool(torch.isclose(out, want32, atol=2e-2,
                                          rtol=2e-2).all()),
              "dx32": bool(torch.isclose(dx, dx32, atol=5e-2,
                                         rtol=5e-2).all()),
              # a bf16 operand rounded the other way moves h by a bf16
              # step of one product
              "h": err.get("h", 0.0) <= 2e-3}
    else:
        ok = {"fwd": err["fwd"] <= 2e-5,
              "dx": bool(torch.isclose(dx, dx_want, atol=5e-4,
                                       rtol=1e-3).all()),
              "h": bool(h is None or torch.isclose(h, h_want, atol=2e-5,
                                                   rtol=0).all())}
    assert all(ok.values()), (ok, err)


def test_fused_model_goes_through_new_kernels(dev):
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    torch.manual_seed(0)
    m = UperNetForSemanticSegmentation("T_CVST", 21, fused_mlp_mode="residual",
                                       fused_head="pallas")
    x = torch.rand(1, 3, 64, 64, device=dev, requires_grad=True)
    kernels.reset_launch_counts()
    ModelBundle(m.to(dev)).logits_fn(x).sum().backward()
    counts = kernels.launch_counts()
    assert counts["convnext_block_fwd"] == counts["convnext_block_dx"] == 0
    assert counts["convnext_mlp_fwd"] == counts["convnext_mlp_dx"] == 15
    assert counts["fpn_concat_conv_fwd"] == counts["fpn_concat_conv_dx"] == 1
    assert torch.isfinite(x.grad).all()


def _bf16_pair(fn_bf16, fn_f32, bf_args, dtype=torch.bfloat16):
    """The bf16 form on bf16 operands, and the float32 form on the same
    values upcast, its result rounded once to bf16."""
    got = fn_bf16(*bf_args)
    up = [[t.float() for t in a] if isinstance(a, list) else
          a.float() if a.dtype == dtype else a for a in bf_args]
    want = fn_f32(*up)
    if isinstance(want, tuple):
        return got, tuple(w.to(dtype) for w in want)
    return got, want.to(dtype)


# the four stage widths of the model (fused form at 96 and 192, two GEMMs
# at 384 and 768) and the ragged VOC stage size
@pytest.mark.parametrize("shape", [(2, 37, 20, 96), (2, 119, 119, 96),
                                   (1, 30, 30, 192), (1, 15, 15, 384),
                                   (1, 8, 9, 768)])
def test_block_bf16_forms_equal_f32_kernels_on_upcast_inputs(dev, shape):
    """bf16 I/O: bit for bit the float32 form on the upcast inputs,
    rounded once at the output; the parameters bf16 too."""
    rng = np.random.default_rng(17)
    p = [t.to(torch.bfloat16) for t in block_params(rng, shape[-1], dev)]
    x = torch.tensor(rng.normal(size=shape), device=dev).to(torch.bfloat16)
    dy = torch.tensor(rng.normal(size=shape), device=dev).to(torch.bfloat16)
    kernels.reset_launch_counts()
    out, out_want = _bf16_pair(cb.convnext_block_fwd_bf16_cuda,
                               cb.convnext_block_fwd_cuda, [x, *p])
    dx, dx_want = _bf16_pair(cb.convnext_block_dx_bf16_cuda,
                             cb.convnext_block_dx_cuda, [x, dy, *p])
    torch.cuda.synchronize()
    assert out.dtype == dx.dtype == torch.bfloat16
    assert torch.equal(out, out_want) and torch.equal(dx, dx_want)
    counts = kernels.launch_counts()
    assert counts["convnext_block_fwd_bf16"] == counts["convnext_block_dx_bf16"] == 1
    # and against the plain version on the same bf16 operands
    torch.testing.assert_close(out.float(),
                               cb.convnext_block_plain(x, *p).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("n,shape,co", [(4, (2, 19, 16, 128), 128),
                                        (3, (3, 40, 72, 96), 160),
                                        (1, (8, 64, 64, 64), 64)])
def test_fpn_bf16_forms_equal_f32_kernels_on_upcast_inputs(dev, n, shape,
                                                          co):
    rng = np.random.default_rng(19)
    bf = lambda a: torch.tensor(a, device=dev).to(torch.bfloat16)  # noqa
    xs = [bf(rng.normal(size=shape)) for _ in range(n)]
    w = bf(rng.normal(size=(n, 3, 3, shape[-1], co)) / 30)
    s = torch.tensor(1 + 0.1 * rng.normal(size=co), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(0.1 * rng.normal(size=co), dtype=torch.float32,
                     device=dev)
    out, out_want = _bf16_pair(fc.fpn_concat_conv_fwd_bf16_cuda,
                               fc.fpn_concat_conv_fwd_cuda, [xs, w, s, b])
    dy = bf(rng.normal(size=out.shape))
    dx, dx_want = _bf16_pair(fc.fpn_concat_conv_dx_bf16_cuda,
                             fc.fpn_concat_conv_dx_cuda, [dy, out, w, s])
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, out_want)
    assert len(dx) == n
    for a, e in zip(dx, dx_want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, e)


def test_bf16_models_go_through_bf16_forms(dev):
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    torch.manual_seed(0)
    m = UperNetForSemanticSegmentation("T_CVST", 21, fused_mlp_mode="block",
                                       fused_head="pallas")
    x = torch.rand(1, 3, 64, 64, device=dev, requires_grad=True)
    kernels.reset_launch_counts()
    logits = ModelBundle(m.to(dev), "bf16").logits_fn(x)
    assert logits.dtype == torch.float32
    logits.sum().backward()
    counts = kernels.launch_counts()
    assert counts["convnext_block_fwd"] == counts["convnext_block_dx"] == 0
    assert counts["convnext_block_fwd_bf16"] == 18
    assert counts["convnext_block_dx_bf16"] == 18
    assert counts["fpn_concat_conv_fwd_bf16"] == 1
    assert counts["fpn_concat_conv_dx_bf16"] == 1
    assert torch.isfinite(x.grad).all()
