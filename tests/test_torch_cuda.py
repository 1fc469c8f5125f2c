"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. This file imports no JAX, so it also runs where JAX is absent; there,
skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the block kernels round matmul operands to bf16 (as the TPU
kernel does), the plain version runs float32 without TF32, so the forward
is held to atol = rtol = 2e-2 and the input gradient to a max error of
2e-2 relative to its largest entry (the bounds of tests/test_kernels.py).
The APGD step and the confusion histogram (both forms, shared and global,
and the shared form's first design) are held to exact equality.

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

Placement (two cards or more; each case skips with one card): every
kernel form run on the last card while card 0 is current, its tensors
there, against the same call on card 0, bit for bit. Every form is
deterministic from run to run (each output tile is one block's, and the
confusion kernel's atomics add integers), so none is held to a tolerance
instead. The models (main path, fused variant, bf16 main path) on the
last card against card 0 under phase 3 of chip_smoke.py's bounds: their
PyTorch operations outside the kernels need not be deterministic.
"""

import numpy as np
import pytest
import torch

from robseg_torch import kernels
from robseg_torch.kernels import confusion as cf
from robseg_torch.kernels import convnext_block as cb
from robseg_torch.kernels import convnext_mlp as cm
from robseg_torch.kernels import fpn_conv as fc
from robseg_torch.kernels.confusion import confusion_matrix_v1_cuda

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
# tokens) in each MLP form (fused at C <= 192, two GEMMs above); the other
# supported widths 128, 256 and 512; and the depthwise tiles' ragged edges
# (8 x 8 tiles at 96, 4 x 8 at 192, 8 x 4 at 384, 4 x 4 at 768) at the VOC
# stage sizes 59, 29 and 14 and at 7 x 11; VOC's batch-8 stage shapes at 96
# and 768, and ragged token counts at 128 and 1024
@pytest.mark.parametrize("shape", [(2, 37, 20, 96), (2, 119, 119, 96),
                                   (2, 60, 60, 192), (2, 30, 30, 384),
                                   (1, 15, 15, 768), (1, 8, 9, 1024),
                                   (1, 3, 5, 96), (1, 3, 43, 96),
                                   (1, 16, 16, 128), (1, 3, 43, 256),
                                   (1, 9, 9, 512), (1, 7, 11, 96),
                                   (2, 59, 59, 192), (3, 29, 29, 384),
                                   (1, 14, 14, 768), (8, 119, 119, 96),
                                   (8, 14, 14, 768), (1, 13, 11, 128),
                                   (2, 7, 9, 1024)])
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


def test_kernels_refuse_weight_gradients(dev):
    """A backward through a kernel with a weight that requires grad
    raises (no weight gradient is dropped silently); with detached
    weights, as the trainer's attack passes them, the input gradient goes
    through the kernels."""
    from robseg_torch.models import build_model
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    torch.manual_seed(0)
    x = torch.rand(1, 3, 64, 64, device=dev, requires_grad=True)
    for m in (build_model("UperNetForSemanticSegmentation",
                          "ConvNeXt-T_CVST", 21),
              UperNetForSemanticSegmentation("T_CVST", 21,
                                             fused_mlp_mode="residual",
                                             fused_head="pallas")):
        m = m.to(dev).eval()
        with pytest.raises(RuntimeError, match="input gradients only"):
            m(x).sum().backward()
        # autograd stops at the first kernel: the head's convolutions may
        # hold gradients, no ConvNeXt block's parameter does
        assert all(p.grad is None for n, p in m.named_parameters()
                   if n.startswith("backbone.stages."))
        m.zero_grad(set_to_none=True)
        tensors = {k: v.detach() for k, v in m.named_parameters()}
        tensors.update(m.named_buffers())
        x.grad = None
        torch.func.functional_call(m, tensors, (x,)).sum().backward()
        assert torch.isfinite(x.grad).all()


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


def blocky_labels(rng, shape, k, side=32):
    """Piecewise-constant labels, ``side`` x ``side`` regions of one class
    (where the kernel's run merging and per-warp copies matter)."""
    b, h, w = shape
    lab = rng.integers(0, k, (b, h // side + 1, w // side + 1))
    return np.kron(lab, np.ones((1, side, side), np.int64))[:, :h, :w]


# K = 21 (VOC) and 151 (ADE20K, one 91 KB shared histogram a block); the
# SEA batch at 512^2 and the VOC crop 473^2 (odd rows: the unaligned first
# pixel and the ragged tail), random and blocky labels; 64 x 512^2 is 2^24
# pixels, where the counts leave float32's exact range (int32 path)
@pytest.mark.parametrize("k,shape,blocky", [
    (21, (16, 512, 512), False), (21, (16, 512, 512), True),
    (151, (16, 512, 512), False), (151, (16, 512, 512), True),
    (21, (3, 473, 473), True), (151, (2, 7, 5), False),
    (151, (64, 512, 512), True)])
def test_confusion_shapes_exact(dev, k, shape, blocky):
    rng = np.random.default_rng(2)
    t = blocky_labels(rng, shape, k) if blocky else rng.integers(0, k, shape)
    p = np.where(rng.random(shape) < 0.5, t,
                 blocky_labels(rng, shape, k) if blocky
                 else rng.integers(0, k, shape))
    t = torch.tensor(t, device=dev)
    p = torch.tensor(p, device=dev)
    t[torch.rand(shape, device=dev) < 0.05] = -1
    for per_image in (False, True):
        kw = dict(num_classes=k, per_image=per_image)
        want = kernels.confusion_matrix_plain(p, t, **kw)
        assert torch.equal(kernels.confusion_matrix_cuda(p, t, **kw), want)
        assert torch.equal(confusion_matrix_v1_cuda(p, t, **kw), want)
    # a view whose rows start off the 16-byte grid
    off = (t.flatten()[1:], p.flatten()[1:])
    assert torch.equal(
        kernels.confusion_matrix_cuda(off[1][None], off[0][None],
                                      num_classes=k),
        kernels.confusion_matrix_plain(off[1][None], off[0][None],
                                       num_classes=k))


def launched_kernels(fn, tries: int = 5) -> set:
    """The names, without namespaces or template arguments, of the CUDA
    kernels one call of ``fn`` launches (torch.profiler; a window in which
    CUPTI handed back no kernel is taken again, up to ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name.replace("void ", "")
                 .replace("(anonymous namespace)::", "")
                 .split("<")[0].split("(")[0] for e in prof.events()
                 if "confusion" in e.name}
        if names:
            return names
    raise AssertionError(f"torch.profiler saw no confusion kernel in {tries} "
                         "windows")


# the form's boundary and the class counts users run, at the SEA batch
# (16 x 512^2), random and blocky labels: 238 (the shared form's largest
# K), 239 (the global form's first), 300, 459 (PASCAL-Context) and 847
# (ADE20K-full; per image on an H100 half the images at once); 847 at the
# VOC crop's odd rows and at 511 x 513 (every other row starts off the
# 16-byte grid); 673 and 716, on both sides of the H100's L2 rule; 64 x
# 512^2 = 2^24 pixels (int32 path) at 239 and 300. Each case also on a view
# whose rows start off the 16-byte grid, and each launch checked to have
# run the kernel of the form ``plan`` chose for this card.
@pytest.mark.parametrize("k,shape,blocky", [
    (238, (16, 512, 512), False), (239, (16, 512, 512), False),
    (239, (16, 512, 512), True),
    (300, (16, 512, 512), False), (300, (16, 512, 512), True),
    (459, (16, 512, 512), False), (459, (16, 512, 512), True),
    (847, (16, 512, 512), False), (847, (16, 512, 512), True),
    (847, (3, 473, 473), True), (847, (16, 511, 513), False),
    (673, (16, 512, 512), False), (716, (16, 512, 512), True),
    (239, (64, 512, 512), True), (300, (64, 512, 512), True)])
def test_confusion_any_classes_exact(dev, k, shape, blocky):
    card = cf.card(torch.cuda.current_device())
    rng = np.random.default_rng(k)
    t = blocky_labels(rng, shape, k) if blocky else rng.integers(0, k, shape)
    p = np.where(rng.random(shape) < 0.5, t,
                 blocky_labels(rng, shape, k) if blocky
                 else rng.integers(0, k, shape))
    t = torch.tensor(t, device=dev)
    p = torch.tensor(p, device=dev)
    t[torch.rand(shape, device=dev) < 0.05] = -1
    p[torch.rand(shape, device=dev) < 0.02] = k + 2
    n = shape[1] * shape[2]
    for per_image in (False, True):
        kw = dict(num_classes=k, per_image=per_image)
        rows, row_n = (shape[0], n) if per_image else (1, shape[0] * n)
        form = cf.plan(k, rows, row_n, *card)["form"]
        assert form == ("shared" if k <= 238 else "global")
        want = kernels.confusion_matrix_plain(p, t, **kw)
        assert torch.equal(kernels.confusion_matrix_cuda(p, t, **kw), want)
        assert launched_kernels(
            lambda: kernels.confusion_matrix_cuda(p, t, **kw)) == {
                {"shared": "confusion_kernel",
                 "global": "confusion_global_kernel"}[form]}
        off = (t.flatten()[1:].view(1, -1), p.flatten()[1:].view(1, -1))
        assert torch.equal(
            kernels.confusion_matrix_cuda(off[1], off[0], **kw),
            kernels.confusion_matrix_plain(off[1], off[0], **kw))


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


def test_fpn_kernels_match_plain_at_the_heads_shape(dev):
    """The head's ragged 473^2 shape (four 512-channel sources; 128 x 1
    tiles, each warpgroup's 64 pixels one TMA-store box in the bf16 form)
    against the plain versions, at the bounds of
    test_fpn_kernels_match_plain. Its check against the unrounded float32
    conv is left out: over 4 x 9 x 512 terms the bf16 rounding of the
    operands reaches that test's 5e-2 by chance (1 of 14.5 M outputs
    0.052 from it on the H100)."""
    rng = np.random.default_rng(13)
    n, shape, co = 4, (2, 119, 119, 512), 512
    t = lambda a: torch.tensor(a, dtype=torch.float32,            # noqa
                               device=dev)
    xs = [t(rng.normal(size=shape)) for _ in range(n)]
    w = t(rng.normal(size=(n, 3, 3, shape[-1], co)) / 30)
    s, b = t(1 + 0.1 * rng.normal(size=co)), t(0.1 * rng.normal(size=co))
    out = fc.fpn_concat_conv_fwd_cuda(xs, w, s, b)
    want = fc.fpn_concat_conv_fwd_plain(xs, w, s, b)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-3
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
# at 384 and 768), the ragged VOC stage sizes (at batch 8 too), the
# depthwise tiles' ragged edges, and the fused and GEMM widths ConvNeXt-T
# does not use (128, 1024)
@pytest.mark.parametrize("shape", [(2, 37, 20, 96), (2, 119, 119, 96),
                                   (1, 30, 30, 192), (1, 15, 15, 384),
                                   (1, 8, 9, 768), (1, 7, 11, 96),
                                   (2, 59, 59, 192), (3, 29, 29, 384),
                                   (1, 14, 14, 768), (8, 119, 119, 96),
                                   (8, 14, 14, 768), (1, 13, 11, 128),
                                   (2, 7, 9, 1024)])
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


# and the head's ragged 473^2 shape (TMA-store boxes of 64 x 1 pixels)
@pytest.mark.parametrize("n,shape,co", [(4, (2, 19, 16, 128), 128),
                                        (3, (3, 40, 72, 96), 160),
                                        (1, (8, 64, 64, 64), 64),
                                        (4, (2, 119, 119, 512), 512)])
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


def test_device_aug_on_card_equals_cpu(dev):
    """``apply_augment`` on the card against the CPU on the same buffers
    and draws: images within 1e-5 (float32 reads and blur sums), masks
    equal."""
    from robseg_torch.data.device_transforms import (apply_augment,
                                                     draw_augment_params)
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((4, 3, 200, 180), generator=g)
    masks = torch.randint(0, 151, (4, 200, 180), generator=g)
    valid = torch.tensor([[200, 180], [150, 180], [200, 90], [60, 70]])
    params = draw_augment_params(torch.Generator().manual_seed(1), 4,
                                 base_size=96)
    params["blur"][:2] = True
    ci, cm_ = apply_augment(imgs, masks, valid, params, crop_size=96)
    gi, gm = apply_augment(imgs.to(dev), masks.to(dev), valid.to(dev),
                           {k: v.to(dev) for k, v in params.items()},
                           crop_size=96)
    torch.testing.assert_close(gi.cpu(), ci, atol=1e-5, rtol=0)
    assert torch.equal(gm.cpu(), cm_)


@pytest.mark.parametrize("eps", [0.5, 20.0])
def test_l1_l2_projections_on_card_match_cpu(dev, eps):
    """The L1 projection (float32 sorts, prefix sums and binary search)
    and the L2 one on the card against the CPU: 1e-4 x max(eps, 1). The
    prefix sums over the 2n = 36000 breakpoints accumulate in float32 on
    the card and in float64 on the CPU (torch's CPU cumsum), and the dual
    step divides their difference: measured 2.44e-5 at eps 0.5 on an
    entry of 1.8 (a box repair)."""
    from robseg_torch.ops import project_l1_ball_box, project_l2
    g = torch.Generator().manual_seed(2)
    x = torch.rand((3, 3, 40, 50), generator=g)
    y = torch.randn((3, 3, 40, 50), generator=g) * 0.2
    y[0, 0, :2] += 1.5
    want = project_l1_ball_box(x, y, eps)
    got = project_l1_ball_box(x.to(dev), y.to(dev), eps).cpu()
    torch.testing.assert_close(got, want, atol=1e-4 * max(eps, 1.0), rtol=0)
    torch.testing.assert_close(project_l2(x.to(dev) + y.to(dev), x.to(dev),
                                          eps).cpu(),
                               project_l2(x + y, x, eps), atol=1e-6, rtol=0)


def test_restarts_and_summary_go_through_kernels(dev):
    """``apgd_restarts`` (ce-targeted, Linf) runs the APGD-step kernel and
    ``iou_acc_summary`` the confusion kernel, on a small conv model; the
    result stays in the eps ball and the summary equals the CPU's."""
    from robseg_torch.attacks import apgd_restarts
    from robseg_torch.ops import iou_acc_summary
    g = torch.Generator().manual_seed(3)
    w = (torch.randn((5, 3, 3, 3), generator=g) * 2).to(dev)

    def fn(x):
        return torch.nn.functional.conv2d(x, w, padding=1)
    x = torch.rand((2, 3, 24, 24), generator=g).to(dev)
    y = torch.randint(0, 5, (2, 24, 24), generator=g).to(dev)
    kernels.reset_launch_counts()
    adv, _, acc = apgd_restarts(fn, x, y, eps=8 / 255, n_iter=5,
                                loss="ce-targeted", n_restarts=2,
                                track_loss="ce-avg", n_target_classes=5)
    assert kernels.launch_counts()["apgd_linf_step"] == 10
    assert float((adv - x).abs().max()) <= 8 / 255 + 1e-6
    pred = fn(adv).argmax(1)
    got = iou_acc_summary(pred, y, num_classes=5)
    assert kernels.launch_counts()["confusion_matrix"] == 1
    want = iou_acc_summary(pred.cpu(), y.cpu(), num_classes=5)
    for a, b in zip(got, want):
        assert float(a) == pytest.approx(float(b), abs=1e-6)


@pytest.mark.parametrize("case", ["conv", "depthwise", "linear", "matmul",
                                  "resize"])
def test_bf16_products_on_card_match_float64(dev, case):
    """The train CLI's bf16 products on the card (matmuls as bf16 cuBLAS
    with a float32 output, convolutions on rounded operands under TF32)
    against float64 on the same rounded operands: forward and both
    operands' gradients from a rounded cotangent within 1e-3 of the
    reference's largest entry (chip_smoke.py phase B1's bound)."""
    from robseg_torch.ops import precision as P
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, device=dev, generator=g)
    fn, ops = {
        "conv": (lambda x, w: P.conv2d(x, w, None, 2, 1),
                 [r(2, 16, 33, 33), r(24, 16, 3, 3)]),
        "depthwise": (lambda x, w: P.conv2d(x, w, None, 1, 3, 1, 32),
                      [r(2, 32, 19, 19), r(32, 1, 7, 7)]),
        "linear": (lambda x, w: P.linear(x, w), [r(2, 9, 9, 96),
                                                 r(384, 96)]),
        "matmul": (lambda q, k: P.matmul(q, k.transpose(-2, -1)),
                   [r(2, 3, 65, 32), r(2, 3, 65, 32)]),
        "resize": (lambda m, x: P.matmul(m, x), [r(40, 17),
                                                 r(2, 5, 17, 17)]),
    }[case]
    ops = [t.requires_grad_(True) for t in ops]
    with P.bf16_products():
        y = fn(*ops)
        gy = torch.randn(y.shape, device=dev, generator=g)
        got = (y,) + torch.autograd.grad(y, ops, gy)
    ref = [P.round_bf16(t.detach()).double().requires_grad_(True)
           for t in ops]
    yr = fn(*ref)
    want = (yr,) + torch.autograd.grad(yr, ref, P.round_bf16(gy).double())
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err <= 1e-3, err


def _data_parallel_rank(group):
    """A rank of ``test_data_parallel_world_on_card``: one data-parallel
    train step on its shard. Returns the launch counts, the loss and a
    checksum of the parameters."""
    from robseg_torch.models import build_model
    from robseg_torch.parallel import replicate, shard_batch
    from robseg_torch.train import AttackConfig, Trainer, make_optimizer
    from robseg_torch.train.schedules import poly_lr
    dev = group.device
    name = ("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST", 21)
    torch.manual_seed(0)
    m = build_model(*name, fused=False).to(dev)
    replicate(m, group)
    with torch.device("meta"):
        twin = build_model(*name, fused=True)
    trainer = Trainer(m, name[0], make_optimizer("adamw", m,
                                                 poly_lr(1e-4, 10)),
                      AttackConfig(eps=4 / 255, n_iters=2), twin=twin,
                      generator=torch.Generator(device=dev).manual_seed(0),
                      group=group)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((4, 3, 64, 64), device=dev, generator=g)
    y = torch.randint(0, 21, (4, 64, 64), device=dev, generator=g)
    kernels.reset_launch_counts()
    loss = float(trainer.train_step(shard_batch(x, group),
                                    shard_batch(y, group)))
    with torch.no_grad():
        digest = [float(p.double().sum()) for p in m.parameters()]
    return kernels.launch_counts(), loss, digest


def test_data_parallel_world_on_card(dev):
    """A world of 2 ranks on the card(s), over NCCL with a card a rank or,
    with one card, sharing it over gloo (chip_smoke.py's phase D picks the
    same; its phase 1 builds the kernels with such a world, every rank
    compiling at once): one data-parallel PIR-AT step of
    UperNet-ConvNeXt-T_CVST (full width, 64^2, 2 images a rank, PGD-2
    through the block kernels' twin). Each rank launched the block pair,
    the loss (averaged over the ranks) is finite and the same on both,
    and the replicas are identical."""
    import math
    from robseg_torch.parallel import spawn_world
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ranks = spawn_world(_data_parallel_rank, 2, device_type="cuda",
                        backend=backend, timeout_s=300)
    for counts, loss, digest in ranks:
        assert counts["convnext_block_fwd"] > 0
        assert counts["convnext_block_dx"] > 0
        assert math.isfinite(loss) and loss == ranks[0][1]
        assert digest == ranks[0][2]


@pytest.fixture
def cards():
    """(card 0, the last card), card 0 current; skips below two cards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the kernels run on the last "
                    "card while card 0 is current")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return (torch.device("cuda", 0),
            torch.device("cuda", torch.cuda.device_count() - 1))


def _block_form(dx: bool, bf16: bool, c: int):
    def run(dev):
        rng = np.random.default_rng(23)
        shape = (2, 37, 20, c) if c <= cb.FUSED_MAX_C else (1, 15, 15, c)
        p = block_params(rng, c, dev)
        x, dy = (torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                              device=dev) for _ in (0, 1))
        if bf16:
            x, dy, *p = (t.to(torch.bfloat16) for t in (x, dy, *p))
        fwd = cb._FWD_CUDA[x.dtype]
        return cb._DX_CUDA[x.dtype](x, dy, *p) if dx else fwd(x, *p)
    return run


def _mlp_form(dx: bool, mode: str, c: int):
    def run(dev):
        save_h, bf16 = cm.MODES[mode]
        rng = np.random.default_rng(29)
        shape = (2, 19, 19, c) if c <= cb.FUSED_MAX_C else (3, 7, 13, c)
        ls, lb, w1, b1, w2, b2, g = mlp_params(rng, c, dev)
        y, dy = (torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                              device=dev) for _ in (0, 1))
        out, h = cm.convnext_mlp_fwd_cuda(y, ls, lb, w1, b1, w2, b2, g,
                                          save_h=save_h, bf16_operands=bf16)
        if not dx:
            return (out,) + ((h,) if save_h else ())
        return cm.convnext_mlp_dx_cuda(y, dy, ls, lb, w1, b1, w2, g, h=h,
                                       bf16_operands=bf16)
    return run


def _fpn_form(dx: bool, bf16: bool):
    def run(dev):
        rng = np.random.default_rng(31)
        n, shape, co = 4, (2, 19, 16, 128), 128
        dt = torch.bfloat16 if bf16 else torch.float32
        t = lambda a: torch.tensor(a, device=dev).to(dt)  # noqa
        xs = [t(rng.normal(size=shape)) for _ in range(n)]
        w = t(rng.normal(size=(n, 3, 3, shape[-1], co)) / 30)
        s = torch.tensor(1 + 0.1 * rng.normal(size=co), dtype=torch.float32,
                         device=dev)
        b = torch.tensor(0.1 * rng.normal(size=co), dtype=torch.float32,
                         device=dev)
        out = fc._FWD_CUDA[dt](xs, w, s, b)
        if not dx:
            return out
        return fc._DX_CUDA[dt](t(rng.normal(size=out.shape)), out, w, s)
    return run


def _apgd_form(dev):
    rng = np.random.default_rng(37)
    shape = (4, 3, 33, 47)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    x = t(rng.random(shape))
    x_adv, x_old = (torch.clamp(x + t(rng.uniform(-0.03, 0.03, shape)), 0,
                                1) for _ in (0, 1))
    return kernels.apgd_linf_step_cuda(x, x_adv, x_old,
                                       t(rng.normal(size=shape)),
                                       t(rng.uniform(0.01, 0.05, (4,))),
                                       8 / 255, 0.75)


def _confusion_form(k: int, per_image: bool, first_design: bool = False):
    def run(dev):
        rng = np.random.default_rng(k)
        shape = (3, 97, 101)
        t = torch.tensor(rng.integers(-1, k, shape), device=dev)
        p = torch.tensor(np.where(rng.random(shape) < 0.5, t.cpu().numpy(),
                                  rng.integers(0, k + 2, shape)), device=dev)
        fn = (confusion_matrix_v1_cuda if first_design
              else kernels.confusion_matrix_cuda)
        return fn(p, t, num_classes=k, per_image=per_image)
    return run


PLACEMENT_FORMS = {
    **{f"block_{d}_{io}_C{c}": _block_form(d == "dx", io == "bf16", c)
       for d in ("fwd", "dx") for io in ("f32", "bf16") for c in (96, 384)},
    **{f"mlp_{d}_{mode}_C{c}": _mlp_form(d == "dx", mode, c)
       for d in ("fwd", "dx") for mode in ("residual", "recompute_bf16")
       for c in (96, 384)},
    **{f"fpn_{d}_{io}": _fpn_form(d == "dx", io == "bf16")
       for d in ("fwd", "dx") for io in ("f32", "bf16")},
    "apgd_linf_step": _apgd_form,
    **{f"confusion_K{k}_{'per_image' if pi else 'summed'}":
       _confusion_form(k, pi) for k in (21, 847) for pi in (False, True)},
    "confusion_first_design_K21": _confusion_form(21, True, True),
}


@pytest.mark.parametrize("form", sorted(PLACEMENT_FORMS))
def test_kernel_runs_on_its_tensors_card(cards, form):
    """The kernel form on the last card while card 0 is current: its
    outputs there, bit for bit those of the same call on card 0, and card
    0 still current after it."""
    home, far = cards
    want = PLACEMENT_FORMS[form](home)
    got = PLACEMENT_FORMS[form](far)
    torch.cuda.synchronize(far)
    assert torch.cuda.current_device() == home.index
    want, got = ((o if isinstance(o, tuple) else (o,)) for o in (want, got))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device == far and b.device == home
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("setting", ["main", "fused-variant", "bf16"])
def test_model_runs_on_its_tensors_card(cards, setting):
    """The full-width UperNet-ConvNeXt-T_CVST (seeded weights, 64^2, batch
    2) in a ModelBundle on the last card while card 0 is current: its
    kernels launch (counted from zero), the logits and the input gradient
    of their sum lie there and agree with the same model on card 0 under
    phase 3 of chip_smoke.py's bounds."""
    from robseg_torch.models import ModelBundle
    from robseg_torch.models.upernet import UperNetForSemanticSegmentation
    home, far = cards
    settings = ({"fused_mlp_mode": "residual", "fused_head": "pallas"}
                if setting == "fused-variant" else {})
    launched = {"main": ("convnext_block_fwd", "convnext_block_dx"),
                "fused-variant": ("convnext_mlp_fwd", "convnext_mlp_dx",
                                  "fpn_concat_conv_fwd",
                                  "fpn_concat_conv_dx"),
                "bf16": ("convnext_block_fwd_bf16",
                         "convnext_block_dx_bf16")}[setting]

    def run(dev):
        torch.manual_seed(0)
        m = UperNetForSemanticSegmentation("T_CVST", 21, **settings)
        fn = ModelBundle(m.to(dev), "bf16" if setting == "bf16"
                         else "default").logits_fn
        x = torch.rand((2, 3, 64, 64), generator=torch.Generator()
                       .manual_seed(1)).to(dev).requires_grad_(True)
        kernels.reset_launch_counts()
        logits = fn(x)
        (grad,) = torch.autograd.grad(logits.sum(), x)
        return logits.detach(), grad, kernels.launch_counts()

    lw, gw, _ = run(home)
    lg, gg, counts = run(far)
    assert torch.cuda.current_device() == home.index
    assert all(counts[k] > 0 for k in launched), counts
    assert lg.device == gg.device == far
    atol = 5e-2 if setting == "bf16" else 2e-2
    torch.testing.assert_close(lg.cpu(), lw.cpu(), atol=atol, rtol=atol)
    cos = float(torch.nn.functional.cosine_similarity(
        gg.cpu().flatten(), gw.cpu().flatten(), dim=0))
    assert rel_max_err(gg.cpu(), gw.cpu()) <= 0.15 and cos >= 0.99
