"""The ``--precision bf16`` path of the port against the JAX package, on
the CPU.

- The plain bf16 block (``convnext_block_plain`` on bf16 ``x`` and
  parameters: float32 math on the upcast inputs, one rounding at the
  output) against JAX's ``convnext_block_reference`` on the upcast
  inputs, output and input gradient at atol = rtol = 5e-2, the bound at
  which tests/test_kernels.py:336 holds the JAX kernel's bf16 form; the
  output and the gradient are bf16, as the JAX kernel writes them.
- The plain bf16 FPN concat-conv against ``fpn_concat_conv_reference(...,
  out_dtype=bf16)``, in the same way.
- The bf16 UperNet-ConvNeXt-T_CVST at 64^2 (the main path's block kernel
  and split bottleneck, through the plain versions) against the JAX model
  with bf16 parameters, BatchNorm statistics and input, on the same
  weights through ``upernet_state_dict_from_jax``: logits at atol = rtol =
  5e-2 and the input gradient of a fixed random cotangent within 0.15 of
  its largest entry, the JAX package's bf16 model-level bounds
  (tests/test_kernels.py:313-318). The two bf16 models round in other
  places (JAX's plain block after each layer, the port's block, as the
  block kernel, once at its output), and the gap compounds through 18
  blocks. Measured here (the test prints them; ``pytest -s``): logits max
  abs error 2.3e-2 (largest logit 1.70), input gradient max error 0.129 of
  its largest entry, cosine 0.993.
- The dtype trail of the ``recompute_bf16`` tail mode under bf16 against
  JAX's (``jax.eval_shape`` over ``apply(..., capture_intermediates=True)``,
  so no Pallas kernel runs): bf16 up to the first tail block, float32
  after it.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robseg_tpu.kernels.convnext_block import convnext_block_reference
from robseg_tpu.kernels.fpn_conv import fpn_concat_conv_reference
from robseg_tpu.models.upernet import UperNetForSemanticSegmentation as JUN
from robseg_torch.convert import upernet_state_dict_from_jax
from robseg_torch.kernels import convnext_block as cb
from robseg_torch.kernels import fpn_conv as fc
from robseg_torch.models import ModelBundle, build_model
from robseg_torch.models.upernet import UperNetForSemanticSegmentation

BF16 = torch.bfloat16
VARIANT, K, HW = "T_CVST", 21, 64


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(a).to(BF16)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def test_block_plain_bf16_matches_jax_reference():
    rng = np.random.default_rng(21)
    c = 96
    jp = [a.astype(np.float32) for a in (
        rng.normal(size=(7, 7, c)) * 0.1, rng.normal(size=c) * 0.1,
        rng.random(c) + 0.5, rng.normal(size=c) * 0.1,
        rng.normal(size=(c, 4 * c)) * 0.05, rng.normal(size=4 * c) * 0.1,
        rng.normal(size=(4 * c, c)) * 0.05, rng.normal(size=c) * 0.1,
        rng.random(c))]
    dw, dwb, ls, lb, w1, b1, w2, b2, g = (_bf16(a) for a in jp)
    p = [dw.permute(2, 0, 1)[:, None].contiguous(), dwb, ls, lb,
         w1.t().contiguous(), b1, w2.t().contiguous(), b2, g]
    x = _bf16(rng.normal(size=(1, 16, 16, c)).astype(np.float32))
    dy = _bf16(rng.normal(size=x.shape).astype(np.float32))

    out = cb.convnext_block_plain(x, *p)
    dx = cb.convnext_block_dx_plain(x, dy, *p)
    assert out.dtype == BF16 and dx.dtype == BF16
    # the JAX oracle on the upcast bf16 values
    up = [jnp.asarray(_f32(t)) for t in (x, dy, dw, dwb, ls, lb, w1, b1, w2,
                                         b2, g)]

    @jax.jit
    def oracle(z, d, *params):
        out, vjp = jax.vjp(lambda a: convnext_block_reference(a, *params), z)
        return out, vjp(d)[0]
    want, dx_want = oracle(*up)
    np.testing.assert_allclose(_f32(out), np.asarray(want), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(_f32(dx), np.asarray(dx_want), atol=5e-2,
                               rtol=5e-2)


def test_fpn_plain_bf16_matches_jax_reference():
    rng = np.random.default_rng(22)
    n, shape, co = 2, (1, 8, 16, 128), 128
    xs = [_bf16(rng.standard_normal(shape).astype(np.float32))
          for _ in range(n)]
    w = _bf16((rng.standard_normal((n, 3, 3, shape[-1], co)) / 30).astype(
        np.float32))
    s = torch.tensor((1 + 0.1 * rng.standard_normal(co)).astype(np.float32))
    t = torch.tensor((0.1 * rng.standard_normal(co)).astype(np.float32))
    dy = _bf16(rng.standard_normal(shape[:-1] + (co,)).astype(np.float32))

    xg = [x.clone().requires_grad_(True) for x in xs]
    out = fc.fpn_concat_conv(xg, w, s, t)
    dxs = torch.autograd.grad(out, xg, dy)
    assert out.dtype == BF16 and all(d.dtype == BF16 for d in dxs)

    jxs = tuple(jnp.asarray(_f32(x)).astype(jnp.bfloat16) for x in xs)
    want, vjp = jax.vjp(
        lambda *z: fpn_concat_conv_reference(
            z, jnp.asarray(_f32(w)).astype(jnp.bfloat16),
            (jnp.asarray(s.numpy()), jnp.asarray(t.numpy())),
            out_dtype=jnp.bfloat16), *jxs)
    dxs_want = vjp(jnp.asarray(_f32(dy)).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(out), np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)
    for a, b in zip(dxs, dxs_want):
        np.testing.assert_allclose(_f32(a), np.asarray(b, np.float32),
                                   atol=5e-2, rtol=5e-2)


def _to_bf16(tree):
    """tools/infer.py:146-153: every float32 leaf (params and
    batch_stats) to bf16."""
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if getattr(a, "dtype", None) == jnp.float32 else a, tree)


@pytest.fixture(scope="module")
def jax_vars():
    """Random JAX variables in the model's tree, drawn with numpy (the
    init's shapes from ``jax.eval_shape``, which compiles nothing):
    kernels at lecun-normal scale (trunc-normal 0.02 in the backbone's
    blocks, as their init), small biases, norm scales near 1, the layer
    scales 1 (tests/test_torch_models.py::jax_vars says why) and random
    BatchNorm statistics."""
    shapes = jax.eval_shape(
        JUN(backbone_variant=VARIANT, num_classes=K).init,
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, HW, HW, 3),
                                                    jnp.float32))
    rng = np.random.default_rng(0)

    def draw(path, a):
        keys = [str(getattr(k, "key", k)) for k in path]
        leaf, s = keys[-1], a.shape
        if leaf == "kernel":
            std = (0.02 if any(k.startswith("stage") for k in keys)
                   else float(np.prod(s[:-1])) ** -0.5)
            v = rng.normal(size=s) * std
        elif leaf in ("bias", "mean"):
            v = rng.normal(size=s) * 0.1
        elif leaf == "scale":
            v = 1 + rng.normal(size=s) * 0.1
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, s)
        else:  # the layer scales
            v = np.ones(s)
        return v.astype(np.float32)
    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return dict(v["params"]), dict(v["batch_stats"])


def test_bf16_model_matches_jax_bf16_model(jax_vars):
    rng = np.random.default_rng(6)
    x = rng.random((1, 3, HW, HW)).astype(np.float32)
    ct = rng.normal(size=(1, K, HW, HW)).astype(np.float32)
    v16 = _to_bf16({"params": jax_vars[0], "batch_stats": jax_vars[1]})
    jm = JUN(backbone_variant=VARIANT, num_classes=K)

    @jax.jit
    def f(z, c):
        lg, vjp = jax.vjp(lambda a: jm.apply(v16, a.astype(jnp.bfloat16))
                          .astype(jnp.float32), z)
        return lg, vjp(c)[0]

    lj, gj = f(jnp.asarray(np.moveaxis(x, 1, -1)),
               jnp.asarray(np.moveaxis(ct, 1, -1)))
    lj, gj = (np.moveaxis(np.asarray(a), -1, 1) for a in (lj, gj))

    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-" + VARIANT,
                    K)
    m.load_state_dict(upernet_state_dict_from_jax(*jax_vars, VARIANT),
                      strict=True)
    bundle = ModelBundle(m, "bf16")
    assert all(t.dtype == BF16 for t in m.state_dict().values()
               if t.is_floating_point())
    xt = torch.tensor(x, requires_grad=True)
    lt = bundle.logits_fn(xt)
    assert lt.dtype == torch.float32
    (lt * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(lt.detach().numpy(), lj, atol=5e-2,
                               rtol=5e-2)
    g = xt.grad.numpy()
    assert xt.grad.dtype == torch.float32
    err = np.abs(g - gj).max() / np.abs(gj).max()
    cos = float((g * gj).sum() / np.linalg.norm(g) / np.linalg.norm(gj))
    print(f"bf16 model: logits max abs error "
          f"{np.abs(lt.detach().numpy() - lj).max():.3e} (largest logit "
          f"{np.abs(lj).max():.3f}), input gradient {err:.3f} of its "
          f"largest entry, cosine {cos:.4f}")
    assert err < 0.15, (err, cos)


def test_tail_mode_dtype_trail_matches_jax(jax_vars):
    """Under bf16, in ``recompute_bf16`` mode: each block's output, each
    stage norm's and the head's output have JAX's dtype."""
    mode = "recompute_bf16"
    jm = JUN(backbone_variant=VARIANT, num_classes=K, fused_mlp=True,
             fused_mlp_mode=mode)
    v16 = _to_bf16({"params": jax_vars[0], "batch_stats": jax_vars[1]})
    _, state = jax.eval_shape(
        lambda z: jm.apply(v16, z, capture_intermediates=True,
                           mutable=["intermediates"]),
        jax.ShapeDtypeStruct((1, HW, HW, 3), jnp.bfloat16))
    inter = state["intermediates"]
    want = {}
    for i, depth in enumerate((3, 3, 9, 3)):
        for j in range(depth):
            want[f"stage{i}.{j}"] = inter["backbone"][
                f"stage{i}_block{j}"]["__call__"][0].dtype
        want[f"norm{i}"] = inter["backbone"][f"norm{i}"]["__call__"][0].dtype
    want["decode_head"] = inter["decode_head"]["__call__"][0].dtype

    m = UperNetForSemanticSegmentation(VARIANT, K, fused_mlp_mode=mode,
                                       fused_head=False)
    m.load_state_dict(upernet_state_dict_from_jax(*jax_vars, VARIANT),
                      strict=True)
    bundle = ModelBundle(m, "bf16")
    got = {}
    mods = {f"stage{i}.{j}": blk for i, st in enumerate(m.backbone.stages)
            for j, blk in enumerate(st)}
    mods.update({f"norm{i}": getattr(m.backbone, f"norm{i}")
                 for i in range(4)})
    mods["decode_head"] = m.decode_head
    for name, mod in mods.items():
        mod.register_forward_hook(
            lambda _m, _i, out, name=name: got.__setitem__(name, out.dtype))
    with torch.no_grad():
        bundle.logits_fn(torch.rand(1, 3, HW, HW))
    assert {k: str(v).removeprefix("torch.") for k, v in got.items()} == {
        k: str(v) for k, v in want.items()}
    # the trail itself: bf16 into the first block, float32 from its output
    assert got["stage0.0"] == torch.float32
    assert got["decode_head"] == torch.float32
