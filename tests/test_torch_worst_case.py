"""robseg_torch.attacks.worst_case against robseg_tpu.attacks.worst_case.

Every engine of the port against the same engine of the JAX package on
seeded ``(A, N, K)`` intersections and unions with absent classes (which
the reference engines' class-list shrink reads): the same selection and
the same ``final_miou``, equal as float64 (no tolerance). The port's
default engine against the JAX package's ``auto``, which is its C++
engine: on these inputs the Python engine selects otherwise, so this
fails for a port whose default is ``python``. The C++ source is the JAX
package's file, byte for byte. A failed ``g++`` build raises an error
that names ``--wc_engine python`` (no silent fallback). The per-image
aggregation inputs (``sea_intersect_union``, ``worst_case_aacc``) equal
the JAX package's.
"""

import inspect
import os

import numpy as np
import pytest
import jax  # noqa: F401  (pinned to the CPU by conftest)

from robseg_tpu.attacks import worst_case as jwc
from robseg_torch.attacks import sea, worst_case as twc
from robseg_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((3, 40, 21), (3, 20, 151))


def _instance(shape, seed=0, absent=3):
    rng = np.random.default_rng(seed)
    k = shape[-1]
    ints = rng.integers(0, 50, shape).astype(np.float64)
    unis = ints + rng.integers(0, 80, shape).astype(np.float64)
    drop = rng.choice(k, absent, replace=False)
    ints[:, :, drop] = 0
    unis[:, :, drop] = 0
    return ints, unis


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("engine", twc.ENGINES)
def test_engine_matches_jax(shape, engine):
    ints, unis = _instance(shape)
    want = jwc.worst_case_miou(ints, unis, engine=engine,
                               return_selection=True)
    got = twc.worst_case_miou(ints, unis, engine=engine,
                              return_selection=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0] == want[0]
    assert isinstance(got[0], float)


@pytest.mark.parametrize("shape", SHAPES)
def test_default_engine_is_jax_auto(shape):
    """The default selects what the JAX CLI's default (``auto``, the C++
    engine) selects; the Python engine takes another trajectory here."""
    ints, unis = _instance(shape)
    want = jwc.worst_case_miou(ints, unis, engine="auto",
                               return_selection=True)
    got = twc.worst_case_miou(ints, unis, return_selection=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0] == want[0]
    py = twc.worst_case_miou(ints, unis, engine="python",
                             return_selection=True)
    assert not np.array_equal(py[1], want[1])
    # the SEA entry points default to the same engine
    assert inspect.signature(sea.run_sea).parameters[
        "wc_engine"].default == "auto"
    from robseg_torch import infer
    assert infer.parse_args(["--cfg", "x.yaml"]).wc_engine == "auto"


def test_native_source_is_the_jax_packages():
    with open(os.path.join(REPO, "robseg_tpu/native/worst_case.cpp"),
              "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "robseg_torch/native/worst_case.cpp"),
              "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("engine", ("auto", "native", "reference"))
def test_failed_build_raises(engine, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CXX", "false")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_native", {})
    ints, unis = _instance(SHAPES[0])
    with pytest.raises(RuntimeError, match="--wc_engine python"):
        twc.worst_case_miou(ints, unis, engine=engine)
    # the Python engines need no build
    assert twc.worst_case_miou(ints, unis, engine="python") == \
        jwc.worst_case_miou(ints, unis, engine="python")


def test_unknown_engine_raises():
    ints, unis = _instance(SHAPES[0])
    with pytest.raises(ValueError, match="unknown worst-case engine"):
        twc.worst_case_miou(ints, unis, engine="fast")


def test_aggregation_inputs_match_jax(rng):
    n, hw, k = 5, 9, 6
    targets = rng.integers(0, k, (n, hw, hw)).astype(np.int32)
    targets[0, :2] = -1
    preds = [np.where(rng.random((n, hw, hw)) < 0.5, targets,
                      rng.integers(0, k, (n, hw, hw))).astype(np.int32)
             for _ in range(3)]
    preds = [np.where(targets == -1, -1, p) for p in preds]
    want = jwc.sea_intersect_union(preds, targets, num_classes=k, batch=2)
    got = twc.sea_intersect_union(preds, targets, num_classes=k, batch=2)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    wa, wper = jwc.worst_case_aacc(preds, targets)
    ga, gper = twc.worst_case_aacc(preds, targets)
    assert abs(ga - wa) <= 1e-7
    np.testing.assert_allclose(gper, wper, rtol=0, atol=1e-7)
