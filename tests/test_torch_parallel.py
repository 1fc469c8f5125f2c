"""Data parallelism of the port (``robseg_torch/parallel``) against the
one-process run and the JAX package's mesh, on the CPU: worlds of 2 ranks
over gloo, each rank a process started by ``parallel.spawn_world`` (a
``file://`` rendezvous in a temporary directory, so no port is picked;
every world ends within its deadline of at most 120 s or is killed).

The rank functions below run in those processes, which import this
module: it imports no JAX at its top (the JAX side imports it inside the
tests and fixtures), so the ranks import none. The module fixture
``world`` starts three worlds one after another on a thread, each with
its own deadline: the train steps, the SEA runs, then the helpers and the
two CLIs. They run while this process computes the references (JAX's
compiles, the one-process runs), and each test reads its world's result.

  * the sampler's index sets equal JAX's ``ShardedEpochSampler`` for
    (4 shards, 2 hosts, host 0 and 1), and so do the loader's batches;
  * SEA: ``run_attack_over_loader`` and ``run_sea`` on 2 ranks, UperNet
    cut small (tests/test_torch_train_models.py's ``narrow_upernet``) in
    float64, a batch of 3 (padded to 4, one padded row on rank 1) then
    one of 2: every adversarial image equal to the one-process run's
    (atol 1e-6, tests/test_sea.py:212-255's bound for JAX's mesh), the
    whole result within 1e-6; ``run_sea`` on the tiny einsum model of
    tests/test_torch_sea.py in float64 against JAX's ``run_sea`` on
    ``make_data_mesh(2)``, every number within 1e-6 (that file's bound);
  * training: two data-parallel steps of ``PSPNet(classes=5,
    dropout=0.0)`` (one bottleneck a stage) in float64, 2 images a rank,
    PGD-2 on, against JAX's ``make_train_step`` on ``make_data_mesh(2)``
    with tests/test_torch_train_step.py's bounds: losses rel 1e-5,
    parameters and BatchNorm statistics within 1e-5 absolute; the eval
    step's confusion matrix (float32 weights) exactly;
  * the train CLI with ``DEVICE: cpu`` on 2 ranks, 2 iterations then
    ``--resume`` to 3: only rank 0 prints, writes and reads the run's
    files (rank 1 resumes from what rank 0 sends);
  * a world in which one rank raises, or one that outlives its deadline,
    raises in the parent within its limit and leaves no rank running.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch
import yaml

from robseg_torch import parallel
from robseg_torch.parallel import spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_SEA, HW_SEA = 4, 64
K_PSP, HW_PSP, B_PSP = 5, (17, 17), 4
C_TINY, HW_TINY = 4, 8


def _threads():
    """Two intra-op threads a rank: the test workers share the host."""
    torch.set_num_threads(2)


def _narrow_upernet_here(mp=None):
    """``narrow_upernet`` on the port alone: through ``mp`` (a pytest
    ``MonkeyPatch``) here, for good in a rank's process."""
    from robseg_torch.models import convnext, upernet
    mp = mp or pytest.MonkeyPatch()
    mp.setitem(convnext.CONVNEXT_SETTINGS, "T_CVST",
               [[1, 1, 1, 1], [96, 32, 64, 128], 64, 0.0])
    for head in ("UperNetHead", "UperNetFCNHead"):
        mp.setattr(upernet, head, functools.partial(getattr(upernet, head),
                                                    channels=32))


def _upernet(state):
    from robseg_torch.models import build_model
    m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST",
                    K_SEA)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return m.double().eval().requires_grad_(False)


def _sea_data():
    rng = np.random.default_rng(0)
    batches = []
    for bs in (3, 2):
        x = rng.random((bs, 3, HW_SEA, HW_SEA))
        y = rng.integers(0, K_SEA, (bs, HW_SEA, HW_SEA))
        y[0, :8, :8] = -1
        batches.append((x, y))
    return batches


def _tiny_data():
    rng = np.random.default_rng(1)
    wk = rng.normal(size=(3, C_TINY)) * 2.0
    batches = []
    for _ in range(2):
        x = rng.random((3, HW_TINY, HW_TINY, 3))
        y = rng.integers(0, C_TINY, (3, HW_TINY, HW_TINY))
        y[0, :2, :2] = -1
        batches.append((x, y))
    return wk, batches, (rng.random(C_TINY) + 0.5).astype(np.float32)


SEA_KW = dict(num_classes=K_SEA, eps=8 / 255, n_iter=5, seed=3,
              wc_engine="python")
TINY_KW = dict(num_classes=C_TINY, eps=8 / 255, n_iter=10, seed=1,
               use_rs=False, wc_engine="python")


def _sea_runs(group, state):
    """The port's SEA functions under ``group`` (None: one process)."""
    from robseg_torch.attacks.sea import run_attack_over_loader, run_sea
    fn = _upernet(state)
    data = _sea_data()
    advs = run_attack_over_loader(
        fn, iter(data), loss="mask-ce-avg", eps=8 / 255, n_iter=4,
        weights=np.ones(K_SEA, np.float32), seed=3, group=group)
    sea = run_sea(fn, lambda: iter(data), group=group, **SEA_KW)
    wk, tiny, w = _tiny_data()
    wt = torch.tensor(wk)
    tiny_sea = run_sea(
        lambda x: torch.einsum("bchw,cd->bdhw", x, wt),
        lambda: iter([(np.ascontiguousarray(x.transpose(0, 3, 1, 2)), y)
                      for x, y in tiny]), weights=w, group=group, **TINY_KW)
    return [a for a, _ in advs], sea, tiny_sea


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


def _one_after_another(jobs):
    """Each of ``jobs`` (callables) in turn on a thread, while this
    process goes on; a future for each."""
    import concurrent.futures
    import threading
    futures = [concurrent.futures.Future() for _ in jobs]

    def run():
        for fut, job in zip(futures, jobs):
            try:
                fut.set_result(job())
            except BaseException as e:  # noqa: BLE001 - read by the test
                fut.set_exception(e)
    threading.Thread(target=run, daemon=True).start()
    return futures


# ----------------------------------------------------------------- sampler

@pytest.mark.parametrize("host", [0, 1])
def test_sampler_rank_indices_match_jax(host):
    from robseg_tpu.data.sampler import ShardedEpochSampler as JSampler
    from robseg_torch.data import ShardedEpochSampler
    for n, bps in ((23, 2), (40, 3)):
        kw = dict(seed=5, num_hosts=2, host_id=host)
        j, t = JSampler(n, 4, **kw), ShardedEpochSampler(n, 4, **kw)
        assert list(t.local_shards) == list(j.local_shards)
        for epoch in range(3):
            got = list(t.global_batch_indices(epoch, bps))
            want = list(j.global_batch_indices(epoch, bps))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert np.array_equal(g, w)


def test_loader_rank_batches_match_jax():
    from robseg_tpu.data import sampler as jsampler
    from robseg_torch.data import IterationBasedLoader, SyntheticSegmentation
    ds = SyntheticSegmentation(num_classes=5, length=11, image_hw=(20, 24),
                               crop_size=16)
    for host in (0, 1):
        t = IterationBasedLoader(ds, batch_size=2, max_iters=5, seed=3,
                                 start_iter=1, num_shards=4, num_hosts=2,
                                 host_id=host)
        j = jsampler.IterationBasedLoader(
            ds, num_shards=4, batch_per_shard=2, max_iters=5, seed=3,
            start_iter=1, num_hosts=2, host_id=host)
        got, want = list(t), list(j)
        assert len(got) == len(want) == 4
        for (ti, tm), (ji, jm) in zip(got, want):
            assert ti.shape[0] == 4  # 2 shards of 2 on this host
            assert np.array_equal(ti, np.moveaxis(ji, -1, 1))
            assert np.array_equal(tm, jm)


def test_one_process_helpers(monkeypatch):
    """Without torchrun's environment there is no group and every helper
    is the identity."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.setup("cpu") is None
    x = torch.arange(6.0)
    assert parallel.shard_batch(x, None) is x
    parallel.all_mean_([x], None)
    assert torch.equal(x, torch.arange(6.0))
    assert parallel.gather_rows(x.numpy(), None) is not None
    assert parallel.is_main(None) and parallel.world_size(None) == 1
    assert parallel.host_local_shard_count(None) == 1
    assert parallel.fold_seed(0, 1, 2) == parallel.fold_seed(0, 1, 2)
    assert parallel.fold_seed(0, 1, 2) != parallel.fold_seed(0, 1, 3)


def _helpers_rank(group):
    r = group.rank
    x = torch.arange(8.0).reshape(4, 2)
    shard = parallel.shard_batch(x, group)
    m = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(m.weight, float(r))
    parallel.replicate(m, group)
    vals = [torch.full((2,), float(r + 1)), torch.full((3,), 2.0 * r,
                                                       dtype=torch.float64)]
    parallel.all_mean_(vals, group)
    total = torch.tensor([r + 1])
    parallel.all_sum_([total], group)
    rows = parallel.gather_rows((np.full((r + 1, 2), r),
                                 np.arange(r + 1)), group)
    return (shard.numpy(), float(m.weight.detach().sum()), vals[0].numpy(),
            vals[1].numpy(), int(total), rows,
            parallel.broadcast_object(f"from {r}", group),
            parallel.host_local_shard_count(group), group.backend)


# ---------------------------------------------------------------- training

def _psp_patch():
    from robseg_torch.models import pspnet as tpsp
    tpsp.ResNetStages = functools.partial(tpsp.ResNetStages,
                                          layers=(1, 1, 1, 1))


def _psp_inputs():
    rng = np.random.default_rng(0)
    x = rng.random((B_PSP,) + HW_PSP + (3,)).astype(np.float32)
    y = rng.integers(0, K_PSP, (B_PSP,) + HW_PSP)
    return x, y


def _train_runs(group, sd):
    """Eval step (float32), then two train steps (float64) of PSPNet on
    this rank's shard."""
    from robseg_torch.models import PSPNet
    from robseg_torch.train import (AttackConfig, Trainer, make_optimizer,
                                    pspnet_lr_scales)
    from robseg_torch.train.schedules import poly_lr
    x, y = _psp_inputs()
    xt = parallel.shard_batch(torch.tensor(np.moveaxis(x, -1, 1)), group)
    yt = parallel.shard_batch(torch.tensor(y), group)
    m = PSPNet(classes=K_PSP, dropout=0.0)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    ev = Trainer(m, "PSPNet", make_optimizer("sgd", m, poly_lr(1e-2, 10)),
                 AttackConfig(enabled=False), group=group)
    hist = ev.eval_step(xt, yt, torch.zeros(K_PSP, K_PSP)).numpy()
    m.double()
    opt = make_optimizer("sgd", m, poly_lr(1e-2, 10), weight_decay=1e-4,
                         lr_scales=pspnet_lr_scales(m))
    trainer = Trainer(m, "PSPNet", opt, AttackConfig(eps=4 / 255,
                                                     n_iters=2),
                      generator=torch.Generator().manual_seed(0),
                      group=group)
    losses = [float(trainer.train_step(xt.double(), yt)) for _ in range(2)]
    return hist, losses, {k: v.numpy() for k, v in m.state_dict().items()}


def _fake_voc(root, n_train, n_val, hw=(60, 80)):
    from PIL import Image
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    for d in ("JPEGImages", "SegmentationClass",
              os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(n_train + n_val)]
    for name in names:
        Image.fromarray((rng.random(hw + (3,)) * 255).astype(np.uint8)).save(
            os.path.join(base, "JPEGImages", name + ".jpg"))
        m = rng.integers(0, 21, hw).astype(np.uint8)
        m[0, :4] = 255
        Image.fromarray(m).save(
            os.path.join(base, "SegmentationClass", name + ".png"))
    seg = os.path.join(base, "ImageSets", "Segmentation")
    with open(os.path.join(seg, "train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(os.path.join(seg, "val.txt"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")
    return root


def _cli_argvs(tmp):
    """The train CLI on a 4 + 3 image VOC fixture, ``DEVICE: cpu``, 64^2
    crops, a global batch of 4 (2 a rank), PGD-1 through the twin: 2
    iterations, then ``--resume`` to 3."""
    with open(os.path.join(REPO, "configs", "pascalvoc_convnext.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DEVICE"] = "cpu"
    cfg["SAVE_DIR"] = os.path.join(tmp, "out")
    cfg["DATASET"].update(NAME="pascalvoc",
                          ROOT=_fake_voc(os.path.join(tmp, "voc"), 4, 3))
    cfg["TRAIN"].update(BASE_SIZE=64, IMAGE_SIZE=[64, 64], BATCH_SIZE=4,
                        N_ITERS=1, EVAL_FREQ=1, EVAL_BATCHES=1)
    cfg["EVAL"].update(IMAGE_SIZE=[64, 64], BASE_SIZE=64)
    path = os.path.join(tmp, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run = os.path.join(tmp, "run")
    first = ["--cfg", path, "--max_iters", "2", "--fused_attack",
             "--run_dir", run]
    return run, [first, first[:3] + ["3", "--resume", "--run_dir", run,
                                     "--fused_attack"]]


def _refuse(*args, **kw):
    raise AssertionError("a rank other than 0 read a file of the run")


def _cli_runs(group, argvs):
    """The train CLI's ``main`` for each argv on this rank; its standard
    output. Rank 1 may not read a checkpoint, the last step or the best
    weights: every decision the CLI takes from a file is rank 0's, so
    ranks on machines without a shared disk agree."""
    import contextlib
    import io
    from robseg_torch.train import __main__ as cli
    from robseg_torch.train.checkpoint import CheckpointManager
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as mp:
        if group.rank:
            for name in ("restore", "latest_step"):
                mp.setattr(CheckpointManager, name, _refuse)
            load = torch.load  # unpickling a broadcast tensor calls it

            def load_no_file(f, *args, **kw):
                if isinstance(f, (str, os.PathLike)):
                    _refuse()
                return load(f, *args, **kw)
            mp.setattr(torch, "load", load_no_file)
        for argv in argvs:
            cli.main(argv)
            parallel.barrier(group)
    return out.getvalue()


def _sea_cli_argv(tmp):
    """The SEA CLI on a 3-image VOC fixture (one batch of 3), ``DEVICE:
    cpu``, 2 APGD iterations a loss, its eval crop cut to 64^2."""
    with open(os.path.join(REPO, "configs", "rig_voc_demo.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["DEVICE"] = "cpu"
    cfg["DATASET"]["ROOT"] = _fake_voc(os.path.join(tmp, "voc_val"), 0, 3)
    cfg["SAVE_DIR"] = os.path.join(tmp, "sea_out")
    cfg["EVAL"]["BATCH_SIZE"] = 3
    path = os.path.join(tmp, "sea_cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return ["--cfg", path, "--n_iter", "2", "--n_batches", "1",
            "--wc_engine", "python"]


def _sea_cli(argv, mp=None):
    """The SEA CLI's ``main`` on ``argv`` with the eval crop at 64^2;
    its standard output."""
    import contextlib
    import io
    from robseg_torch import infer
    (mp or pytest.MonkeyPatch()).setattr(
        infer, "dataset_eval_geometry", lambda name: (64, (64, 64)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(argv)
    return out.getvalue()


WORLDS = ("train", "sea", "cli")


def _world_rank(group, part, states, cli_argvs, sea_argv):
    """The module's world ``part`` (one of ``WORLDS``) on this rank; the
    weights from the ``.npz`` files ``states`` names (faster than
    pickling them into each process)."""
    _threads()
    _narrow_upernet_here()
    _psp_patch()
    if part == "train":
        return _train_runs(group, dict(np.load(states[1])))
    if part == "sea":
        return _sea_runs(group, dict(np.load(states[0])))
    return {"helpers": _helpers_rank(group),
            "cli": _cli_runs(group, cli_argvs),
            "sea_cli": _sea_cli(sea_argv + ["--shard"])}


class _World:
    """The worlds' futures and the inputs they were given."""

    def __init__(self, futures, upernet, psp, jax_psp, run, sea_argv):
        self.futures, self.upernet, self.psp = futures, upernet, psp
        self.jax_psp, self.run, self.sea_argv = jax_psp, run, sea_argv

    def result(self, part):
        """World ``part``'s results, in rank order."""
        return self.futures[part].result()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's worlds of 2 ranks, started in the background: UperNet
    cut small with seeded weights (SEA), PSPNet with one bottleneck a
    stage and JAX's ``_init`` weights (train steps), the CLI's fixture."""
    import jax.numpy as jnp
    from robseg_tpu.models import pspnet as jpsp
    from robseg_torch.convert import pspnet_state_dict_from_jax
    from robseg_torch.models import build_model
    from test_torch_train_models import _init

    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    with pytest.MonkeyPatch.context() as narrow:
        _narrow_upernet_here(narrow)
        torch.manual_seed(0)
        m = build_model("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST",
                        K_SEA)
    upernet = {k: v.numpy() for k, v in m.state_dict().items()}
    # JAX's PSPNet builds its stages when applied: patched for the module
    mp.setattr(jpsp, "ResNetStages", functools.partial(
        jpsp.ResNetStages, layers=(1, 1, 1, 1)))
    jm = jpsp.PSPNet(classes=K_PSP, dropout=0.0)
    params, stats = _init(jm, HW_PSP,
                          labels=jnp.zeros((1,) + HW_PSP, jnp.int32))
    psp = {k: v.numpy() for k, v in pspnet_state_dict_from_jax(
        params, stats, True).items()}
    tmp = str(tmp_path_factory.mktemp("world"))
    states = [os.path.join(tmp, f"{name}.npz") for name in ("upernet", "psp")]
    for path, sd in zip(states, (upernet, psp)):
        np.savez(path, **sd)
    run, argvs = _cli_argvs(tmp)
    sea_argv = _sea_cli_argv(tmp)
    futures = _one_after_another([functools.partial(
        spawn_world, _world_rank, 2, (part, states, argvs, sea_argv),
        timeout_s=120) for part in WORLDS])
    yield _World(dict(zip(WORLDS, futures)), upernet, psp,
                 (jm, params, stats), run, sea_argv)
    for fut in futures:  # no rank outlives the module
        fut.exception()
    mp.undo()
    torch.set_num_threads(n_threads)


def test_data_parallel_train_steps_match_jax_mesh(world, monkeypatch):
    import jax
    import jax.numpy as jnp
    from robseg_tpu.attacks import pgd as jpgd
    from robseg_tpu.parallel import make_data_mesh, replicate, shard_batch
    from robseg_tpu.train import (AttackConfig as JAttack, TrainState,
                                  make_eval_step, make_optimizer as j_opt,
                                  make_train_step)
    from robseg_tpu.train.optim import pspnet_lr_scales as j_scales
    from robseg_tpu.train.schedules import poly_lr as j_poly
    from robseg_torch.convert import pspnet_state_dict_from_jax
    from test_torch_train_step import _Float64Zeros

    jm, params, stats = world.jax_psp
    x, y = _psp_inputs()
    mesh = make_data_mesh(2)
    bx, by = shard_batch(mesh, (x, y.astype(np.int32)))
    want_hist = np.asarray(make_eval_step(jm, K_PSP, mesh)(
        replicate(mesh, params), replicate(mesh, stats), bx, by,
        replicate(mesh, jnp.zeros((K_PSP, K_PSP)))))
    monkeypatch.setattr(jpgd, "jnp", _Float64Zeros())
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), t)
        p64, s64 = f64(params), f64(stats)
        tx = j_opt("sgd", p64, j_poly(1e-2, 10), weight_decay=1e-4,
                   lr_scales=j_scales(p64))
        state = replicate(mesh, TrainState(
            step=jnp.asarray(0), params=p64, batch_stats=s64,
            opt_state=tx.init(p64), rng=jax.random.PRNGKey(1)))
        step = make_train_step(jm, "PSPNet", tx, mesh,
                               JAttack(eps=4 / 255, n_iters=2))
        bx, by = shard_batch(mesh, (x.astype(np.float64),
                                    y.astype(np.int32)))
        want_losses = []
        for _ in range(2):
            state, metrics = step(state, bx, by)
            want_losses.append(float(metrics["loss"]))
        state = jax.device_get(state)
    finally:
        jax.config.update("jax_enable_x64", False)
    want = pspnet_state_dict_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), True)

    ranks = world.result("train")
    assert want_hist.sum() == B_PSP * HW_PSP[0] * HW_PSP[1]
    moved = 0.0
    for hist, losses, got in ranks:
        assert np.array_equal(hist, want_hist)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, v in got.items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == 2, k
                continue
            np.testing.assert_allclose(v, want[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
            moved = max(moved, float(np.abs(v - world.psp[k]).max()))
    assert moved > 1e-3
    # the replicas are identical, bit for bit
    for k in ranks[0][2]:
        assert np.array_equal(ranks[0][2][k], ranks[1][2][k]), k


# --------------------------------------------------------------------- SEA

def test_sharded_sea_matches_one_process_and_jax(world):
    import jax
    import jax.numpy as jnp
    from robseg_tpu.attacks.sea import run_sea as j_run_sea
    from robseg_tpu.parallel import make_data_mesh

    wk, tiny, w = _tiny_data()
    jax.config.update("jax_enable_x64", True)
    try:
        want_tiny = j_run_sea(
            lambda x: jnp.einsum("bhwc,cd->bhwd", x, jnp.asarray(wk)),
            lambda: iter([(x, y.astype(np.int32)) for x, y in tiny]),
            weights=w, mesh=make_data_mesh(2), **TINY_KW)
    finally:
        jax.config.update("jax_enable_x64", False)
    with pytest.MonkeyPatch.context() as mp:
        _narrow_upernet_here(mp)
        one_advs, one_sea, one_tiny = _sea_runs(None, world.upernet)
    _close(one_tiny, want_tiny)

    for advs, sea, tiny_sea in world.result("sea"):
        assert [a.shape[0] for a in advs] == [3, 2]  # padding sliced off
        for got, want in zip(advs, one_advs):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert abs(sea["final_miou"] - one_sea["final_miou"]) < 1e-6
        assert abs(sea["worst_Acc"] - one_sea["worst_Acc"]) < 1e-6
        _close(sea, one_sea)
        for key in ("clean", "worst_Acc", "worst_Acc_indiv",
                    "loss-wise_stats", "loss-wise_miou", "final_miou"):
            _close(tiny_sea[key], want_tiny[key])
    # the attack moved the images: the check is not of clean copies
    assert max(float(np.abs(a - x).max())
               for a, (x, _) in zip(one_advs, _sea_data())) > 1e-3


# --------------------------------------------------------------- train CLI

def test_train_cli_on_two_ranks(world):
    out0, out1 = (rank["cli"] for rank in world.result("cli"))
    run = world.run
    assert out1 == ""  # rank 1 prints nothing
    assert "data-parallel: 2 ranks (gloo), 2 images a rank" in out0
    assert out0.count("Loss: ") == 3 and "Resumed from step 2" in out0
    assert "Restored best-so-far" in out0 and "full mIoU" in out0
    with open(os.path.join(run, "train_log")) as f:
        assert f.read().count("Loss: ") == 3  # one writer
    # an epoch is one iteration (4 images at 4 a step): a checkpoint each
    assert sorted(os.listdir(os.path.join(run, "ckpts"))) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]
    for name in ("final_model.pth", "best.json"):
        assert os.path.exists(os.path.join(run, name)), name
    launches = [ln for ln in out0.splitlines()
                if ln.startswith("kernel launches by rank: ")]
    assert len(launches) == 2  # CPU tensors launch no kernel
    assert "kernel launches: {" in out0


def test_sea_cli_shard_on_two_ranks(world, tmp_path):
    """``python -m robseg_torch.infer --shard`` on 2 ranks against the
    one-process CLI on the same fixture (UperNet cut small, seeded by the
    CLI): the same JSON; rank 0 alone prints and writes."""
    import json
    out0, out1 = (rank["sea_cli"] for rank in world.result("cli"))
    assert out1 == ""
    argv = list(world.sea_argv)
    cfg_path = argv[1]
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    sharded_dir = cfg["SAVE_DIR"]
    cfg["SAVE_DIR"] = str(tmp_path / "one")
    argv[1] = str(tmp_path / "one.yaml")
    with open(argv[1], "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.MonkeyPatch.context() as mp:
        _narrow_upernet_here(mp)
        one = _sea_cli(argv, mp)

    def result(d):
        names = [n for n in os.listdir(d) if n.startswith("worse_SEA_")]
        assert len(names) == 1
        with open(os.path.join(d, names[0])) as f:
            return json.load(f)
    _close(result(sharded_dir), result(cfg["SAVE_DIR"]))
    for out in (out0, one):
        assert out.count("max Linf pert: ") == 3
    assert "kernel launches by rank: " in out0
    with open(os.path.join(sharded_dir, "sea_eval_log.txt")) as f:
        assert f.read().count("SEA statistics at: ") == 1  # one writer


def test_helpers_in_a_world(world):
    for r, (shard, wsum, v0, v1, total, rows, b, local, be) in enumerate(
            rank["helpers"] for rank in world.result("cli")):
        assert np.array_equal(shard, np.arange(8.0).reshape(4, 2)[2 * r:
                                                                  2 * r + 2])
        assert wsum == 0.0  # rank 0's weights everywhere
        assert np.array_equal(v0, [1.5, 1.5]) and np.array_equal(
            v1, [1.0] * 3) and v1.dtype == np.float64
        assert total == 3 and b == "from 0" and local == 2
        assert be == "gloo"
        assert np.array_equal(rows[0], [[0, 0], [1, 1], [1, 1]])
        assert np.array_equal(rows[1], [0, 0, 1])


# -------------------------------------------------------- failing worlds

def _failing_rank(group, how):
    if group.rank == 1:
        if how == "raises":
            raise ValueError("rank one fails")
        time.sleep(300)
    t = torch.ones(1)
    torch.distributed.all_reduce(t)  # rank 0 waits for rank 1 here
    return float(t)


@pytest.mark.parametrize("how,error,limit", [
    ("raises", RuntimeError, 60.0), ("hangs", TimeoutError, 8.0)])
def test_failing_world_ends(how, error, limit):
    """A rank that raises ends the world at once, with its traceback; a
    rank that hangs ends it at the deadline. No rank is left running."""
    import multiprocessing
    t0 = time.monotonic()
    with pytest.raises(error) as info:
        spawn_world(_failing_rank, 2, (how,), timeout_s=limit)
    assert time.monotonic() - t0 < limit + 25.0
    if how == "raises":
        assert "rank 1 raised" in str(info.value)
        assert "rank one fails" in str(info.value)
    assert not multiprocessing.active_children()
