"""robseg_torch imports no JAX, and its copied constants equal the JAX
package's."""

import subprocess
import sys

import numpy as np


def test_port_imports_no_jax():
    """Every module of the package, found by walking it (the train slice's
    too: the trainer, its CLI, PGD, checkpoints, PIR init, prefetch; and
    the worst-case engines, the filter attack, multi-scale inference and
    the on-device augmentation; the bf16 products, the contrastive losses,
    seeds, palettes, profiling and FLOPs), imports without pulling in JAX
    or robseg_tpu."""
    code = ("import importlib, pkgutil, sys\n"
            "import robseg_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    robseg_torch.__path__, 'robseg_torch.')]\n"
            "for m in names:\n"
            "    importlib.import_module(m)\n"
            "for want in ('robseg_torch.infer', 'robseg_torch.attacks.pgd',\n"
            "             'robseg_torch.train.trainer',\n"
            "             'robseg_torch.train.__main__',\n"
            "             'robseg_torch.train.checkpoint',\n"
            "             'robseg_torch.convert.pir',\n"
            "             'robseg_torch.data.prefetch',\n"
            "             'robseg_torch.attacks.worst_case',\n"
            "             'robseg_torch.attacks.filters',\n"
            "             'robseg_torch.utils.sliding_window',\n"
            "             'robseg_torch.data.device_transforms',\n"
            "             'robseg_torch.ops.precision',\n"
            "             'robseg_torch.ops.contrastive',\n"
            "             'robseg_torch.utils.misc',\n"
            "             'robseg_torch.utils.visualize',\n"
            "             'robseg_torch.utils.profiling',\n"
            "             'robseg_torch.utils.flops'):\n"
            "    assert want in names, (want, names)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'flax', 'optax',\n"
            "                                    'robseg_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_convnext_settings_match():
    from robseg_tpu.models.convnext import CONVNEXT_SETTINGS as ref
    from robseg_torch.models.convnext import CONVNEXT_SETTINGS
    assert CONVNEXT_SETTINGS == ref


def test_class_weights_match():
    from robseg_tpu.utils import class_weights as ref
    from robseg_torch.utils import class_weights as port
    for name in ("VOC_WTS", "ADE_WTS"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for ds in ("pascalvoc", "ade20k", "pascalaug"):
        assert np.array_equal(port.class_balance_weights(ds),
                              ref.class_balance_weights(ds))


def test_eval_geometry_and_names_match():
    from robseg_tpu import config as ref
    from robseg_torch import config as port
    for ds in ("pascalvoc", "pascalaug", "ade20k", "PascalVOC"):
        assert port.dataset_eval_geometry(ds) == ref.dataset_eval_geometry(ds)
    for name, bb in (("UperNetForSemanticSegmentation", "ConvNeXt-T_CVST"),
                     ("SegMenter", "vit_small_patch16_384"),
                     ("PSPNet", "")):
        assert port.model_display_name(name, bb) == \
            ref.model_display_name(name, bb)


def test_sea_losses_match():
    from robseg_tpu.attacks.sea import SEA_LOSSES as ref
    from robseg_torch.attacks.sea import SEA_LOSSES
    from robseg_torch.ops.losses import ATTACK_CRITERIA
    assert SEA_LOSSES == ref
    assert set(SEA_LOSSES) <= set(ATTACK_CRITERIA)


def test_device_key(tmp_path):
    import pytest
    import torch
    from robseg_torch.config import resolve_device
    assert resolve_device({"DEVICE": "cpu"}) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device({"DEVICE": "npu"})
    for name in ("tpu", "gpu", "cuda"):
        if torch.cuda.is_available():
            assert resolve_device({"DEVICE": name}).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no"):
                resolve_device({"DEVICE": name})


def test_segmenter_variants_match():
    from robseg_tpu.models import SEGMENTER_VARIANTS as ref
    from robseg_torch.models import SEGMENTER_VARIANTS
    assert SEGMENTER_VARIANTS == ref


def test_attack_and_ops_exports_match_jax():
    """``robseg_torch.attacks`` and ``robseg_torch.ops`` export every
    public name of their JAX counterparts (``apgd_restarts``,
    ``run_attack_over_loader``, ``pgd_filters``, ``iou_acc_summary``,
    ...)."""
    import robseg_torch.attacks as tattacks
    import robseg_torch.ops as tops
    import robseg_tpu.attacks as jattacks
    import robseg_tpu.ops as jops
    for port, ref in ((tattacks, jattacks), (tops, jops)):
        names = {n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), type(np))}
        missing = sorted(n for n in names if not hasattr(port, n))
        assert not missing, missing


def test_utils_exports_match_jax():
    """``robseg_torch.utils`` exports every public name of
    ``robseg_tpu.utils`` (``fix_seeds``, ``model_param_count``, ...)."""
    import robseg_torch.utils as tutils
    import robseg_tpu.utils as jutils
    names = {n for n in dir(jutils) if not n.startswith("_")
             and not isinstance(getattr(jutils, n), type(np))}
    assert names and not sorted(n for n in names if not hasattr(tutils, n))
