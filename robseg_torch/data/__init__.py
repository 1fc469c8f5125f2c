"""PASCAL-VOC and ADE20K val data for the SEA CLI (numpy and PIL)."""

from robseg_torch.data.datasets import (  # noqa: F401
    ADE20KSegmentation, VOCSegmentation, get_segmentation_dataset)
from robseg_torch.data.sampler import simple_eval_loader  # noqa: F401
from robseg_torch.data.transforms import (  # noqa: F401
    to_float_chw_last, val_sync_transform)
