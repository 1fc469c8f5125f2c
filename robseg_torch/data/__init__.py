"""PASCAL-VOC, VOC-aug, ADE20K and synthetic data, train and val (numpy,
PIL and scipy), and the on-device train augmentation
(``device_transforms.py``)."""

from robseg_torch.data.datasets import (  # noqa: F401
    DATASETS, ADE20KSegmentation, SyntheticSegmentation, VOCAugSegmentation,
    VOCSegmentation, get_segmentation_dataset)
from robseg_torch.data.prefetch import PrefetchIterator, prefetch  # noqa: F401
from robseg_torch.data.sampler import (  # noqa: F401
    IterationBasedLoader, ShardedEpochSampler, simple_eval_loader)
from robseg_torch.data.transforms import (  # noqa: F401
    to_float_chw_last, train_sync_transform, val_sync_transform)
from robseg_torch.data.device_transforms import (  # noqa: F401
    augment_batch, color_jitter, load_raw_batch)
