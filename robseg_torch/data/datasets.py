"""PASCAL-VOC 2012, VOC-aug (SBD), ADE20K and a synthetic dataset.

Copies of ``robseg_tpu/data/datasets.py`` (numpy, PIL and scipy only;
``robseg_tpu.data`` imports JAX). Items are an HWC float32 image in [0, 1]
and an int32 mask: VOC folds the void label 255 into background class 0
(parity ``semseg/datasets/pascal_voc.py:114-117``), VOC-aug keeps its
``.mat`` labels as they are;
ADE20K has 151 classes with class 0 the background and label offset 0
(``semseg/datasets/ade.py:61-63``). ``mode="train"`` applies
``train_sync_transform`` with a per-sample ``random.Random`` seeded by
``(seed, epoch, index)``, ``mode="val"`` the center crop.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from robseg_torch.data.transforms import (to_float_chw_last,
                                          train_sync_transform,
                                          val_sync_transform)


class SegmentationDatasetBase:
    """Shared train/val transform plumbing (``dataset_wrappers.py:11-108``)."""

    NUM_CLASS: int = 0

    def __init__(self, split: str = "train", mode: Optional[str] = None,
                 base_size: int = 520, crop_size=480, seed: int = 0):
        self.split = split
        self.mode = mode if mode is not None else split
        self.base_size = base_size
        self.crop_size = crop_size[0] if isinstance(
            crop_size, (tuple, list)) else crop_size
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _load(self, index: int) -> Tuple[Image.Image, Image.Image]:
        raise NotImplementedError

    def _mask_transform(self, mask: np.ndarray) -> np.ndarray:
        return mask.astype(np.int32)

    def __getitem__(self, index: int):
        img, mask = self._load(index)
        if self.mode == "train":
            # a tuple of ints hashes the same in every process
            rng = random.Random(hash((self.seed, self.epoch, index)))
            img_a, mask_a = train_sync_transform(
                img, mask, base_size=self.base_size,
                crop_size=self.crop_size, rng=rng)
        elif self.mode == "val":
            img_a, mask_a = val_sync_transform(img, mask, self.crop_size)
        else:  # testval
            img_a, mask_a = np.array(img), np.array(mask).astype("int32")
        return to_float_chw_last(img_a), self._mask_transform(mask_a)


class VOCSegmentation(SegmentationDatasetBase):
    """``VOCdevkit/VOC2012`` with ``ImageSets/Segmentation/<split>.txt``."""

    BASE_DIR = "VOCdevkit/VOC2012"
    NUM_CLASS = 21

    def __init__(self, root: str, split: str = "val", crop_size=473, **kw):
        super().__init__(split=split, crop_size=crop_size, **kw)
        voc_root = os.path.join(root, self.BASE_DIR)
        mask_dir = os.path.join(voc_root, "SegmentationClass")
        image_dir = os.path.join(voc_root, "JPEGImages")
        split_f = os.path.join(voc_root, "ImageSets/Segmentation",
                               f"{split}.txt")
        self.images: List[str] = []
        self.masks: List[str] = []
        with open(split_f) as lines:
            for line in lines:
                name = line.rstrip("\n")
                self.images.append(os.path.join(image_dir, name + ".jpg"))
                self.masks.append(os.path.join(mask_dir, name + ".png"))

    def __len__(self):
        return len(self.images)

    def _load(self, index):
        return (Image.open(self.images[index]).convert("RGB"),
                Image.open(self.masks[index]))

    def _mask_transform(self, mask):
        target = mask.astype(np.int32)
        target[target == 255] = 0  # fold void into background (parity)
        return target


class VOCAugSegmentation(SegmentationDatasetBase):
    """SBD: ``VOCaug/dataset/{img,cls}`` with ``trainval.txt`` (train) or
    ``val.txt``, masks in MATLAB ``.mat`` files, labels as stored
    (``semseg/datasets/pascal_aug.py:13-135``)."""

    BASE_DIR = "VOCaug/dataset"
    NUM_CLASS = 21

    def __init__(self, root: str, split: str = "train", crop_size=473,
                 **kw):
        super().__init__(split=split, crop_size=crop_size, **kw)
        voc_root = os.path.join(root, self.BASE_DIR)
        if split not in ("train", "val"):
            raise RuntimeError("Unknown dataset split.")
        split_f = os.path.join(
            voc_root, "trainval.txt" if split == "train" else "val.txt")
        self.images, self.masks = [], []
        with open(split_f) as lines:
            for line in lines:
                name = line.rstrip("\n")
                self.images.append(os.path.join(voc_root, "img",
                                                name + ".jpg"))
                self.masks.append(os.path.join(voc_root, "cls",
                                               name + ".mat"))

    def __len__(self):
        return len(self.images)

    def _load(self, index):
        import scipy.io as sio
        mat = sio.loadmat(self.masks[index], mat_dtype=True, squeeze_me=True,
                          struct_as_record=False)
        return (Image.open(self.images[index]).convert("RGB"),
                Image.fromarray(mat["GTcls"].Segmentation))


class ADE20KSegmentation(SegmentationDatasetBase):
    """ADEChallengeData2016: every ``images/<dir>/*.jpg`` with an
    ``annotations/<dir>/*.png`` of the same stem, sorted; ``<dir>`` is
    ``training`` for the train split, ``validation`` otherwise."""
    BASE_DIR = "ADEChallengeData2016"
    NUM_CLASS = 151

    def __init__(self, root: str, split: str = "val", crop_size=512,
                 n_cls: int = 151, **kw):
        if n_cls not in (150, 151):
            raise ValueError(f"Invalid number of classes: {n_cls}.")
        super().__init__(split=split, crop_size=crop_size, **kw)
        self.n_classes = n_cls
        self.offset = 0  # parity: ade.py:63
        ade_root = os.path.join(root, self.BASE_DIR)
        sub = "training" if split == "train" else "validation"
        img_dir = os.path.join(ade_root, "images", sub)
        msk_dir = os.path.join(ade_root, "annotations", sub)
        self.images: List[str] = []
        self.masks: List[str] = []
        for fn in sorted(os.listdir(img_dir)):
            if not fn.endswith(".jpg"):
                continue
            mpath = os.path.join(msk_dir, fn[:-4] + ".png")
            if os.path.isfile(mpath):
                self.images.append(os.path.join(img_dir, fn))
                self.masks.append(mpath)

    def __len__(self):
        return len(self.images)

    def _load(self, index):
        return (Image.open(self.images[index]).convert("RGB"),
                Image.open(self.masks[index]))

    def _mask_transform(self, mask):
        return mask.astype(np.int32) - self.offset


class SyntheticSegmentation(SegmentationDatasetBase):
    """Deterministic fake data: random images, blocky labels."""

    def __init__(self, num_classes: int = 21, length: int = 8,
                 image_hw=(96, 128), **kw):
        kw.setdefault("split", "val")
        super().__init__(**kw)
        self.NUM_CLASS = num_classes
        self.length = length
        self.image_hw = image_hw

    def __len__(self):
        return self.length

    def _load(self, index):
        rng = np.random.default_rng(1234 + index)
        h, w = self.image_hw
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        blocks = rng.integers(0, self.NUM_CLASS, size=(h // 16 + 1,
                                                       w // 16 + 1))
        mask = np.kron(blocks, np.ones((16, 16), np.int64))[:h, :w]
        return (Image.fromarray(img),
                Image.fromarray(mask.astype(np.uint8)))


DATASETS = {
    "pascalvoc": VOCSegmentation,
    "pascalaug": VOCAugSegmentation,
    "ade20k": ADE20KSegmentation,
    "synthetic": SyntheticSegmentation,
}


def get_segmentation_dataset(name: str, **kwargs):
    """Registry; parity: ``semseg/datasets/__init__.py:29-33``."""
    if name.lower() not in DATASETS:
        raise ValueError(f"Unknown dataset {name!r}; one of "
                         f"{sorted(DATASETS)}")
    return DATASETS[name.lower()](**kwargs)
