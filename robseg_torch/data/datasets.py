"""PASCAL-VOC 2012 and ADE20K segmentation, val mode.

Copies of ``robseg_tpu/data/datasets.py``'s ``VOCSegmentation`` and
``ADE20KSegmentation`` for evaluation (numpy and PIL; ``robseg_tpu.data``
imports JAX). Items are an HWC float32 image in [0, 1] and an int32 mask:
VOC folds the void label 255 into background class 0 (parity
``semseg/datasets/pascal_voc.py:114-117``); ADE20K has 151 classes with
class 0 the background and label offset 0 (``semseg/datasets/ade.py:61-63``).
VOC-aug and the train splits are a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
from PIL import Image

from robseg_torch.data.transforms import to_float_chw_last, val_sync_transform


class VOCSegmentation:
    BASE_DIR = "VOCdevkit/VOC2012"
    NUM_CLASS = 21

    def __init__(self, root: str, split: str = "val", crop_size=473):
        self.crop_size = (crop_size[0] if isinstance(crop_size, (tuple, list))
                          else crop_size)
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

    def __getitem__(self, index: int):
        img = Image.open(self.images[index]).convert("RGB")
        mask = Image.open(self.masks[index])
        img_a, mask_a = val_sync_transform(img, mask, self.crop_size)
        target = mask_a.astype(np.int32)
        target[target == 255] = 0  # fold void into background (parity)
        return to_float_chw_last(img_a), target


class ADE20KSegmentation:
    """ADEChallengeData2016, val split: every ``images/validation/*.jpg``
    with a ``annotations/validation/*.png`` of the same stem, sorted."""
    BASE_DIR = "ADEChallengeData2016"
    NUM_CLASS = 151

    def __init__(self, root: str, split: str = "val", crop_size=512,
                 n_cls: int = 151):
        if split == "train":
            raise NotImplementedError(
                "the ADE20K train split is a later slice (ROADMAP.md)")
        if n_cls not in (150, 151):
            raise ValueError(f"Invalid number of classes: {n_cls}.")
        self.crop_size = (crop_size[0] if isinstance(crop_size, (tuple, list))
                          else crop_size)
        self.n_classes = n_cls
        self.offset = 0  # parity: ade.py:63
        ade_root = os.path.join(root, self.BASE_DIR)
        img_dir = os.path.join(ade_root, "images/validation")
        msk_dir = os.path.join(ade_root, "annotations/validation")
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

    def __getitem__(self, index: int):
        img = Image.open(self.images[index]).convert("RGB")
        mask = Image.open(self.masks[index])
        img_a, mask_a = val_sync_transform(img, mask, self.crop_size)
        return to_float_chw_last(img_a), mask_a.astype(np.int32) - self.offset


def get_segmentation_dataset(name: str, *, root: str, split: str = "val",
                             crop_size=473):
    """The eval dataset for ``name``: PASCAL-VOC or ADE20K."""
    if name.lower() == "pascalvoc":
        return VOCSegmentation(root, split=split, crop_size=crop_size)
    if name.lower() == "ade20k":
        return ADE20KSegmentation(root, split=split, crop_size=crop_size)
    raise NotImplementedError(
        f"dataset {name!r} is not ported yet: VOC-aug is a later slice "
        "(ROADMAP.md)")
