"""Utilities: logging, class weights, palettes, seeds, profiling."""

from robseg_torch.utils.class_weights import (  # noqa: F401
    ADE_WTS, VOC_WTS, class_balance_weights)
from robseg_torch.utils.logger import Logger  # noqa: F401
from robseg_torch.utils.misc import fix_seeds, model_param_count  # noqa: F401
