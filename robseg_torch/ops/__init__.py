"""Losses, metrics, projections and resizing on NCHW tensors."""

from robseg_torch.ops.losses import (  # noqa: F401
    ATTACK_CRITERIA,
    cross_entropy_pixelwise,
    dice_loss,
    dlr_loss,
    get_train_loss,
    js_loss,
    make_attack_criterion,
    margin_loss,
    masked_cross_entropy,
    masked_cross_entropy_balanced,
    ohem_cross_entropy,
    pixel_to_img_loss,
    segmentation_cross_entropy,
)
from robseg_torch.ops.metrics import (  # noqa: F401
    confusion_matrix,
    f1_from_hist,
    iou_acc_summary,
    iou_from_hist,
    per_image_intersect_union,
    pixel_acc_from_hist,
)
from robseg_torch.ops.projections import (  # noqa: F401
    project_l1_ball_box,
    project_l2,
    project_linf,
)
from robseg_torch.ops.resize import adaptive_avg_pool, resize_bilinear  # noqa: F401
