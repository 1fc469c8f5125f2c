"""PIR-AT training: schedules, optimizers, the trainer, checkpoints, and
the CLI ``python -m robseg_torch.train`` (``__main__.py``)."""

from robseg_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager, save_weights)
from robseg_torch.train.optim import (  # noqa: F401
    ScheduledOptimizer, decay_mask, freeze_mask, layerwise_lr_scales,
    make_optimizer, pspnet_lr_scales)
from robseg_torch.train.schedules import (  # noqa: F401
    get_scheduler, poly_learning_rate, poly_lr, polynomial_lr_timm,
    warmup_cosine_lr, warmup_poly_lr)
from robseg_torch.train.trainer import (  # noqa: F401
    AttackConfig, Trainer, make_loss_fn, metrics_from_hist)
