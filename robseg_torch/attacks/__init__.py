"""APGD, the training PGD, SEA and the worst-case aggregation."""

from robseg_torch.attacks.apgd import (  # noqa: F401
    APGDResult, apgd_attack, apgd_largereps)
from robseg_torch.attacks.pgd import (  # noqa: F401
    TRAIN_ATTACK_LOSSES, pgd_attack, pgd_attack_rs, segpgd_loss)
from robseg_torch.attacks.sea import (  # noqa: F401
    SEA_LOSSES, eval_performance, evaluate, run_sea)
from robseg_torch.attacks.worst_case import worst_case_miou  # noqa: F401
