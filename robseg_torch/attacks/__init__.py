"""APGD (Linf, L2, L1, restarts), the training PGD, the filter attack,
SEA and the worst-case aggregation."""

from robseg_torch.attacks.apgd import (  # noqa: F401
    APGDResult, apgd_attack, apgd_largereps, apgd_restarts)
from robseg_torch.attacks.filters import pgd_filters  # noqa: F401
from robseg_torch.attacks.pgd import (  # noqa: F401
    TRAIN_ATTACK_LOSSES, pgd_attack, pgd_attack_rs, segpgd_loss)
from robseg_torch.attacks.sea import (  # noqa: F401
    SEA_LOSSES, check_imgs, eval_performance, evaluate,
    run_attack_over_loader, run_sea)
from robseg_torch.attacks.worst_case import (  # noqa: F401
    sea_intersect_union, worst_case_aacc, worst_case_miou)
