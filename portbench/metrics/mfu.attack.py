"""mfu.attack: the reference's FLOPs of the attack iterations the traced
run's window finished (``portbench/flops.py``: one iteration is a forward
and an input gradient of each image) over the window's seconds, as a share
of the card's dense TF32 peak, the precision of the cell's products
(``peak_flops`` of the configuration) (%). Nothing recomputed counts."""


def read(obs):
    units, seconds = obs.extra.get("window_units"), obs.extra.get("window_s")
    if not units or not seconds:
        return None
    return 100.0 * obs.flops_per_unit * units / seconds / \
        obs.cfg["peak_flops"]
