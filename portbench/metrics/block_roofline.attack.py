"""block_roofline.attack: the ConvNeXt block kernels' least time over their
device time in the traced slice (%), on the cells whose model runs them.

The least time of one block call is chip_smoke.py's bound (copied): the
larger of its bytes over 3.35 TB/s (x in and out, dx also dy, float32, and
the float32 weights) and its operations over their peak (the MLP's bf16
products at 989 TFLOP/s, the 7x7 depthwise taps' float32 FMAs at 67
TFLOP/s); an attack pass runs each block's forward and input gradient once.
The stage grids follow the stem (two 3x3 stride-2 convolutions, padding 1)
and the 2x2 stride-2 downsamplers: 473^2 gives 119/59/29/14. The device
time is that of the kernels named in ``BLOCK_KERNELS``.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "f32": 67e12}
BLOCK_KERNELS = ("pack_kernel", "dwconv_ln_kernel", "mlp_fused_kernel",
                 "mlp_gemm_kernel", "ln_bwd_kernel", "dwcorr_kernel")


def bound_s(nbytes, flops) -> float:
    return max(nbytes / HBM_BYTES_PER_S,
               max(f / PEAK[k] for k, f in flops.items()))


def stage_grids(hw):
    h, w = hw
    h, w = -(-h // 2), -(-w // 2)
    h, w = -(-h // 2), -(-w // 2)
    grids = [(h, w)]
    for _ in range(3):
        h, w = h // 2, w // 2
        grids.append((h, w))
    return grids


def pass_bound_s(cfg, batch, hw) -> float:
    """Least time of one pass (forward and input gradient) through every
    block at ``batch`` images."""
    a = cfg["arch"]
    total = 0.0
    for depth, c, (h, w) in zip(a["depths"], a["dims"], stage_grids(hw)):
        n = batch * h * w
        fwd = bound_s(8 * n * c + 32 * c * c,
                      {"bf16": 16 * n * c * c, "f32": 98 * n * c})
        dx = bound_s(12 * n * c + 32 * c * c,
                     {"bf16": 24 * n * c * c, "f32": 196 * n * c})
        total += depth * (fwd + dx)
    return total


def is_block(op) -> bool:
    return any(k in op.name for k in BLOCK_KERNELS)


def share(obs, passes_per_unit: int):
    tr = obs.workload["traffic"]
    ms = obs.device_ms(is_block)
    if ms <= 0 or not obs.units:
        return None
    least = pass_bound_s(obs.cfg, tr["batch"], tr["hw"]) * passes_per_unit
    return 100.0 * least * obs.units / (ms / 1e3)


def read(obs):
    return share(obs, 1)
