"""Norm-ball projections for the Linf, L2 and L1 attacks.

Port of ``robseg_tpu/ops/projections.py``: ``project_linf``,
``project_l2`` (the rescale-then-clamp of ``semseg/attacker.py:414-424``)
and ``project_l1_ball_box``, the vectorised sort and binary search of the
reference's ``L1_projection`` (``semseg/attacker.py:55-120``), computed in
float32 whatever the input dtype, as the JAX function computes it.
"""

from __future__ import annotations

import math

import torch


def project_linf(x_adv: torch.Tensor, x: torch.Tensor, eps) -> torch.Tensor:
    """Clamp into the Linf eps-ball around x, then into [0, 1]."""
    return torch.clamp(torch.minimum(torch.maximum(x_adv, x - eps), x + eps),
                       0.0, 1.0)


def _l2_norm(d: torch.Tensor) -> torch.Tensor:
    """Per-image L2 norm, kept as ``(B, 1, 1, 1)`` (autoattack's L2_norm)."""
    b = d.shape[0]
    n = torch.sqrt((d.reshape(b, -1) ** 2).sum(-1) + 0.0)
    return n.reshape((b,) + (1,) * (d.ndim - 1))


def project_l2(x_adv: torch.Tensor, x: torch.Tensor, eps) -> torch.Tensor:
    """Scale into the L2 eps-ball around x, then clamp into [0, 1]; the
    clamp comes after the rescale, so the result may leave the ball a
    little, as in the reference."""
    d = x_adv - x
    n = _l2_norm(d)
    scaled = x + d / (n + 1e-12) * torch.clamp(n, max=eps)
    return torch.clamp(scaled, 0.0, 1.0)


def project_l1_ball_box(x: torch.Tensor, y: torch.Tensor,
                        eps1) -> torch.Tensor:
    """Delta such that ``||y + delta||_1 = eps1`` and ``0 <= x + y + delta
    <= 1`` (``x`` the ball's centre, ``y`` the perturbation). Per
    coordinate, ``u`` bounds the growth of ``|y_i|`` inside the box and
    ``l = -|y_i|`` its decrease; every coordinate moves by
    ``clip(alpha, l, u)`` in magnitude, alpha the dual step found by a
    binary search over the sorted breakpoints of the piecewise-linear
    budget. If ``y`` is already inside the ball, delta only repairs box
    violations (``u < 0``)."""
    b = x.shape[0]
    xf = x.reshape(b, -1).to(torch.float32)
    yf = y.reshape(b, -1).to(torch.float32)
    sigma = torch.sign(yf)
    # u: headroom to *grow* |y_i| inside the box (<= 0 means box violated)
    u = torch.minimum(1.0 - xf - yf, xf + yf)
    u = torch.minimum(torch.zeros_like(yf), u)
    l = -torch.abs(yf)  # noqa: E741
    d = u

    bs, indbs = torch.sort(-torch.cat([u, l], dim=1), dim=1, stable=True)
    bs2 = torch.cat([bs[:, 1:], torch.zeros((b, 1), dtype=bs.dtype,
                                            device=bs.device)], dim=1)

    inu = 2.0 * (indbs < u.shape[1]).to(torch.float32) - 1.0
    size1 = torch.cumsum(inu, dim=1)

    s1 = -u.sum(dim=1)
    c = eps1 - torch.abs(yf).sum(dim=1)
    needs_proj = (s1 + c) < 0  # else the point is feasible enough already

    s = s1[:, None] + torch.cumsum((bs2 - bs) * size1, dim=1)

    # binary search over the breakpoint index, ceil(log2(2n)) steps
    n2 = bs.shape[1]
    nitermax = max(1, math.ceil(math.log2(n2)))
    lb = torch.zeros((b,), dtype=torch.float32, device=x.device)
    ub = torch.full((b,), float(n2 - 1), dtype=torch.float32,
                    device=x.device)
    for _ in range(nitermax):
        mid = torch.floor((lb + ub) / 2.0)
        neg = s.gather(1, mid.to(torch.int64)[:, None])[:, 0] + c < 0
        lb = torch.where(neg, mid, lb)
        ub = torch.where(neg, ub, mid)

    lb2 = lb.to(torch.int64)[:, None]
    s_lb = s.gather(1, lb2)[:, 0]
    size_next = size1.gather(1, torch.clamp(lb2 + 1, max=n2 - 1))[:, 0]
    bs2_lb = bs2.gather(1, lb2)[:, 0]
    alpha = (-s_lb - c) / size_next + bs2_lb
    d_proj = -torch.minimum(torch.maximum(-u, alpha[:, None]), -l)
    d = torch.where(needs_proj[:, None], d_proj, d)
    return (sigma * d).reshape(x.shape).to(x.dtype)
