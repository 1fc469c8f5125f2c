"""The plain reference of the attacks: the SEA losses and ce-avg, the Linf
APGD step with its projection.

Written from Croce, Singh and Hein, "Towards Reliable Evaluation and Fast
Training of Robust Semantic Segmentation Models" (ECCV 2024,
arXiv:2306.12941): labels are ``(B, H, W)`` with -1 for ignored pixels,
logits ``(B, K, H, W)``; a per-pixel loss is 0 at ignored pixels; an image's
loss is the mean over all of its pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ce_pixels(logits, y, weights=None):
    """Per-pixel ``-w[y] log softmax(logits)[y]``, 0 where y is -1."""
    valid = y != -1
    t = torch.where(valid, y, 0)
    nll = -torch.log_softmax(logits, 1).gather(1, t[:, None])[:, 0]
    if weights is not None:
        nll = nll * weights[t]
    return torch.where(valid, nll, 0.0)


def correct_mask(logits, y):
    return ((logits.argmax(1) == y) & (y != -1)).to(logits.dtype)


def js_pixels(logits, y):
    """Jensen-Shannon divergence between softmax(logits) and one-hot(y)."""
    valid = y != -1
    p = torch.softmax(logits, 1)
    q = F.one_hot(torch.where(valid, y, 0), logits.shape[1]).permute(
        0, 3, 1, 2).to(logits.dtype)
    m = torch.clamp_min((p + q) / 2, torch.finfo(logits.dtype).tiny)
    log_m = torch.log(m)

    def kl(a):
        return torch.where(a > 0, a * torch.log(torch.where(a > 0, a, 1.0)),
                           0.0) - a * log_m
    return torch.where(valid, ((kl(p) + kl(q)) / 2).sum(1), 0.0)


def pixel_loss(name: str, logits, y, weights=None, correct=None):
    """A SEA criterion per pixel (``mask-ce-bal`` reads the class
    weights). The masked losses take the pixels classified correctly from
    ``correct`` where it is given, else from ``logits``."""
    if name in ("ce", "ce-avg"):
        return ce_pixels(logits, y)
    mask = correct_mask(logits, y) if correct is None \
        else correct.to(logits.dtype)
    if name == "mask-ce-avg":
        return mask * ce_pixels(logits, y)
    if name == "mask-ce-bal":
        return mask * ce_pixels(logits, y, weights)
    if name == "js-avg":
        return js_pixels(logits, y)
    raise ValueError(name)


def image_loss(name: str, logits, y, weights=None, correct=None):
    """(B,) image losses: the pixel loss over the labelled pixels, averaged
    over all pixels."""
    per = pixel_loss(name, logits, y, weights, correct) * \
        (y != -1).to(logits.dtype)
    return per.reshape(per.shape[0], -1).mean(-1)


def loss_input_grad(net, x, y, name: str, weights=None, correct=None):
    """(logits, gradient of the summed image losses with respect to x)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        logits = net(x)
        (g,) = torch.autograd.grad(
            image_loss(name, logits, y, weights, correct).sum(), x)
    return logits.detach(), g


def project_linf(z, x, eps):
    """The nearest point of the Linf ball of radius eps around x within the
    image box [0, 1]."""
    return torch.clamp(torch.minimum(torch.maximum(z, x - eps), x + eps),
                       0.0, 1.0)


def apgd_linf_step(x, x_adv, x_old, grad, step, eps, a):
    """APGD's Linf update with momentum ``a``: a sign step of per-image
    size ``step``, projected, then the momentum mix, projected again."""
    step = step.reshape((step.shape[0],) + (1,) * (x.ndim - 1))
    z = project_linf(x_adv + step * torch.sign(grad), x, eps)
    return project_linf(x_adv + a * (z - x_adv) + (1 - a) * (x_adv - x_old),
                        x, eps)
