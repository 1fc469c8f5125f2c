"""Contrastive and unsupervised losses (research utilities).

Port of ``robseg_tpu/ops/contrastive.py`` (present in the reference's
``semseg/val.py`` but called by none of its scripts):
  * ``nt_xent_loss``: SimCLR NT-Xent over flattened embeddings
    (``semseg/val.py:259-297``);
  * ``ce_unsup``: cross-entropy over an embedding-similarity matrix, with
    targeted variants (``semseg/val.py:300-326``).
Their products go through ``ops.precision``, as JAX's follow the matmul
precision of the context.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from robseg_torch.ops.precision import matmul


def nt_xent_loss(emb_i: torch.Tensor, emb_j: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """SimCLR NT-Xent between two batches of paired embeddings: the
    cosine similarities of the 2B L2-normalised embeddings, the positives
    on the +-B diagonals (``val.py:269-297``)."""
    b = emb_i.shape[0]
    zi = emb_i.reshape(b, -1)
    zj = emb_j.reshape(b, -1)
    zi = zi / zi.norm(dim=1, keepdim=True)
    zj = zj / zj.norm(dim=1, keepdim=True)
    reps = torch.cat([zi, zj], dim=0)                        # (2B, D)
    sim = matmul(reps, reps.t())                             # cosine (unit)
    pos = torch.cat([torch.diagonal(sim, b), torch.diagonal(sim, -b)])
    neg_mask = 1.0 - torch.eye(2 * b, dtype=sim.dtype, device=sim.device)
    nominator = torch.exp(pos / temperature)
    denominator = (neg_mask * torch.exp(sim / temperature)).sum(dim=1)
    return (-torch.log(nominator / denominator)).sum() / (2 * b)


def ce_unsup(out: torch.Tensor, targets: torch.Tensor,
             reduction: str = "mean", targeted: bool = False,
             alpha: float = 0.0) -> torch.Tensor:
    """CE over ``out @ targets^T`` with identity labels; targeted: the
    next row's (alpha 0) or the most similar other row's (alpha 1), the
    loss negated (``val.py:300-326``)."""
    out = out.reshape(out.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1)
    b = out.shape[0]
    preds = matmul(out, targets.t())
    labels = torch.arange(b, device=preds.device)
    if targeted:
        if alpha == 0.0:
            labels = (labels + 1) % b
        elif alpha == 1.0:
            labels = torch.argmax(
                preds - 10.0 * torch.diag(torch.diagonal(preds)), dim=1)
        else:
            raise ValueError(f"alpha={alpha} not supported")
    logp = F.log_softmax(preds, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    loss = nll.mean() if reduction == "mean" else nll
    return -loss if targeted else loss
