# pixelrec_multimodal_tpu_torch/models/losses.py
"""Loss functions, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/models/losses.py``: the symmetric
CLIP-style contrastive loss and the recommender's weighted BCE with the
reference's NaN contract. Every branch is on values (``torch.where``), so a
batch with non-finite predictions costs no host round trip: the train step
reads the loss on the device and skips the update there.

With a ``mesh`` whose 'data' axis splits the batch, each rank computes its
part of the global batch's loss (``parallel/mesh.py``'s convention: the
parts sum to the loss one process computes on the whole batch): the
weighted means divide by the global denominator, and the InfoNCE logits
run over the global batch (the features gathered over 'data'), each rank
taking the rows and the columns of its own examples.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..parallel.mesh import (
    DATA_AXIS,
    all_gather,
    data_mesh,
    gather_data,
    sum_data,
)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=eps)


def _global_denominator(mesh, weight: torch.Tensor) -> torch.Tensor:
    """The global batch's weighted-mean denominator (no gradient)."""
    return torch.clamp(sum_data(mesh, weight.detach().sum()), min=1.0)


def contrastive_loss(image_features: torch.Tensor,
                     text_features: torch.Tensor,
                     temperature: Union[torch.Tensor, float] = 0.07,
                     weight: Optional[torch.Tensor] = None,
                     mesh=None) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of aligned pairs. ``weight`` (0/1 per
    row) masks padded rows out of both softmax directions: their logits
    become -1e9 in the rows and the columns, and the mean runs over the
    kept rows. With a ``mesh`` splitting the batch over 'data', this
    rank's part of the global batch's loss."""
    mesh = data_mesh(mesh)
    if mesh is not None:
        return _contrastive_part(image_features, text_features, temperature,
                                 weight, mesh)
    img = l2_normalize(image_features)
    txt = l2_normalize(text_features)
    logits = img @ txt.T / temperature
    if weight is not None:
        neg = torch.tensor(-1e9, dtype=logits.dtype, device=logits.device)
        logits = torch.where(weight[None, :] > 0, logits, neg)
        logits = torch.where(weight[:, None] > 0, logits, neg)
    diag = torch.diagonal(logits)
    lse_rows = torch.logsumexp(logits, dim=1)
    lse_cols = torch.logsumexp(logits, dim=0)
    if weight is None:
        loss_i2t = torch.mean(lse_rows - diag)
        loss_t2i = torch.mean(lse_cols - diag)
    else:
        denom = torch.clamp(weight.sum(), min=1.0)
        loss_i2t = (weight * (lse_rows - diag)).sum() / denom
        loss_t2i = (weight * (lse_cols - diag)).sum() / denom
    return (loss_i2t + loss_t2i) / 2


def _contrastive_part(image_features, text_features, temperature, weight,
                      mesh) -> torch.Tensor:
    """This rank's part of the global InfoNCE: the logits of its rows
    against every column (image to text) and of its columns against every
    row (text to image), over the gathered features."""
    img = l2_normalize(image_features)
    txt = l2_normalize(text_features)
    b = img.shape[0]
    start = mesh.index(DATA_AXIS) * b
    own = torch.arange(b, device=img.device)
    rows = img @ gather_data(mesh, txt).T / temperature     # [b, B]
    cols = gather_data(mesh, img) @ txt.T / temperature     # [B, b]
    if weight is not None:
        w_all = all_gather(mesh, DATA_AXIS, weight.detach().contiguous())
        neg = torch.tensor(-1e9, dtype=rows.dtype, device=rows.device)
        rows = torch.where(w_all[None, :] > 0, rows, neg)
        rows = torch.where(weight[:, None] > 0, rows, neg)
        cols = torch.where(weight[None, :] > 0, cols, neg)
        cols = torch.where(w_all[:, None] > 0, cols, neg)
    lse_rows = torch.logsumexp(rows, dim=1)
    lse_cols = torch.logsumexp(cols, dim=0)
    diag_rows = rows[own, start + own]
    diag_cols = cols[start + own, own]
    if weight is None:
        denom = float(b * mesh.shape[DATA_AXIS])
        loss_i2t = (lse_rows - diag_rows).sum() / denom
        loss_t2i = (lse_cols - diag_cols).sum() / denom
    else:
        denom = _global_denominator(mesh, weight)
        loss_i2t = (weight * (lse_rows - diag_rows)).sum() / denom
        loss_t2i = (weight * (lse_cols - diag_cols)).sum() / denom
    return (loss_i2t + loss_t2i) / 2


def recommender_loss(predictions: torch.Tensor, labels: torch.Tensor,
                     vision_features: Optional[torch.Tensor] = None,
                     text_features: Optional[torch.Tensor] = None,
                     temperature: Union[torch.Tensor, float] = 0.07,
                     use_contrastive: bool = True,
                     contrastive_weight: float = 0.1,
                     bce_weight: float = 1.0,
                     weight: Optional[torch.Tensor] = None,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """Weighted BCE (+ contrastive) over post-sigmoid ``predictions``,
    clamped to [1e-7, 1 - 1e-7] before the log. If any prediction is
    non-finite, ``total`` and ``bce`` are NaN and ``contrastive`` is 0.
    With a ``mesh`` splitting the batch over 'data', this rank's parts of
    the global batch's losses (the non-finite rule then holds per rank;
    the train step applies it to the sums)."""
    mesh = data_mesh(mesh)
    eps = 1e-7
    p = torch.clamp(predictions, eps, 1.0 - eps)
    per_example = -(labels * torch.log(p)
                    + (1.0 - labels) * torch.log1p(-p))
    if mesh is not None:
        rows = per_example.shape[0]
        if weight is None:
            bce = per_example.sum() / float(rows * mesh.shape[DATA_AXIS])
        else:
            bce = (weight * per_example).sum() / _global_denominator(
                mesh, weight)
    elif weight is None:
        bce = torch.mean(per_example)
    else:
        bce = (weight * per_example).sum() / torch.clamp(weight.sum(),
                                                          min=1.0)
    if use_contrastive and vision_features is not None \
            and text_features is not None:
        contr = contrastive_loss(vision_features, text_features, temperature,
                                 weight=weight, mesh=mesh)
    else:
        contr = torch.zeros((), dtype=predictions.dtype,
                            device=predictions.device)
    total = bce_weight * bce + contrastive_weight * contr
    finite = torch.isfinite(predictions).all()
    nan = torch.full((), float('nan'), dtype=predictions.dtype,
                     device=predictions.device)
    return {'total': torch.where(finite, total, nan),
            'bce': torch.where(finite, bce, nan),
            'contrastive': torch.where(finite, contr, torch.zeros_like(contr))}
