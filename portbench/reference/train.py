"""The plain reference of the frozen-feature training step, in float32.

Each step: the forward in training mode (``model.Model.forward_train``),
the weighted binary cross-entropy, the gradients of every parameter, the
clip of their global norm (``g * max / norm`` where the norm is at least
``max``), then AdamW with decoupled decay (``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2``, ``p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p)``)
and the BatchNorm running statistics moved by the batch. Nothing here
imports the port, JAX or the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .model import Dropout, Model, Weights, bce, exact

STAT_SUFFIXES = ('running_mean', 'running_var')


def is_parameter(name: str) -> bool:
    return not name.endswith(STAT_SUFFIXES + ('num_batches_tracked',))


def train_steps(cfg: dict, weights: Weights, packed: torch.Tensor,
                batches: List[Dict[str, torch.Tensor]],
                dropout_gen: torch.Generator,
                product: Optional[Callable] = None,
                keep_rows: Optional[Callable] = None) -> dict:
    """Run ``batches`` through the reference from ``weights`` (left as they
    are). Returns ``losses`` (one float a step), ``grad1`` (the first
    step's clipped gradient by parameter name), ``params`` and ``stats``
    (the parameters and the running statistics after the last step).
    ``product`` computes every product (the control's float8);
    ``keep_rows(batch) -> batch`` lets a test drop rows of each batch
    from the loss."""
    t = cfg['training']
    lr, wd, clip = t['learning_rate'], t['weight_decay'], t['gradient_clip']
    b1, b2, eps = t['adam_beta1'], t['adam_beta2'], t['adam_eps']
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items() if is_parameter(k)}
    stats = {k: v.detach().clone() for k, v in weights.items()
             if k.endswith(STAT_SUFFIXES)}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    drop = Dropout(cfg['model']['dropout_rate'], dropout_gen)
    losses, grad1 = [], None
    with exact():
        for step, batch in enumerate(batches, start=1):
            model = Model(cfg, {**params, **stats}, product)
            moved: Dict[str, torch.Tensor] = {}
            scores = model.forward_train(batch, packed, drop, moved)
            kept = batch if keep_rows is None else keep_rows(batch)
            if keep_rows is not None:
                scores = scores[:kept['label'].shape[0]]
            loss = bce(scores, kept['label'], kept.get('weight'))
            names = list(params)
            grads = torch.autograd.grad(loss, [params[k] for k in names],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)}
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= clip:
                grads = {k: g / norm * clip for k, g in grads.items()}
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    mu[k] = b1 * mu[k] + (1 - b1) * g
                    nu[k] = b2 * nu[k] + (1 - b2) * g * g
                    m_hat = mu[k] / (1 - b1 ** step)
                    v_hat = nu[k] / (1 - b2 ** step)
                    p -= lr * (m_hat / (torch.sqrt(v_hat) + eps) + wd * p)
                stats.update(moved)
            losses.append(float(loss.detach()))
    return {'losses': losses, 'grad1': grad1,
            'params': {k: v.detach() for k, v in params.items()},
            'stats': stats}
