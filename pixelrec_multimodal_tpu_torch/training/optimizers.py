# pixelrec_multimodal_tpu_torch/training/optimizers.py
"""Optimizers and the per-epoch learning-rate schedule, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/training/optimizers.py`` (optax):
the same three optimizers with torch's weight-decay coupling as optax
builds it, the global-norm clip, gradient accumulation and frozen
parameters, each written to optax's arithmetic:

* ``adamw``: optax ``adamw``, decay decoupled: ``u = m_hat / (sqrt(v_hat) +
  eps) + wd * p``, ``p += -lr * u``;
* ``adam`` and ``sgd``: ``add_decayed_weights`` first, ``g += wd * p``, then
  ``adam`` or ``sgd`` with momentum 0.9 (``t = g + 0.9 t``, ``p += -lr * t``);
* the clip: ``where(norm < max, g, g / norm * max)`` on the global norm,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* accumulation over k micro-batches (``optax.MultiSteps``): the running mean
  ``acc + (g - acc) / (n + 1)``, clipped after averaging, the update
  committed every k-th step;
* ``with_frozen``: frozen parameters get no update and no decay, and the
  clip's norm runs over the trainable ones only.

``build_optimizer`` returns an ``Optimizer``; its ``init`` binds it to the
trainable parameters of a model and lays them out as views of one flat
float32 buffer, so that each update is a few elementwise passes over that
buffer (in place) instead of a few per tensor. Every update is gated by a
device-side flag (the train step's finite loss): a gated-off step leaves the
parameters and the state as they were without a host round trip. The
learning rate lives in the state as a float32 tensor the host may change
between epochs (``set_learning_rate``), as optax's ``inject_hyperparams``
slot.

Under tensor parallelism (``parallel/tensor_parallel.shard_module``) each
rank's buffer holds its shards of the sharded parameters, so the layout
differs by rank; their moments are the shards'. The clip's norm is the
whole parameters' all the same: the square sums of the sharded entries
are summed over 'model', and the replicated entries count once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..parallel.mesh import MODEL_AXIS, all_reduce

KINDS = ('adamw', 'adam', 'sgd')
SGD_MOMENTUM = 0.9


@dataclasses.dataclass
class OptState:
    """An optimizer bound to its parameters: ``names`` and ``params`` the
    trainable parameters in the model's order, ``flat`` their storage (each
    parameter a view of it), ``lr`` the learning rate (float32 tensor);
    ``count``, ``mu``, ``nu`` Adam's step and moments, ``trace`` SGD's
    momentum; ``mini_step``, ``gradient_step`` and ``acc`` the
    accumulation's (k > 1); ``sharded`` a float mask over ``flat``, 1 on
    the entries of parameters sharded over ``mesh``'s 'model' axis (None
    without tensor parallelism)."""
    names: List[str]
    params: List[nn.Parameter]
    flat: torch.Tensor
    lr: torch.Tensor
    count: torch.Tensor
    mu: Optional[torch.Tensor] = None
    nu: Optional[torch.Tensor] = None
    trace: Optional[torch.Tensor] = None
    mini_step: Optional[torch.Tensor] = None
    gradient_step: Optional[torch.Tensor] = None
    acc: Optional[torch.Tensor] = None
    sharded: Optional[torch.Tensor] = None
    mesh: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The recipe ``build_optimizer`` returns; ``init`` binds it to a
    model's parameters and ``update`` applies one step."""
    kind: str = 'adamw'
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    gradient_clip: Optional[float] = 1.0
    accumulation_steps: int = 1
    # name -> trainable; None: every parameter is
    trainable: Optional[Callable[[str], bool]] = None

    def init(self, named_params: Iterable[Tuple[str, nn.Parameter]]
             ) -> OptState:
        """Bind to the trainable ones of ``named_params`` (e.g.
        ``model.named_parameters()``): their values move into one flat
        buffer on their device and each parameter becomes a view of it, so
        move the model before this call, not after."""
        pairs = [(n, p) for n, p in named_params
                 if self.trainable is None or self.trainable(n)]
        if not pairs:
            raise ValueError('no trainable parameters to optimize')
        names, params = [n for n, _ in pairs], [p for _, p in pairs]
        devices = {p.device for p in params}
        if len(devices) != 1 or any(p.dtype != torch.float32 for p in params):
            raise ValueError(f'the parameters must be float32 on one device, '
                             f'got {sorted(map(str, devices))}')
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        offset = 0
        for p in params:
            p.data = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        dev = flat.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        state = OptState(names=names, params=params, flat=flat,
                         lr=torch.tensor(self.learning_rate,
                                         dtype=torch.float32, device=dev),
                         count=zero.clone())
        if self.kind == 'sgd':
            state.trace = torch.zeros_like(flat)
        else:
            state.mu, state.nu = torch.zeros_like(flat), torch.zeros_like(flat)
        if self.accumulation_steps > 1:
            state.mini_step, state.gradient_step = zero.clone(), zero.clone()
            state.acc = torch.zeros_like(flat)
        shards = [getattr(p, 'tp', None) for p in params]
        if any(t is not None for t in shards):
            state.mesh = next(t.mesh for t in shards if t is not None)
            state.sharded = torch.cat([torch.full(
                (p.numel(),), float(t is not None), device=dev)
                for p, t in zip(params, shards)])
        return state

    def flat_grads(self, state: OptState,
                   grads: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
        """The gradients of ``state.params`` (None: zero) as one flat
        tensor in the layout of ``state.flat``."""
        return torch.cat([torch.zeros_like(p).reshape(-1) if g is None
                          else g.reshape(-1)
                          for p, g in zip(state.params, grads)])

    def update(self, state: OptState, g: torch.Tensor,
               apply: torch.Tensor) -> None:
        """One step on the flat gradient ``g``, in place, where the bool
        tensor ``apply`` is true; where it is false the parameters and the
        state stay as they were."""
        p = state.flat
        k = self.accumulation_steps
        if k > 1:
            acc = state.acc + (g - state.acc) / (
                state.mini_step.to(torch.float32) + 1.0)
            g = acc
        if self.gradient_clip is not None and self.gradient_clip > 0:
            norm = (torch.linalg.vector_norm(g) if state.sharded is None
                    else _sharded_norm(state, g))
            g = torch.where(norm < self.gradient_clip, g,
                            g / norm * self.gradient_clip)
        wd = self.weight_decay
        if self.kind in ('adam', 'sgd'):
            g = g + wd * p
        new = {}
        if self.kind == 'sgd':
            new['trace'] = g + SGD_MOMENTUM * state.trace
            u = new['trace']
        else:
            count = state.count + 1
            new['count'] = count
            new['mu'] = (1 - self.b1) * g + self.b1 * state.mu
            new['nu'] = (1 - self.b2) * (g * g) + self.b2 * state.nu
            c = count.to(torch.float32)
            mu_hat = new['mu'] / (1 - torch.pow(
                torch.tensor(self.b1, dtype=torch.float32, device=p.device), c))
            nu_hat = new['nu'] / (1 - torch.pow(
                torch.tensor(self.b2, dtype=torch.float32, device=p.device), c))
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if self.kind == 'adamw':
                u = u + wd * p
        u = u * -state.lr
        commit = apply
        if k > 1:
            emit = state.mini_step == k - 1
            commit = apply & emit
            state.acc.copy_(torch.where(
                apply, torch.where(emit, torch.zeros_like(acc), acc),
                state.acc))
            state.gradient_step.copy_(torch.where(
                commit, state.gradient_step + 1, state.gradient_step))
            state.mini_step.copy_(torch.where(
                apply, (state.mini_step + 1) % k, state.mini_step))
        p.copy_(torch.where(commit, p + u, p))
        for name, value in new.items():
            old = getattr(state, name)
            old.copy_(torch.where(commit, value, old))


def _sharded_norm(state: OptState, g: torch.Tensor) -> torch.Tensor:
    """The global norm of the whole parameters' gradient of which ``g``
    holds this rank's shards: the sharded entries' square sum summed over
    'model', plus the replicated entries' once."""
    sq = g * g
    sharded = all_reduce(state.mesh, MODEL_AXIS,
                         (sq * state.sharded).sum(), op='sum')
    return torch.sqrt((sq * (1.0 - state.sharded)).sum() + sharded)


def build_optimizer(optimizer_type: str = 'adamw',
                    learning_rate: float = 1e-3,
                    weight_decay: float = 0.01,
                    adam_beta1: float = 0.9,
                    adam_beta2: float = 0.999,
                    adam_eps: float = 1e-8,
                    gradient_clip: Optional[float] = 1.0,
                    gradient_accumulation_steps: int = 1) -> Optimizer:
    """Global-norm clip, then the optimizer, with a learning rate the host
    may change (``set_learning_rate``); ``gradient_accumulation_steps`` > 1
    averages that many micro-batches' gradients per update. An unknown
    ``optimizer_type`` falls back to AdamW at the default betas and eps, as
    in JAX."""
    kind = optimizer_type.lower()
    if kind not in KINDS:
        print(f"Unknown optimizer type: {optimizer_type}. Using AdamW.")
        return Optimizer('adamw', learning_rate, weight_decay,
                         gradient_clip=gradient_clip,
                         accumulation_steps=gradient_accumulation_steps)
    return Optimizer(kind, learning_rate, weight_decay, adam_beta1,
                     adam_beta2, adam_eps, gradient_clip,
                     gradient_accumulation_steps)


def with_frozen(tx: Optimizer,
                trainable_mask: Union[Mapping[str, bool],
                                      Callable[[str], bool]]) -> Optimizer:
    """``tx`` restricted to the trainable parameters: ``trainable_mask``
    maps a parameter's name (``model.named_parameters()``) to True or
    False, or is a function of the name. Frozen parameters get no update
    and, under AdamW, no decay; the clip's norm leaves them out."""
    if callable(trainable_mask):
        fn = trainable_mask
    else:
        mask = dict(trainable_mask)
        fn = mask.__getitem__
    return dataclasses.replace(tx, trainable=fn)


def get_learning_rate(opt_state: OptState) -> float:
    return float(opt_state.lr)


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """Set the learning rate in place; returns ``opt_state``."""
    opt_state.lr.fill_(lr)
    return opt_state


class LRScheduler:
    """Host-side per-epoch LR controller.

    reduce_on_plateau: multiply by ``factor`` after ``patience`` epochs without
    val-loss improvement (torch ReduceLROnPlateau mode='min'). cosine:
    CosineAnnealingLR over ``total_epochs``. step: StepLR with
    step_size=``patience``, gamma=``factor``.
    """

    def __init__(self, scheduler_type: str = 'reduce_on_plateau',
                 base_lr: float = 1e-3, patience: int = 2, factor: float = 0.5,
                 min_lr: float = 1e-6, total_epochs: int = 10):
        self.kind = scheduler_type.lower()
        if self.kind not in ('reduce_on_plateau', 'cosine', 'step'):
            print(f"Unknown scheduler type: {scheduler_type}. "
                  "Using ReduceLROnPlateau.")
            self.kind = 'reduce_on_plateau'
        self.base_lr = base_lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.total_epochs = max(total_epochs, 1)
        self._lr = base_lr
        self._best = math.inf
        self._bad_epochs = 0
        self._epoch = 0

    @property
    def lr(self) -> float:
        return self._lr

    def step(self, val_loss: Optional[float] = None) -> float:
        """Advance one epoch; returns the LR for the next epoch."""
        self._epoch += 1
        if self.kind == 'reduce_on_plateau':
            if val_loss is not None and not math.isnan(val_loss):
                # torch default threshold 1e-4 (rel mode 'rel' on 'min').
                if val_loss < self._best * (1 - 1e-4):
                    self._best = val_loss
                    self._bad_epochs = 0
                else:
                    self._bad_epochs += 1
                    if self._bad_epochs > self.patience:
                        self._lr = max(self._lr * self.factor, self.min_lr)
                        self._bad_epochs = 0
        elif self.kind == 'cosine':
            t = self._epoch % (2 * self.total_epochs)
            self._lr = self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
                1 + math.cos(math.pi * t / self.total_epochs))
        elif self.kind == 'step':
            self._lr = self.base_lr * (
                self.factor ** (self._epoch // max(self.patience, 1)))
        return self._lr

    def state_dict(self) -> dict:
        return {'kind': self.kind, 'lr': self._lr, 'best': self._best,
                'bad_epochs': self._bad_epochs, 'epoch': self._epoch}

    def load_state_dict(self, d: dict):
        self._lr = d.get('lr', self._lr)
        self._best = d.get('best', self._best)
        self._bad_epochs = d.get('bad_epochs', 0)
        self._epoch = d.get('epoch', 0)
