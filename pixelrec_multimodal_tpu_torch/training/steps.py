# pixelrec_multimodal_tpu_torch/training/steps.py
"""Train and eval steps of the frozen-feature path, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/training/steps.py``: item features
are gathered by item index from tables on the model's device (one row
gather for a packed table), then the forward, the loss, the gradients, the
clip and the update, and the classification sums at threshold 0.5, all on
the device. The non-finite-loss skip is a device-side flag: a batch whose
loss is not finite leaves the parameters, the optimizer state and the
BatchNorm statistics as they were, and the epoch functions read nothing on
the host, so an epoch's per-batch metrics come back in one transfer when
the caller reads them.

JAX's steps return a new state; these update the ``TrainState`` in place
(parameters, optimizer state and BatchNorm buffers) and return it. The
dropout masks come from a ``torch.Generator`` on the model's device, which
``train_epoch`` draws from batch after batch, where JAX splits a key. The
model's device is the one everything runs on: ``'cuda'`` unless the model
was built on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..models.losses import recommender_loss
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce,
    data_mesh,
    data_parallel,
    owned_rows,
)
from .optimizers import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    """The step count (int64 tensor: finite steps taken), the model (its
    parameters and BatchNorm statistics), the optimizer and its state."""
    step: torch.Tensor
    model: torch.nn.Module
    opt_state: OptState
    tx: Optimizer

    @classmethod
    def create(cls, *, model: torch.nn.Module, tx: Optimizer) -> 'TrainState':
        """Bind ``tx`` to ``model``'s parameters (``Optimizer.init``)."""
        return cls(step=torch.zeros((), dtype=torch.int64,
                                    device=model.device),
                   model=model, opt_state=tx.init(model.named_parameters()),
                   tx=tx)

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics by state-dict name."""
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith(('running_mean', 'running_var'))}


# kwarg name + model-dim attribute for each float feature table
_FEATURE_TABLE_SPEC = {
    'vision_emb': ('vision_features', 'vision_feature_dim'),
    'language_emb': ('language_features', 'language_feature_dim'),
    'numerical': ('numerical_features', 'num_numerical_features'),
    'clip_text_emb': ('clip_text_features', 'clip_text_feature_dim'),
}
PACKED_PREFIX = 'packed::'


def _take(table: torch.Tensor, it: torch.Tensor, n_items: int,
          mesh) -> torch.Tensor:
    """Rows ``it`` of an item table of a catalog of ``n_items``: a table
    of ``n_items / model-size`` rows under a ``mesh`` with a 'model' axis
    holds this rank's rows of the item axis split over 'model'
    (``item_table_sharding``), gathered by ``owned_rows``; any other table
    is whole."""
    size = mesh.shape[MODEL_AXIS] if mesh is not None else 1
    n = table.shape[0]
    if size == 1 or n * size != n_items:
        return torch.index_select(table, 0, it)
    return owned_rows(mesh, table, it, mesh.index(MODEL_AXIS) * n)


def gather_feature_kwargs(model, tables: Dict[str, torch.Tensor],
                          batch: Dict[str, torch.Tensor],
                          mesh=None) -> Dict[str, torch.Tensor]:
    """Item-index gathers from the feature tables -> model kwargs.

    A modality the model declares whose table is absent gets zero features
    (the reference's placeholders for missing features), so the forward's
    shapes always follow the model. A key
    ``packed::<name>=<width>+<name>=<width>+...`` holds the listed float
    tables concatenated along the feature axis: one row gather serves them
    all, and slices of the row recover each modality. Under a ``mesh``, a
    table of ``model.n_items / model-size`` rows holds this rank's rows of
    the item axis split over 'model' (``_take``).
    """
    it = batch['item_idx'].long()
    B = it.shape[0]
    kw: Dict[str, torch.Tensor] = {}
    packed_key = next((k for k in tables if k.startswith(PACKED_PREFIX)),
                      None)
    if packed_key is not None:
        row = _take(tables[packed_key], it, model.n_items, mesh)
        off = 0
        for part in packed_key[len(PACKED_PREFIX):].split('+'):
            name, _, width = part.partition('=')
            width = int(width)
            kwarg, dim_attr = _FEATURE_TABLE_SPEC[name]
            wanted = (int(getattr(model, dim_attr) or 0) > 0
                      if name != 'clip_text_emb' else model.contrastive_active)
            if wanted:
                kw[kwarg] = row[:, off:off + width]
            off += width

    for name, (kwarg, dim_attr) in _FEATURE_TABLE_SPEC.items():
        if kwarg in kw:
            continue
        dim = int(getattr(model, dim_attr) or 0)
        needed = (dim > 0 if name != 'clip_text_emb'
                  else model.contrastive_active)
        if needed:
            kw[kwarg] = (_take(tables[name], it, model.n_items, mesh)
                         if name in tables else
                         torch.zeros((B, dim), dtype=torch.float32,
                                     device=it.device))
    return kw


def _classification_sums(preds: torch.Tensor, labels: torch.Tensor,
                         weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted tp/fp/fn/correct/count sums at threshold 0.5."""
    hard = (preds > 0.5).float()
    pos = labels > 0.5
    return {
        'correct': (weight * (hard == labels)).sum(),
        'tp': (weight * ((hard == 1) & pos)).sum(),
        'fp': (weight * ((hard == 1) & ~pos)).sum(),
        'fn': (weight * ((hard == 0) & pos)).sum(),
        'count': weight.sum(),
    }


_METRIC_NAMES = ('total_loss', 'bce_loss', 'contrastive_loss', 'correct',
                 'tp', 'fp', 'fn', 'count')


def step_metrics(scores: torch.Tensor, loss: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's metrics: the three losses and the classification sums."""
    weight = batch.get('weight', torch.ones_like(batch['label']))
    return {'total_loss': loss['total'].detach(),
            'bce_loss': loss['bce'].detach(),
            'contrastive_loss': loss['contrastive'].detach(),
            **_classification_sums(scores.squeeze(-1).detach(),
                                   batch['label'], weight)}


def _local_metrics(scores, loss, batch) -> torch.Tensor:
    """This rank's parts of a meshed step's metrics, and a last entry 1.0
    where its predictions are not all finite."""
    m = step_metrics(scores, loss, batch)
    bad = (~torch.isfinite(scores.detach()).all()).float()
    return torch.stack([m[k].float() for k in _METRIC_NAMES] + [bad])


def _global_metrics(summed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The metrics of the global batch from their parts summed over
    'data': the contrastive loss is 0 where any rank's predictions were
    not finite, as one process's is."""
    m = dict(zip(_METRIC_NAMES, summed[:len(_METRIC_NAMES)].unbind()))
    m['contrastive_loss'] = torch.where(summed[-1] > 0, torch.zeros_like(
        m['contrastive_loss']), m['contrastive_loss'])
    return m


def reduced_metrics(scores: torch.Tensor, loss: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor],
                    mesh=None) -> Dict[str, torch.Tensor]:
    """``step_metrics``, over the global batch when ``mesh`` splits it
    over 'data' (the loss parts and sums summed over 'data', one
    all-reduce)."""
    mesh = data_mesh(mesh)
    if mesh is None:
        return step_metrics(scores, loss, batch)
    return _global_metrics(all_reduce(
        mesh, DATA_AXIS, _local_metrics(scores, loss, batch), op='sum'))


def gated_train_update(state: 'TrainState', forward: Callable[[], tuple],
                       batch: Dict[str, torch.Tensor],
                       mesh=None) -> Dict[str, torch.Tensor]:
    """Run ``forward() -> (scores, loss)`` in training mode and take one
    update on the gradients of ``loss['total']`` for the optimizer's
    parameters, where that loss is finite; where it is not, the
    parameters, the optimizer state and the BatchNorm statistics the
    forward moved stay as they were, with no host round trip. Returns the
    step's metrics (``step_metrics``). With a ``mesh`` splitting the batch
    over 'data', ``loss`` is this rank's part: the flat gradient and the
    metrics' parts are summed over 'data' in one all-reduce, and the
    global loss decides."""
    mesh = data_mesh(mesh)
    stats = list(state.batch_stats.values())
    saved = [b.clone() for b in stats]
    state.model.train()
    scores, loss = forward()
    grads = torch.autograd.grad(loss['total'], state.opt_state.params,
                                allow_unused=True)
    g = state.tx.flat_grads(state.opt_state, grads)
    if mesh is None:
        metrics = step_metrics(scores, loss, batch)
    else:
        n = g.numel()
        summed = all_reduce(mesh, DATA_AXIS, torch.cat(
            [g, _local_metrics(scores, loss, batch)]), op='sum')
        g, metrics = summed[:n], _global_metrics(summed[n:])
    finite = torch.isfinite(metrics['total_loss'])
    state.tx.update(state.opt_state, g, finite)
    with torch.no_grad():
        for b, s in zip(stats, saved):
            b.copy_(torch.where(finite, b, s))
        state.step.add_(finite.long())
    return metrics


def _stack(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_step_fns(model, tables: Dict[str, torch.Tensor],
                  bce_weight: float = 1.0,
                  contrastive_weight: float = 0.1,
                  use_contrastive: Optional[bool] = None,
                  extra_features_fn: Optional[Callable] = None,
                  return_epoch_fns: bool = False, mesh=None):
    """(train_step, eval_step) over ``model`` and its feature ``tables``
    (tensors on the model's device); with ``return_epoch_fns`` also
    (train_epoch, eval_epoch), which run a whole epoch of stacked batches
    and return the per-batch metrics stacked ([num_batches] each).

    ``train_step(state, batch, generator)`` -> (state, metrics);
    ``eval_step(state, batch)`` -> metrics; ``train_epoch(state, batches,
    generator)`` -> (state, metrics); ``eval_epoch(state, batches)`` ->
    metrics. A batch holds ``user_idx``, ``item_idx``, ``tag_idx``,
    ``label`` and optionally ``weight`` (0/1 per row); ``batches`` the same
    with a leading batch axis. ``extra_features_fn(batch) -> kwargs`` adds
    or replaces features (default: the table gathers alone).

    With a ``mesh`` each batch is this rank's rows of the global batch
    (``parallel/mesh.batch_sharding``; ``batches``: axis 1), and the
    metrics are the global batch's on every rank (module docstring); the
    tables may be whole or this rank's rows of the item axis split over
    'model' (``item_table_sharding``), told apart by their row count
    (``gather_feature_kwargs``).
    """
    contrastive = (model.contrastive_active if use_contrastive is None
                   else use_contrastive and model.contrastive_active)
    device = model.device
    split = data_mesh(mesh)

    def forward(batch, generator):
        kw = gather_feature_kwargs(model, tables, batch, mesh)
        if extra_features_fn is not None:
            kw.update(extra_features_fn(batch))
        with data_parallel(split, batch['item_idx'].shape[0]):
            out = model(batch['user_idx'], batch['item_idx'],
                        batch['tag_idx'], return_embeddings=contrastive,
                        generator=generator, **kw)
        if contrastive:
            scores, vis_c, txt_c, _ = out
        else:
            scores, vis_c, txt_c = out, None, None
        temp = (model.temperature if contrastive
                and hasattr(model, 'temperature')
                else model.contrastive_temperature)
        loss = recommender_loss(
            scores.squeeze(-1), batch['label'], vis_c, txt_c, temp,
            use_contrastive=contrastive,
            contrastive_weight=contrastive_weight, bce_weight=bce_weight,
            weight=batch.get('weight'), mesh=split)
        return scores, loss

    def on_device(batch):
        return {k: v.to(device) for k, v in batch.items()}

    def train_step(state: TrainState, batch, generator=None):
        batch = on_device(batch)
        metrics = gated_train_update(
            state, lambda: forward(batch, generator), batch, split)
        return state, metrics

    def eval_step(state: TrainState, batch):
        batch = on_device(batch)
        model.eval()
        with torch.no_grad():
            scores, loss = forward(batch, None)
            return reduced_metrics(scores, loss, batch, split)

    def train_epoch(state: TrainState, batches, generator=None):
        batches = on_device(batches)
        n = batches['item_idx'].shape[0]
        metrics = []
        for i in range(n):
            state, m = train_step(state, {k: v[i] for k, v in
                                          batches.items()}, generator)
            metrics.append(m)
        return state, _stack(metrics)

    def eval_epoch(state: TrainState, batches):
        batches = on_device(batches)
        n = batches['item_idx'].shape[0]
        return _stack([eval_step(state, {k: v[i] for k, v in
                                         batches.items()})
                       for i in range(n)])

    fns = (train_step, eval_step, train_epoch, eval_epoch)
    return fns if return_epoch_fns else fns[:2]


def init_train_state(model, tx: Optimizer) -> TrainState:
    """The train state of a built model (its parameters come from the
    model's own generator, where JAX's ``init_train_state`` initializes
    them from a key): ``tx`` bound to the model's parameters on the
    model's device."""
    return TrainState.create(model=model, tx=tx)
