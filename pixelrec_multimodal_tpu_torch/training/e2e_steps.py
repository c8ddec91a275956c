"""Train and eval steps of the end-to-end (unfrozen encoder) path, in
PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/training/e2e_steps.py`` for
``models/end_to_end.EndToEndRecommender``: batches carry raw pixels and
tokens (``MultimodalDataset.batches(include_raw=...)``), the images are
augmented on their device (``ops/augment.py``) inside the train step, and
freezing is the optimizer's (``training/optimizers.with_frozen``).

The steps share ``training/steps.py``'s update (``gated_train_update``: a
``TrainState`` updated in place, the flat-buffer ``Optimizer``, the update
gated on the device by the loss's finiteness, so a skipped step leaves
the parameters, the optimizer state and the scorer's BatchNorm
statistics as they were) and its metrics (``reduced_metrics``: the
classification sums at 0.5). Gradients are taken for the trainable
parameters only, and ``init_e2e_train_state`` turns ``requires_grad``
off for the others, so a frozen tower's forward builds no graph and the
backward never enters it; JAX computes those gradients and masks them,
which gives the same update. Dropout and augmentation draw from the
``torch.Generator`` the caller passes (augmentation first), seeded per
step by the caller, where JAX folds a key.

With a ``mesh`` (``parallel/mesh.py``) a batch is this rank's rows of a
global batch split over 'data', and the step computes the function of the
global batch as ``training/steps.py``'s meshed step does: the
augmentation's draws are made for the global batch and each rank keeps
its rows, so are dropout's masks, and the flat gradient is summed over
'data' once a step. The towers' and the scorer's parameters may be
sharded over 'model' (``parallel/tensor_parallel.shard_module``, before
``init_e2e_train_state``); remat recomputes a tower's collectives with it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import ImageAugmentationConfig
from ..models.losses import recommender_loss
from ..ops.augment import augment_batch, augment_draws
from ..parallel.mesh import DATA_AXIS, data_mesh, data_parallel
from .optimizers import Optimizer
from .steps import TrainState, gated_train_update, reduced_metrics

RAW_INPUTS = ('image', 'text_input_ids', 'text_attention_mask',
              'clip_text_input_ids', 'clip_text_attention_mask')


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == 'cuda':
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def global_draws(generator: torch.Generator, images: torch.Tensor,
                 config: ImageAugmentationConfig, mesh) -> dict:
    """The augmentation's draws for the global batch of which ``images``
    are this rank's rows (split over 'data'), cut to those rows: each
    per-image draw keeps the rank's rows, a batch-wide one (the blur's
    sigma) stays whole."""
    b = images.shape[0]
    total = b * mesh.shape[DATA_AXIS]
    rows = slice(mesh.index(DATA_AXIS) * b, (mesh.index(DATA_AXIS) + 1) * b)
    draws = augment_draws(generator, (total,) + tuple(images.shape[1:]),
                          config)
    return {op: {k: v[rows] if v.dim() and v.shape[0] == total else v
                 for k, v in d.items()} for op, d in draws.items()}


def make_e2e_step_fns(model, tables: Dict[str, torch.Tensor],
                      bce_weight: float = 1.0,
                      contrastive_weight: float = 0.1,
                      augmentation_config: Optional[ImageAugmentationConfig]
                      = None, mesh=None):
    """(train_step, eval_step) for an ``EndToEndRecommender`` whose
    ``tables`` (tensors on the model's device) may hold 'numerical'.

    ``train_step(state, batch, generator=None, draws=None)`` -> (state,
    metrics); ``eval_step(state, batch)`` -> metrics. A batch holds
    ``user_idx``, ``item_idx``, ``tag_idx``, ``label``, optionally
    ``weight`` and the raw inputs of the towers (``image``,
    ``text_input_ids``, ...). ``draws`` (``ops/augment.augment_draws``)
    replaces the augmentation's own; ``generator`` None means the
    device's default one. With a ``mesh`` the batch is this rank's rows
    and ``draws``, when given, this rank's rows of the global draws.
    """
    scorer = model.scorer
    contrastive = scorer.contrastive_active
    device = model.device
    augment = augmentation_config is not None and augmentation_config.enabled
    split = data_mesh(mesh)

    def forward(batch, train, generator=None, draws=None):
        it = batch['item_idx'].long()
        kw = {k: batch[k] for k in RAW_INPUTS if k in batch}
        if scorer.num_numerical_features > 0:
            kw['numerical_features'] = (
                torch.index_select(tables['numerical'], 0, it)
                if 'numerical' in tables else
                torch.zeros((it.shape[0], scorer.num_numerical_features),
                            dtype=torch.float32, device=it.device))
        if train and augment and 'image' in kw:
            if draws is None and split is not None:
                draws = global_draws(generator, kw['image'],
                                     augmentation_config, split)
            kw['image'] = augment_batch(generator, kw['image'],
                                        augmentation_config, draws)
        with data_parallel(split, it.shape[0]):
            out = model(batch['user_idx'], batch['item_idx'],
                        batch['tag_idx'], return_embeddings=contrastive,
                        generator=generator, **kw)
        if contrastive:
            scores, vis_c, txt_c, _ = out
        else:
            scores, vis_c, txt_c = out, None, None
        temp = (scorer.temperature if contrastive
                and hasattr(scorer, 'temperature')
                else scorer.contrastive_temperature)
        loss = recommender_loss(
            scores.squeeze(-1), batch['label'], vis_c, txt_c, temp,
            use_contrastive=contrastive,
            contrastive_weight=contrastive_weight, bce_weight=bce_weight,
            weight=batch.get('weight'), mesh=split)
        return scores, loss

    def on_device(batch):
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    def train_step(state: TrainState, batch, generator=None, draws=None):
        batch = on_device(batch)
        if generator is None:
            generator = _default_generator(device)
        metrics = gated_train_update(
            state, lambda: forward(batch, True, generator, draws), batch,
            split)
        return state, metrics

    def eval_step(state: TrainState, batch):
        batch = on_device(batch)
        model.eval()
        with torch.no_grad():
            scores, loss = forward(batch, False)
            return reduced_metrics(scores, loss, batch, split)

    return train_step, eval_step


def init_e2e_train_state(model, tx: Optimizer) -> TrainState:
    """The train state of a built end-to-end model: ``tx`` bound to its
    trainable parameters (``with_frozen``'s mask), and ``requires_grad``
    off for every other parameter. JAX's counterpart initializes the
    parameters from a key on dummy inputs; the port's model has its
    parameters from its build."""
    state = TrainState.create(model=model, tx=tx)
    trainable = set(state.opt_state.names)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    return state
