# pixelrec_multimodal_tpu_torch/training/trainer.py
"""Host-side training orchestration.

Counterpart of ``pixelrec_multimodal_tpu/training/trainer.py``: the epoch
loop, metric bookkeeping, early stopping on a configured metric and
direction, best and last checkpoints each epoch, the LR scheduler and
wandb-gated logging, over the train and eval steps of ``training/steps.py``
on the model's device. The host shuffles indices, feeds batches, reads the
metrics (once per epoch on the default whole-epoch path) and makes the
decisions between epochs.

Kept from the JAX package: the epoch bookkeeping (the loop runs from
``self.epoch``, which a checkpoint restores to the epoch it was written
in), the non-finite batch accounting, the checkpoint directory contract
and ``meta.json``'s fields.

Divergences kept on purpose:

* dropout draws from a ``torch.Generator`` on the model's device, seeded
  from ``seed + 1`` and the epoch at the start of each epoch, so both epoch
  paths draw the same masks and an epoch's masks do not depend on what
  ran before it; its masks are not JAX's;
* ``load_checkpoint`` restores the weights. JAX's, called before
  ``train()`` (as its train script does for a resume), keeps the restored
  arrays aside and ``train()`` starts from fresh ones. Here parameters and
  BatchNorm statistics are copied into the model at once, and the
  optimizer state, the step count and the scheduler's state as soon as
  ``train()`` builds the optimizer and the scheduler, so a resumed run
  continues as the trainer that wrote the checkpoint would.

Each epoch's host seconds, split into batching, training, validation and
checkpoint writes, go to ``epoch_seconds``.

With a ``mesh`` (``parallel/mesh.py``) the trainer is data-parallel with
replicated state, as JAX's: each rank takes its rows of every batch (the
stacked batches sliced on axis 1, the per-batch ones through the loader),
the tables are whole on every rank, and the steps compute the global
batch's function, their metrics summed over 'data'. Every rank reads the
same metrics, so early stopping, the scheduler and the non-finite
accounting decide alike; rank 0 alone writes ``state.pt`` and
``meta.json`` and the others wait at a barrier. The model axis is idle
(its ranks compute alike); tensor parallelism is the steps' and
``parallel/tensor_parallel.py``'s, not the trainer's. A 1x1 mesh runs the
single-process trainer. Kept on purpose: the rank 0 writes (JAX's Orbax
checkpoint is written by every process) and dropout's generator drawing
the global batch's masks with each rank keeping its rows.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import PrefetchLoader
from ..parallel.mesh import batch_sharding
from ..utils.checkpointing import (
    load_checkpoint,
    load_model_state,
    save_checkpoint,
)
from ..utils.logging import maybe_wandb_log, maybe_wandb_save_checkpoint
from .optimizers import (
    LRScheduler,
    build_optimizer,
    get_learning_rate,
    set_learning_rate,
)
from .steps import TrainState, init_train_state, make_step_fns

_METRIC_KEYS = ('total_loss', 'bce_loss', 'contrastive_loss', 'accuracy',
                'precision', 'recall', 'f1_score')
_LOSS_KEYS = ('total_loss', 'bce_loss', 'contrastive_loss')
_SUM_KEYS = ('correct', 'tp', 'fp', 'fn', 'count')
# The optimizer state's tensors a checkpoint holds, by OptState field.
_OPT_FIELDS = ('lr', 'count', 'mu', 'nu', 'trace', 'mini_step',
               'gradient_step', 'acc')


def _finalize_epoch_metrics(loss_sums: Dict[str, float], valid_batches: int,
                            sums: Dict[str, float]) -> Dict[str, float]:
    """Batch-mean losses + epochwise precision/recall/F1 from count sums."""
    nb = max(valid_batches, 1) if valid_batches else None
    tp, fp, fn = sums['tp'], sums['fp'], sums['fn']
    count = sums['count']
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return {
        'total_loss': loss_sums['total_loss'] / nb if nb else float('nan'),
        'bce_loss': loss_sums['bce_loss'] / nb if nb else float('nan'),
        'contrastive_loss': loss_sums['contrastive_loss'] / nb if nb else float('nan'),
        'accuracy': sums['correct'] / count if count > 0 else 0.0,
        'precision': precision,
        'recall': recall,
        'f1_score': f1,
    }


def train_state_tensors(state: TrainState) -> Dict[str, Any]:
    """The train state as the checkpoint holds it: parameters and
    BatchNorm statistics by state-dict name, the optimizer state by field
    (its tensors flat in the order of ``names``), the step."""
    opt = state.opt_state
    return {
        'params': dict(state.model.named_parameters()),
        'batch_stats': state.batch_stats,
        'opt_state': {'names': list(opt.names),
                      **{f: getattr(opt, f) for f in _OPT_FIELDS
                         if getattr(opt, f) is not None}},
        'step': state.step,
    }


@torch.no_grad()
def restore_optimizer(state: TrainState, saved: Dict[str, Any]):
    """Copy a checkpoint's optimizer state and step (``saved``: its
    state) into ``state``, in place; raises where they were written for
    another optimizer or other parameters."""
    opt = state.opt_state
    fields = saved['opt_state']
    if list(fields['names']) != list(opt.names):
        raise ValueError('the checkpoint was written for other trainable '
                         'parameters than this optimizer holds')
    for field in _OPT_FIELDS:
        mine = getattr(opt, field)
        if (field in fields) != (mine is not None):
            raise ValueError(f'the checkpoint\'s optimizer state does not '
                             f'match this optimizer (field {field!r})')
        if mine is not None:
            mine.copy_(fields[field])
    state.step.copy_(saved['step'])


def epoch_seed(seed: int, epoch: int) -> int:
    """The dropout generator's seed for ``epoch`` of a trainer seeded
    ``seed``: one stream per (seed + 1, epoch)."""
    return int(np.random.SeedSequence([seed + 1, epoch]).generate_state(
        1, np.uint64)[0])


class Trainer:
    """Drives the train and eval steps over a MultimodalDataset."""

    def __init__(self, model, config=None,
                 checkpoint_dir: str = 'models/checkpoints',
                 use_contrastive: bool = True,
                 trial_info: Optional[Dict[str, Any]] = None,
                 mesh=None, seed: int = 0, compiled_epochs: bool = True):
        self.model = model
        self.config = config
        self.mesh = mesh
        self.seed = seed
        self.base_checkpoint_dir = Path(checkpoint_dir)
        if config is not None and hasattr(config, 'model'):
            combo = f"{config.model.vision_model}_{config.model.language_model}"
            self.model_checkpoint_dir = self.base_checkpoint_dir / combo
        else:
            self.model_checkpoint_dir = self.base_checkpoint_dir
            print("Warning: No model config provided to Trainer. "
                  "Using base checkpoint directory.")
        self.encoders_dir = self.base_checkpoint_dir / 'encoders'
        self.model_checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.encoders_dir.mkdir(parents=True, exist_ok=True)
        print("Trainer initialized:")
        print(f"  → Model checkpoints: {self.model_checkpoint_dir}")
        print(f"  → Shared encoders: {self.encoders_dir}")

        self.use_contrastive = use_contrastive
        self.trial_info = trial_info
        # Whole-epoch calls (train_epoch / eval_epoch over stacked batches,
        # one metrics transfer an epoch) or one step a batch through the
        # prefetching loader.
        self.compiled_epochs = compiled_epochs
        self.epoch = 0
        self.patience_counter = 0
        self.best_early_stopping_score: Optional[float] = None
        self.state: Optional[TrainState] = None
        self.scheduler: Optional[LRScheduler] = None
        self.training_history: Dict[str, Any] = {
            'train_losses': [], 'val_losses': [],
            'train_metrics': [], 'val_metrics': [], 'best_metrics': {},
        }
        self.epoch_seconds: List[Dict[str, float]] = []
        # A checkpoint's optimizer state and step, and its scheduler state,
        # restored before train() built the optimizer and the scheduler.
        self._pending_opt: Optional[Dict[str, Any]] = None
        self._pending_scheduler: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ train
    def train(self, train_dataset, val_dataset, epochs: int = 10,
              lr: float = 0.001, weight_decay: float = 0.01, patience: int = 3,
              gradient_clip: float = 1.0, optimizer_type: str = 'adamw',
              adam_beta1: float = 0.9, adam_beta2: float = 0.999,
              adam_eps: float = 1e-8, use_lr_scheduler: bool = True,
              lr_scheduler_type: str = 'reduce_on_plateau',
              lr_scheduler_patience: int = 2, lr_scheduler_factor: float = 0.5,
              lr_scheduler_min_lr: float = 1e-6,
              batch_size: int = 64,
              gradient_accumulation_steps: int = 1,
              ) -> Tuple[List[float], List[float]]:
        """Run the epoch loop; returns (train_losses, val_losses)."""
        tx = build_optimizer(optimizer_type, lr, weight_decay, adam_beta1,
                             adam_beta2, adam_eps, gradient_clip,
                             gradient_accumulation_steps)
        if self.state is None:
            self.state = init_train_state(self.model, tx)
        if self._pending_opt is not None:
            restore_optimizer(self.state, self._pending_opt)
            self._pending_opt = None
        if use_lr_scheduler:
            self.scheduler = LRScheduler(
                lr_scheduler_type, base_lr=lr, patience=lr_scheduler_patience,
                factor=lr_scheduler_factor, min_lr=lr_scheduler_min_lr,
                total_epochs=epochs)
            if self._pending_scheduler is not None:
                self.scheduler.load_state_dict(self._pending_scheduler)
        self._pending_scheduler = None

        # One packed float table (one row gather a batch), in bf16 for a
        # bf16 model: its first Dense casts the rows to bf16 anyway.
        device = self.model.device
        table_dtype = (torch.bfloat16 if self.model.dtype == torch.bfloat16
                       else None)
        tables = train_dataset.feature_store.device_tables(
            device=device, pack=True, dtype=table_dtype, mesh=self.mesh)
        cw = bw = None
        if self.config is not None:
            cw = self.config.training.contrastive_weight
            bw = self.config.training.bce_weight
        train_step, eval_step, train_epoch, eval_epoch = make_step_fns(
            self.model, tables,
            bce_weight=1.0 if bw is None else bw,
            contrastive_weight=0.1 if cw is None else cw,
            use_contrastive=self.use_contrastive,
            return_epoch_fns=True, mesh=self.mesh)
        self._eval_step = eval_step
        self._train_epoch_fn = train_epoch if self.compiled_epochs else None
        self._eval_epoch_fn = eval_epoch if self.compiled_epochs else None

        train_losses: List[float] = []
        val_losses: List[float] = []
        dropout = torch.Generator(device=device)

        for epoch_num in range(self.epoch, epochs):
            self.epoch = epoch_num
            seconds = {'batching': 0.0, 'train': 0.0, 'validation': 0.0,
                       'checkpoint': 0.0}
            self.epoch_seconds.append(seconds)

            dropout.manual_seed(epoch_seed(self.seed, epoch_num))
            train_metrics = self._run_epoch(
                train_step, train_dataset, batch_size, epoch_num, dropout,
                training=True)
            self.training_history['train_metrics'].append(train_metrics)
            self.training_history['train_losses'].append(
                train_metrics['total_loss'])
            train_losses.append(train_metrics['total_loss'])

            validated = False
            if val_dataset is not None and len(val_dataset) > 0:
                val_metrics = self._run_epoch(
                    eval_step, val_dataset, batch_size, epoch_num, None,
                    training=False)
                validated = not math.isnan(val_metrics['total_loss'])
                val_losses.append(val_metrics['total_loss'])
                if validated:
                    self.training_history['val_metrics'].append(val_metrics)
                    self.training_history['val_losses'].append(
                        val_metrics['total_loss'])
                    self._update_best_metrics(val_metrics)
            else:
                print(f"Epoch {self.epoch + 1}: Validation skipped "
                      "(no validation data).")
                val_metrics = {k: (float('nan') if 'loss' in k else 0.0)
                               for k in _METRIC_KEYS}
                val_losses.append(float('nan'))

            maybe_wandb_log(train_metrics, val_metrics, self.epoch,
                            self.get_learning_rate())

            # Plateau steps on validated epochs only; the others every epoch.
            if self.scheduler is not None:
                if self.scheduler.kind == 'reduce_on_plateau':
                    if validated:
                        new_lr = self.scheduler.step(val_metrics['total_loss'])
                        self._apply_lr(new_lr)
                else:
                    self._apply_lr(self.scheduler.step())

            if self.best_early_stopping_score is None and validated:
                direction = self._direction()
                self.best_early_stopping_score = (
                    float('inf') if direction == 'minimize' else float('-inf'))

            if validated:
                score = self._early_stopping_score(val_metrics)
                if score is not None and not math.isnan(score):
                    if self._check_early_stopping(score, patience):
                        print(f"Early stopping at epoch {self.epoch + 1} "
                              f"based on {self._monitor_name()}")
                        self.save_checkpoint('last_model')
                        break

            self.save_checkpoint('last_model')
            self._print_epoch_summary(epoch_num, epochs, train_metrics,
                                      val_metrics)

        return train_losses, val_losses

    # ------------------------------------------------------------ inner loops
    def _run_epoch(self, step_fn, dataset, batch_size: int, epoch: int,
                   generator, training: bool) -> Dict[str, float]:
        epoch_fn = self._train_epoch_fn if training else self._eval_epoch_fn
        if epoch_fn is not None:
            return self._run_epoch_compiled(epoch_fn, dataset, batch_size,
                                            epoch, generator, training)
        seconds = self.epoch_seconds[-1]
        phase = 'train' if training else 'validation'
        loss_sums = {k: 0.0 for k in _LOSS_KEYS}
        sums = {k: 0.0 for k in _SUM_KEYS}
        valid_batches = 0
        loader = iter(PrefetchLoader(
            dataset.batches(batch_size, shuffle=training,
                            seed=self.seed + epoch),
            prefetch=2, device=self.model.device, mesh=self.mesh))
        bidx = 0
        while True:
            t0 = time.perf_counter()
            batch = next(loader, None)
            t1 = time.perf_counter()
            seconds['batching'] += t1 - t0
            if batch is None:
                break
            if training:
                self.state, metrics = step_fn(self.state, batch, generator)
            else:
                metrics = step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            seconds[phase] += time.perf_counter() - t1
            if math.isfinite(metrics['total_loss']):
                for k in loss_sums:
                    loss_sums[k] += metrics[k]
                valid_batches += 1
                for k in sums:
                    sums[k] += metrics[k]
            else:
                print(f"WARNING: Skipping metrics for batch {bidx} due to "
                      "non-finite loss (NaN or Inf).")
                sums['count'] += metrics['count']
            bidx += 1
        return _finalize_epoch_metrics(loss_sums, valid_batches, sums)

    def _run_epoch_compiled(self, epoch_fn, dataset, batch_size: int,
                            epoch: int, generator, training: bool
                            ) -> Dict[str, float]:
        """One call for the whole epoch; one metrics transfer."""
        seconds = self.epoch_seconds[-1]
        t0 = time.perf_counter()
        stacked = dataset.stacked_batches(batch_size, shuffle=training,
                                          seed=self.seed + epoch)
        if self.mesh is not None:
            # The leading axis is the batch count; the rows are axis 1.
            rows = batch_sharding(self.mesh, batch_size)
            stacked = {k: v[:, rows] for k, v in stacked.items()}
        device = self.model.device
        stacked = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in stacked.items()}
        t1 = time.perf_counter()
        seconds['batching'] += t1 - t0
        if training:
            self.state, metrics = epoch_fn(self.state, stacked, generator)
        else:
            metrics = epoch_fn(self.state, stacked)
        names = list(metrics)
        host = torch.stack([metrics[k].float() for k in names]).cpu().numpy()
        seconds['train' if training else 'validation'] += \
            time.perf_counter() - t1
        metrics = dict(zip(names, host))

        # Reproduce per-batch accounting: skip non-finite batches.
        finite = np.isfinite(metrics['total_loss'])
        n_valid = int(finite.sum())
        if n_valid < len(finite):
            print(f"WARNING: {len(finite) - n_valid} batches skipped due to "
                  "non-finite loss (NaN or Inf).")
        loss_sums = {k: float(metrics[k][finite].sum()) for k in _LOSS_KEYS}
        sums = {k: float(metrics[k][finite].sum()) for k in _SUM_KEYS}
        sums['count'] += float(metrics['count'][~finite].sum())
        return _finalize_epoch_metrics(loss_sums, n_valid, sums)

    # --------------------------------------------------------- early stopping
    def _monitor_name(self) -> str:
        if self.config is not None:
            return self.config.training.early_stopping_metric
        return 'val_loss'

    def _direction(self) -> str:
        if self.config is not None:
            return self.config.training.early_stopping_direction
        return 'minimize'

    def _early_stopping_score(self, val_metrics: Dict[str, float]
                              ) -> Optional[float]:
        """The configured metric in the val dict ('val_' stripped, 'loss'
        -> 'total_loss'; the val loss when it is not there)."""
        key = self._monitor_name().replace('val_', '')
        if key == 'loss':
            key = 'total_loss'
        score = val_metrics.get(key)
        if score is None:
            print(f"Warning: Early stopping metric '{self._monitor_name()}' "
                  f"(lookup key: '{key}') not found. Defaulting to val_loss.")
            score = val_metrics.get('total_loss')
            if self.config is not None:
                self.config.training.early_stopping_direction = 'minimize'
        return score

    def _check_early_stopping(self, score: float, patience: int) -> bool:
        if math.isnan(score):
            print("Warning: Early stopping score is NaN. "
                  "Skipping check for this epoch.")
            return False
        if self._direction() == 'minimize':
            improved = score < self.best_early_stopping_score
        else:
            improved = score > self.best_early_stopping_score
        if improved:
            self.best_early_stopping_score = score
            self.patience_counter = 0
            self.save_checkpoint('best_model', is_best=True)
            return False
        self.patience_counter += 1
        return self.patience_counter >= patience

    def _update_best_metrics(self, val_metrics: Dict[str, float]):
        best = self.training_history['best_metrics']
        for key, value in val_metrics.items():
            name = f'val_{key}'
            if name not in best:
                best[name] = value
            elif 'loss' in key:
                best[name] = min(best[name], value)
            else:
                best[name] = max(best[name], value)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, filename: str, is_best: bool = False,
                        additional_info: Optional[Dict[str, Any]] = None):
        """Persist the train state and its metadata."""
        if self.state is None:
            return
        t0 = time.perf_counter()
        meta = {
            'epoch': self.epoch,
            'best_early_stopping_score': self.best_early_stopping_score,
            'early_stopping_metric': self._monitor_name(),
            'early_stopping_direction': self._direction(),
            'training_history': self.training_history,
            'best_metrics': self.get_all_best_metrics(),
            'scheduler_state': (self.scheduler.state_dict()
                                if self.scheduler else None),
        }
        if self.config is not None:
            meta['model_config'] = {
                'vision_model': self.config.model.vision_model,
                'language_model': self.config.model.language_model,
            }
        if self.trial_info:
            meta['trial_info'] = self.trial_info
        if additional_info:
            meta['additional_info'] = additional_info
        path = save_checkpoint(self.model_checkpoint_dir, filename,
                               train_state_tensors(self.state), meta,
                               mesh=self.mesh)
        if self.epoch_seconds:
            self.epoch_seconds[-1]['checkpoint'] += time.perf_counter() - t0
        if is_best:
            print(f"Saved best model checkpoint to {path}")
            maybe_wandb_save_checkpoint(path)

    def load_checkpoint(self, filename: str):
        """Restore the train state and its metadata: parameters and
        BatchNorm statistics into the model at once; the optimizer state,
        the step and the scheduler's state at once if train() has built
        them, else when it does."""
        restored = load_checkpoint(self.model_checkpoint_dir, filename,
                                   device=self.model.device)
        if restored is None:
            print(f"Warning: Checkpoint file not found at "
                  f"{self.model_checkpoint_dir / filename}")
            return
        state, meta = restored['state'], restored['meta']
        load_model_state(self.model, state)
        if self.state is not None:
            restore_optimizer(self.state, state)
        else:
            self._pending_opt = {'opt_state': state['opt_state'],
                                 'step': state['step']}
        self.epoch = meta.get('epoch', 0)
        self.best_early_stopping_score = meta.get(
            'best_early_stopping_score', meta.get('best_val_loss'))
        if 'training_history' in meta:
            self.training_history = meta['training_history']
        if 'trial_info' in meta:
            self.trial_info = meta['trial_info']
        if meta.get('scheduler_state'):
            if self.scheduler is not None:
                self.scheduler.load_state_dict(meta['scheduler_state'])
            self._pending_scheduler = meta['scheduler_state']
        print(f"Loaded checkpoint from {self.model_checkpoint_dir / filename} "
              f"(epoch {self.epoch})")

    # ----------------------------------------------------------------- helpers
    def _apply_lr(self, lr: float):
        set_learning_rate(self.state.opt_state, lr)

    def get_learning_rate(self) -> float:
        if self.state is None:
            return 0.0
        return get_learning_rate(self.state.opt_state)

    def get_model_checkpoint_dir(self) -> Path:
        return self.model_checkpoint_dir

    def get_encoders_dir(self) -> Path:
        return self.encoders_dir

    def get_best_metric(self, metric_name: str = 'val_loss') -> float:
        """Best value seen for a metric."""
        best = self.training_history['best_metrics']
        if metric_name in best:
            return best[metric_name]
        for prefix, hist_key in (('val_', 'val_metrics'),
                                 ('train_', 'train_metrics')):
            if metric_name.startswith(prefix):
                key = metric_name[len(prefix):]
                rows = self.training_history[hist_key]
                values = [m.get(key) for m in rows if key in m]
                if values:
                    return (min(values) if 'loss' in metric_name
                            else max(values))
        return float('inf') if 'loss' in metric_name else float('-inf')

    def get_all_best_metrics(self) -> Dict[str, float]:
        out = {}
        for name in ('total_loss', 'bce_loss', 'contrastive_loss', 'accuracy',
                     'f1_score', 'precision', 'recall'):
            v = self.get_best_metric(f'val_{name}')
            if math.isfinite(v):
                out[f'val_{name}'] = v
        for name in ('total_loss', 'bce_loss', 'contrastive_loss', 'accuracy',
                     'f1_score'):
            v = self.get_best_metric(f'train_{name}')
            if math.isfinite(v):
                out[f'train_{name}'] = v
        return out

    def get_trial_number(self) -> Optional[int]:
        if self.trial_info and 'trial_number' in self.trial_info:
            return self.trial_info['trial_number']
        return None

    def update_trial_info(self, info: Dict[str, Any]):
        if self.trial_info is None:
            self.trial_info = {}
        self.trial_info.update(info)

    def _print_epoch_summary(self, epoch: int, total_epochs: int,
                             train_metrics, val_metrics):
        def fmt(x):
            return f"{x:.4f}" if isinstance(x, float) and math.isfinite(x) else "N/A"
        print(f"\nEpoch {epoch + 1}/{total_epochs}")
        print(f"Train Loss: {fmt(train_metrics['total_loss'])} "
              f"(BCE: {fmt(train_metrics['bce_loss'])}, "
              f"Contrastive: {fmt(train_metrics['contrastive_loss'])})")
        print(f"Train Acc: {fmt(train_metrics['accuracy'])} | "
              f"Train F1: {fmt(train_metrics['f1_score'])}")
        print(f"Val Loss: {fmt(val_metrics['total_loss'])} "
              f"(BCE: {fmt(val_metrics['bce_loss'])}, "
              f"Contrastive: {fmt(val_metrics['contrastive_loss'])})")
        print(f"Val Acc: {fmt(val_metrics['accuracy'])} | "
              f"Val F1: {fmt(val_metrics['f1_score'])}")
        print(f"Learning Rate: {self.get_learning_rate():.6f}")
        print("-" * 50)
