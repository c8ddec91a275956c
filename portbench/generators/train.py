"""The training traffic generator: the port's frozen-feature ``train_epoch``
(``training/steps.py:make_step_fns``) over stacked sets of batches, with
its AdamW (``training/optimizers.py``), as its Trainer calls it: one call
an epoch unit, the losses read on the host after each.

Set-up makes the weights, the item features (one packed table on the
card) and the users' histories from the seed, then a pool of batches on
the card: the histories' positives drawn uniformly, each with a negative of
the same user and a uniform item (``negative_sampling_ratio`` 1.0),
shuffled. It builds the one train state (model, optimizer state, step
functions) and makes the window's own first call with it: ``train_epoch``
over pool batches 0 to ``batches_per_call`` - 1, stacked, as every call of
the window is. While that call runs, the optimizer it steps with is
watched (``Watch``): after the first update the benchmark keeps a copy of
the optimizer's first moments (the first gradient as the optimizer took
it, after the clip, is ``mu / (1 - b1)``), after update ``check_steps`` a
copy of the parameters and running statistics; the call's own losses give
each step's. The window then goes on with that same state.

The check, once the window has closed and the program is freed: the plain
reference takes the same steps from the same weights, batches and dropout
masks (the same generator, drawn layer by layer) in float32, and the
readings are: the relative gap of each step's loss, the worst step
(``loss_gap``); for each parameter, the gap between the program's and the
reference's norm of the first gradient, over the larger of the reference's
norm of that leaf and of the median leaf, read at the median leaf
(``grad_gap_median``, steady from seed to seed), the worst leaf
(``grad_gap``, which swings with one small leaf, a late bias whose
gradient is a cancelling sum over the batch) and averaged over the leaves
(``grad_gap_mean``); the same gap of the change of each parameter and
running statistic over the steps, the worst leaf (``change_gap``),
leaving out parameters whose reference gradient is under a thousandth of
the median leaf's. The cell's file names the readings it compares.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import inputs
from ..reference.train import train_steps
from .common import Phases, free_device, port_model

# A parameter whose first reference gradient is under this share of the
# median leaf's moves under Adam by rounding alone: left out of the change.
STILL_LEAF = 1e-3


def packed_key(cfg: dict) -> str:
    """The port's key of the packed feature table (``PACKED_PREFIX``)."""
    names = {'vision': 'vision_emb', 'language': 'language_emb',
             'numerical': 'numerical'}
    return 'packed::' + '+'.join(
        f'{names[k]}={w}' for k, w in inputs.feature_widths(cfg).items())


def make_pool(cfg: dict, traffic: dict, tags: torch.Tensor, seed: int,
              device) -> Dict[str, torch.Tensor]:
    """``pool_batches`` batches of the configuration's training
    ``batch_size`` rows on ``device``."""
    indptr, items = inputs.make_histories(cfg, traffic['history'], seed,
                                          device)
    g = inputs.generator(seed, 'pool', device)
    batch = cfg['training']['batch_size']
    n = traffic['pool_batches'] * batch
    n_pos = n // 2
    owner = torch.repeat_interleave(
        torch.arange(cfg['n_users'], device=device, dtype=torch.int32),
        torch.from_numpy(np.diff(indptr)).to(device))
    hist = torch.from_numpy(items).to(device)
    entry = torch.randint(0, len(items), (n_pos,), generator=g, device=device)
    users = torch.cat([owner[entry], owner[entry]])
    negatives = torch.randint(0, cfg['n_items'], (n - n_pos,), generator=g,
                              device=device, dtype=torch.int32)
    item = torch.cat([hist[entry], negatives])
    label = torch.cat([torch.ones(n_pos, device=device),
                       torch.zeros(n - n_pos, device=device)])
    order = torch.randperm(n, generator=g, device=device)
    shape = (traffic['pool_batches'], batch)
    item = item[order].view(shape)
    return {'user_idx': users[order].view(shape),
            'item_idx': item,
            'tag_idx': tags[item.long()].to(torch.int32),
            'label': label[order].view(shape),
            'weight': torch.ones(shape, device=device)}


def take(pool: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in pool.items()}


class Watch:
    """The optimizer as ``train_epoch`` steps with it, unchanged, keeping a
    copy of the first moments after update 1 (``mu``) and of the model's
    parameters and running statistics after update ``last`` (``after``)."""

    def __init__(self, tx, model, last: int):
        self.tx, self.model, self.last = tx, model, last
        self.updates, self.mu, self.after = 0, None, None

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, opt_state, g, apply):
        self.tx.update(opt_state, g, apply)
        self.updates += 1
        if self.updates == 1:
            self.mu = opt_state.mu.clone()
        if self.updates == self.last:
            self.after = {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()
                          if not k.endswith('num_batches_tracked')}


class Traffic:
    unit = 'samples'

    def __init__(self, cell, seed: int, device,
                 options: Optional[dict] = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.options = options or {}
        self.per_call = self.traffic['batches_per_call']
        self.batch = self.cfg['training']['batch_size']
        self.calls = 0
        self.steps = 0
        self.losses = []

    def setup(self):
        from pixelrec_multimodal_tpu_torch.training import (
            build_optimizer,
            init_train_state,
            make_step_fns,
        )
        cfg, dev, t = self.cfg, self.device, self.cfg['training']
        self.phases = lap = Phases()
        self.weights = inputs.make_weights(cfg, self.seed, dev)
        self.feats = inputs.make_features(cfg, self.seed, dev)
        self.pool = make_pool(cfg, self.traffic, self.feats['tag'],
                              self.seed, dev)
        lap.lap('inputs')
        model = port_model(cfg, self.weights, dev)
        tx = build_optimizer(t['optimizer_type'], t['learning_rate'],
                             t['weight_decay'], t['adam_beta1'],
                             t['adam_beta2'], t['adam_eps'],
                             t['gradient_clip'])
        self.state = init_train_state(model, tx)
        _, _, self.train_epoch, _ = make_step_fns(
            model, {packed_key(cfg): self.feats['packed']},
            return_epoch_fns=True)
        self.dropout = inputs.generator(self.seed, 'dropout', dev)
        lap.lap('port_model')
        # The window's first call, watched for the check; it warms up too.
        n = self.traffic['check_steps']
        if not 1 <= n <= self.per_call:
            raise ValueError('check_steps must lie within the first call')
        watch = Watch(tx, model, n)
        self.state.tx = watch
        self.call()
        self.state.tx = tx
        self.program = {'losses': self.losses[0][:n].tolist(),
                        'mu': watch.mu, 'after': watch.after}
        self.steps = 0
        self.losses.clear()
        lap.lap('first_call')

    def prepare(self):
        pass

    def call(self) -> float:
        n = self.traffic['pool_batches'] // self.per_call
        lo = (self.calls % n) * self.per_call
        self.state, m = self.train_epoch(
            self.state, take(self.pool, lo, lo + self.per_call), self.dropout)
        self.losses.append(m['total_loss'].cpu().numpy())  # syncs
        self.calls += 1
        self.steps += self.per_call
        return float(self.per_call * self.batch)

    # -------------------------------------------------------------- check
    def program_leaves(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The program's first gradient and its state after the first
        steps, by state-dict name."""
        opt = self.state.opt_state
        b1 = self.cfg['training']['adam_beta1']
        grad1, off = {}, 0
        for name, p in zip(opt.names, opt.params):
            grad1[name] = self.program['mu'][off:off + p.numel()].view(
                p.shape) / (1 - b1)
            off += p.numel()
        return {'grad1': grad1, 'after': self.program['after']}

    def release(self):
        del self.state, self.train_epoch
        free_device(self.device)

    def readings(self) -> Dict[str, float]:
        skipped = int(sum((~np.isfinite(x)).sum() for x in self.losses))
        prog = self.program_leaves()
        self.release()
        n = self.traffic['check_steps']
        batches = [take(self.pool, s, s + 1) for s in range(n)]
        batches = [{k: v[0] for k, v in b.items()} for b in batches]
        ref = train_steps(self.cfg, self.weights, self.feats['packed'],
                          batches,
                          inputs.generator(self.seed, 'dropout', self.device))
        out = compare(self.weights, self.program['losses'], prog, ref)
        out.update(attempted=self.steps, failed=skipped)
        return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def compare(weights: Dict[str, torch.Tensor], losses, prog: dict,
            ref: dict) -> Dict[str, float]:
    """The check's readings (module docstring) of a program's ``losses``,
    ``prog['grad1']`` and ``prog['after']`` against the reference's."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, ref['losses']))
    g_ref = {k: _norm(v) for k, v in ref['grad1'].items()}
    g_med = float(np.median(list(g_ref.values())))
    grad_gaps = [abs(_norm(prog['grad1'][k]) - g) / max(g, g_med)
                 for k, g in g_ref.items()]
    moved = {k: v for k, v in ref['params'].items()
             if g_ref[k] >= STILL_LEAF * g_med}
    moved.update(ref['stats'])
    d_ref = {k: _norm(v - weights[k]) for k, v in moved.items()}
    d_med = float(np.median(list(d_ref.values())))
    change_gap = max(
        abs(_norm(prog['after'][k] - weights[k]) - d) / max(d, d_med)
        for k, d in d_ref.items())
    return {'loss_gap': loss_gap, 'grad_gap': max(grad_gaps),
            'grad_gap_median': float(np.median(grad_gaps)),
            'grad_gap_mean': float(np.mean(grad_gaps)),
            'change_gap': change_gap,
            'leaves_left_out': float(len(ref['params']) + len(ref['stats'])
                                     - len(moved))}
