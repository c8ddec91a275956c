"""The plain reference against the port's model, in float32 on the CPU at a
tiny size: the scores of every pair, and the training steps (the same
dropout masks from the same generator). The port run in its configured
bf16 fails the same comparison."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import inputs, spec
from portbench.generators.common import port_model
from portbench.generators.train import compare, make_pool, packed_key, take
from portbench.reference.model import Model, exact
from portbench.reference.train import train_steps

CELLS = {'concatenate': 'concat.topk-seen.u512',
         'gated': 'gated.topk-seen.u512'}
# float32 against float32 in another order of sums
SCORE_TOL = 2e-6
TRAIN_TOL = 1e-4


def tiny_config(cell: str, dtype: str) -> dict:
    cfg = copy.deepcopy(spec.cell(cell).config)
    cfg.update(n_users=64, n_items=256, compute_dtype=dtype)
    return cfg


def port_scores(cfg: dict, weights: dict, feats: dict, users: torch.Tensor
                ) -> torch.Tensor:
    model = port_model(cfg, weights, 'cpu')
    n = cfg['n_items']
    u = users.repeat_interleave(n)
    it = torch.arange(n).repeat(len(users))
    kw = {f'{k}_features': feats[k][it] for k in
          inputs.feature_widths(cfg)}
    with torch.no_grad():
        return model(u, it, feats['tag'][it], **kw).view(len(users), n)


def score_gap(fusion: str, dtype: str) -> float:
    cfg = tiny_config(CELLS[fusion], dtype)
    weights = inputs.make_weights(cfg, 2147483717, 'cpu')
    feats = inputs.make_features(cfg, 2147483717, 'cpu')
    users = torch.tensor([0, 5, 63])
    with exact():
        ref = Model(cfg, weights)
        want = ref.score_users(users, ref.catalog(feats), 1000)
        got = port_scores(cfg, weights, feats, users)
    return float((got - want).abs().max())


@pytest.mark.parametrize('fusion', sorted(CELLS))
def test_reference_scores_match_the_port_in_float32(fusion):
    assert score_gap(fusion, 'float32') <= SCORE_TOL


@pytest.mark.parametrize('fusion', sorted(CELLS))
def test_the_port_in_bf16_fails_the_score_comparison(fusion):
    assert score_gap(fusion, 'bfloat16') > 10 * SCORE_TOL


def train_gaps(dtype: str) -> dict:
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_step_fns,
    )
    cell = spec.cell('concat.train.b262144')
    cfg = tiny_config('concat.train.b262144', dtype)
    cfg['training'] = {**cfg['training'], 'batch_size': 256}
    traffic = {**cell.traffic, 'pool_batches': 3}
    seed = 2147483719
    weights = inputs.make_weights(cfg, seed, 'cpu')
    feats = inputs.make_features(cfg, seed, 'cpu')
    pool = make_pool(cfg, traffic, feats['tag'], seed, 'cpu')
    t = cfg['training']
    model = port_model(cfg, weights, 'cpu')
    state = init_train_state(model, build_optimizer(
        'adamw', t['learning_rate'], t['weight_decay'],
        gradient_clip=t['gradient_clip']))
    _, _, train_epoch, _ = make_step_fns(
        model, {packed_key(cfg): feats['packed']}, return_epoch_fns=True)
    drop = inputs.generator(seed, 'dropout', 'cpu')
    with exact():
        state, m = train_epoch(state, take(pool, 0, 1), drop)
        mu = state.opt_state.mu.clone()
        state, m2 = train_epoch(state, take(pool, 1, 3), drop)
    grad1, off = {}, 0
    for name, p in zip(state.opt_state.names, state.opt_state.params):
        grad1[name] = mu[off:off + p.numel()].view(p.shape) / 0.1
        off += p.numel()
    after = {k: v for k, v in model.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    ref = train_steps(cfg, weights, feats['packed'],
                      [{k: v[0] for k, v in take(pool, s, s + 1).items()}
                       for s in range(3)],
                      inputs.generator(seed, 'dropout', 'cpu'))
    losses = m['total_loss'].tolist() + m2['total_loss'].tolist()
    return compare(weights, losses, {'grad1': grad1, 'after': after}, ref)


def test_reference_training_matches_the_port_in_float32():
    gaps = train_gaps('float32')
    assert max(gaps['loss_gap'], gaps['grad_gap'], gaps['change_gap']) \
        <= TRAIN_TOL, gaps


def test_the_port_in_bf16_fails_the_training_comparison():
    gaps = train_gaps('bfloat16')
    assert max(gaps['loss_gap'], gaps['grad_gap'], gaps['change_gap']) \
        > 10 * TRAIN_TOL, gaps
