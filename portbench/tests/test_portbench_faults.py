"""The check that decides ``correct`` fails what it must: a whole run of a
cell at a tiny size on the CPU (the look for a card skipped), with the
timed path broken underneath, comes out not correct under the cell's own
limits; so do the controls, the reference in float8 in the port's place,
for the top-K cells through the cell's own window and comparison."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from portbench import calibrate, run, spec

TOPK_CELLS = ['concat.topk-seen.u512', 'gated.topk-seen.u512',
              'concat.topk-all.u8192']


def tiny(name: str) -> spec.Cell:
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config.update(n_users=512, n_items=2048)
    if c.traffic['generator'] == 'topk':
        c.traffic = {**c.traffic, 'users_per_request': 24, 'check_rows': 48,
                     'warmup_requests': 1}
    else:
        c.config['training'] = {**c.config['training'], 'batch_size': 512}
        c.traffic = {**c.traffic, 'pool_batches': 8, 'batches_per_call': 4}
    return c


def correct(cell: spec.Cell, seed: int = 2147483723, **kw) -> bool:
    result, _ = run.run(cell, seed, 1.0, False, 'cpu', **kw)
    return result['correct']


def scorer_module():
    from pixelrec_multimodal_tpu_torch.inference import scorer
    return scorer


@pytest.mark.parametrize('name', TOPK_CELLS)
def test_a_sound_run_is_correct(name):
    assert correct(tiny(name))


@pytest.mark.parametrize('name', TOPK_CELLS)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    mod = scorer_module()
    merge = mod.merge_topk

    def altered(*a, **kw):
        v, i = merge(*a, **kw)
        i = i.clone()
        i[:, -1] = (i[:, -1] + 1) % 2048
        return v, i
    monkeypatch.setattr(mod, 'merge_topk', altered)
    assert not correct(tiny(name))


@pytest.mark.parametrize('name', TOPK_CELLS)
def test_half_of_the_users_left_out(name, monkeypatch):
    mod = scorer_module()
    users_of = mod.CatalogScorer._users_of

    def half(self, user_indices, s, rows):
        u = users_of(self, user_indices, s, rows)
        n = len(u) // 2
        return torch.cat([u[:len(u) - n], u[:n]])
    monkeypatch.setattr(mod.CatalogScorer, '_users_of', half)
    assert not correct(tiny(name))


@pytest.mark.parametrize('name', TOPK_CELLS[:2])
def test_the_seen_filter_left_out(name, monkeypatch):
    mod = scorer_module()
    monkeypatch.setattr(mod.CatalogScorer, '_seen_items',
                        lambda self, mask, rows: self._tensor(
                            np.zeros((len(rows), 0), np.int32)))
    assert not correct(tiny(name))


@pytest.mark.parametrize('name', TOPK_CELLS)
def test_the_float8_control_is_not_correct(name):
    assert not correct(tiny(name), options={'control': 'fp8'})


def test_a_sound_training_run_is_correct():
    assert correct(tiny('concat.train.b262144'))


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from pixelrec_multimodal_tpu_torch.training import optimizers
    monkeypatch.setattr(optimizers.Optimizer, 'update',
                        lambda self, state, g, apply: None)
    assert not correct(tiny('concat.train.b262144'))


def test_half_of_the_batch_left_out_of_the_loss(monkeypatch):
    from pixelrec_multimodal_tpu_torch.training import steps
    loss = steps.recommender_loss

    def half(predictions, labels, *a, weight=None, **kw):
        n = predictions.shape[0] // 2
        return loss(predictions[:n], labels[:n], *a,
                    weight=None if weight is None else weight[:n], **kw)
    monkeypatch.setattr(steps, 'recommender_loss', half)
    assert not correct(tiny('concat.train.b262144'))


def test_the_training_controls_are_not_correct():
    cell = tiny('concat.train.b262144')
    limits = cell.settings['limits']
    for line in calibrate.train_control(cell, 2147483729, 'cpu'):
        assert any(line[k] > v for k, v in limits.items()), line
