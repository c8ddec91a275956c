"""The port's evaluate entry point against the JAX package's script, on
the CPU.

One small ID-only workspace (``tests/_torch_port.make_workspace``, top-K
5) is copied twice; the JAX scripts split and train on one copy, the
port's entry points on the other, and JAX's ``best_model`` weights are
written into the port's checkpoints (``port_state_of``), so both evaluate
scripts score the same model. Each runs from its own workspace on the
same relative paths (the split's test file, ``--train_data`` its train
file, ``--save_predictions``), so the results JSON must match: every
metric within 1e-6 and ``evaluation_metadata`` equal. The predictions
hold the same items per user (value sets: tie order may differ) with
scores within 1e-5, and the baselines' to the bit. Over two gloo ranks
(``torchrun`` with ``--model_parallel 2``) the port's results equal its
one-process results and JAX's on a 1x2 mesh of its forced CPU devices.
"""
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from pixelrec_multimodal_tpu.utils.checkpointing import (
    load_checkpoint as jax_load_checkpoint,
)
from pixelrec_multimodal_tpu_torch.scripts import create_splits as tsplits
from pixelrec_multimodal_tpu_torch.scripts import evaluate as tevaluate
from pixelrec_multimodal_tpu_torch.scripts import train as ttrain
from pixelrec_multimodal_tpu_torch.utils import checkpointing
from tests._torch_mesh import Torchrun
from tests._torch_port import (
    load_jax_script,
    make_workspace,
    port_state_of,
    quiet,
)

TOP_K, METRIC_TOL, SCORE_TOL = 5, 1e-6, 1e-5
MODEL_DIR = Path('models') / 'checkpoints' / 'None_None'
SPLIT = Path('data') / 'splits' / 'split_1'


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The workspace, split and trained by each package, the port's
    checkpoints holding JAX's best weights."""
    base = tmp_path_factory.mktemp('evaluate')
    make_workspace(base / 'seed')
    for name in ('jax', 'torch'):
        shutil.copytree(base / 'seed', base / name)
        cfg_path = base / name / 'config.yaml'
        cfg = yaml.safe_load(cfg_path.read_text().replace(
            str(base / 'seed'), str(base / name)))
        cfg['recommendation'] = {'top_k': TOP_K}
        cfg_path.write_text(yaml.dump(cfg))
    jcfg, tcfg = (str(base / n / 'config.yaml') for n in ('jax', 'torch'))
    quiet(load_jax_script('create_splits').main, jcfg)
    quiet(tsplits.main, tcfg)
    jres = quiet(load_jax_script('train').main,
                 ['--config', jcfg, '--device', 'cpu'])
    quiet(ttrain.main, ['--config', tcfg, '--device', 'cpu'])

    stats = jres['metadata']['data_stats']
    kw = dict(n_users=stats['total_users'], n_items=stats['total_items'],
              n_tags=stats['total_tags'],
              num_numerical_features=stats['numerical_features'],
              embedding_dim=16, vision_feature_dim=None,
              language_feature_dim=None, use_contrastive=False,
              fusion_hidden_dims=(32, 16), use_batch_norm=True)
    jstate = jax_load_checkpoint(base / 'jax' / MODEL_DIR,
                                 'best_model')['state']
    weights = port_state_of(kw, SimpleNamespace(
        params=jstate['params'], batch_stats=jstate['batch_stats']))
    restored = checkpointing.load_checkpoint(base / 'torch' / MODEL_DIR,
                                             'best_model')
    state = restored['state']
    state['params'] = {k: weights[k] for k in state['params']}
    state['batch_stats'] = {k: weights[k] for k in state['batch_stats']}
    checkpointing.save_checkpoint(base / 'torch' / MODEL_DIR, 'best_model',
                                  state, restored['meta'])
    return SimpleNamespace(base=base, jeval=load_jax_script('evaluate'))


def evaluate_both(ws, monkeypatch, *args, jax_args=()):
    """Both entry points from their own workspace on the same flags (JAX's
    with ``jax_args`` after them): (the port's results and predictions as
    written, JAX's)."""
    out = {}
    for side, main, extra in (('jax', ws.jeval.main, jax_args),
                              ('torch', tevaluate.main, ())):
        monkeypatch.chdir(ws.base / side)
        returned = quiet(main, [
            '--config', 'config.yaml', '--device', 'cpu', '--test_data',
            str(SPLIT / 'test.csv'), '--output', 'eval.json',
            '--save_predictions', 'preds.json', *args, *extra])
        written = json.loads((ws.base / side / 'results' / 'eval.json')
                             .read_text())
        assert written == json.loads(json.dumps(returned))
        out[side] = (written, json.loads((ws.base / side / 'preds.json')
                                         .read_text()))
    return out['torch'], out['jax']


def assert_same_results(got, ref, exact=False):
    (results, preds), (ref_results, ref_preds) = got, ref
    assert results.keys() == ref_results.keys()
    assert results['evaluation_metadata'] == ref_results['evaluation_metadata']
    for key, value in ref_results.items():
        if isinstance(value, float) and not exact:
            assert results[key] == pytest.approx(value, abs=METRIC_TOL), key
        else:
            assert results[key] == value, key
    assert list(preds) == list(ref_preds)
    if exact:
        assert preds == ref_preds
    for user, items in ref_preds.items():
        mine, theirs = dict(preds[user]), dict(items)
        assert set(mine) == set(theirs), user
        np.testing.assert_allclose([mine[i] for i in theirs],
                                   list(theirs.values()), atol=SCORE_TOL)
    return results, preds


@pytest.mark.parametrize('args', [
    [],
    ['--no_sampling'],
    ['--full_catalog'],
    ['--sampling_strategy', 'popularity_inverse', '--num_negatives', '10'],
    ['--eval_task', 'ranking'],
], ids=['sampled', 'no_sampling', 'full_catalog', 'popularity_inverse',
        'ranking'])
def test_multimodal_matches_jax(ws, monkeypatch, args):
    results, preds = assert_same_results(
        *evaluate_both(ws, monkeypatch, *args))
    assert results['num_users_evaluated'] == 15 == len(preds)
    if '--full_catalog' in args:
        assert results['evaluation_method'] == 'full_catalog'
        assert {len(v) for v in preds.values()} == {TOP_K}
    if '--eval_task' not in args:
        assert results['avg_personalization'] > 0


RANKED = {'sampled': [], 'full_catalog': ['--full_catalog']}


@pytest.fixture(scope='module')
def ranked(ws):
    """The evaluate entry point under ``torchrun`` (two gloo ranks,
    ``--model_parallel 2``) for each of RANKED, all started at once."""
    return {name: Torchrun('evaluate', [
        '--config', 'config.yaml', '--device', 'cpu', '--test_data',
        SPLIT / 'test.csv', '--output', f'eval_mesh_{name}.json',
        '--save_predictions', f'preds_mesh_{name}.json',
        '--model_parallel', '2', *args], ws.base / 'torch')
        for name, args in RANKED.items()}


@pytest.mark.parametrize('name', list(RANKED))
def test_evaluate_over_two_ranks(ws, ranked, monkeypatch, name):
    """``torchrun`` with two gloo ranks and ``--model_parallel 2``: rank 0
    alone prints and writes results and predictions equal to the
    one-process run's, which equal JAX's on its own 1x2 mesh (sampled
    candidates: each scored by the rank that holds it)."""
    args = RANKED[name]
    got, ref = evaluate_both(ws, monkeypatch, *args, jax_args=[
        '--data_parallel', '1', '--model_parallel', '2'])
    assert_same_results(got, ref)
    out = ranked[name].wait()
    assert out.count('Results saved to') == 1
    torch_ws = ws.base / 'torch'
    mesh = (json.loads((torch_ws / 'results' / f'eval_mesh_{name}.json')
                       .read_text()),
            json.loads((torch_ws / f'preds_mesh_{name}.json').read_text()))
    assert_same_results(mesh, got)
    assert_same_results(mesh, ref)


@pytest.mark.parametrize('kind', ['random', 'popularity', 'item_knn',
                                  'user_knn'])
def test_baselines_match_jax(ws, monkeypatch, kind):
    results, _ = assert_same_results(*evaluate_both(
        ws, monkeypatch, '--recommender_type', kind, '--train_data',
        str(SPLIT / 'train.csv')), exact=True)
    assert results['evaluation_metadata']['recommender_type'] == kind


def test_absolute_output_path(ws, monkeypatch, tmp_path):
    monkeypatch.chdir(ws.base / 'torch')
    out = tmp_path / 'sub' / 'abs.json'
    returned = quiet(tevaluate.main, [
        '--config', 'config.yaml', '--device', 'cpu', '--test_data',
        str(SPLIT / 'val.csv'), '--recommender_type', 'popularity',
        '--output', str(out), '--num_workers', '3',
        '--warmup_recommender_cache'])
    assert json.loads(out.read_text()) == returned
    assert 'predictions' not in returned


def test_evaluate_refusals(ws, monkeypatch, tmp_path):
    """Without a card the default device raises; a device other than cuda
    or cpu raises; a mesh past the one process raises JAX's message; a
    JAX-package checkpoint (an Orbax state/ directory) raises."""
    monkeypatch.chdir(ws.base / 'torch')
    cfg = ['--config', 'config.yaml', '--test_data', str(SPLIT / 'test.csv')]
    with pytest.raises((ValueError, RuntimeError)):
        quiet(tevaluate.main, [*cfg, '--device', 'tpu'])
    for flag in (['--model_parallel', '2'], ['--data_parallel', '2']):
        with pytest.raises(ValueError,
                           match=r'mesh but only 1 device\(s\) visible'):
            quiet(tevaluate.main, [*cfg, '--device', 'cpu', *flag])
    jax_cfg = yaml.safe_load((ws.base / 'torch' / 'config.yaml').read_text())
    jax_cfg['checkpoint_dir'] = str(ws.base / 'jax' / 'models' /
                                    'checkpoints')
    (tmp_path / 'config.yaml').write_text(yaml.dump(jax_cfg))
    with pytest.raises(ValueError, match='JAX-package checkpoint'):
        quiet(tevaluate.main, ['--config', str(tmp_path / 'config.yaml'),
                               '--device', 'cpu', '--test_data',
                               str(SPLIT / 'test.csv')])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        quiet(tevaluate.main, cfg)
