"""The port's entry points over the 'data' axis of two gloo ranks on the
CPU, under ``torchrun``, against the same entry points in one process.

The recommend tests' workspace (``tests/_torch_port.make_workspace``, top-K
5), split and trained by the port. ``generate_recommendations`` (7
sampled users: the user block pads the 'data' axis) and ``evaluate
--full_catalog`` with ``--data_parallel 2`` write the one-process report
and results (scores to 1e-5, metrics to 1e-6). ``precompute_cache
--data_parallel 2`` over the cached token tables of 8 items (16 tokens,
so that MiniLM's forward is short): each rank runs half of each batch of
64 and the pooled rows are all-gathered in item order; rank 0 writes the
one-process tables (the language table to 1e-5 of its scale, the rest
equal). The model axis of these entry points, and JAX's meshed scripts,
are held in ``tests/test_torch_recommend_cli.py`` and
``tests/test_torch_evaluate_cli.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import yaml

from pixelrec_multimodal_tpu_torch.data.feature_store import (
    ItemFeatureStore,
    cache_subdir_name,
)
from pixelrec_multimodal_tpu_torch.scripts import create_splits
from pixelrec_multimodal_tpu_torch.scripts import evaluate
from pixelrec_multimodal_tpu_torch.scripts import generate_recommendations
from pixelrec_multimodal_tpu_torch.scripts import precompute_cache
from pixelrec_multimodal_tpu_torch.scripts import train
from tests._torch_mesh import Torchrun
from tests._torch_port import make_workspace, quiet

SCORE_TOL, METRIC_TOL, TABLE_TOL = 1e-5, 1e-6, 1e-5
N_PRE, TOKENS = 8, 16
TEST_CSV = Path('data') / 'splits' / 'split_1' / 'test.csv'


def precompute_config(ws: Path, cache: str) -> Path:
    """The workspace's config with MiniLM (sentence-bert) and its own cache
    directory, in which the 8 items' token tables are cached."""
    cfg = yaml.safe_load((ws / 'config.yaml').read_text())
    cfg['model']['language_model'] = 'sentence-bert'
    cfg['data']['cache_config']['cache_directory'] = str(ws / cache)
    path = ws / f'config_{cache}.yaml'
    path.write_text(yaml.dump(cfg))
    rng = np.random.default_rng(4)
    tokens = rng.integers(1000, 30000, (N_PRE, TOKENS)).astype(np.int32)
    mask = np.ones_like(tokens)
    tokens[:, 0] = 101
    for j in range(N_PRE):
        tokens[j, 6 + j:] = 0
        mask[j, 6 + j:] = 0
    store = ItemFeatureStore(N_PRE, [f'i{j}' for j in range(N_PRE)], None,
                             'sentence-bert')
    store.tables = {'text_input_ids': tokens, 'text_attention_mask': mask}
    store.save(str(ws / cache))
    return path


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The workspace, split and trained by the port; then the three entry
    points started under torchrun, all at once."""
    base = tmp_path_factory.mktemp('mesh_cli')
    cfg_path = make_workspace(base)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg['recommendation'] = {'top_k': 5}
    cfg_path.write_text(yaml.dump(cfg))
    quiet(create_splits.main, str(cfg_path))
    quiet(train.main, ['--config', str(cfg_path), '--device', 'cpu'])
    pre = {name: precompute_config(base, name) for name in ('one', 'two')}
    flags = ['--device', 'cpu', '--data_parallel', '2']
    runs = {
        'generate': Torchrun('generate_recommendations', [
            '--config', 'config.yaml', '--sample_users', '7', '--output',
            'recs_mesh.json', *flags], base),
        'evaluate': Torchrun('evaluate', [
            '--config', 'config.yaml', '--test_data', TEST_CSV,
            '--full_catalog', '--output', 'eval_mesh.json',
            '--save_predictions', 'preds_mesh.json', *flags], base),
        'precompute': Torchrun('precompute_cache', [
            '--config', pre['two'], '--max_items', N_PRE, *flags], base)}
    return base, pre, runs


def test_generate_over_the_data_axis(ws, monkeypatch):
    base, _, runs = ws
    monkeypatch.chdir(base)
    one = quiet(generate_recommendations.main, [
        '--config', 'config.yaml', '--device', 'cpu', '--sample_users', '7',
        '--output', 'recs_one.json'])
    out = runs['generate'].wait()
    assert "Device mesh: {'data': 2, 'model': 1}" in out
    assert out.count('Generating recommendations for 7 users') == 1
    mesh = json.loads((base / 'results' / 'recs_mesh.json').read_text())
    assert list(mesh['recommendations']) == list(one['recommendations'])
    for user, items in one['recommendations'].items():
        got = {e['item_id']: e['score'] for e in mesh['recommendations'][user]}
        assert set(got) == {e['item_id'] for e in items} and len(items) == 5
        np.testing.assert_allclose([got[e['item_id']] for e in items],
                                   [e['score'] for e in items],
                                   atol=SCORE_TOL)


def test_evaluate_over_the_data_axis(ws, monkeypatch):
    base, _, runs = ws
    monkeypatch.chdir(base)
    one = quiet(evaluate.main, [
        '--config', 'config.yaml', '--device', 'cpu', '--test_data',
        str(TEST_CSV), '--full_catalog', '--output', 'eval_one.json',
        '--save_predictions', 'preds_one.json'])
    assert runs['evaluate'].wait().count('Results saved to') == 1
    mesh = json.loads((base / 'results' / 'eval_mesh.json').read_text())
    assert mesh.keys() == one.keys()
    for key, value in one.items():
        if isinstance(value, float):
            assert mesh[key] == pytest.approx(value, abs=METRIC_TOL), key
        else:
            assert mesh[key] == value, key
    preds = json.loads((base / 'preds_mesh.json').read_text())
    ref = json.loads((base / 'preds_one.json').read_text())
    assert list(preds) == list(ref)
    for user, items in ref.items():
        got = dict(preds[user])
        assert set(got) == {i for i, _ in items}
        np.testing.assert_allclose([got[i] for i, _ in items],
                                   [s for _, s in items], atol=SCORE_TOL)


def test_precompute_over_the_data_axis(ws):
    base, pre, runs = ws
    quiet(precompute_cache.main, ['--config', str(pre['one']), '--device',
                                  'cpu', '--max_items', str(N_PRE)])
    out = runs['precompute'].wait()
    assert out.count('Done: 8 items') == 1
    tables = []
    for name in ('one', 'two'):
        npz = base / name / cache_subdir_name(None, 'sentence-bert') / \
            'feature_tables.npz'
        with np.load(npz, allow_pickle=False) as z:
            tables.append({k: z[k] for k in z.files})
    ref, got = tables
    assert sorted(got) == sorted(ref) and 'language_emb' in got
    assert got['language_emb'].shape == (N_PRE, 384)
    assert got['text_input_ids'].shape == (N_PRE, TOKENS)
    for k in ref:
        if k == 'language_emb':
            scale = np.abs(ref[k]).max()
            np.testing.assert_allclose(got[k], ref[k],
                                       atol=TABLE_TOL * scale)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
