"""The port's training-subset and search entry points against the JAX
package's scripts, on the CPU.

Subsets: ``create_subsets`` of both packages on copies of one workspace
write the same three CSV files byte for byte and print the same drift,
on integer timestamps (nanoseconds to pandas), on
``YYYY-MM-DD HH:MM:SS`` strings, and on timestamps near 1.7e18 ns whose
quantile edges float64 rounds past the extreme values, so the stratified
split raises and the random fallback runs. ``to_datetime`` and ``qcut``
are held against pandas at those magnitudes.

Search: both scripts' ``main`` on one workspace copied twice, each with
``run_training`` replaced by the same deterministic function of the
trial's configuration (three epochs of validation losses, so the pruner
acts; a failure for some configurations, so the worst value is
returned): 12 trials with ``--pruning`` past TPE's startup, then a
``--resume`` run. The trials, every written file (workspace paths aside,
``best_params.json`` but its ``datetime``, ``study_config.json`` but its
``device``) and ``study_results.json`` byte for byte agree. Then a real
search of 2 trials on the CPU, whose best checkpoint loads, and the
refusals.
"""
import contextlib
import io
import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml

from pixelrec_multimodal_tpu_torch.data.columns import read_csv, write_csv
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.timestamps import (
    qcut_codes,
    to_datetime,
)
from pixelrec_multimodal_tpu_torch.scripts import (
    create_splits as tsplits,
    create_training_subsets as tsubsets,
    hyperparameter_search as thps,
)
from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
    load_checkpoint,
)
from tests._torch_port import load_jax_script, make_workspace, quiet

SUBSETS = ('train_50_percent.csv', 'train_20_percent.csv',
           'train_05_percent.csv')
DRIFT = 'Absolute sum of differences in monthly timestamp distribution'
FALLBACK = 'falling back to random split'


def copy_workspace(seed: Path, dest: Path) -> str:
    """``seed`` copied to ``dest``, its config's paths pointed there."""
    shutil.copytree(seed, dest)
    cfg = dest / 'config.yaml'
    cfg.write_text(cfg.read_text().replace(str(seed), str(dest)))
    return str(cfg)


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    """The ``make_workspace`` workspace, split by the port."""
    seed = tmp_path_factory.mktemp('hpo') / 'seed'
    quiet(tsplits.main, str(make_workspace(seed)))
    return seed


def capture(fn, *args):
    """(``fn(*args)``, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def rewrite_timestamps(ws: Path, kind: str):
    """The split's train.csv with its timestamp column rewritten:
    ``strings`` as 'YYYY-MM-DD HH:MM:SS' over several months, ``near_1e18``
    as nanoseconds near 1.7e18 that float64 cannot hold apart."""
    path = ws / 'data' / 'splits' / 'split_1' / 'train.csv'
    df = pd.read_csv(path)
    t = df['timestamp'].to_numpy()
    if kind == 'strings':
        df['timestamp'] = [f'2023-{1 + v % 9:02d}-{1 + 2 * v:02d} '
                           f'{v:02d}:{(7 * k) % 60:02d}:{(13 * k) % 60:02d}'
                           for k, v in enumerate(t)]
    else:
        df['timestamp'] = 1_700_000_000_000_000_100 + t
    df.to_csv(path, index=False)


@pytest.mark.parametrize('kind', ['ints', 'strings', 'near_1e18'])
def test_subsets_equal_jax_byte_for_byte(workspace, tmp_path, kind):
    jax_subsets = load_jax_script('create_training_subsets')
    printed, split = {}, {}
    for name in ('jax', 'torch'):
        cfg = copy_workspace(workspace, tmp_path / name)
        if kind != 'ints':
            rewrite_timestamps(tmp_path / name, kind)
        fn = jax_subsets.create_subsets if name == 'jax' \
            else tsubsets.create_subsets
        _, printed[name] = capture(fn, cfg)
        split[name] = tmp_path / name / 'data' / 'splits' / 'split_1'
    for f in SUBSETS:
        assert (split['torch'] / f).read_bytes() == \
            (split['jax'] / f).read_bytes(), f
    drift = {n: [line for line in text.splitlines() if DRIFT in line]
             for n, text in printed.items()}
    assert drift['torch'] == drift['jax'] and len(drift['torch']) == 1
    fell_back = {n: FALLBACK in text for n, text in printed.items()}
    assert fell_back['torch'] == fell_back['jax']
    if kind == 'near_1e18':
        assert fell_back['torch'] and 'Input y contains NaN' in \
            printed['torch']
    # nested: 5% within 20% within 50%
    rows = [set(map(tuple, pd.read_csv(split['torch'] / f)
                    [['user_id', 'item_id', 'timestamp']].to_numpy().tolist()))
            for f in SUBSETS]
    assert rows[2] <= rows[1] <= rows[0]


def test_subsets_returns_the_sizes(workspace, tmp_path):
    cfg = copy_workspace(workspace, tmp_path / 'ws')
    out = quiet(tsubsets.main, ['--config', cfg])
    full = len(pd.read_csv(tmp_path / 'ws' / 'data' / 'splits' / 'split_1'
                           / 'train.csv'))
    assert out['rows']['full'] == full
    assert abs(out['rows']['50'] - 0.5 * full) <= 2
    assert abs(out['rows']['20'] - 0.2 * full) <= 2
    assert math.isfinite(out['drift'])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_to_datetime_and_qcut_match_pandas_near_1e18(seed):
    """Integer nanoseconds near 1.7e18 (float64 steps of 256 ns there),
    with ties: the same datetimes, the same bins (NaN where an edge
    rounded past a value) and the same CSV cells as pandas."""
    rng = np.random.default_rng(seed)
    v = 1_700_000_000_000_000_000 + rng.integers(0, 4000, 500) * (
        1 + seed * 127) + rng.integers(0, 3, 500)
    ref = pd.to_datetime(pd.Series(v))
    got = to_datetime(v)
    assert str(got.dtype) == str(ref.dtype) == 'datetime64[ns]'
    np.testing.assert_array_equal(got.view('i8'), ref.astype('int64'))
    codes = pd.qcut(ref, q=10, labels=False, duplicates='drop').to_numpy()
    mine = qcut_codes(got, 10)
    assert mine.dtype == codes.dtype
    np.testing.assert_array_equal(mine, codes)
    strings = pd.Series(ref.dt.strftime('%Y-%m-%d %H:%M:%S').to_numpy(),
                        dtype=object)
    parsed = to_datetime(strings.to_numpy())
    sref = pd.to_datetime(strings)
    assert str(parsed.dtype) == str(sref.dtype) == 'datetime64[us]'
    np.testing.assert_array_equal(parsed.view('i8'), sref.astype('int64'))
    np.testing.assert_array_equal(qcut_codes(parsed, 10), pd.qcut(
        sref, q=10, labels=False, duplicates='drop').to_numpy())


def test_datetime_cells_match_pandas(tmp_path):
    """``write_csv`` of datetime columns: dates alone where every value is
    midnight, else the fractional digits the finest value needs."""
    cases = {'midnight': np.array([0, 86400 * 10 ** 9]),
             'ns': np.array([3, 10]), 'us': np.array([1000, 86400 * 10 ** 9]),
             'ms': np.array([3 * 10 ** 6, 10 ** 9]),
             'seconds': np.array([10 ** 9, 7 * 10 ** 9])}
    for name, v in cases.items():
        ref, out = tmp_path / f'{name}_pd.csv', tmp_path / f'{name}.csv'
        pd.DataFrame({'t': pd.to_datetime(pd.Series(v))}).to_csv(
            ref, index=False)
        write_csv({'t': to_datetime(v)}, out)
        assert out.read_bytes() == ref.read_bytes(), name
        assert read_csv(out)['t'].tolist() == \
            pd.read_csv(ref)['t'].tolist()
    with pytest.raises(ValueError):
        to_datetime(np.array(['2023-01-05 10:00:00', '2023-02-01'],
                             dtype=object))


# ------------------------------------------------------------ the search
def fake_training(config, args):
    """A deterministic stand-in for ``run_training``: validation losses
    over three epochs from the trial's configuration and training file;
    batch size 16 fails."""
    m, t = config.model, config.training
    if t.batch_size == 16:
        raise RuntimeError('stand-in failure')
    base = ((math.log10(t.learning_rate) + 3) ** 2
            + abs(m.embedding_dim - 256) / 256 + len(m.fusion_hidden_dims) / 10
            + t.batch_size / 128 + m.dropout_rate
            + 0.3 * bool(m.use_batch_norm) + {
                'concatenate': 0.0, 'gated': 0.1,
                'attention': 0.2}[m.fusion_type]
            + {'train_05_percent.csv': 0.3, 'train_20_percent.csv': 0.2,
               'train_50_percent.csv': 0.1}.get(
                   Path(config.data.train_data_path).name, 0.0))
    val = [base + 1.0 / (epoch + 1) for epoch in range(3)]
    return {'best_val_loss': min(val), 'val_losses': val,
            'epochs_completed': 3, 'training_time': 1.5,
            'all_best_metrics': {'val_loss': min(val),
                                 'val_accuracy': 1 - min(val) / 10}}


SEARCH = ['--n_trials', '12', '--pruning', '--study_name', 'parity',
          '--trials_on_5_percent', '4', '--trials_on_20_percent', '7',
          '--trials_on_50_percent', '10', '--device', 'cpu']


@pytest.fixture(scope='module')
def searches(workspace, tmp_path_factory):
    """Both scripts' searches, then a resumed run of 3 more trials."""
    base = tmp_path_factory.mktemp('search')
    jhps = load_jax_script('hyperparameter_search')
    out = {'base': base}
    for name, module in (('jax', jhps), ('torch', thps)):
        cfg = copy_workspace(workspace, base / name)
        quiet(tsubsets.create_subsets, cfg)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, 'run_training', fake_training)
            out[name] = search(module, cfg, base / name)
    return out


def search(module, cfg: str, root: Path) -> dict:
    """12 trials, then 3 more resumed, into ``root``."""
    flags = ['--config', cfg, '--output_dir', str(root / 'hpo'),
              '--storage', str(root / 'study.json')]
    first = quiet(module.main, flags + SEARCH)
    first = [(t.number, t.state, t.value, t.params, t.user_attrs)
             for t in first.trials]
    resumed = quiet(module.main, flags + SEARCH[2:] + [
        '--n_trials', '3', '--resume'])
    return {'first': first, 'study': resumed, 'dir': root / 'hpo'}


def normalized(text: str, searches, name: str) -> str:
    return text.replace(str(searches['base'] / name), '<ws>')


def test_search_trials_match_jax(searches):
    assert searches['torch']['first'] == searches['jax']['first']
    port, jax_study = searches['torch']['study'], searches['jax']['study']
    assert [(t.number, t.state, t.value, t.params, t.user_attrs,
             t.intermediate_values) for t in port.trials] == \
        [(t.number, t.state, t.value, t.params, t.user_attrs,
          t.intermediate_values) for t in jax_study.trials]
    states = [t.state for t in port.trials]
    assert len(states) == 15 and 'PRUNED' in states
    values = [t.value for t in port.trials if t.value is not None]
    assert math.inf in values  # a failed training scores the worst value
    fractions = {t.user_attrs.get('data_fraction') for t in port.trials}
    assert fractions == {0.05, 0.2, 0.5, 1.0}


@pytest.mark.parametrize('name', ['best_params.json', 'study_config.json',
                                  'study_results.json', 'best_config.yaml'])
def test_search_files_match_jax(searches, name):
    texts = {n: normalized((searches[n]['dir'] / name).read_text(),
                           searches, n) for n in ('jax', 'torch')}
    if name == 'study_results.json':
        assert texts['torch'] == texts['jax']
        return
    if name == 'best_config.yaml':
        assert yaml.safe_load(texts['torch']) == yaml.safe_load(texts['jax'])
        return
    got, ref = json.loads(texts['torch']), json.loads(texts['jax'])
    drop = 'datetime' if name == 'best_params.json' else 'device'
    got.pop(drop), ref.pop(drop)
    assert got == ref
    if name == 'best_params.json':
        assert got['trial_number'] == searches['torch']['study'] \
            .best_trial.number


def test_trial_directories_match_jax(searches):
    """Every trial's config.yaml (as data) and trial_summary.json."""
    dirs = {n: sorted(p.name for p in searches[n]['dir'].glob('trial_*'))
            for n in ('jax', 'torch')}
    assert dirs['torch'] == dirs['jax'] and len(dirs['torch']) == 14
    summaries = 0
    for trial in dirs['torch']:
        for name in ('config.yaml', 'trial_summary.json'):
            paths = {n: searches[n]['dir'] / trial / name
                     for n in ('jax', 'torch')}
            assert paths['torch'].exists() == paths['jax'].exists()
            if not paths['torch'].exists():
                continue
            texts = {n: normalized(p.read_text(), searches, n)
                     for n, p in paths.items()}
            load = yaml.safe_load if name.endswith('.yaml') else json.loads
            assert load(texts['torch']) == load(texts['jax']), (trial, name)
            summaries += name == 'trial_summary.json'
    assert 0 < summaries < 15  # pruned trials write none


def test_search_pngs_match_jax(searches):
    pngs = {n: sorted(p.name for p in searches[n]['dir'].glob('*.png'))
            for n in ('jax', 'torch')}
    assert pngs['torch'] == pngs['jax'] == [
        'optimization_history.png', 'parallel_coordinate.png',
        'param_importances.png']


# ---------------------------------------------------- a real search, CPU
def write_tables(cfg_path: str, pairs):
    """Random precomputed tables for the (vision, language) pairs, with a
    CLIP text table for a CLIP vision model, in the config's cache."""
    cfg = yaml.safe_load(Path(cfg_path).read_text())
    items = read_csv(cfg['data']['processed_item_info_path'])
    ids = np.unique(items['item_id'].astype(str))
    rng = np.random.default_rng(4)
    dims = {'clip': 768, 'resnet': 2048, 'convnext': 1024,
            'sentence-bert': 384, 'mpnet': 768, 'bert': 768}
    for vision, language in pairs:
        store = ItemFeatureStore(len(ids), ids, vision, language)
        if vision:
            store.set_embedding_table('vision_emb', rng.standard_normal(
                (len(ids), dims[vision]), dtype=np.float32))
        if language:
            store.set_embedding_table('language_emb', rng.standard_normal(
                (len(ids), dims[language]), dtype=np.float32))
        if vision == 'clip':
            store.set_embedding_table('clip_text_emb', rng.standard_normal(
                (len(ids), 512), dtype=np.float32))
        store.save(cfg['data']['cache_config']['cache_directory'])


def test_real_search_on_the_cpu(workspace, tmp_path):
    """Two trials of one epoch, trained for real: both COMPLETE with a
    finite value, the files written, and a trial's best checkpoint loads
    with the port's ``load_checkpoint``."""
    cfg = copy_workspace(workspace, tmp_path / 'ws')
    quiet(tsubsets.create_subsets, cfg)
    write_tables(cfg, [('clip', 'sentence-bert'),
                       ('resnet', 'sentence-bert')])
    out = tmp_path / 'ws' / 'hpo'
    study = quiet(thps.main, ['--config', cfg, '--n_trials', '2',
                              '--study_name', 'real', '--output_dir',
                              str(out), '--device', 'cpu'])
    assert [t.state for t in study.trials] == ['COMPLETE'] * 2
    assert all(math.isfinite(t.value) for t in study.trials)
    for name in ('best_params.json', 'study_results.json',
                 'best_config.yaml', 'study_config.json',
                 'trial_0/trial_summary.json', 'trial_1/config.yaml'):
        assert (out / name).exists(), name
    best = study.best_trial
    combo = f"{best.params['vision_model']}_{best.params['language_model']}"
    ckpt = load_checkpoint(out / f'trial_{best.number}' / 'checkpoints' /
                           combo, 'best_model', device='cpu')
    assert ckpt['state'] and 'epoch' in ckpt['meta']


# ------------------------------------------------------------ refusals
def test_search_refuses_other_devices(workspace, tmp_path):
    cfg = copy_workspace(workspace, tmp_path / 'ws')
    with pytest.raises((ValueError, RuntimeError)):
        quiet(thps.main, ['--config', cfg, '--device', 'tpu',
                          '--output_dir', str(tmp_path / 'o')])


def test_search_without_matplotlib_warns_as_jax(workspace, tmp_path,
                                                monkeypatch):
    """With matplotlib hidden both scripts print the same warning and
    write no PNG."""
    jhps = load_jax_script('hyperparameter_search')
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    warnings = {}
    for name, module in (('jax', jhps), ('torch', thps)):
        cfg = copy_workspace(workspace, tmp_path / name)
        monkeypatch.setattr(module, 'run_training', fake_training)
        _, text = capture(module.main, [
            '--config', cfg, '--n_trials', '2', '--study_name', 'w',
            '--output_dir', str(tmp_path / name / 'hpo'), '--device', 'cpu'])
        warnings[name] = [line for line in text.splitlines()
                          if 'Could not generate visualizations' in line]
        assert not list((tmp_path / name / 'hpo').glob('*.png'))
    assert warnings['torch'] == warnings['jax'] and len(warnings['torch']) == 1
