"""The port's search engine (``pixelrec_multimodal_tpu_torch/hpo``) against
the JAX package's (``pixelrec_multimodal_tpu/hpo``), on the CPU, bit for
bit: the same objective run by both engines from the same seed proposes
the same parameters trial by trial and ends in the same states, values,
pruning decisions, storage files, importances and study table.

``test_records_json_matches_pandas`` holds the port's writer of pandas'
``to_json(orient='records', indent=2)`` to equal bytes: it copies pandas'
float formatter (ujson's ``double_precision=10``), not only its records.
"""
import json
import math
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from pixelrec_multimodal_tpu.hpo import search as jsearch
from pixelrec_multimodal_tpu.hpo import visualization as jvis
from pixelrec_multimodal_tpu_torch.data.columns import (
    from_records,
    write_json_records,
)
from pixelrec_multimodal_tpu_torch.hpo import search as tsearch
from pixelrec_multimodal_tpu_torch.hpo import visualization as tvis
from pixelrec_multimodal_tpu_torch.scripts import (
    hyperparameter_search as thps,
)
from tests._torch_port import load_jax_script, quiet

ENGINES = {'jax': jsearch, 'torch': tsearch}
N_TRIALS = 40


def objective_for(engine):
    """A deterministic objective over float, log float, stepped float,
    int, log int, categorical (with None) and bool parameters, which
    prunes, fails and reports three steps for the pruner."""
    def objective(trial):
        x = trial.suggest_float('x', -5.0, 5.0)
        lr = trial.suggest_float('lr', 1e-5, 1e-1, log=True)
        q = trial.suggest_float('q', 0.0, 1.0, step=0.1)
        n = trial.suggest_int('n', 1, 20)
        m = trial.suggest_int('m', 2, 256, log=True)
        kind = trial.suggest_categorical('kind', ['a', 'b', None])
        width = trial.suggest_categorical('width', [16, 32, 64])
        flag = trial.suggest_categorical('flag', [True, False])
        if kind is None and x > 3.5:
            raise engine.TrialPruned('no kind')
        if n % 5 == 3:
            raise ValueError('n % 5 == 3')
        value = ((x - 1.2) ** 2 + abs(math.log10(lr) + 3)
                 + abs(n - 7) / 5 + abs(math.log2(m) - 5) / 3
                 + {'a': 0.0, 'b': 0.5, None: 1.0}[kind] + width / 64
                 + 0.3 * flag + q)
        for step in range(3):
            trial.report(value + 1.0 / (step + 1), step)
            if trial.should_prune():
                raise engine.TrialPruned()
        trial.set_user_attr('n_even', n % 2 == 0)
        return value
    return objective


def trial_records(study):
    return [(t.number, t.state, t.value, t.params, t.distributions,
             t.user_attrs, t.intermediate_values) for t in study.trials]


def run_study(engine, direction, pruning, sampler='tpe', seed=3,
              n_trials=N_TRIALS):
    make = engine.TPESampler if sampler == 'tpe' else engine.RandomSampler
    study = engine.create_study(
        'parity', sampler=make(seed=seed), direction=direction,
        pruner=engine.MedianPruner(n_startup_trials=3) if pruning else None)
    quiet(study.optimize, objective_for(engine), n_trials=n_trials)
    return study


@pytest.fixture(scope='module')
def studies():
    """The 40-trial TPE study of each engine, minimizing with pruning."""
    return {name: run_study(engine, 'minimize', True)
            for name, engine in ENGINES.items()}


@pytest.mark.parametrize('direction', ['minimize', 'maximize'])
@pytest.mark.parametrize('pruning', [True, False], ids=['pruner', 'none'])
def test_tpe_study_matches_jax(direction, pruning):
    jax_study = run_study(jsearch, direction, pruning)
    port = run_study(tsearch, direction, pruning)
    assert trial_records(port) == trial_records(jax_study)
    states = {t.state for t in port.trials}
    assert {'COMPLETE', 'FAIL'} <= states
    if pruning:
        assert 'PRUNED' in states
    assert port.best_params == jax_study.best_params
    assert port.best_value == jax_study.best_value


def test_random_sampler_matches_jax():
    jax_study = run_study(jsearch, 'minimize', False, sampler='random',
                          seed=11, n_trials=25)
    port = run_study(tsearch, 'minimize', False, sampler='random', seed=11,
                     n_trials=25)
    assert trial_records(port) == trial_records(jax_study)


@pytest.mark.parametrize('warmup', [0, 2])
@pytest.mark.parametrize('direction', ['minimize', 'maximize'])
def test_median_pruner_decisions_match_jax(warmup, direction):
    """The same finished trials (complete, pruned, failed, with NaN and
    infinite reports) and the same candidate records: the same
    decisions."""
    decisions = {}
    for name, engine in ENGINES.items():
        study = engine.Study('p', direction=direction)
        states = ['COMPLETE', 'PRUNED', 'FAIL', 'COMPLETE', 'RUNNING']
        for k in range(12):
            t = engine.FrozenTrial(number=k, state=states[k % 5])
            t.intermediate_values = {
                s: float(v) for s, v in enumerate(
                    np.random.default_rng(100 + k).normal(size=4))}
            if k == 4:
                t.intermediate_values[1] = float('inf')
            study.trials.append(t)
        pruner = engine.MedianPruner(n_startup_trials=3,
                                     n_warmup_steps=warmup)
        out = []
        for k in range(30):
            probe = engine.FrozenTrial(number=100 + k)
            steps = int(np.random.default_rng(k).integers(0, 5))
            probe.intermediate_values = {
                s: float(np.random.default_rng(k + s).normal())
                for s in range(steps)}
            if k % 7 == 3 and steps:
                probe.intermediate_values[steps - 1] = float('nan')
            out.append(pruner.should_prune(study, probe))
        decisions[name] = out
    assert decisions['torch'] == decisions['jax']
    assert any(decisions['torch']) and not all(decisions['torch'])


@pytest.mark.parametrize('url', [False, True], ids=['path', 'sqlite_url'])
def test_storage_after_resume_matches_jax(tmp_path, url):
    """Six trials into a storage file, then a resumed study runs six more:
    the same file from both engines, and the resumed study continues the
    numbering and the sampler's history."""
    texts = {}
    for name, engine in ENGINES.items():
        base = tmp_path / name
        storage = (f'sqlite:///{base}/study.db' if url
                   else str(base / 'study.json'))
        first = engine.create_study('resume', storage=storage,
                                    sampler=engine.TPESampler(seed=7))
        quiet(first.optimize, objective_for(engine), n_trials=6)
        resumed = quiet(engine.create_study, 'resume', storage=storage,
                        sampler=engine.TPESampler(seed=8),
                        load_if_exists=True)
        quiet(resumed.optimize, objective_for(engine), n_trials=6)
        path = base / ('study.db.json' if url else 'study.json')
        texts[name] = path.read_text()
        assert [t.number for t in resumed.trials] == list(range(12))
    assert texts['torch'] == texts['jax']


def test_two_workers_share_storage_as_jax(tmp_path):
    """Two studies on one storage file take turns, each merging the
    other's trials before it draws: the same file from both engines."""
    texts = {}
    for name, engine in ENGINES.items():
        storage = str(tmp_path / f'{name}.json')
        w1 = engine.create_study('shared', storage=storage,
                                 sampler=engine.TPESampler(seed=0),
                                 load_if_exists=True)
        w2 = engine.create_study('shared', storage=storage,
                                 sampler=engine.TPESampler(seed=1),
                                 load_if_exists=True)
        objective = objective_for(engine)
        for _ in range(4):
            quiet(w1.optimize, objective, n_trials=1)
            quiet(w2.optimize, objective, n_trials=1)
        assert len(w2.trials) == 8
        texts[name] = Path(storage).read_text()
    assert texts['torch'] == texts['jax']
    assert [t['number'] for t in json.loads(texts['torch'])['trials']] == \
        list(range(8))


def test_threads_run_trials_together():
    """``optimize(n_jobs=2)`` runs two trials at once: each trial waits at
    a two-party barrier, which only two concurrent trials pass (run one
    after another, the first wait would time out and the trial fail)."""
    barrier = threading.Barrier(2, timeout=30)

    def objective(trial):
        x = trial.suggest_float('x', -5, 5)
        barrier.wait()
        return x ** 2

    study = tsearch.create_study('threads')
    quiet(study.optimize, objective, n_trials=6, n_jobs=2)
    assert [t.state for t in study.trials] == ['COMPLETE'] * 6
    assert sorted(t.number for t in study.trials) == list(range(6))


def test_param_importances_match_jax(studies):
    port = tvis.compute_param_importances(studies['torch'])
    assert port == jvis.compute_param_importances(studies['jax'])
    assert list(port) == list(jvis.compute_param_importances(studies['jax']))
    assert math.isclose(sum(port.values()), 1.0)
    # each package's function on the other's study too
    assert tvis.compute_param_importances(studies['jax']) == port


def test_study_table_json_matches_pandas(studies, tmp_path):
    """``trials_dataframe`` written by the port's records writer equals
    JAX's DataFrame written by pandas' ``to_json``, byte for byte (a
    failed trial's value None as null)."""
    jpath, tpath = tmp_path / 'jax.json', tmp_path / 'torch.json'
    studies['jax'].trials_dataframe().to_json(jpath, orient='records',
                                              indent=2)
    write_json_records(studies['torch'].trials_dataframe(), tpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    table = studies['torch'].trials_dataframe()
    assert list(table)[:3] == ['number', 'state', 'value']
    assert np.isnan(table['value']).any()  # the failed trials' None


def test_records_json_matches_pandas(tmp_path):
    """A table with inf, NaN, None, bools, ints, floats of every
    magnitude, strings to escape and keys some rows lack: the same bytes
    as ``pd.DataFrame(rows).to_json(orient='records', indent=2)``."""
    rng = np.random.default_rng(2)
    floats = [0.1, 1 / 3, 2.0, 1e16, 9999999999999998.0, 1e-15, 1e-16,
              5e-11, -5e-11, 123.4567890125, 0.99999999999, 2.5e-11, -0.0,
              1.5e-10, 2.5e-10, 5e17, -3.25, float('nan'), float('inf'),
              -float('inf')]
    floats += list(rng.standard_normal(400)
                   * 10.0 ** rng.integers(-18, 18, 400))
    rows = []
    for k, x in enumerate(floats):
        row = {'number': k, 'state': 'COMPLETE' if k % 3 else 'PRUNED',
               'value': x, 'params_bool': bool(k % 2),
               'params_opt': [None, 128, 256][k % 3],
               'params_text': ['sentence-bert', None,
                               'a/b"\\é\n\x01\U0001F600'][k % 3],
               'params_mixed': ['x', 1, 2.5, True][k % 4]}
        if k % 5:
            row['params_int'] = k
        if k % 7:
            row['params_gappy_bool'] = k % 2 == 0
        if k > 10:
            row['user_attrs_data_fraction'] = 0.05
        rows.append(row)
    rows.append({'number': len(rows), 'params_none': None})
    jpath, tpath = tmp_path / 'pandas.json', tmp_path / 'port.json'
    pd.DataFrame(rows).to_json(jpath, orient='records', indent=2)
    write_json_records(from_records(rows), tpath)
    assert tpath.read_bytes() == jpath.read_bytes()


# The issue's table of the first five trials the search script draws from
# its default seed (42): (vision, language, fusion, embedding_dim, heads,
# hidden, batch, activation, batch norm, contrastive, optimizer,
# projection).
SEED_42_TRIALS = [
    ('clip', 'sentence-bert', 'concatenate', 128, 2, '512', 64, 'relu',
     False, True, 'adam', None),
    ('resnet', 'sentence-bert', 'concatenate', 512, 8, '256, 128, 64', 32,
     'relu', True, False, 'adamw', 256),
    ('resnet', 'bert', 'concatenate', 512, 2, '512, 256, 128', 16, 'tanh',
     True, False, 'sgd', 256),
    ('clip', 'bert', 'gated', 128, 8, '256, 128', 64, 'gelu', False, True,
     'adam', None),
    ('convnext', None, 'attention', 256, 2, '512, 256', 64, 'relu', True,
     True, 'adam', 256),
]
TABLE_KEYS = ('vision_model', 'language_model', 'fusion_type',
              'embedding_dim', 'num_attention_heads', 'fusion_hidden_dims',
              'batch_size', 'fusion_activation', 'use_batch_norm',
              'use_contrastive', 'optimizer_type', 'projection_hidden_dim')


def test_seed_42_draws(tmp_path, monkeypatch):
    """Both search scripts' objectives (run_training stubbed) from the
    default seed draw the same trials, the first five as tabled; trial 6
    draws no modality and is pruned; the pairs chip_smoke.py writes
    tables for are the ones these trials draw beyond its cli workspace's
    resnet/sentence-bert."""
    import chip_smoke
    cfg = tmp_path / 'config.yaml'
    cfg.write_text(f'data:\n  train_data_path: {tmp_path / "train.csv"}\n')
    jhps = load_jax_script('hyperparameter_search')
    stub = lambda config, args: {'best_val_loss': 1.0}  # noqa: E731
    drawn = {}
    for name, module in (('jax', jhps), ('torch', thps)):
        monkeypatch.setattr(module, 'run_training', stub)
        study = quiet(module.main, [
            '--config', str(cfg), '--n_trials', '7', '--study_name', 's',
            '--output_dir', str(tmp_path / name), '--device', 'cpu'])
        drawn[name] = [(t.state, t.params) for t in study.trials]
    assert drawn['torch'] == drawn['jax']
    table = [tuple(params[k] for k in TABLE_KEYS)
             for _, params in drawn['torch'][:5]]
    assert table == SEED_42_TRIALS
    assert drawn['torch'][6] == ('PRUNED', {'vision_model': None,
                                            'language_model': None})
    pairs = {(v, lang) for v, lang, *_ in SEED_42_TRIALS}
    assert set(chip_smoke.HPO_NEW_TABLES) == pairs - {
        ('resnet', 'sentence-bert')}
    assert chip_smoke.HPO_TRIALS == len(SEED_42_TRIALS)
