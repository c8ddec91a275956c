"""The port's split and train entry points against the JAX package's
scripts, on the CPU: one small ID-only workspace (15 users, 40 items,
processed CSV files written by pandas, ``vision_model: null`` and
``language_model: null``), copied twice. The JAX ``scripts/
create_splits.py`` and ``scripts/train.py`` (imported by path, ``--device
cpu``, 1 epoch) run on one copy, the port's
``pixelrec_multimodal_tpu_torch.scripts`` on the other.

Held equal: the split CSV files byte for byte (the config's strategy,
which merges the stratification column from the item table, and a loop
of strategies through the split step alone), the encoders' classes, the
training ``data_stats``, the metadata's keys and parameter count, both
written configs as dicts and as text (workspace paths aside), and the set
of files each run writes beside its checkpoint format. The losses must be
finite: loss parity is ``tests/test_torch_trainer.py``'s, since the two
scripts initialize their models differently.
"""
import json
import math
import pickle
import shutil

import pandas as pd
import pytest
import torch
import yaml

from pixelrec_multimodal_tpu_torch.scripts import create_splits as tsplits
from pixelrec_multimodal_tpu_torch.scripts import train as ttrain
from tests._torch_port import load_jax_script, make_workspace, quiet

SPLIT_FILES = ('train.csv', 'val.csv', 'test.csv')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The workspace copied twice; the JAX scripts split and train on one
    copy, the port's entry points on the other."""
    base = tmp_path_factory.mktemp('cli')
    make_workspace(base / 'seed')
    shutil.copytree(base / 'seed', base / 'jax')
    shutil.copytree(base / 'seed', base / 'torch')
    for name in ('jax', 'torch'):
        cfg = base / name / 'config.yaml'
        cfg.write_text(cfg.read_text().replace(str(base / 'seed'),
                                               str(base / name)))
    jsplit, jtrain = load_jax_script('create_splits'), load_jax_script('train')
    jcfg, tcfg = str(base / 'jax' / 'config.yaml'), \
        str(base / 'torch' / 'config.yaml')
    quiet(jsplit.main, jcfg)
    split = quiet(tsplits.main, tcfg)
    jres = quiet(jtrain.main, ['--config', jcfg, '--device', 'cpu'])
    tres = quiet(ttrain.main, ['--config', tcfg, '--device', 'cpu'])
    return {'base': base, 'jax': jres, 'torch': tres, 'split': split,
            'jsplit': jsplit}


def test_split_files_equal_byte_for_byte(runs):
    base = runs['base']
    for name in SPLIT_FILES:
        want = (base / 'jax' / 'data/splits/split_1' / name).read_bytes()
        got = (base / 'torch' / 'data/splits/split_1' / name).read_bytes()
        assert got == want, name
    rows = runs['split']['rows']
    assert rows == {n: len(pd.read_csv(base / 'torch/data/splits/split_1'
                                       / f'{n}.csv')) for n in rows}
    # the merged stratification column, missing on some rows, made the
    # stratified split fall back to the random one on both sides
    assert runs['split']['stats']['user_overlap_ratio_val'] == 1.0


@pytest.mark.parametrize('strategy', ['leave_one_out', 'stratified', 'user',
                                      'item', 'temporal', 'simple_random',
                                      'stratified_by_column'])
def test_split_step_alone_per_strategy(runs, strategy, tmp_path):
    """Each strategy through both split entry points on fresh copies of
    the workspace: the same files, byte for byte."""
    out = {}
    for name in ('jax', 'torch'):
        ws = tmp_path / name
        ws.mkdir()
        shutil.copytree(runs['base'] / 'seed' / 'data' / 'processed',
                        ws / 'processed')
        cfg = yaml.safe_load((runs['base'] / 'seed' / 'config.yaml')
                             .read_text())
        cfg['data']['processed_interactions_path'] = \
            str(ws / 'processed' / 'interactions.csv')
        cfg['data']['processed_item_info_path'] = \
            str(ws / 'processed' / 'item_info.csv')
        cfg['data']['split_data_path'] = str(ws / 'split')
        cfg['data']['splitting'].update(
            strategy=strategy, train_final_ratio=0.7, val_final_ratio=0.15,
            test_final_ratio=0.15,
            stratify_by='category' if strategy == 'stratified_by_column'
            else None)
        (ws / 'config.yaml').write_text(yaml.dump(cfg))
        main = runs['jsplit'].main if name == 'jax' else tsplits.main
        quiet(main, str(ws / 'config.yaml'))
        out[name] = {p.name: p.read_bytes()
                     for p in sorted((ws / 'split').glob('*.csv'))}
    assert out['torch'] == out['jax']
    assert set(out['torch']) >= {'train.csv', 'val.csv'}


def test_encoders_equal(runs):
    base = runs['base']
    for name in ('user', 'item', 'tag'):
        files = [base / side / 'models/checkpoints/encoders'
                 / f'{name}_encoder.pkl' for side in ('jax', 'torch')]
        want, got = (pickle.loads(f.read_bytes()) for f in files)
        assert [str(c) for c in got.classes_] == \
            [str(c) for c in want.classes_], name
    users = pickle.loads((base / 'torch/models/checkpoints/encoders/'
                          'user_encoder.pkl').read_bytes())
    assert '7' in set(users.classes_.tolist())  # '0007' read as an integer


def test_metadata_and_stats_equal(runs):
    jmeta, tmeta = runs['jax']['metadata'], runs['torch']['metadata']
    assert tmeta['data_stats'] == jmeta['data_stats']
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta['model_params'] == jmeta['model_params']
    assert tmeta['numerical_features_validation'] == \
        jmeta['numerical_features_validation']
    assert tmeta['numerical_features_validation']['missing_features'] == \
        ['absent_feature']
    assert tmeta['model_config'] == jmeta['model_config']
    assert tmeta['training_config'] == jmeta['training_config']
    assert tmeta['device_info'] == {'devices': ['cpu'], 'backend': 'cpu'}
    on_disk = json.loads((runs['base'] / 'torch' / 'results' /
                          'training_metadata.json').read_text())
    assert sorted(on_disk) == sorted(jmeta)


def test_losses_finite(runs):
    for side in ('jax', 'torch'):
        res = runs[side]
        assert res['epochs_completed'] == 1
        assert all(math.isfinite(v) for v in
                   res['train_losses'] + res['val_losses']), side


@pytest.mark.parametrize('name', ['training_run_config_validated.yaml',
                                  'training_run_config.yaml'])
def test_written_configs_equal(runs, name):
    """As dicts (PyYAML reads both) and as text: the port's writer writes
    what PyYAML's dump writes."""
    base = runs['base']
    texts = {side: (base / side / 'results' / name).read_text()
             .replace(str(base / side), '<ws>') for side in ('jax', 'torch')}
    assert yaml.safe_load(texts['torch']) == yaml.safe_load(texts['jax'])
    assert texts['torch'] == texts['jax']


def test_written_files_match(runs):
    """Every file the JAX run writes, the port's writes too; the
    checkpoints in each package's own format (``state.pt`` here, Orbax's
    directory there)."""
    base = runs['base']

    def files(side):
        out = set()
        for p in (base / side).rglob('*'):
            rel = p.relative_to(base / side).as_posix()
            if p.is_file() and '/best_model/' not in rel and \
                    '/last_model/' not in rel:
                out.add(rel)
        return out
    assert files('torch') == files('jax')
    for ckpt in ('best_model', 'last_model'):
        d = base / 'torch' / 'models/checkpoints/None_None' / ckpt
        assert (d / 'state.pt').exists() and (d / 'meta.json').exists()
        assert (base / 'jax' / 'models/checkpoints/None_None' / ckpt /
                'meta.json').exists()
    assert runs['torch']['seconds']['train'] > 0


def test_train_entry_point_refusals(runs, monkeypatch):
    """Without a card the default device raises; a device other than
    cuda or cpu raises; a mesh past the one process raises JAX's
    message."""
    cfg = str(runs['base'] / 'torch' / 'config.yaml')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        quiet(ttrain.main, ['--config', cfg])
    with pytest.raises((ValueError, RuntimeError)):
        quiet(ttrain.main, ['--config', cfg, '--device', 'tpu'])
    for flag in (['--data_parallel', '2'], ['--model_parallel', '4']):
        with pytest.raises(ValueError,
                           match=r'mesh but only 1 device\(s\) visible'):
            quiet(ttrain.main, ['--config', cfg, '--device', 'cpu', *flag])


def test_split_entry_point_raises_where_jax_carries_on(tmp_path):
    """A missing item table for the merge, or nothing left after the
    filter: the JAX script prints and carries on or stops quietly; the
    port raises."""
    cfg_path = make_workspace(tmp_path)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg['data']['processed_item_info_path'] = str(tmp_path / 'nope.csv')
    cfg_path.write_text(yaml.dump(cfg))
    with pytest.raises(FileNotFoundError):
        quiet(tsplits.main, str(cfg_path))
    cfg['data']['splitting']['min_interactions_per_user'] = 10 ** 6
    cfg_path.write_text(yaml.dump(cfg))
    with pytest.raises(ValueError, match='No data left'):
        quiet(tsplits.main, str(cfg_path))
