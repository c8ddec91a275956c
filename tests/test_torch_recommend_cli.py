"""The port's recommend entry point and checkpoint tools against the JAX
package's scripts, on the CPU.

One small ID-only workspace (``tests/_torch_port.make_workspace``, top-K
5) is copied twice; the JAX scripts split and train on one copy, the
port's entry points on the other. JAX's ``best_model`` weights are then
written into the port's checkpoints (``port_state_of``), so both
``generate_recommendations`` serve the same model. Each run goes from
its own workspace with the config given as ``config.yaml``, so the JSON
reports must match in every key but ``generated_at``: item lists as value
sets, scores to 1e-5 (int8 codes: at most 1% of the pairs past 1e-5,
none past 1e-2, as ``tests/test_torch_int8.py``). Over two gloo ranks
(``torchrun`` with ``--model_parallel 2``) the port's report equals its
one-process report and JAX's on a 1x2 mesh of its forced CPU devices.

The checkpoint manager runs on twin trees (``state.pt`` against an Orbax
``state/`` directory of the same bytes) with equal outputs apart from
times; ``inspect_checkpoint`` and ``extract_encoders`` run on the
workspaces.
"""
import contextlib
import io
import json
import pickle
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from pixelrec_multimodal_tpu.utils.checkpointing import (
    load_checkpoint as jax_load_checkpoint,
)
from pixelrec_multimodal_tpu_torch.config import Config
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.scripts import checkpoint_manager as tcm
from pixelrec_multimodal_tpu_torch.scripts import create_splits as tsplits
from pixelrec_multimodal_tpu_torch.scripts import extract_encoders as textract
from pixelrec_multimodal_tpu_torch.scripts import (
    generate_recommendations as tgen,
)
from pixelrec_multimodal_tpu_torch.scripts import inspect_checkpoint as tinspect
from pixelrec_multimodal_tpu_torch.scripts import train as ttrain
from pixelrec_multimodal_tpu_torch.scripts.evaluate import (
    find_encoders,
    find_model_checkpoint,
    load_precomputed_tables,
)
from pixelrec_multimodal_tpu_torch.utils import checkpointing
from tests._torch_mesh import Torchrun
from tests._torch_port import (
    load_jax_script,
    make_workspace,
    port_state_of,
    quiet,
)

TOP_K, TOL = 5, 1e-5
AGREE, MAX_FLIPPED, FLIP_TOL = 1e-5, 0.01, 1e-2
MODEL_DIR = Path('models') / 'checkpoints' / 'None_None'


def printed(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*a, **kw)
    return out.getvalue(), result


@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The workspace, split and trained by each package, the port's
    checkpoints holding JAX's best weights."""
    base = tmp_path_factory.mktemp('recommend')
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
    jres = quiet(load_jax_script('train').main, ['--config', jcfg, '--device',
                                             'cpu'])
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
    for name in ('best_model', 'last_model'):
        restored = checkpointing.load_checkpoint(base / 'torch' / MODEL_DIR,
                                                 name)
        state = restored['state']
        assert set(weights) >= set(state['params']) | \
            set(state['batch_stats'])
        state['params'] = {k: weights[k] for k in state['params']}
        state['batch_stats'] = {k: weights[k] for k in state['batch_stats']}
        checkpointing.save_checkpoint(base / 'torch' / MODEL_DIR, name,
                                      state, restored['meta'])
    return SimpleNamespace(base=base, jgen=load_jax_script(
        'generate_recommendations'))


def generate_both(ws, monkeypatch, *args, jax_args=None):
    """Both entry points from their own workspace on the same flags (JAX's
    on ``jax_args`` where given); the reports as written."""
    out = {}
    for side, main, flags in (('jax', ws.jgen.main, jax_args or args),
                              ('torch', tgen.main, args)):
        monkeypatch.chdir(ws.base / side)
        returned = quiet(main, ['--config', 'config.yaml', '--device', 'cpu',
                                '--output', 'recs.json', *flags])
        written = json.loads((ws.base / side / 'results' / 'recs.json')
                             .read_text())
        assert written == json.loads(json.dumps(returned))
        out[side] = written
    return out['torch'], out['jax']


def assert_same_report(got, ref, int8=False):
    meta = dict(got['metadata'])
    assert meta.pop('generated_at') and ref['metadata']['generated_at']
    assert meta == {k: v for k, v in ref['metadata'].items()
                    if k != 'generated_at'}
    assert list(got['recommendations']) == list(ref['recommendations'])
    got_scores, ref_scores = [], []
    for user, items in ref['recommendations'].items():
        mine = {e['item_id']: e['score'] for e in got['recommendations'][user]}
        theirs = {e['item_id']: e['score'] for e in items}
        assert set(mine) == set(theirs), user
        got_scores += [mine[i] for i in theirs]
        ref_scores += list(theirs.values())
    diff = np.abs(np.asarray(got_scores) - np.asarray(ref_scores))
    if int8:
        assert (diff > AGREE).sum() <= MAX_FLIPPED * diff.size
        assert diff.max(initial=0.0) <= FLIP_TOL
    else:
        assert diff.max(initial=0.0) <= TOL


# --------------------------------------------------------------- generate
@pytest.mark.parametrize('args', [
    ['--users', '0', '3', '11', 'nobody'],
    ['--sample_users', '4'],
    [],
    ['--use_diversity'],
    ['--use_diversity', '--diversity_weight', '0.7', '--sample_users', '6'],
], ids=['users', 'sample', 'first5', 'mmr', 'mmr_w07'])
def test_generate_matches_jax(ws, monkeypatch, args):
    got, ref = generate_both(ws, monkeypatch, *args)
    assert_same_report(got, ref)
    recs = got['recommendations']
    if args[:1] == ['--users']:
        assert recs['nobody'] == [] and len(recs) == 4
    elif args[:1] == ['--sample_users']:
        assert len(recs) == 4
    elif not args:
        assert list(recs) == ['0', '1', '10', '11', '12']
    assert all(len(v) == TOP_K for u, v in recs.items() if u != 'nobody')


def test_generate_user_file_and_absolute_output(ws, monkeypatch, tmp_path):
    users = tmp_path / 'users.txt'
    users.write_text('4\n\n 9 \n14\n')
    got, ref = generate_both(ws, monkeypatch, '--user_file', str(users))
    assert_same_report(got, ref)
    assert list(got['recommendations']) == ['4', '9', '14']
    out = tmp_path / 'abs.json'
    monkeypatch.chdir(ws.base / 'torch')
    returned = quiet(tgen.main, ['--config', 'config.yaml', '--device',
                                 'cpu', '--users', '4', '--output',
                                 str(out)])
    assert json.loads(out.read_text()) == returned


@pytest.mark.parametrize('precision', ['int8', 'int8!'])
def test_generate_int8_matches_jax(ws, monkeypatch, precision):
    """int8 quantizes this head on the port's side: its flip point (64
    chain operations a first-layer lane, measured on the H100) lies below
    the head's 256, where JAX's (1,000, measured on the TPU) serves bf16;
    so both are held against JAX's int8!: the same item sets, scores
    within the int8 tolerance."""
    monkeypatch.chdir(ws.base / 'torch')
    rec, _ = quiet(tgen.load_model_and_data, Config.from_yaml('config.yaml'),
                   precision=precision, device='cpu')
    assert rec.scorer.precision == 'int8'
    got, ref = generate_both(ws, monkeypatch, '--precision', precision,
                             '--sample_users', '8',
                             jax_args=['--precision', 'int8!',
                                       '--sample_users', '8'])
    assert_same_report(got, ref, int8=True)


def test_generate_recommends_no_seen_item(ws, monkeypatch):
    """filter_seen (the default) drops every item of the user's history
    in the processed interactions."""
    monkeypatch.chdir(ws.base / 'torch')
    config = Config.from_yaml('config.yaml')
    rec, dataset = quiet(tgen.load_model_and_data, config, device='cpu')
    out = quiet(tgen.main, ['--config', 'config.yaml', '--device', 'cpu',
                            '--sample_users', '15', '--use_diversity'])
    for user, items in out['recommendations'].items():
        assert not {e['item_id'] for e in items} & \
            dataset.get_user_history(user)
    assert rec.scorer.device.type == 'cpu'


RANKED = {'top_k': ['--sample_users', '8'],
          'mmr': ['--use_diversity', '--sample_users', '6']}


@pytest.fixture(scope='module')
def ranked(ws):
    """The generate entry point under ``torchrun`` (two gloo ranks,
    ``--model_parallel 2``) for each of RANKED, all started at once."""
    return {name: Torchrun('generate_recommendations', [
        '--config', 'config.yaml', '--device', 'cpu', '--model_parallel',
        '2', '--output', f'recs_mesh_{name}.json', *args], ws.base / 'torch')
        for name, args in RANKED.items()}


@pytest.mark.parametrize('name', list(RANKED))
def test_generate_over_two_ranks(ws, ranked, monkeypatch, name):
    """``torchrun`` with two gloo ranks and ``--model_parallel 2``: rank 0
    alone prints and writes a report equal to the one-process report, which
    equals JAX's on its own 1x2 mesh."""
    args = RANKED[name]
    got, ref = generate_both(ws, monkeypatch, *args, jax_args=[
        *args, '--data_parallel', '1', '--model_parallel', '2'])
    assert_same_report(got, ref)
    out = ranked[name].wait()
    assert out.count('Recommendations saved to') == 1
    assert "Device mesh: {'data': 1, 'model': 2}" in out
    mesh = json.loads((ws.base / 'torch' / 'results' /
                       f'recs_mesh_{name}.json').read_text())
    assert_same_report(mesh, got)
    assert_same_report(mesh, ref)


def test_generate_refusals(ws, monkeypatch):
    """Without a card the default device raises; a device other than
    cuda or cpu raises; a mesh past the one process raises JAX's message;
    a diversity weight out of [0, 1] is a usage error."""
    monkeypatch.chdir(ws.base / 'torch')
    cfg = ['--config', 'config.yaml', '--users', '0']
    with pytest.raises((ValueError, RuntimeError)):
        quiet(tgen.main, [*cfg, '--device', 'tpu'])
    for flag in (['--model_parallel', '2'], ['--data_parallel', '2']):
        with pytest.raises(ValueError,
                           match=r'mesh but only 1 device\(s\) visible'):
            quiet(tgen.main, [*cfg, '--device', 'cpu', *flag])
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            quiet(tgen.main, [*cfg, '--device', 'cpu', '--diversity_weight',
                              '1.5'])
    with pytest.raises(ValueError, match='attention'):
        quiet(tgen.main, [*cfg, '--device', 'cpu', '--cascade', '8'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        quiet(tgen.main, cfg)


def jax_checkpoints_config(ws, tmp_path):
    """The port's workspace with the JAX run's checkpoints and encoders."""
    cfg = yaml.safe_load((ws.base / 'torch' / 'config.yaml').read_text())
    cfg['checkpoint_dir'] = str(ws.base / 'jax' / 'models' / 'checkpoints')
    path = tmp_path / 'config.yaml'
    path.write_text(yaml.dump(cfg))
    return path


def test_orbax_checkpoint_refused(ws, tmp_path):
    """A JAX-package checkpoint (an Orbax state/ directory) raises, in the
    discovery helper and through the entry point."""
    path = jax_checkpoints_config(ws, tmp_path)
    with pytest.raises(ValueError, match='JAX-package checkpoint'):
        find_model_checkpoint(Config.from_yaml(str(path)))
    with pytest.raises(ValueError, match='JAX-package checkpoint'):
        quiet(tgen.main, ['--config', str(path), '--device', 'cpu',
                          '--users', '0'])
    found = find_model_checkpoint(Config.from_yaml(
        str(ws.base / 'torch' / 'config.yaml')))
    assert found == ws.base / 'torch' / MODEL_DIR / 'best_model'
    last = find_model_checkpoint(Config.from_yaml(
        str(ws.base / 'torch' / 'config.yaml')), 'last_model.pth')
    assert last.name == 'last_model'


def test_sklearn_encoder_refused(ws, tmp_path, monkeypatch):
    """Encoders the JAX package pickled need scikit-learn: without it the
    port raises and names extract_encoders."""
    path = jax_checkpoints_config(ws, tmp_path)
    config = Config.from_yaml(str(path))
    assert type(find_encoders(config)['user_encoder']).__module__\
        .startswith('sklearn')
    for name in [m for m in sys.modules if m.split('.')[0] == 'sklearn']:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match='extract_encoders'):
        find_encoders(config)
    with pytest.raises(ImportError, match='extract_encoders'):
        quiet(tgen.main, ['--config', str(path), '--device', 'cpu',
                          '--users', '0'])


def test_missing_precomputed_tables_refused(ws):
    """A model that takes vision features and finds no vision table
    raises rather than score zero features."""
    config = Config.from_yaml(str(ws.base / 'torch' / 'config.yaml'))
    store = ItemFeatureStore(3, np.asarray(['a', 'b', 'c']))
    load_precomputed_tables(config, store)  # ID-only: nothing needed
    config.model.vision_model = 'resnet'
    with pytest.raises(FileNotFoundError, match='vision_emb'):
        load_precomputed_tables(config, store)
    store.tables['vision_emb'] = np.zeros((3, 2048), np.float32)
    load_precomputed_tables(config, store)


# -------------------------------------------------------- checkpoint tools
def twin_trees(root: Path):
    """The same checkpoints in both formats: meta.json beside an Orbax
    state/ directory (JAX) or a state.pt of the same bytes (port)."""
    blob = bytes(range(256)) * 40
    metas = {
        'resnet_sentence-bert/best_model': {
            'epoch': 3, 'best_early_stopping_score': 0.25,
            'model_config': {'vision_model': 'resnet',
                             'language_model': 'sentence-bert'}},
        'loose_model': {'epoch': 1, 'best_early_stopping_score': 0.5,
                        'model_config': {'vision_model': None,
                                         'language_model': None}},
        'mystery_model': {'epoch': 7},
    }
    for side in ('jax', 'torch'):
        base = root / side / 'ckpts'
        for rel, meta in metas.items():
            d = base / rel
            if side == 'jax':
                (d / 'state').mkdir(parents=True)
                (d / 'state' / 'blob').write_bytes(blob)
            else:
                d.mkdir(parents=True)
                (d / 'state.pt').write_bytes(blob)
            (d / 'meta.json').write_text(json.dumps(meta))
        (base / 'user_encoder.pkl').write_bytes(b'x' * 10)
        (base / 'encoders').mkdir()
        (base / 'encoders' / 'item_encoder.pkl').write_bytes(b'y' * 10)
    return root


def run_manager(root, monkeypatch, *args):
    """(port's output, JAX's output), each run from its own tree."""
    jcm = load_jax_script('checkpoint_manager')
    outs = []
    for side, main in (('torch', tcm.main), ('jax', jcm.main)):
        monkeypatch.chdir(root / side)
        outs.append(printed(main, [*args, '--checkpoint_dir', 'ckpts'])[0])
    return outs


def tree(base: Path):
    return sorted(str(p.relative_to(base)).replace('state.pt', 'state/blob')
                  for p in base.rglob('*') if p.is_file())


@pytest.mark.parametrize('command', ['list', 'organize --dry-run'])
def test_checkpoint_manager_matches_jax(tmp_path, monkeypatch, command):
    root = twin_trees(tmp_path)
    got, ref = run_manager(root, monkeypatch, *command.split())
    assert sorted(got.splitlines()) == sorted(ref.splitlines())
    assert 'combo=resnet_sentence-bert' in got or 'dry-run' in got
    assert tree(root / 'torch' / 'ckpts') == tree(root / 'jax' / 'ckpts')


def test_checkpoint_manager_info_and_organize_match_jax(tmp_path,
                                                        monkeypatch):
    root = twin_trees(tmp_path)
    run_manager(root, monkeypatch, 'info')
    infos = [json.loads((root / side / 'ckpts' / 'checkpoint_info.json')
                        .read_text()) for side in ('torch', 'jax')]
    for info in infos:
        assert info.pop('generated_at')
        info['checkpoints'].sort(key=lambda c: c['path'])
    assert infos[0] == infos[1]
    assert infos[0]['num_checkpoints'] == 3
    got, ref = run_manager(root, monkeypatch, 'organize')
    assert sorted(got.splitlines()) == sorted(ref.splitlines())
    assert tree(root / 'torch' / 'ckpts') == tree(root / 'jax' / 'ckpts')
    assert 'None_None/loose_model/state/blob' in tree(root / 'torch' /
                                                      'ckpts')
    # the port lists no JAX-package checkpoint
    monkeypatch.chdir(root / 'jax')
    assert 'No checkpoints found' in printed(
        tcm.main, ['list', '--checkpoint_dir', 'ckpts'])[0]


def test_inspect_checkpoint(ws, tmp_path):
    """OK on the trained checkpoint (as many arrays as JAX's inspector
    walks); exit 1 on a zeroed tensor and on a non-finite one."""
    best = ws.base / 'torch' / MODEL_DIR / 'best_model'
    out, code = printed(tinspect.main, [str(best)])
    assert code == 0 and 'Result: OK' in out
    jout, ok = printed(load_jax_script('inspect_checkpoint')
                       .inspect_checkpoint_weights,
                       str(ws.base / 'jax' / MODEL_DIR / 'best_model'))
    assert ok and out.splitlines()[0].split()[1] == \
        jout.splitlines()[0].split()[1]
    restored = checkpointing.load_checkpoint(best.parent, 'best_model')
    name = next(iter(restored['state']['params']))
    for value, status in ((0.0, 'ALL-ZERO!'), (float('nan'), 'NON-FINITE!')):
        state = restored['state']
        state['params'][name] = torch.full_like(state['params'][name], value)
        checkpointing.save_checkpoint(tmp_path, 'bad', state,
                                      restored['meta'])
        out, code = printed(tinspect.main, [str(tmp_path / 'bad')])
        assert code == 1 and status in out and 'CORRUPTION' in out
    out, code = printed(tinspect.main, [str(tmp_path / 'absent')])
    assert code == 1 and 'not found' in out


def test_extract_encoders_matches_jax(ws):
    """The port's extract_encoders writes the train script's classes,
    equal to JAX's extract_encoders'."""
    encoders = {side: ws.base / side / 'models' / 'checkpoints' / 'encoders'
                for side in ('jax', 'torch')}
    trained = {n: pickle_load(encoders['torch'] / f'{n}_encoder.pkl')
               for n in ('user', 'item', 'tag')}
    for name in ('user', 'item', 'tag'):
        (encoders['torch'] / f'{name}_encoder.pkl').unlink()
    quiet(textract.main, ['--config', str(ws.base / 'torch' /
                                          'config.yaml')])
    quiet(load_jax_script('extract_encoders').main,
          ['--config', str(ws.base / 'jax' / 'config.yaml')])
    for name in ('user', 'item', 'tag'):
        got = pickle_load(encoders['torch'] / f'{name}_encoder.pkl')
        ref = pickle_load(encoders['jax'] / f'{name}_encoder.pkl')
        assert type(got).__module__.startswith('pixelrec_multimodal_tpu_torch')
        assert got.classes_.tolist() == trained[name].classes_.tolist()
        assert [str(c) for c in got.classes_] == \
            [str(c) for c in ref.classes_], name


def pickle_load(path: Path):
    return pickle.loads(path.read_bytes())
