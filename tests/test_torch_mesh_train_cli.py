"""The port's ``train`` entry point over the 'data' axis of two gloo
ranks on the CPU, under ``torchrun``, against the port in one process and
the JAX script with ``--data_parallel 2``.

On the ``tests/_torch_port.make_workspace`` workspace (split by the port,
copied three times; dropout 0.3: the ranks draw the global batch's
masks), ``--device cpu --data_parallel 2``: rank 0 alone prints and
writes; the losses and the checkpoint within 1e-5 of the port's one
process; the files, the metadata's keys and ``data_stats`` as the JAX
script's with ``--data_parallel 2``. A batch that the data axis does not
divide is refused before any work, naming the divisor JAX's script
shrinks the axis to.
"""
import json
import shutil

import numpy as np
import pytest
import torch
import yaml

from pixelrec_multimodal_tpu_torch.parallel import Mesh
from pixelrec_multimodal_tpu_torch.scripts import create_splits as tsplits
from pixelrec_multimodal_tpu_torch.scripts import train as ttrain
from tests._torch_mesh import Torchrun
from tests._torch_port import load_jax_script, make_workspace, quiet

TOL = 1e-5


def workspaces(base):
    """The workspace split by the port, copied for the meshed run, the
    one-process run and the JAX script."""
    cfg = make_workspace(base / 'mesh')
    quiet(tsplits.main, str(cfg))
    for name in ('one', 'jax'):
        shutil.copytree(base / 'mesh', base / name)
        path = base / name / 'config.yaml'
        path.write_text(path.read_text().replace(str(base / 'mesh'),
                                                 str(base / name)))
    return {name: base / name for name in ('mesh', 'one', 'jax')}


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """torchrun started first; then the port's one process and the JAX
    script."""
    base = tmp_path_factory.mktemp('mesh_train_cli')
    ws = workspaces(base)
    run = Torchrun('train', ['--config', 'config.yaml', '--device', 'cpu',
                             '--data_parallel', '2'], ws['mesh'])
    scripts = {
        'one': quiet(ttrain.main, ['--config', str(ws['one'] /
                                                   'config.yaml'),
                                   '--device', 'cpu']),
        'jax': quiet(load_jax_script('train').main, [
            '--config', str(ws['jax'] / 'config.yaml'), '--device', 'cpu',
            '--data_parallel', '2'])}
    return {'ws': ws, 'scripts': scripts, 'torchrun': run.wait()}


def test_train_entry_point_under_torchrun(world):
    """Two gloo ranks: rank 0 alone prints and writes; the losses, the
    metadata's numbers and the checkpoint are the one process's (dropout
    0.3, the global batch's masks)."""
    out, ws = world['torchrun'], world['ws']
    assert out.count("Device mesh: {'data': 2, 'model': 1}") == 1
    assert out.count('Training complete') == 1
    one = world['scripts']['one']
    mesh = json.loads((ws['mesh'] / 'results' / 'training_metadata.json')
                      .read_text())
    assert one['metadata']['training_config']['batch_size'] == 32
    for k in ('final_train_loss', 'final_val_loss', 'best_val_loss'):
        assert mesh[k] == pytest.approx(one['metadata'][k], abs=TOL), k
    assert mesh['device_info']['mesh'] == {'data': 2, 'model': 1}
    ckpt = 'models/checkpoints/None_None/best_model/state.pt'
    got = torch.load(ws['mesh'] / ckpt, weights_only=True)
    ref = torch.load(ws['one'] / ckpt, weights_only=True)
    for k, v in ref['params'].items():
        np.testing.assert_allclose(got['params'][k].numpy(), v.numpy(),
                                   atol=TOL, err_msg=k)
    assert torch.equal(got['step'], ref['step'])


def test_train_entry_point_files_match_jax_meshed_script(world):
    ws = world['ws']
    jax_res = world['scripts']['jax']
    mesh = json.loads((ws['mesh'] / 'results' / 'training_metadata.json')
                      .read_text())
    assert mesh['data_stats'] == jax_res['metadata']['data_stats']
    assert set(mesh) == set(jax_res['metadata'])
    assert np.isfinite(mesh['final_train_loss'])
    for name in ('encoders/user_encoder.pkl', 'encoders/item_encoder.pkl',
                 'None_None/best_model/meta.json',
                 'None_None/last_model/meta.json'):
        for w in ('mesh', 'jax'):
            assert (ws[w] / 'models' / 'checkpoints' / name).exists(), name
    for name in ('training_run_config.yaml',
                 'training_run_config_validated.yaml'):
        got = yaml.safe_load((ws['mesh'] / 'results' / name).read_text())
        ref = yaml.safe_load((ws['jax'] / 'results' / name).read_text())
        assert got.keys() == ref.keys()


def test_training_mesh_refuses_an_uneven_batch(monkeypatch):
    """Where the data axis does not divide the batch, JAX's script shrinks
    the axis to the largest divisor; the port raises before any work and
    names that divisor."""
    jtrain = load_jax_script('train')
    shrunk = quiet(jtrain.build_training_mesh, 3, 1, 32)
    assert shrunk.devices.shape == (2, 1)
    three = Mesh(np.arange(3).reshape(3, 1), 0,
                 {'data': None, 'model': None})
    monkeypatch.setattr(ttrain, 'mesh_from_flags', lambda dp, mp: three)
    with pytest.raises(ValueError, match='largest divisor is '
                                         'data_parallel=2'):
        ttrain.build_training_mesh(3, 1, 32)
    monkeypatch.setattr(ttrain, 'mesh_from_flags', lambda dp, mp: None)
    assert ttrain.build_training_mesh(None, 1, 32) is None


def test_cache_and_scaler_writes_are_whole_or_absent(tmp_path, monkeypatch):
    """Ranks that build the same dataset write the same feature cache and
    scaler: each file is written beside its place and renamed over it, so
    a rank reading it never sees half a file (a write that fails leaves
    the previous file)."""
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.data.processors import (
        NumericalProcessor,
    )
    store = ItemFeatureStore(3, ['a', 'b', 'c'])
    store.tables['numerical'] = np.ones((3, 2), np.float32)
    store.save(str(tmp_path))
    proc = NumericalProcessor()
    proc.fit_scaler({'x': np.arange(4.0)}, ['x'])
    proc.save_scaler(tmp_path / 'scaler.pkl')

    def half(path, *a, **kw):
        with open(path, 'wb') as f:
            f.write(b'PK')
        raise OSError('disk full')
    monkeypatch.setattr(np, 'savez', half)
    with pytest.raises(OSError):
        store.save(str(tmp_path))
    monkeypatch.setattr('pickle.dump', lambda obj, f: half(f.name))
    with pytest.raises(OSError):
        proc.save_scaler(tmp_path / 'scaler.pkl')
    fresh = ItemFeatureStore(3, ['a', 'b', 'c'])
    assert fresh.load_tables(str(tmp_path))
    assert np.array_equal(fresh.tables['numerical'], store.tables['numerical'])
    assert NumericalProcessor().load_scaler(tmp_path / 'scaler.pkl')
