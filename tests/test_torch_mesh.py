"""The port's mesh layer (``parallel/mesh.py``) and its catalog-sharded
top-k (``ops/topk.py:sharded_topk``) against the JAX package's, on four
gloo ranks on the CPU (``tests/_torch_mesh.py``) and JAX's forced CPU
devices.

``make_mesh`` and ``mesh_from_flags`` give JAX's shapes, grids and
coordinates for 1x4, 2x2 and 4x1 and raise JAX's messages, with JAX
shown the same four devices. ``sharded_topk`` over 4 and over 2 shards
matches JAX's ``sharded_topk`` under ``shard_map``: values exactly, ids as
sets (ties inside the top-k, none at its boundary), k past the shard's
rows; ids of NEG_INF entries stay -1 in the port (JAX offsets them).
``init_distributed`` joins a group the caller started and refuses a local
rank past the cards and ``'cuda'`` without one.
"""
import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pixelrec_multimodal_tpu.ops.topk import sharded_topk as jax_sharded_topk
from pixelrec_multimodal_tpu.parallel import mesh as jmesh
from pixelrec_multimodal_tpu_torch.parallel import mesh as tmesh
from tests._torch_mesh import Ranks

WORLD, B, N, K = 4, 6, 32, 12
NEG_INF = -1e30
REQUESTS = [
    ('make_mesh', {'model_parallel': 4}),
    ('make_mesh', {'data_parallel': 2, 'model_parallel': 2}),
    ('make_mesh', {}),
    ('make_mesh', {'model_parallel': 3}),
    ('make_mesh', {'data_parallel': 3, 'model_parallel': 2}),
    ('mesh_from_flags', {'model_parallel': 2}),
    ('mesh_from_flags', {'data_parallel': 1, 'model_parallel': 4}),
    ('mesh_from_flags', {}),
    ('mesh_from_flags', {'data_parallel': 4, 'model_parallel': 2}),
    ('mesh_from_flags', {'data_parallel': 8}),
    ('mesh_from_flags', {'model_parallel': 8}),
]
# JAX lets a mesh take fewer devices than it sees; every port rank runs
# the entry point, so a mesh smaller than the world raises.
SMALLER = [('mesh_from_flags', {'data_parallel': 1, 'model_parallel': 2}),
           ('mesh_from_flags', {'data_parallel': 1, 'model_parallel': 1})]


def topk_scores():
    """[B, N] scores: ties inside each row's top-k (two pairs of equal
    values among its largest), a row with fewer than K finite entries
    (NEG_INF fills the rest), a row whose top-k lies in one shard."""
    rng = np.random.default_rng(3)
    s = rng.standard_normal((B, N)).astype(np.float32)
    s[2, :] = NEG_INF
    s[2, [1, 9, 17, 30, 31]] = rng.standard_normal(5)
    s[4, 8:16] += 10.0
    for r in range(B):
        top = np.argsort(-s[r])[:5]
        s[r, top[1]] = s[r, top[2]]
        s[r, top[3]] = s[r, top[4]]
    return s


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp('mesh'), WORLD)
    scores = topk_scores()
    r.submit({'calls': [
        {'id': 'info', 'kind': 'mesh_info', 'requests': REQUESTS},
        {'id': 'smaller', 'kind': 'mesh_info', 'requests': SMALLER},
        {'id': 'init', 'kind': 'init_distributed'},
        {'id': 'topk_1x4', 'kind': 'sharded_topk', 'mesh': (1, 4),
         'args': {'scores': scores, 'k': K}},
        {'id': 'topk_2x2', 'kind': 'sharded_topk', 'mesh': (2, 2),
         'args': {'scores': scores, 'k': K}},
    ]})
    yield r
    r.kill()


@pytest.fixture
def four_devices(monkeypatch):
    """JAX shown four devices, as the port's world of four ranks."""
    devices = jax.devices()[:WORLD]
    monkeypatch.setattr(jmesh.jax, 'devices', lambda: devices)
    return devices


def jax_info(requests):
    """``tests._torch_mesh.mesh_info``'s answer from the JAX package."""
    out = []
    for name, kw in requests:
        try:
            m = getattr(jmesh, name)(**kw)
        except ValueError as e:
            out.append(('error', str(e)))
            continue
        out.append(None if m is None else (
            'mesh', dict(m.shape), [[d.id for d in row]
                                    for row in m.devices.tolist()]))
    return out


def test_mesh_shapes_grids_and_messages(ranks, four_devices):
    """Every rank sees JAX's shapes and grids (device ids as ranks) and
    its own grid coordinates, one group per axis, and JAX's errors."""
    ref = jax_info(REQUESTS)
    assert [r[0] for r in ref] == ['mesh'] * 3 + ['error'] * 2 + \
        ['mesh'] * 3 + ['error'] * 3
    for rank, out in enumerate(ranks.results()):
        for got, want in zip(out['info'], ref):
            if want[0] == 'error':
                assert got == want
                continue
            kind, shape, grid, coords, grouped = got
            assert (kind, shape, grid) == want
            assert coords == tuple(int(c) for c in np.argwhere(
                np.asarray(grid) == rank)[0])
            assert grouped == {'data': True, 'model': True}


def test_mesh_smaller_than_the_world_raises(ranks, four_devices):
    """JAX takes the first devices; the port raises."""
    assert [r and r[0] for r in jax_info(SMALLER)] == ['mesh', None]
    for out in ranks.results():
        assert [r[0] for r in out['smaller']] == ['error', 'error']
        assert 'every rank takes a place' in out['smaller'][0][1]
        assert '4 ranks were started' in out['smaller'][1][1]


def test_mesh_in_one_process(monkeypatch):
    """Without a process group the world is one process: a 1x1 mesh whose
    collectives are the identity, mesh_from_flags None for 1x1 and JAX's
    message past one device."""
    m = tmesh.make_mesh()
    assert m.shape == {'data': 1, 'model': 1} and m.coords == (0, 0)
    assert m.groups == {'data': None, 'model': None}
    t = torch.arange(6.0).reshape(2, 3)
    assert tmesh.all_gather(m, 'model', t, dim=1) is t
    assert m.traffic == {'all_gather': 24}
    assert tmesh.mesh_from_flags() is None
    one = jax.devices()[:1]
    monkeypatch.setattr(jmesh.jax, 'devices', lambda: one)
    for kw in ({'model_parallel': 2}, {'data_parallel': 3}):
        with pytest.raises(ValueError) as want:
            jmesh.mesh_from_flags(**kw)
        with pytest.raises(ValueError) as got:
            tmesh.mesh_from_flags(**kw)
        assert str(got.value) == str(want.value)
        assert 'only 1 device(s) visible' in str(got.value)


def jax_topk(scores, mp):
    mesh = jmesh.make_mesh(jax.devices()[:WORLD], model_parallel=mp)
    fn = jax.jit(shard_map(lambda s: jax_sharded_topk(s, K, 'model'),
                           mesh=mesh, in_specs=P(None, 'model'),
                           out_specs=P(), check_vma=False))
    v, i = fn(scores)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize('shape', [(1, 4), (2, 2)], ids=['1x4', '2x2'])
def test_sharded_topk_matches_jax(ranks, shape):
    scores = topk_scores()
    jv, ji = jax_topk(scores, shape[1])
    outs = [out[f'topk_{shape[0]}x{shape[1]}'] for out in ranks.results()]
    for tv, ti in outs:
        assert tv.shape == ti.shape == (B, K) and ti.dtype == np.int32
        np.testing.assert_array_equal(tv, jv)
        live = jv > NEG_INF / 2
        for r in range(B):
            assert set(ti[r][live[r]]) == set(ji[r][live[r]])
            np.testing.assert_array_equal(
                scores[r, ti[r][live[r]]], tv[r][live[r]])
        # JAX offsets a NEG_INF entry's id by its shard's base; the port
        # keeps -1
        assert (~live).sum() == K - 5 and (ti[~live] == -1).all()
        assert (ji[~live] >= 0).all()
        np.testing.assert_array_equal(tv, outs[0][0])
        np.testing.assert_array_equal(ti, outs[0][1])


def test_init_distributed_joins_the_callers_group(ranks):
    """A group the caller started is used as it is: no new group, the
    device asked for."""
    for out in ranks.results():
        assert out['init'] == ('cpu', WORLD)


def test_init_distributed_refusals(monkeypatch):
    """'cuda' without a card raises; under torchrun a local rank past the
    visible cards raises, naming the count, before any group starts;
    another device raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tmesh.init_distributed('cuda')
    with pytest.raises((ValueError, RuntimeError), match='tpu'):
        tmesh.init_distributed('tpu')
    assert tmesh.init_distributed('cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('LOCAL_RANK', '1')
    with pytest.raises(RuntimeError, match=r'local rank 1 .* 1 CUDA '
                                           r'device\(s\) visible'):
        tmesh.init_distributed('cuda')
    assert not torch.distributed.is_initialized()
