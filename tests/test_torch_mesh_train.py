"""The port's training over a mesh (``parallel/mesh.py``,
``parallel/tensor_parallel.py``, the meshed steps of ``training/``) on four
gloo ranks on the CPU (``tests/_torch_mesh.py``), against JAX's step on
four forced CPU devices and against the port in one process.

A clip-style flagship at small widths (BatchNorm, InfoNCE over a CLIP text
table, one packed item table, AdamW with the clip) takes two steps of a
16-row batch with padded rows (weight 0) from the same converted weights:

* at 4x1 and 2x2 (data-parallel, replicated state), and at 2x2 with the
  parameters tensor-parallel and the table split over 'model', against
  JAX's ``make_step_fns`` step with the batch on ``P('data')`` over 4
  devices at dropout 0: losses, metrics and BatchNorm statistics within
  1e-5, parameters as the single-process parity holds AdamW (all but 0.2%
  of entries within 1e-5, none past 1e-3; ``tests/test_torch_train.py``);
* the tensor-parallel step against the replicated one, to the same;
* at 2x2 with dropout 0.1 against one process drawing from the same
  generator seed (the ranks draw the global batch's masks), to the same;
* the unfrozen step (``parallel/dryrun.e2e_model``: tiny CLIP towers and a
  text tower under remat, the augmentation on, dropout 0.1) at 2x2,
  tensor-parallel, against one process: the augmentation's draws and the
  masks are the global batch's.

Every rank returns the same metrics and the same whole state, bit for
bit. ``param_shardings`` picks JAX's parameters on the same Flax trees
with JAX's per-rank shard shapes; the gather from a table split over
'model' equals the whole table's; a checkpoint written at 2x2 loads in one
process bit for bit, and one written in one process loads at 2x2 as its
slices.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from pixelrec_multimodal_tpu.encoders import clip as jclip
from pixelrec_multimodal_tpu.encoders import text_models as jtext
from pixelrec_multimodal_tpu.models import end_to_end as jend
from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.parallel import mesh as jmesh
from pixelrec_multimodal_tpu.training import e2e_steps as je2e
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch.config import ImageAugmentationConfig
from pixelrec_multimodal_tpu_torch.parallel import Mesh, param_shardings
from pixelrec_multimodal_tpu_torch.parallel import mesh as tmesh
from pixelrec_multimodal_tpu_torch.parallel import dryrun
from pixelrec_multimodal_tpu_torch.parallel.tensor_parallel import (
    shard_module,
)
from pixelrec_multimodal_tpu_torch.training import e2e_steps as te2e
from pixelrec_multimodal_tpu_torch.training import optimizers as topt
from pixelrec_multimodal_tpu_torch.training import steps as tsteps
from pixelrec_multimodal_tpu_torch.training.trainer import (
    restore_optimizer,
    train_state_tensors,
)
from pixelrec_multimodal_tpu_torch.utils import checkpointing
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    end_to_end_state_dict,
)
from tests._torch_mesh import Ranks
from tests._torch_port import (
    LANGUAGE,
    N_TAGS,
    N_USERS,
    NUMERICAL,
    VISION,
    item_tables,
    model_kwargs,
    port_model,
    randomize_batchnorm,
)

WORLD, N_ITEMS, B, STEPS, CLIP_TEXT = 4, 40, 16, 2, 48
LR, TOL = 1e-2, 1e-5
ADAM_MAX_SHARE, ADAM_PAST_TOL = 2e-3, 1e-3
OPT = dict(optimizer_type='adamw', learning_rate=LR, weight_decay=0.01,
           gradient_clip=1.0)
PACKED = (f'packed::vision_emb={VISION}+language_emb={LANGUAGE}'
          f'+numerical={NUMERICAL}+clip_text_emb={CLIP_TEXT}')
E2E_ITEMS, E2E_B = 32, 8
AUGMENT = dict(enabled=True, gaussian_blur=False)
SGD = dict(optimizer_type='sgd', learning_rate=LR, weight_decay=0.01,
           gradient_clip=1.0)
META = {'epoch': 1}


def kwargs(dropout=0.0):
    return dict(model_kwargs(N_ITEMS), use_contrastive=True,
                clip_text_feature_dim=CLIP_TEXT, dropout_rate=dropout)


@functools.lru_cache(maxsize=None)
def flax_variables():
    """JAX's model and a Flax tree of its shapes (traced, not run), its
    parameters drawn from a numpy seed (BatchNorm's by
    ``randomize_batchnorm``)."""
    jmodel = JaxRecommender(**kwargs())
    z = jnp.zeros(4, jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)}, z, z, z,
        vision_features=jnp.zeros((4, VISION)),
        language_features=jnp.zeros((4, LANGUAGE)),
        numerical_features=jnp.zeros((4, NUMERICAL)),
        clip_text_features=jnp.zeros((4, CLIP_TEXT)), train=False,
        return_embeddings=True))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: (0.2 * rng.standard_normal(
        s.shape)).astype(np.float32), shapes)
    variables['params']['temperature'] = np.float32(0.07)
    return jmodel, randomize_batchnorm(variables)


def packed_table():
    t = item_tables(N_ITEMS)
    clip = np.random.default_rng(11).standard_normal(
        (N_ITEMS, CLIP_TEXT)).astype(np.float32)
    return {PACKED: np.concatenate([t['vision_emb'], t['language_emb'],
                                    t['numerical'], clip], axis=1)}


def global_batches(seed=5):
    rng = np.random.default_rng(seed)
    w = (rng.random((STEPS, B)) > 0.2).astype(np.float32)
    w[:, -3:] = 0.0  # padded rows
    return dict(user_idx=rng.integers(0, N_USERS, (STEPS, B)).astype(np.int32),
                item_idx=rng.integers(0, N_ITEMS, (STEPS, B)).astype(np.int32),
                tag_idx=rng.integers(0, N_TAGS, (STEPS, B)).astype(np.int32),
                label=rng.integers(0, 2, (STEPS, B)).astype(np.float32),
                weight=w)


def port_steps(model, tables, bs, seed=0, opt=OPT):
    """The port's single-process steps over ``bs``: (metrics a step,
    state)."""
    state = tsteps.init_train_state(model, topt.build_optimizer(**opt))
    step, _ = tsteps.make_step_fns(model, {k: torch.from_numpy(v)
                                           for k, v in tables.items()})
    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(len(bs['item_idx'])):
        state, m = step(state, {k: torch.from_numpy(v[i])
                                for k, v in bs.items()}, gen)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def jax_steps(jmodel, variables, tables, bs):
    """JAX's steps with each batch on P('data') over 4 forced devices."""
    mesh = jmesh.make_mesh(jax.devices()[:WORLD], data_parallel=WORLD)
    sh = NamedSharding(mesh, P(jmesh.DATA_AXIS))
    tx = jopt.build_optimizer('adamw', LR, 0.01, gradient_clip=1.0)
    state = jsteps.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables['batch_stats'], tx=tx)
    train, _ = jsteps.make_step_fns(jmodel, {k: jnp.asarray(v)
                                             for k, v in tables.items()})
    out = []
    for i in range(STEPS):
        b = {k: jax.device_put(jnp.asarray(v[i]), sh) for k, v in bs.items()}
        state, m = train(state, b, jax.random.PRNGKey(i))
        out.append({k: float(v) for k, v in m.items()})
    whole = port_model(kwargs(), jax.tree.map(np.asarray, {
        'params': state.params, 'batch_stats': state.batch_stats}))
    return out, {k: v.numpy() for k, v in whole.state_dict().items()}


def one_process_checkpoint(variables, tables, directory):
    """One AdamW step in one process, written as the trainer writes."""
    model = port_model(kwargs(), variables)
    _, state = port_steps(model, tables, {k: v[:1] for k, v in
                                          global_batches(9).items()})
    checkpointing.save_checkpoint(directory, 'best_model',
                                  train_state_tensors(state), META)


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks, started first; the job; then JAX's steps and the
    one-process references while the ranks run."""
    base = tmp_path_factory.mktemp('mesh_train')
    ranks = Ranks(base / 'job', WORLD)
    jmodel, variables = flax_variables()
    tables, bs = packed_table(), global_batches()
    one_process_checkpoint(variables, tables, base / 'ckpt_one')
    e2e_bs = {k: v[None] for k, v in dryrun.e2e_batch(
        E2E_B, E2E_ITEMS).items()}
    e2e_num = np.random.default_rng(7).standard_normal(
        (E2E_ITEMS, dryrun.NUMERICAL)).astype(np.float32)
    common = {'kind': 'train_steps', 'model': 'contr', 'tables': 'items',
              'batches': bs, 'optimizer': OPT}
    ranks.submit({
        'models': {'contr': {'kw': kwargs(), 'variables': variables}},
        'tables': {'items': tables}, 'e2e_numerical': e2e_num,
        'calls': [
            dict(common, id='4x1', mesh=(4, 1)),
            dict(common, id='2x2', mesh=(2, 2)),
            dict(common, id='tp', mesh=(2, 2), tp=True, tables_sharded=True,
                 checkpoint=str(base / 'ckpt_mesh')),
            dict(common, id='drop', mesh=(2, 2), kw={'dropout_rate': 0.1},
                 seed=5),
            {'id': 'gather', 'kind': 'gather', 'model': 'contr',
             'tables': 'items', 'mesh': (2, 2),
             'item_idx': bs['item_idx'][0]},
            {'id': 'load', 'kind': 'load_checkpoint', 'model': 'contr',
             'mesh': (2, 2), 'tp': True,
             'checkpoint': str(base / 'ckpt_one')},
            {'id': 'e2e', 'kind': 'e2e_steps', 'mesh': (2, 2), 'tp': True,
             'n_items': E2E_ITEMS, 'batches': e2e_bs, 'optimizer': SGD,
             'augmentation': AUGMENT, 'seed': 3}]})
    refs = {'jax': jax_steps(jmodel, variables, tables, bs)}
    drop, state = port_steps(port_model(kwargs(0.1), variables), tables, bs,
                             seed=5)
    refs['drop'] = (drop, {k: v.numpy()
                           for k, v in state.model.state_dict().items()})
    refs['e2e'] = e2e_one_process(e2e_bs, e2e_num)
    yield ranks.results(), refs, base
    ranks.kill()


def e2e_one_process(bs, num):
    model = dryrun.e2e_model(E2E_ITEMS, 'cpu')
    state = te2e.init_e2e_train_state(model, topt.build_optimizer(**SGD))
    step, _ = te2e.make_e2e_step_fns(
        model, {'numerical': torch.from_numpy(num)},
        augmentation_config=ImageAugmentationConfig(**AUGMENT))
    gen = torch.Generator().manual_seed(3)
    state, m = step(state, {k: torch.from_numpy(v[0]) for k, v in bs.items()},
                    gen)
    return ([{k: float(v) for k, v in m.items()}],
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


def held(ref: dict, got: dict, adam: bool = True):
    """Parameters and statistics within TOL, AdamW's few sign-sensitive
    entries aside (module docstring)."""
    past = total = 0
    for k, r in ref.items():
        if k.endswith('num_batches_tracked'):
            continue
        d = np.abs(np.asarray(r, np.float64) - got[k])
        past += int((d > TOL).sum())
        total += d.size
        assert d.max() <= (ADAM_PAST_TOL if adam else TOL), (k, d.max())
    assert past <= (ADAM_MAX_SHARE * total if adam else 0), (past, total)


def state_dict_of(result):
    st = result['state']
    return {**st['params'], **st['batch_stats']}


def metrics_close(got, ref):
    for g, r in zip(got, ref, strict=True):
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, atol=TOL, err_msg=k)


@pytest.mark.parametrize('call', ['4x1', '2x2', 'tp'])
def test_meshed_step_matches_jax(world, call):
    out, refs, _ = world
    ref_metrics, ref_state = refs['jax']
    got = out[0][call]
    metrics_close(got['metrics'], ref_metrics)
    assert got['metrics'][0]['contrastive_loss'] > 0
    assert got['step'] == STEPS
    held(ref_state, state_dict_of(got))


@pytest.mark.parametrize('call', ['4x1', '2x2', 'tp', 'drop', 'e2e'])
def test_every_rank_holds_the_same_result(world, call):
    out = world[0]
    for r in range(1, WORLD):
        assert out[r][call]['metrics'] == out[0][call]['metrics']
        for group in ('params', 'batch_stats'):
            for k, v in out[0][call]['state'][group].items():
                assert np.array_equal(out[r][call]['state'][group][k], v), k


def test_tp_step_matches_the_replicated_one(world):
    """The tensor-parallel step at 2x2 (parameters and table split over
    'model') against the replicated one; each rank holds half of every
    sharded parameter."""
    out = world[0]
    metrics_close(out[0]['tp']['metrics'], out[0]['2x2']['metrics'])
    held(state_dict_of(out[0]['2x2']), state_dict_of(out[0]['tp']))
    full, shard = out[0]['2x2']['shapes'], out[0]['tp']['shapes']
    halved = {k for k in full if shard[k] != full[k]}
    assert 'user_embedding.weight' in halved
    assert 'tag_embedding.weight' not in halved  # 7 rows: replicated
    for k in halved:
        assert shard[k] == (full[k][0] // 2,) + full[k][1:], k
    # the gradient's sum over 'data' carries the shards only
    assert out[0]['tp']['traffic']['all_reduce_sum'] < \
        out[0]['2x2']['traffic']['all_reduce_sum']


def test_dropout_step_matches_one_process(world):
    out, refs, _ = world
    ref_metrics, ref_state = refs['drop']
    metrics_close(out[0]['drop']['metrics'], ref_metrics)
    held(ref_state, state_dict_of(out[0]['drop']))
    assert out[0]['drop']['metrics'] != out[0]['2x2']['metrics']


def test_meshed_e2e_step_matches_one_process(world):
    out, refs, _ = world
    ref_metrics, ref_state = refs['e2e']
    metrics_close(out[0]['e2e']['metrics'], ref_metrics)
    held(ref_state, state_dict_of(out[0]['e2e']), adam=False)


def test_sharded_table_gather_equals_the_whole_table(world):
    for r in range(WORLD):
        sharded, whole = world[0][r]['gather']
        assert sorted(sharded) == sorted(whole)
        for k in whole:
            assert np.array_equal(sharded[k], whole[k]), k


def test_checkpoint_written_on_the_mesh_loads_in_one_process(world):
    """The 2x2 tensor-parallel state, written on the mesh, is the
    single-process file: it loads into one process's model and optimizer,
    bit for bit the state the ranks gathered."""
    out, _, base = world
    restored = checkpointing.load_checkpoint(base / 'ckpt_mesh',
                                             'best_model')
    st = restored['state']
    ref = out[0]['tp']['state']
    for group in ('params', 'batch_stats'):
        assert sorted(st[group]) == sorted(ref[group])
        for k, v in ref[group].items():
            assert np.array_equal(st[group][k].numpy(), v), k
    for field, v in ref['opt_state'].items():
        if field == 'names':
            assert list(st['opt_state']['names']) == list(v)
        else:
            assert np.array_equal(st['opt_state'][field].numpy(), v), field
    model = port_model(kwargs())
    state = tsteps.init_train_state(model, topt.build_optimizer(**OPT))
    checkpointing.load_model_state(model, st)
    restore_optimizer(state, st)
    for k, v in ref['params'].items():
        assert np.array_equal(dict(model.named_parameters())[k]
                              .detach().numpy(), v), k
    assert int(state.step) == STEPS


def test_checkpoint_written_in_one_process_loads_on_the_mesh(world):
    """Each rank's parameters and optimizer fields are its slices of the
    single-process file, bit for bit."""
    out, _, base = world
    st = checkpointing.load_checkpoint(base / 'ckpt_one', 'best_model')[
        'state']
    model = port_model(kwargs())
    for r in range(WORLD):
        got = out[r]['load']
        mesh = Mesh(np.arange(WORLD).reshape(2, 2), r,
                    {'data': None, 'model': None})
        assert mesh.coords == got['coords']
        want = checkpointing.shard_state(st, mesh,
                                         param_shardings(model, mesh))
        for k, v in want['params'].items():
            assert np.array_equal(got['params'][k], v.numpy()), k
        for field in ('mu', 'nu', 'lr', 'count'):
            assert np.array_equal(got['opt_state'][field],
                                  want['opt_state'][field].numpy()), field
    assert got['params']['item_embedding.weight'].shape == (N_ITEMS // 2,
                                                            32)


# -------------------------------------------------- shardings against JAX
def tiny_jax_e2e():
    """The shapes of the Flax parameters of JAX's dry-run end-to-end model
    (``__graft_entry__.py``), as its ``init_e2e_train_state`` makes them
    (traced, not run)."""
    vis = jclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                 num_layers=2, num_heads=2, image_size=32,
                                 patch_size=16)
    txt = jtext.TextEncoderConfig(vocab_size=64, hidden_size=24,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=48,
                                  max_position_embeddings=16)
    ctx = jclip.CLIPTextConfig(vocab_size=64, hidden_size=16,
                               intermediate_size=32, num_layers=2,
                               num_heads=2, max_position_embeddings=16)
    scorer = JaxRecommender(
        n_users=64, n_items=E2E_ITEMS, n_tags=8, num_numerical_features=4,
        embedding_dim=16, vision_feature_dim=32, language_feature_dim=24,
        clip_text_feature_dim=16, use_contrastive=True,
        fusion_hidden_dims=(32,), fusion_type='concatenate',
        use_batch_norm=True, dropout_rate=0.1, vision_model_name='clip',
        language_model_name='sentence-bert')

    class TinyE2E(jend.EndToEndRecommender):
        def setup(self):
            self.vision_encoder = self._maybe_remat(
                jclip.CLIPVisionTower(vis))
            self.language_encoder = self._maybe_remat(
                jtext.TextTransformer(txt))
            self.clip_text_encoder = self._maybe_remat(
                jclip.CLIPTextTower(ctx))

    model = TinyE2E(scorer=scorer, vision_model_name='clip',
                    language_model_name='sentence-bert', use_clip_text=True)
    state = jax.eval_shape(lambda: je2e.init_e2e_train_state(
        model, jopt.build_optimizer('sgd', 0.1), jax.random.PRNGKey(0),
        image_size=32, text_len=16, clip_text_len=16))
    return state.params


def jax_choice(params, to_torch):
    """JAX's ``param_shardings`` on a 2x2 mesh of ``params`` in torch
    names: name -> (sharded, the shard's torch shape)."""
    mesh = jmesh.make_mesh(jax.devices()[:4], data_parallel=2,
                           model_parallel=2)
    sh = jmesh.param_shardings(params, mesh)
    marks = to_torch(jax.tree.map(
        lambda s, p: np.full(p.shape, float(jmesh.MODEL_AXIS in s.spec),
                             np.float32), sh, params))
    shards = to_torch(jax.tree.map(
        lambda s, p: np.zeros(s.shard_shape(p.shape), np.float32), sh,
        params))
    return {k: (bool(m.max() > 0), tuple(shards[k].shape))
            for k, m in marks.items()}


def port_choice(build):
    """The port's ``param_shardings`` on a 2x2 mesh: name -> (sharded,
    rank 0's shard shape), the shard shapes the same on every rank."""
    shapes = []
    for r in range(4):
        mesh = Mesh(np.arange(4).reshape(2, 2), r,
                    {'data': None, 'model': None})
        model = build()
        dims = shard_module(model, mesh)
        shapes.append({k: tuple(p.shape) for k, p in
                       model.named_parameters()})
    assert all(s == shapes[0] for s in shapes)
    return {k: (dims[k] == 0, shapes[0][k]) for k in dims}


@pytest.mark.parametrize('helper', ['batch', 'replicated', 'items',
                                    'score_matrix'])
def test_sharding_helpers_give_jax_device_slices(helper):
    """Each rank's slice of the port's helpers is the block JAX's
    NamedSharding of the same name gives the device at its coordinates
    (a 2x2 mesh; ``shard_batch`` takes ``batch_sharding``'s rows)."""
    jm = jmesh.make_mesh(jax.devices()[:4], data_parallel=2,
                         model_parallel=2)
    shape = (8, 12) if helper == 'score_matrix' else (8,)
    jsh = {'batch': jmesh.batch_sharding, 'replicated': jmesh.replicated,
           'items': jmesh.item_table_sharding,
           'score_matrix': jmesh.score_matrix_sharding}[helper](jm)
    where = jsh.devices_indices_map(shape)
    for r in range(4):
        mesh = Mesh(np.arange(4).reshape(2, 2), r,
                    {'data': None, 'model': None})
        got = {'batch': lambda: (tmesh.batch_sharding(mesh, 8),),
               'replicated': lambda: (tmesh.replicated(mesh, 8),),
               'items': lambda: (tmesh.item_table_sharding(mesh, 8),),
               'score_matrix': lambda: tmesh.score_matrix_sharding(
                   mesh, 8, 12)}[helper]()
        ref = where[jm.devices[mesh.coords]]
        assert [(g.start, g.stop) for g in got] == \
            [(x.start or 0, x.stop if x.stop is not None else n)
             for x, n in zip(ref, shape)]
    batch = {'x': np.arange(8), 'y': np.arange(16).reshape(8, 2)}
    mesh = Mesh(np.arange(4).reshape(2, 2), 3, {'data': None, 'model': None})
    assert np.array_equal(tmesh.shard_batch(batch, mesh)['y'],
                          batch['y'][4:])


@pytest.mark.parametrize('which', ['flagship', 'e2e'])
def test_param_shardings_match_jax(which):
    if which == 'flagship':
        _, variables = flax_variables()
        ref = jax_choice(variables['params'], lambda t: {
            k[len('scorer.'):]: v for k, v in
            end_to_end_state_dict({'scorer': t}).items()})
        got = port_choice(lambda: port_model(kwargs()))
    else:
        ref = jax_choice(tiny_jax_e2e(), end_to_end_state_dict)
        got = port_choice(lambda: dryrun.e2e_model(E2E_ITEMS, 'cpu'))
    assert got == ref
    assert sum(s for s, _ in got.values()) >= 8
