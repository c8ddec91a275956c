"""Parity of the port's training core with the JAX package's, on the CPU:
config, losses, the train-mode model (dropout, BatchNorm on batch
statistics), ``CrossModalAttention``, the optimizers (clip, accumulation,
frozen parameters, the learning rate and its schedule) and the steps
(``make_step_fns``: the feature gather, the non-finite skip, the epochs).

Both packages run the same numpy-seeded inputs from the same Flax
variables (converted by ``utils/flax_convert.load_flax_variables``), in
float32. Tolerances: 1e-5 absolute on values of order 1 (float32 sums in
another order) unless a test says otherwise. Dropout's masks come from
different generators by design, so parity runs at dropout 0 and dropout
itself is held by its mask rate.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu import config as jconfig
from pixelrec_multimodal_tpu.models import layers as jlayers
from pixelrec_multimodal_tpu.models import losses as jlosses
from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.models.multimodal import (
    build_model as jbuild_model,
)
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch import config as tconfig
from pixelrec_multimodal_tpu_torch.models import layers as tlayers
from pixelrec_multimodal_tpu_torch.models import losses as tlosses
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
    build_model,
)
from pixelrec_multimodal_tpu_torch.training import optimizers as topt
from pixelrec_multimodal_tpu_torch.training import steps as tsteps
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_flax_variables,
)
from tests._torch_port import (
    LANGUAGE,
    N_TAGS,
    N_USERS,
    NUMERICAL,
    VISION,
    item_tables,
    make_pair,
    model_kwargs,
    to_torch,
)

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS, B, STEPS, LR = 40, 16, 3, 1e-2
TOL = 1e-5
# Adam and AdamW divide each moment by its own root, so an entry whose
# gradient sums to nearly nothing moves by up to lr either way on a
# rounding of that sum. After 3 steps at lr 1e-2, 0-2 of the ~24,600
# parameter entries of the concat model differ past TOL (at most 1.2e-4),
# and 23 of the ~30,700 of the contrastive model (at most 7e-5; its
# projections sum over L2-normalised rows); the rest within TOL. At most a
# share ADAM_MAX_SHARE of them may, each within ADAM_PAST_TOL; SGD's
# updates are linear in the gradient, and all of its entries hold TOL.
ADAM_MAX_SHARE, ADAM_PAST_TOL = 2e-3, 1e-3
CLIP_TEXT = 48


def batches(nb, seed=5, b=B):
    rng = np.random.default_rng(seed)
    return dict(user_idx=rng.integers(0, N_USERS, (nb, b)).astype(np.int32),
                item_idx=rng.integers(0, N_ITEMS, (nb, b)).astype(np.int32),
                tag_idx=rng.integers(0, N_TAGS, (nb, b)).astype(np.int32),
                label=rng.integers(0, 2, (nb, b)).astype(np.float32),
                weight=(rng.random((nb, b)) > 0.2).astype(np.float32))


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def tt(tree):
    return {k: to_torch(v) for k, v in tree.items()}


def port_of(kw, variables):
    """A fresh port model on the CPU holding ``variables``."""
    model = MultimodalRecommender(**kw, device='cpu')
    load_flax_variables(model, jax.tree.map(np.asarray, variables))
    return model


def held(ref: dict, got: dict, adam: bool):
    """State dicts equal within TOL, Adam's few sign-sensitive entries
    aside (module docstring); returns the count past TOL."""
    past = total = 0
    for k, r in ref.items():
        if k.endswith('num_batches_tracked'):
            continue
        d = (r - got[k]).abs()
        past += int((d > TOL).sum())
        total += d.numel()
        assert d.max() <= (ADAM_PAST_TOL if adam else TOL), (k, d.max())
    assert past <= (ADAM_MAX_SHARE * total if adam else 0), (past, total)
    return past


def contrastive_pair(seed=0):
    """A clip-style model (contrastive heads, learnable temperature) in
    both packages from the same Flax variables."""
    kw = dict(model_kwargs(N_ITEMS), use_contrastive=True,
              clip_text_feature_dim=CLIP_TEXT)
    jmodel = JaxRecommender(**kw)
    z = jnp.zeros(4, jnp.int32)
    variables = jmodel.init(
        {'params': jax.random.PRNGKey(seed)}, z, z, z,
        vision_features=jnp.zeros((4, VISION)),
        language_features=jnp.zeros((4, LANGUAGE)),
        numerical_features=jnp.zeros((4, NUMERICAL)),
        clip_text_features=jnp.zeros((4, CLIP_TEXT)), train=False,
        return_embeddings=True)
    variables = jax.tree.map(np.asarray, variables)
    return jmodel, variables, port_of(kw, variables), kw


# ------------------------------------------------------------------ config
def test_config_copy_matches_and_imports_without_yaml(tmp_path):
    """The port's config is the JAX package's, field for field, and its
    module imports with PyYAML unavailable."""
    raw = {'model': {'fusion_type': 'gated', 'fusion_hidden_dims': [64, 32]},
           'training': {'optimizer_type': 'sgd', 'gradient_clip': 0.5},
           'data': {'cache_features': False}}
    assert tconfig.Config.from_dict(raw).to_dict() == \
        jconfig.Config.from_dict(raw).to_dict()
    path = tmp_path / 'c.yaml'
    tconfig.Config.from_dict(raw).to_yaml(str(path))
    assert jconfig.Config.from_yaml(str(path)).to_dict() == \
        tconfig.Config.from_dict(raw).to_dict()
    code = ('import sys; sys.modules["yaml"] = None\n'
            'from pixelrec_multimodal_tpu_torch import config\n'
            'print(config.Config().model.embedding_dim)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=60)
    assert out.stdout.strip() == '64'


@pytest.mark.parametrize('vision,language,contrastive', [
    ('resnet', 'sentence-bert', True), ('clip', 'mpnet', True),
    ('clip', None, False), (None, None, True)])
def test_build_model_matches_jax(vision, language, contrastive):
    """build_model: the backbones' widths, the contrastive-requires-CLIP
    gate and every attribute as JAX's, and parameters of the same shapes
    (the Flax variables of JAX's model load into it)."""
    mc = tconfig.ModelConfig(vision_model=vision, language_model=language,
                             use_contrastive=contrastive, embedding_dim=16,
                             fusion_hidden_dims=[32, 16], fusion_type='gated')
    jm = jbuild_model(jconfig.ModelConfig(**vars(mc)), 30, 20, 5, 3)
    tm = build_model(mc, 30, 20, 5, 3, device='cpu')
    for attr in ('vision_feature_dim', 'language_feature_dim',
                 'clip_text_feature_dim', 'use_contrastive', 'dropout_rate',
                 'fusion_hidden_dims', 'fusion_type', 'num_modalities',
                 'contrastive_active', 'vision_model_name'):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    kw = {}
    if jm.vision_feature_dim:
        kw['vision_features'] = jnp.zeros((2, jm.vision_feature_dim))
    if jm.language_feature_dim:
        kw['language_features'] = jnp.zeros((2, jm.language_feature_dim))
    if jm.contrastive_active:
        kw['clip_text_features'] = jnp.zeros((2, jm.clip_text_feature_dim))
    z = jnp.zeros(2, jnp.int32)
    variables = jm.init({'params': jax.random.PRNGKey(0)}, z, z, z,
                        numerical_features=jnp.zeros((2, 3)),
                        return_embeddings=jm.contrastive_active, **kw)
    missing = load_flax_variables(tm, jax.tree.map(np.asarray, variables))
    assert all(k.endswith('num_batches_tracked') for k in missing), missing


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize('weighted', [False, True])
def test_contrastive_loss_matches_jax(weighted):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((12, 16)).astype(np.float32)
    txt = rng.standard_normal((12, 16)).astype(np.float32)
    w = (rng.random(12) > 0.3).astype(np.float32) if weighted else None
    ref = jlosses.contrastive_loss(jnp.asarray(img), jnp.asarray(txt), 0.07,
                                   None if w is None else jnp.asarray(w))
    got = tlosses.contrastive_loss(to_torch(img), to_torch(txt), 0.07,
                                   None if w is None else to_torch(w))
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize('case', ['plain', 'weighted', 'contrastive',
                                  'non_finite'])
def test_recommender_loss_matches_jax(case):
    """Weighted BCE and contrastive terms, and the NaN contract: a
    non-finite prediction makes total and bce NaN and contrastive 0."""
    rng = np.random.default_rng(8)
    p = rng.uniform(0, 1, 20).astype(np.float32)
    p[:2] = (0.0, 1.0)  # the clamp at 1e-7
    if case == 'non_finite':
        p[5] = np.nan
    y = rng.integers(0, 2, 20).astype(np.float32)
    w = (rng.random(20) > 0.25).astype(np.float32)
    v, t = (rng.standard_normal((20, 8)).astype(np.float32) for _ in range(2))
    kw = dict(use_contrastive=case in ('contrastive', 'non_finite'),
              contrastive_weight=0.3, bce_weight=0.7)
    feats = case in ('contrastive', 'non_finite')
    weight = None if case == 'plain' else w
    ref = jlosses.recommender_loss(
        jnp.asarray(p), jnp.asarray(y), jnp.asarray(v) if feats else None,
        jnp.asarray(t) if feats else None, 0.1,
        weight=None if weight is None else jnp.asarray(weight), **kw)
    got = tlosses.recommender_loss(
        to_torch(p), to_torch(y), to_torch(v) if feats else None,
        to_torch(t) if feats else None, 0.1,
        weight=None if weight is None else to_torch(weight), **kw)
    for k in ('total', 'bce', 'contrastive'):
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=TOL,
                                   atol=TOL, equal_nan=True)
    if case == 'non_finite':
        assert np.isnan(got['total'].item()) and got['contrastive'] == 0


# ------------------------------------------------------ train-mode forward
@pytest.mark.parametrize('fusion', ['concatenate', 'gated', 'attention'])
def test_train_forward_and_batch_stats_match_jax(fusion):
    """Train mode at dropout 0: the scores on the batch's statistics and
    the BatchNorm running statistics after one forward, against
    ``apply(train=True, mutable=['batch_stats'])``."""
    jmodel, variables, tmodel = make_pair(N_ITEMS, 'gelu', 'sigmoid',
                                          fusion_type=fusion, heads=4)
    rng = np.random.default_rng(9)
    idx = batches(1, seed=9)
    feats = dict(vision_features=rng.standard_normal((B, VISION)),
                 language_features=rng.standard_normal((B, LANGUAGE)),
                 numerical_features=rng.standard_normal((B, NUMERICAL)))
    feats = {k: v.astype(np.float32) for k, v in feats.items()}
    args = [idx[k][0] for k in ('user_idx', 'item_idx', 'tag_idx')]
    ref, mutated = jmodel.apply(
        variables, *map(jnp.asarray, args), **jx(feats), train=True,
        mutable=['batch_stats'], rngs={'dropout': jax.random.PRNGKey(0)})
    tmodel.train()
    out = tmodel(*map(to_torch, args), **tt(feats))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL)
    stats = jax.tree.map(np.asarray, mutated['batch_stats'])
    for name, s in stats['prediction_network'].items():
        bn = getattr(tmodel.prediction_network, name)
        np.testing.assert_allclose(bn.running_mean.numpy(), s['mean'],
                                   atol=TOL)
        np.testing.assert_allclose(bn.running_var.numpy(), s['var'],
                                   atol=TOL)
    # the scorer's towers stay in eval mode in a training module
    with torch.no_grad():
        u = tmodel.user_tower(to_torch(args[0]))
        it = tmodel.item_tower(to_torch(args[1]), to_torch(args[2]),
                               **tt(feats))
        before = tmodel.prediction_network.BatchNorm_0.running_mean.clone()
        tmodel.score_from_towers(u, it)
        assert torch.equal(
            tmodel.prediction_network.BatchNorm_0.running_mean, before)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_dropout_keeps_its_rate_from_a_seeded_generator(rate):
    """Dropout keeps 1 - rate of the entries (within 4 standard errors on
    40,000 draws), scales them by 1 / (1 - rate), draws the same mask from
    the same seed, and is the identity out of training."""
    x = torch.ones(200, 200)
    out = tlayers.dropout(x, rate, True, torch.Generator().manual_seed(3))
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / x.numel())
    assert torch.allclose(out[out != 0], torch.tensor(1 / (1 - rate)))
    again = tlayers.dropout(x, rate, True, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert tlayers.dropout(x, rate, False) is x
    # through the model: two seeds give two masks, one seed one
    kw = dict(model_kwargs(N_ITEMS), dropout_rate=rate)
    model = MultimodalRecommender(**kw, device='cpu').train()
    idx = batches(1, seed=2)
    rng = np.random.default_rng(2)
    feats = tt({'vision_features': rng.standard_normal((B, VISION)),
                'language_features': rng.standard_normal((B, LANGUAGE)),
                'numerical_features': rng.standard_normal((B, NUMERICAL))})
    feats = {k: v.float() for k, v in feats.items()}
    args = [to_torch(idx[k][0]) for k in ('user_idx', 'item_idx', 'tag_idx')]

    def run(seed):
        return model(*args, **feats,
                     generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(4), run(4)) and not torch.equal(run(4), run(5))


@pytest.mark.parametrize('token_level', [False, True])
def test_cross_modal_attention_matches_jax(token_level):
    rng = np.random.default_rng(10)
    shape_v = (6, 5, 12) if token_level else (6, 12)
    vis = rng.standard_normal(shape_v).astype(np.float32)
    txt = rng.standard_normal((6, 7, 20) if token_level else (6, 20)
                              ).astype(np.float32)
    jm = jlayers.CrossModalAttention(dim=16)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(vis),
                        jnp.asarray(txt))
    ref = jm.apply(variables, jnp.asarray(vis), jnp.asarray(txt))
    tm = tlayers.CrossModalAttention(12, 20, 16)
    load_flax_variables(tm, jax.tree.map(np.asarray, variables))
    out = tm(to_torch(vis), to_torch(txt))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL)


# -------------------------------------------------------------- optimizers
def run_both(kind, clip, accum, jmodel, variables, tmodel, tables, bs,
             frozen=None, jtables=None):
    """STEPS train steps of both packages from the same weights; returns
    (JAX state, port state, per-step losses of each)."""
    jtx = jopt.build_optimizer(kind, LR, 0.01, gradient_clip=clip,
                               gradient_accumulation_steps=accum)
    ttx = topt.build_optimizer(kind, LR, 0.01, gradient_clip=clip,
                               gradient_accumulation_steps=accum)
    if frozen is not None:
        mask = jax.tree_util.tree_map_with_path(
            lambda path, _: path[0].key != frozen, variables['params'])
        jtx = jopt.with_frozen(jtx, mask)
        ttx = topt.with_frozen(ttx, lambda n: not n.startswith(frozen + '.'))
    jstate = jsteps.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables.get('batch_stats'), tx=jtx)
    tstate = tsteps.init_train_state(tmodel, ttx)
    jtrain, _ = jsteps.make_step_fns(jmodel, jtables or jx(tables))
    ttrain, _ = tsteps.make_step_fns(tmodel, tt(tables))
    losses = ([], [])
    for i in range(bs['item_idx'].shape[0]):
        b = {k: v[i] for k, v in bs.items()}
        jstate, jm = jtrain(jstate, jx(b), jax.random.PRNGKey(i))
        tstate, tm = ttrain(tstate, tt(b))
        losses[0].append(float(jm['total_loss']))
        losses[1].append(tm['total_loss'].item())
    return jstate, tstate, losses


def jax_state_dict(kw, jstate):
    return port_of(kw, {'params': jstate.params,
                        'batch_stats': jstate.batch_stats}).state_dict()


@pytest.mark.parametrize('accum', [1, 2])
@pytest.mark.parametrize('clip', [1.0, None])
@pytest.mark.parametrize('kind', ['adamw', 'adam', 'sgd'])
def test_three_steps_match_jax(kind, clip, accum):
    """3 steps at lr 1e-2: the losses, every parameter and the BatchNorm
    statistics against JAX's (Adam's few sign-sensitive entries aside)."""
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    jstate, tstate, losses = run_both(kind, clip, accum, jmodel, variables,
                                      tmodel, item_tables(N_ITEMS),
                                      batches(STEPS))
    np.testing.assert_allclose(losses[1], losses[0], atol=TOL)
    held(jax_state_dict(model_kwargs(N_ITEMS), jstate),
         tmodel.state_dict(), adam=kind != 'sgd')
    assert int(tstate.step) == int(jstate.step) == STEPS
    if accum > 1:
        assert int(tstate.opt_state.mini_step) == STEPS % accum
        assert int(tstate.opt_state.gradient_step) == STEPS // accum


def test_frozen_parameters_match_jax():
    """with_frozen: the vision projection frozen gets no update and no
    AdamW decay, the clip's norm leaves it out, the rest matches JAX."""
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()
              if k.startswith('vision_projection.')}
    jstate, tstate, losses = run_both('adamw', 1.0, 1, jmodel, variables,
                                      tmodel, item_tables(N_ITEMS),
                                      batches(STEPS), frozen='vision_projection')
    np.testing.assert_allclose(losses[1], losses[0], atol=TOL)
    held(jax_state_dict(model_kwargs(N_ITEMS), jstate), tmodel.state_dict(),
         adam=True)
    for k, v in before.items():
        assert torch.equal(tmodel.state_dict()[k], v), k
    assert not any(n.startswith('vision_projection.')
                   for n in tstate.opt_state.names)


def test_contrastive_train_steps_match_jax():
    """A clip-style model: the contrastive loss over the CLIP text table
    and the learnable temperature, 3 AdamW steps against JAX's."""
    jmodel, variables, tmodel, kw = contrastive_pair()
    tables = item_tables(N_ITEMS)
    tables['clip_text_emb'] = np.random.default_rng(11).standard_normal(
        (N_ITEMS, CLIP_TEXT)).astype(np.float32)
    jstate, tstate, losses = run_both('adamw', 1.0, 1, jmodel, variables,
                                      tmodel, tables, batches(STEPS))
    np.testing.assert_allclose(losses[1], losses[0], atol=TOL)
    held(jax_state_dict(kw, jstate), tmodel.state_dict(), adam=True)
    assert tmodel.temperature.item() != 0.07


def test_learning_rate_get_set_and_schedules_match_jax():
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    jtx = jopt.build_optimizer('adamw', 3e-3, gradient_accumulation_steps=2)
    jstate = jtx.init(variables['params'])
    ttx = topt.build_optimizer('adamw', 3e-3, gradient_accumulation_steps=2)
    tstate = ttx.init(tmodel.named_parameters())
    assert topt.get_learning_rate(tstate) == pytest.approx(
        jopt.get_learning_rate(jstate))
    jstate = jopt.set_learning_rate(jstate, 5e-4)
    tstate = topt.set_learning_rate(tstate, 5e-4)
    assert topt.get_learning_rate(tstate) == jopt.get_learning_rate(jstate)
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, float('nan'), 0.5, 0.6]
    for kind in ('reduce_on_plateau', 'cosine', 'step', 'other'):
        js = jopt.LRScheduler(kind, 1e-3, patience=2, factor=0.5,
                              total_epochs=4)
        ts = topt.LRScheduler(kind, 1e-3, patience=2, factor=0.5,
                              total_epochs=4)
        assert [ts.step(v) for v in losses] == [js.step(v) for v in losses]
        assert ts.state_dict() == js.state_dict()
        again = topt.LRScheduler(kind, 1e-3)
        again.load_state_dict(ts.state_dict())
        assert again.lr == ts.lr


def test_unknown_optimizer_falls_back_to_adamw():
    tx = topt.build_optimizer('lion', 2e-3, 0.05, adam_beta1=0.5)
    assert (tx.kind, tx.learning_rate, tx.weight_decay, tx.b1) == (
        'adamw', 2e-3, 0.05, 0.9)


# ------------------------------------------------------------------ steps
def test_packed_table_gather_matches_jax():
    """One packed row gather (``packed::name=width+...``) and the absent
    tables' zeros, against JAX's gather_feature_kwargs; the packed and
    the separate tables give the same kwargs."""
    _, variables, tmodel = make_pair(N_ITEMS)
    jmodel = JaxRecommender(**model_kwargs(N_ITEMS))
    tables = item_tables(N_ITEMS)
    key = (f'packed::vision_emb={VISION}+language_emb={LANGUAGE}')
    packed = {key: np.concatenate([tables['vision_emb'],
                                   tables['language_emb']], axis=1)}
    b = {'item_idx': batches(1)['item_idx'][0]}
    kwargs = []
    for tabs in (packed, tables):
        ref = jsteps.gather_feature_kwargs(jmodel, jx(tabs), jx(b))
        got = tsteps.gather_feature_kwargs(tmodel, tt(tabs), tt(b))
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        kwargs.append(got)
    assert not kwargs[0]['numerical_features'].any()  # no table: zeros
    for k in ('vision_features', 'language_features'):
        assert torch.equal(kwargs[0][k], kwargs[1][k])


def test_non_finite_batch_is_skipped_as_in_jax():
    """A batch whose loss is NaN (a NaN label) leaves the parameters, the
    optimizer state (here the accumulation's too), the BatchNorm statistics
    and the step count as they were, in both packages; the finite steps
    around it match."""
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    bs = batches(STEPS)
    bs['label'][1, 3] = np.nan
    jstate, tstate, losses = run_both('adamw', 1.0, 2, jmodel, variables,
                                      tmodel, item_tables(N_ITEMS), bs)
    assert np.isnan(losses[0][1]) and np.isnan(losses[1][1])
    assert not np.isnan(losses[1][0]) and not np.isnan(losses[1][2])
    assert int(tstate.step) == int(jstate.step) == 2
    np.testing.assert_allclose(losses[1], losses[0], atol=TOL)
    held(jax_state_dict(model_kwargs(N_ITEMS), jstate), tmodel.state_dict(),
         adam=True)
    assert int(tstate.opt_state.mini_step) == 0  # 2 finite of 3 steps
    assert int(tstate.opt_state.count) == 1


def test_epochs_match_steps_and_jax():
    """train_epoch over stacked batches equals train_step batch by batch
    (bit for bit) and JAX's train_epoch (per-batch metrics, parameters);
    eval_epoch's metrics match JAX's."""
    jmodel, variables, tmodel = make_pair(N_ITEMS)
    tables = item_tables(N_ITEMS)
    bs = batches(4, seed=12)
    jtx = jopt.build_optimizer('adamw', LR, 0.01)
    jstate = jsteps.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables['batch_stats'], tx=jtx)
    _, _, jtrain_epoch, jeval_epoch = jsteps.make_step_fns(
        jmodel, jx(tables), return_epoch_fns=True)
    jstate, jm = jtrain_epoch(jstate, jx(bs), jax.random.PRNGKey(0))
    jev = jeval_epoch(jstate, jx(bs))

    twin = port_of(model_kwargs(N_ITEMS), variables)
    fns = tsteps.make_step_fns(tmodel, tt(tables), return_epoch_fns=True)
    tstate, tm = fns[2](tsteps.init_train_state(
        tmodel, topt.build_optimizer('adamw', LR, 0.01)), tt(bs))
    tev = fns[3](tstate, tt(bs))
    step, _ = tsteps.make_step_fns(twin, tt(tables))
    wstate = tsteps.init_train_state(twin, topt.build_optimizer('adamw', LR,
                                                                0.01))
    for i in range(4):
        wstate, m = step(wstate, tt({k: v[i] for k, v in bs.items()}))
        assert m['total_loss'].item() == tm['total_loss'][i].item()
    for k, v in twin.state_dict().items():
        assert torch.equal(v, tmodel.state_dict()[k]), k
    for k in jm:
        assert tm[k].shape == (4,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   atol=TOL, err_msg=k)
        np.testing.assert_allclose(tev[k].numpy(), np.asarray(jev[k]),
                                   atol=TOL, err_msg=k)
    held(jax_state_dict(model_kwargs(N_ITEMS), jstate), tmodel.state_dict(),
         adam=True)
