"""The port's ``Trainer`` against the JAX package's, on the CPU, and the
slice as a whole: interactions -> datasets -> epochs -> checkpoints ->
``CatalogScorer.top_k``.

Both packages train the same model from the same Flax variables (the
JAX trainer initializes them from its seed; the port's model receives
them through ``utils/flax_convert.load_flax_variables``) on the same
datasets, built from pandas frames on each side (JAX runs on the CPU as
its own tests run it). Synthetic data: each user prefers one of six tags;
training positives come from that tag, validation positives from
another, so the validation loss rises once the model learns and early
stopping fires before ``epochs``.

Tolerances: SGD in float32 at dropout 0 holds the epoch losses and the
parameters to 1e-5, the classification sums exactly, the LR sequence and
the early-stopping epoch exactly, and ``meta.json``'s floats to 1e-5.
AdamW divides each moment by its own root (``tests/test_torch_train.py``),
so its losses are held to 1e-4. Dropout's masks differ from JAX's by
design, so the port's dropout runs only port against port.
"""
import copy
import json
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from pixelrec_multimodal_tpu import config as jconfig
from pixelrec_multimodal_tpu.data.dataset import MultimodalDataset as JaxDataset
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.training import Trainer as JaxTrainer
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch import config as tconfig
from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
from pixelrec_multimodal_tpu_torch.data.processors.numerical_processor import (
    StandardScaler,
)
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.parallel import Mesh, make_mesh
from pixelrec_multimodal_tpu_torch.training import Trainer
from pixelrec_multimodal_tpu_torch.training.steps import make_step_fns
from pixelrec_multimodal_tpu_torch.utils import checkpointing
from tests._torch_port import port_model, port_state_of

TOL, ADAM_TOL = 1e-5, 1e-4
N_USERS, N_TAGS, PER_TAG, VISION, LANGUAGE = 12, 6, 8, 24, 12
N_ITEMS = N_TAGS * PER_TAG
BATCH, EPOCHS = 32, 6
META_KEYS = {'epoch', 'best_early_stopping_score', 'early_stopping_metric',
             'early_stopping_direction', 'training_history', 'best_metrics',
             'scheduler_state', 'model_config'}


# ------------------------------------------------------------------- data
def frames(seed=0):
    """(items, train interactions, validation interactions, vision and
    language tables) as pandas frames and numpy arrays."""
    rng = np.random.default_rng(seed)
    items = pd.DataFrame({
        'item_id': [f'i{j}' for j in range(N_ITEMS)],
        'tag': [f't{j % N_TAGS}' for j in range(N_ITEMS)],
        'price': rng.normal(10, 3, N_ITEMS),
        'views': rng.integers(0, 500, N_ITEMS).astype(float)})
    of_tag = [np.arange(t, N_ITEMS, N_TAGS) for t in range(N_TAGS)]
    train, val = [], []
    for u in range(N_USERS):
        liked, other = of_tag[u % N_TAGS], of_tag[(u + 3) % N_TAGS]
        train += [(f'u{u}', f'i{i}') for i in rng.choice(liked, 6, False)]
        val += [(f'u{u}', f'i{i}') for i in rng.choice(other, 2, False)]
    cols = ['user_id', 'item_id']
    tables = (rng.standard_normal((N_ITEMS, VISION)).astype(np.float32),
              rng.standard_normal((N_ITEMS, LANGUAGE)).astype(np.float32))
    return (items, pd.DataFrame(train, columns=cols),
            pd.DataFrame(val, columns=cols), tables)


def datasets(dataset_cls, scaler, seed=0):
    """(full, train, val) as the train script builds them: the full
    dataset fits the encoders, the others share them."""
    items, train, val, (vis, lang) = frames(seed)
    common = dict(item_info_df=items, image_folder='/nonexistent',
                  vision_model_name=None, language_model_name=None,
                  numerical_feat_cols=['price', 'views'],
                  categorical_feat_cols=['tag'],
                  numerical_normalization_method='standardization',
                  numerical_scaler=scaler)
    full = dataset_cls(interactions_df=pd.concat([train, val]),
                       create_negative_samples=False, **common)
    enc = dict(user_encoder=full.user_encoder,
               item_encoder=full.item_encoder, tag_encoder=full.tag_encoder)
    out = [full]
    for inter in (train, val):
        ds = dataset_cls(interactions_df=inter, **enc, **common)
        ds.feature_store.set_embedding_table('vision_emb', vis)
        ds.feature_store.set_embedding_table('language_emb', lang)
        out.append(ds)
    return out


def jax_datasets():
    from sklearn.preprocessing import StandardScaler as SkStandard
    items = frames()[0]
    return datasets(JaxDataset, SkStandard().fit(
        items[['price', 'views']].fillna(0).values))


def port_datasets():
    items = frames()[0]
    return datasets(MultimodalDataset, StandardScaler().fit(
        items[['price', 'views']].fillna(0).values))


def model_kwargs(full, dropout=0.0):
    return dict(n_users=full.n_users, n_items=full.n_items,
                n_tags=full.n_tags, num_numerical_features=2,
                embedding_dim=16, vision_feature_dim=VISION,
                language_feature_dim=LANGUAGE, use_contrastive=False,
                fusion_hidden_dims=(32, 16), use_batch_norm=True,
                dropout_rate=dropout)


def jax_variables(jmodel, seed=0):
    """The variables JAX's Trainer(seed=seed) initializes its state with."""
    st = jsteps.init_train_state(jmodel, jopt.build_optimizer('sgd', 0.1),
                                 jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, {'params': st.params,
                                     'batch_stats': st.batch_stats})


def configs(tmp):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        cfg.model.vision_model = cfg.model.language_model = None
        cfg.checkpoint_dir = str(tmp)
        out.append(cfg)
    return out


def record_lr(trainer):
    """Collect the LR after each completed epoch (the epoch summary)."""
    lrs = []
    trainer._print_epoch_summary = lambda *a: lrs.append(
        trainer.get_learning_rate())
    return lrs


def run_pair(tmp, **train_kw):
    """Both trainers from the same weights on the same data; returns a
    dict of the JAX and port trainers, their losses, LR sequences and
    models."""
    jfull, jtr, jva = jax_datasets()
    tfull, ttr, tva = port_datasets()
    kw = model_kwargs(jfull)
    jmodel = JaxRecommender(**kw)
    tmodel = port_model(kw, jax_variables(jmodel))
    jcfg, tcfg = configs(tmp)
    jt = JaxTrainer(jmodel, config=jcfg, checkpoint_dir=str(tmp / 'jax'))
    tt = Trainer(tmodel, config=tcfg, checkpoint_dir=str(tmp / 'port'))
    jlr, tlr = record_lr(jt), record_lr(tt)
    args = dict(epochs=EPOCHS, batch_size=BATCH, patience=2,
                lr_scheduler_patience=0)
    args.update(train_kw)
    return dict(jax=jt, port=tt, jlosses=jt.train(jtr, jva, **args),
                tlosses=tt.train(ttr, tva, **args), jlr=jlr, tlr=tlr,
                jmodel=jmodel, tmodel=tmodel, data=(jtr, ttr))


def assert_close_tree(got, ref, tol, path='meta'):
    """JSON trees equal, floats within ``tol``."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            assert_close_tree(got[k], ref[k], tol, f'{path}.{k}')
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close_tree(g, r, tol, f'{path}[{i}]')
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, abs=tol, nan_ok=True), path
    else:
        assert got == ref, path


@pytest.fixture(scope='module')
def sgd(tmp_path_factory):
    """SGD, float32, dropout 0, clip 1.0, decay 0.01, the plateau
    scheduler at patience 0: the stop fires after epoch 3 of 6."""
    return run_pair(tmp_path_factory.mktemp('sgd'), optimizer_type='sgd',
                    lr=0.05)


# ----------------------------------------------------------- SGD parity
def test_epoch_losses_match_jax(sgd):
    for got, ref in zip(sgd['tlosses'], sgd['jlosses']):
        assert len(got) == len(ref) >= 3
        np.testing.assert_allclose(got, ref, atol=TOL)
    jh, th = sgd['jax'].training_history, sgd['port'].training_history
    for k in ('train_losses', 'val_losses'):
        np.testing.assert_allclose(th[k], jh[k], atol=TOL)


def test_classification_sums_match_jax(sgd):
    """Accuracy, precision, recall and F1 come from the epoch's tp, fp, fn,
    correct and count sums: equal sums give equal values."""
    jh, th = sgd['jax'].training_history, sgd['port'].training_history
    for k in ('train_metrics', 'val_metrics'):
        for got, ref in zip(th[k], jh[k]):
            for m in ('accuracy', 'precision', 'recall', 'f1_score'):
                assert got[m] == ref[m], (k, m)


def test_parameters_match_jax(sgd):
    ref = port_state_of(model_kwargs(sgd['data'][1]), sgd['jax'].state)
    got = sgd['tmodel'].state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=k)
    assert int(sgd['port'].state.step) == int(sgd['jax'].state.step)


def test_early_stopping_epoch_matches_jax(sgd):
    jt, tt = sgd['jax'], sgd['port']
    assert tt.epoch == jt.epoch < EPOCHS - 1
    assert tt.patience_counter == jt.patience_counter == 2
    assert tt.best_early_stopping_score == pytest.approx(
        jt.best_early_stopping_score, abs=TOL)
    assert tt.get_all_best_metrics().keys() == \
        jt.get_all_best_metrics().keys()


def test_lr_sequence_matches_jax(sgd):
    """The plateau scheduler steps on validated epochs only; at patience 0
    each epoch without improvement halves the LR."""
    assert sgd['tlr'] == sgd['jlr']
    assert sgd['port'].get_learning_rate() == sgd['jax'].get_learning_rate()
    assert len(set(sgd['tlr'] + [sgd['port'].get_learning_rate()])) > 1


@pytest.mark.parametrize('name', ['best_model', 'last_model'])
def test_meta_json_matches_jax(sgd, name):
    jt, tt = sgd['jax'], sgd['port']
    root = tt.get_model_checkpoint_dir()
    assert root.name == 'None_None' == jt.get_model_checkpoint_dir().name
    ref = json.loads((jt.get_model_checkpoint_dir() / name / 'meta.json'
                      ).read_text())
    got = json.loads((root / name / 'meta.json').read_text())
    assert set(got) == set(ref) == META_KEYS
    assert_close_tree(got, ref, TOL)
    assert checkpointing.checkpoint_exists(root, name + '.pth')
    assert checkpointing.find_checkpoint(root) == root / 'best_model'


def test_adamw_run_matches_jax(tmp_path):
    """AdamW (the default) with the same control flow: epochs run, stop
    epoch, LR sequence; losses within 1e-4."""
    out = run_pair(tmp_path, lr=0.01)
    for got, ref in zip(out['tlosses'], out['jlosses']):
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, atol=ADAM_TOL)
    assert out['port'].epoch == out['jax'].epoch
    assert out['tlr'] == out['jlr']


def test_non_finite_batches_are_accounted_as_in_jax(tmp_path):
    """A NaN label makes one batch's loss NaN: it leaves the parameters
    alone and its metrics out, but its rows in the accuracy's count, on
    both packages and both of the port's epoch paths."""
    jfull, jtr, jva = jax_datasets()
    tfull, ttr, tva = port_datasets()
    for ds in (jtr, ttr):
        ds.samples['label'][5] = np.nan
    kw = model_kwargs(jfull)
    jmodel = JaxRecommender(**kw)
    variables = jax_variables(jmodel)
    args = dict(epochs=1, batch_size=BATCH, optimizer_type='sgd', lr=0.05)
    jt = JaxTrainer(jmodel, checkpoint_dir=str(tmp_path / 'j'))
    jt.train(jtr, jva, **args)
    ref = jt.training_history['train_metrics'][0]
    for compiled in (True, False):
        tt = Trainer(port_model(kw, variables), compiled_epochs=compiled,
                     checkpoint_dir=str(tmp_path / f'p{compiled}'))
        tt.train(ttr, tva, **args)
        got = tt.training_history['train_metrics'][0]
        assert_close_tree(got, ref, TOL)
        assert int(tt.state.step) == int(jt.state.step) == \
            ttr.num_batches(BATCH) - 1


# ------------------------------------------------- the slice as a whole
def test_trained_models_serve_the_same_top_k(sgd):
    """Both trained models serve ``top_k`` on the CPU (JAX's scorer as its
    own tests run it; the port's plain path) with each user's training
    history masked: the top-10 sets are equal, no seen item returned."""
    jt, tt = sgd['jax'], sgd['port']
    jtr, ttr = sgd['data']
    variables = {'params': jt.state.params,
                 'batch_stats': jt.state.batch_stats}
    js = JaxScorer(sgd['jmodel'], variables, jtr.feature_store)
    ts = CatalogScorer(tt.model, ttr.feature_store, device='cpu')
    indptr, idx = ttr.user_history_matrix()
    seen = np.zeros((ttr.n_users, ttr.n_items), dtype=bool)
    for u in range(ttr.n_users):
        seen[u, idx[indptr[u]:indptr[u + 1]]] = True
    users = np.arange(ttr.n_users, dtype=np.int32)
    for mask in (None, seen):
        jv, ji = js.top_k(users, 10, seen_mask=mask)
        tv, ti = ts.top_k(users, 10, seen_mask=mask)
        np.testing.assert_allclose(tv, np.asarray(jv), atol=TOL)
        for a, b in zip(ti, np.asarray(ji)):
            assert set(a) == set(b)
    assert not seen[users[:, None], ti].any()


# ---------------------------------------------------------- checkpoints
def port_run(tmp, epochs, dropout=0.2, seed=0, **kw):
    """A port trainer (AdamW, dropout) on the port's datasets."""
    full, tr, va = port_datasets()
    gen = torch.Generator().manual_seed(seed)
    model = MultimodalRecommender(**model_kwargs(full, dropout),
                                  generator=gen, device='cpu')
    _, tcfg = configs(tmp)
    trainer = Trainer(model, config=tcfg, checkpoint_dir=str(tmp), **kw)
    return trainer, tr, va


def test_checkpoint_round_trip_keeps_the_flat_buffer_views(tmp_path):
    """A checkpoint loads into a trainer that has trained: the values come
    back bit for bit, the parameters stay views of the optimizer's flat
    buffer (loading copies into them), and the next step moves the
    model."""
    t1, tr, va = port_run(tmp_path / 'a', 1)
    t1.train(tr, va, epochs=1, batch_size=BATCH)
    saved = torch.load(tmp_path / 'a' / 'None_None' / 'last_model' /
                       'state.pt', weights_only=True)
    assert all(v.device.type == 'cpu' for v in saved['params'].values())
    assert sorted(saved['opt_state']) == ['count', 'lr', 'mu', 'names',
                                          'nu']
    t2, _, _ = port_run(tmp_path / 'b', 1, seed=1)
    t2.train(tr, va, epochs=1, batch_size=BATCH)
    shutil.copytree(tmp_path / 'a' / 'None_None',
                    tmp_path / 'b' / 'None_None', dirs_exist_ok=True)
    t2.load_checkpoint('last_model')
    opt = t2.state.opt_state
    for name, p in t2.model.named_parameters():
        assert torch.equal(p, saved['params'][name]), name
        assert opt.flat.data_ptr() <= p.data_ptr() < \
            opt.flat.data_ptr() + opt.flat.numel() * 4, name
    for f in ('mu', 'nu', 'count', 'lr'):
        assert torch.equal(getattr(opt, f), saved['opt_state'][f]), f
    assert torch.equal(t2.state.step, saved['step'])
    assert t2.epoch == 0 and t2.training_history == \
        t1.training_history
    before = {n: p.clone() for n, p in t2.model.named_parameters()}
    t2.train(tr, va, epochs=1, batch_size=BATCH)
    moved = [n for n, p in t2.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert moved and torch.equal(
        opt.flat, torch.cat([p.detach().reshape(-1)
                             for p in t2.state.opt_state.params]))


def test_resume_continues_bit_for_bit(tmp_path):
    """The port's resume applies the weights: a fresh trainer that loads
    ``last_model`` and trains on ends bit for bit where the trainer that
    wrote it ends when it trains on (both restart at the saved epoch's
    index, as JAX's loop does). The scheduler's state comes back too."""
    t1, tr, va = port_run(tmp_path / 'a', 2)
    t1.train(tr, va, epochs=2, batch_size=BATCH)
    meta = json.loads((tmp_path / 'a' / 'None_None' / 'last_model' /
                       'meta.json').read_text())
    shutil.copytree(tmp_path / 'a', tmp_path / 'b')
    losses1 = t1.train(tr, va, epochs=3, batch_size=BATCH)
    t2, _, _ = port_run(tmp_path / 'b', 2, seed=7)
    t2.load_checkpoint('last_model')
    assert t2.epoch == meta['epoch'] == 1
    assert t2._pending_scheduler == meta['scheduler_state']
    losses2 = t2.train(tr, va, epochs=3, batch_size=BATCH)
    assert losses2 == losses1
    for (n, a), b in zip(t1.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert t2.training_history == t1.training_history
    assert t2.scheduler.state_dict()['epoch'] == \
        meta['scheduler_state']['epoch'] + 2


def test_jax_resume_starts_from_fresh_weights(tmp_path):
    """The other half of the divergence: JAX's trainer, loading before
    ``train()``, keeps the restored arrays aside and trains from the
    weights its seed initializes, as a trainer that never loaded."""
    jfull, jtr, jva = jax_datasets()
    kw = model_kwargs(jfull)
    args = dict(batch_size=BATCH, optimizer_type='sgd', lr=0.05)
    j1 = JaxTrainer(JaxRecommender(**kw), checkpoint_dir=str(tmp_path))
    j1.train(jtr, jva, epochs=2, **args)
    j2 = JaxTrainer(JaxRecommender(**kw), checkpoint_dir=str(tmp_path))
    j2.load_checkpoint('last_model')
    assert j2.epoch == 1 and hasattr(j2, '_pending_state')
    j2.train(jtr, jva, epochs=3, **args)
    j3 = JaxTrainer(JaxRecommender(**kw), checkpoint_dir=str(tmp_path / 'c'))
    j3.epoch = 1
    j3.train(jtr, jva, epochs=3, **args)
    for a, b in zip(jax.tree.leaves(j2.state.params),
                    jax.tree.leaves(j3.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    j1.train(jtr, jva, epochs=3, **args)
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(j1.state.params),
                               jax.tree.leaves(j2.state.params)))


# -------------------------------------------------------- port-only paths
def test_epoch_paths_agree_bit_for_bit(tmp_path):
    """``compiled_epochs=False`` (one step a batch through the prefetching
    loader) draws the same dropout masks and gives the same weights as the
    whole-epoch default, bit for bit. The epoch's mean loss sums the
    batches' float32 losses in float32 on the whole-epoch path and in
    float64 on the other, as in JAX: equal to float32 rounding."""
    runs = []
    for compiled in (True, False):
        t, tr, va = port_run(tmp_path / str(compiled), 2,
                             compiled_epochs=compiled)
        runs.append((t.train(tr, va, epochs=2, batch_size=BATCH), t))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6, atol=0)
    for a, b in zip(runs[0][1].model.state_dict().values(),
                    runs[1][1].model.state_dict().values()):
        assert torch.equal(a, b)
    assert set(runs[1][1].epoch_seconds[0]) == {
        'batching', 'train', 'validation', 'checkpoint'}


def test_bf16_tables_give_the_f32_tables_losses():
    """A bf16 model gathers the same values from a bf16 packed table as
    from the float32 one (its first Dense casts to bf16): equal losses
    over an epoch, equal weights after it."""
    full, tr, _ = port_datasets()
    model = port_model(model_kwargs(full, dropout=0.1),
                       dtype=torch.bfloat16)
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        init_train_state,
    )
    stacked = {k: torch.from_numpy(v)
               for k, v in tr.stacked_batches(BATCH, seed=3).items()}
    out = []
    for dtype in (None, torch.bfloat16):
        m = copy.deepcopy(model)
        tables = tr.feature_store.device_tables(device='cpu', pack=True,
                                                dtype=dtype)
        assert next(t for k, t in tables.items()
                    if k.startswith('packed::')).dtype == \
            (dtype or torch.float32)
        state = init_train_state(m, build_optimizer('adamw', 1e-2))
        _, _, train_epoch, _ = make_step_fns(m, tables,
                                             use_contrastive=False,
                                             return_epoch_fns=True)
        _, metrics = train_epoch(state, stacked,
                                 torch.Generator().manual_seed(0))
        out.append((metrics['total_loss'], m.state_dict()))
    assert torch.equal(out[0][0], out[1][0])
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_trainer_refuses_a_mesh(tmp_path):
    """A Trainer on a 1x1 mesh is the Trainer without one, bit for bit
    (losses, parameters; dropout on); a mesh whose data axis does not
    divide the batch is refused before its first step."""
    runs = []
    for name, mesh in (('none', None), ('1x1', make_mesh())):
        t, tr, va = port_run(tmp_path / name, 2, mesh=mesh)
        runs.append((t.train(tr, va, epochs=2, batch_size=BATCH),
                     t.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    three = Mesh(np.arange(3).reshape(3, 1), 0,
                 {'data': None, 'model': None})
    t, tr, va = port_run(tmp_path / 'three', 1, mesh=three)
    with pytest.raises(ValueError, match="do not divide over the 'data'"):
        t.train(tr, va, epochs=1, batch_size=BATCH)
    t, tr, va = port_run(tmp_path, 1)
    t.load_checkpoint('missing_model')  # warns, changes nothing
    assert t.epoch == 0 and t._pending_opt is None
