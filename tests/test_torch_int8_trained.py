"""int8 on a trained flagship-width concat head, the port against the JAX
package, on the CPU (ROADMAP C0).

The port's ``Trainer`` trains the flagship head (embedding 64, vision
2,048, language 384, numerical 7, MLP [512, 256, 128] with BatchNorm,
dropout 0.1, AdamW) from JAX's initial variables on synthetic
interactions: each user prefers two of 16 tags. Its trained state is
carried back into Flax variables, and each package's scorer then
quantizes the same weights its own way (``precision='int8!'``:
calibration on the JAX package's sample, ``quantize_head`` or
``quantize_mlp_chain``). Each side's int8 chain in float32 (the port's
plain int8 chain; JAX's ``xla_pairwise_scores`` with ``qlayers``) is held
against its own float32 chain by the top-50 agreement over 64 users and
the whole 2,048-item catalog.

The question: is the port's int8 lower than the reference's on trained
weights? The two agreements must lie within ``NOISE`` of each other, and
the two int8 score matrices within the int8 parity gate of
``tests/test_torch_int8.py``; the agreements at JAX's initialization are
held the same way, beside them.
"""
import copy
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.inference.scorer import (
    CatalogScorer as JaxScorer,
)
from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch import config as tconfig
from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.data.processors.numerical_processor import (
    StandardScaler,
)
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from pixelrec_multimodal_tpu_torch.training import Trainer
from pixelrec_multimodal_tpu_torch.utils import flax_convert
from tests._torch_port import port_model, quiet

N_USERS, N_TAGS, N_ITEMS = 256, 16, 2048
VISION, LANGUAGE, NUMERICAL, EMB = 2048, 384, 7, 64
HIDDEN = (512, 256, 128)
EPOCHS, BATCH, TOP_K, EVAL_USERS = 4, 1024, 50, 64
# Two quantizations of the same weights rank within NOISE of each other:
# their calibration ranges differ by float32 ulps of the matmuls, which
# moves a code at a boundary and so a score by up to ~1e-4, and a pair at
# the 50th place may swap.
NOISE = 0.01
# tests/test_torch_int8.py's int8 parity gate: pairs past AGREE at most
# MAX_FLIPPED of them, none past FLIP_TOL.
AGREE, MAX_FLIPPED, FLIP_TOL = 1e-5, 0.01, 1e-2


def kwargs():
    return dict(n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
                num_numerical_features=NUMERICAL, embedding_dim=EMB,
                vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
                use_contrastive=False, fusion_hidden_dims=HIDDEN,
                use_batch_norm=True, dropout_rate=0.1)


def data(seed=0):
    """Items (a tag each, numerical columns), the vision and language
    tables, and each user's training and validation positives from the
    two tags the user prefers."""
    rng = np.random.default_rng(seed)
    items = pd.DataFrame({'item_id': [f'i{j:04d}' for j in range(N_ITEMS)],
                          'tag': [f't{j % N_TAGS}' for j in range(N_ITEMS)]})
    for c in range(NUMERICAL):
        items[f'num_{c}'] = rng.normal(0, 1, N_ITEMS)
    tables = {'vision_emb': rng.standard_normal((N_ITEMS, VISION),
                                                dtype=np.float32),
              'language_emb': rng.standard_normal((N_ITEMS, LANGUAGE),
                                                  dtype=np.float32)}
    train, val = [], []
    for u in range(N_USERS):
        liked = rng.choice(N_TAGS, 2, replace=False)
        pool = np.concatenate([np.arange(t, N_ITEMS, N_TAGS) for t in liked])
        picks = rng.choice(pool, 28, replace=False)
        train += [(f'u{u:03d}', f'i{j:04d}') for j in picks[:24]]
        val += [(f'u{u:03d}', f'i{j:04d}') for j in picks[24:]]
    cols = ['user_id', 'item_id']
    return items, tables, pd.DataFrame(train, columns=cols), \
        pd.DataFrame(val, columns=cols)


def flax_variables_of(template: Mapping, state: dict) -> dict:
    """A port concat model's state dict as Flax variables shaped like
    ``template`` (the inverse of ``flax_convert.load_flax_variables`` for
    models with no attention: Dense kernels transposed back)."""
    def walk(tree, path, names):
        out = {}
        for key, value in tree.items():
            if isinstance(value, Mapping):
                out[key] = walk(value, path + (key,), names)
                continue
            t = state[flax_convert._torch_key(path + (key,), names)]
            t = t.detach().cpu().numpy()
            out[key] = t.T if key == 'kernel' else t
            assert out[key].shape == np.shape(value), path + (key,)
        return out
    return {'params': walk(template['params'], (),
                           flax_convert._PARAM_NAMES),
            'batch_stats': walk(template['batch_stats'], (),
                                flax_convert._STAT_NAMES)}


def agreement(ref: np.ndarray, q: np.ndarray) -> float:
    top_r = np.argsort(-ref, axis=1, kind='stable')[:, :TOP_K]
    top_q = np.argsort(-q, axis=1, kind='stable')[:, :TOP_K]
    return float(np.mean([len(set(a) & set(b)) / TOP_K
                          for a, b in zip(top_r, top_q)]))


def int8_fidelity(jmodel, variables, tmodel, tables, users):
    """(JAX's agreement, the port's, the two int8 score matrices) of one
    set of weights."""
    ids = np.asarray(sorted(f'i{j:04d}' for j in range(N_ITEMS)))
    jstore, tstore = JaxStore(N_ITEMS, ids), ItemFeatureStore(N_ITEMS, ids)
    for store in (jstore, tstore):
        store.tables.update(tables)
    js = quiet(JaxScorer, jmodel, variables, jstore, precision='int8!')
    ts = CatalogScorer(tmodel, tstore, precision='int8!', device='cpu')
    tf = CatalogScorer(tmodel, tstore, device='cpu')
    juf = js._fast_user_side(variables, jnp.asarray(users))[0]
    jitf = js._item_fast[0]
    jf32 = np.asarray(jpm.xla_pairwise_scores(
        {k: v for k, v in js._head.items() if k != 'qlayers'}, juf, jitf))
    jq = np.asarray(jpm.xla_pairwise_scores(js._head, juf, jitf))
    with torch.no_grad():
        tu = torch.from_numpy(users.astype(np.int64))
        tuf = ts._fast_user_side(tu)[0]
        tq = tpm.pairwise_scores_plain(ts._head, tuf, ts._item_fast[0])
        tf32 = tpm.pairwise_scores_plain(tf._head, tf._fast_user_side(tu)[0],
                                         tf._item_fast[0])
    return (agreement(jf32, jq), agreement(tf32.numpy(), tq.numpy()),
            jq, tq.numpy())


@pytest.fixture(scope='module')
def fidelity(tmp_path_factory):
    """The agreements at JAX's initialization and after the port's
    Trainer, each side against its own float32 chain."""
    items, tables, train, val = data()
    num_cols = [f'num_{c}' for c in range(NUMERICAL)]
    common = dict(item_info_df=items, image_folder='/nonexistent',
                  vision_model_name=None, language_model_name=None,
                  numerical_feat_cols=num_cols, categorical_feat_cols=['tag'],
                  numerical_normalization_method='standardization',
                  numerical_scaler=StandardScaler().fit(
                      items[num_cols].values))
    full = MultimodalDataset(interactions_df=pd.concat([train, val]),
                             create_negative_samples=False, **common)
    enc = dict(user_encoder=full.user_encoder,
               item_encoder=full.item_encoder, tag_encoder=full.tag_encoder)
    sets = []
    for inter in (train, val):
        ds = MultimodalDataset(interactions_df=inter, **enc, **common)
        for name, table in tables.items():
            ds.feature_store.set_embedding_table(name, table)
        sets.append(ds)
    # the item ids sort in row order, so the tables are the encoder's
    tables = dict(full.feature_store.tables, **tables)

    kw = kwargs()
    jmodel = JaxRecommender(**kw)
    st = jsteps.init_train_state(jmodel, jopt.build_optimizer('adamw', 1e-3),
                                 jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, {'params': st.params,
                                     'batch_stats': st.batch_stats})
    tmodel = port_model(kw, init)
    users = np.random.default_rng(1).choice(
        N_USERS, EVAL_USERS, replace=False).astype(np.int32)
    before = int8_fidelity(jmodel, init, copy.deepcopy(tmodel), tables,
                           users)
    cfg = tconfig.Config()
    cfg.model.vision_model = cfg.model.language_model = None
    trainer = quiet(Trainer, tmodel, config=cfg,
                    checkpoint_dir=str(tmp_path_factory.mktemp('c0')))
    losses = quiet(trainer.train, *sets, epochs=EPOCHS, batch_size=BATCH,
                   lr=1e-3, optimizer_type='adamw', patience=EPOCHS)
    trained = flax_variables_of(init, tmodel.state_dict())
    back = port_model(kw, trained).state_dict()
    for k, v in tmodel.state_dict().items():
        assert torch.equal(back[k], v), k
    after = int8_fidelity(jmodel, trained, tmodel, tables, users)
    return {'before': before, 'after': after, 'losses': losses}


@pytest.mark.parametrize('when', ['before', 'after'])
def test_port_int8_agrees_with_jax_int8(fidelity, when):
    """The port's plain int8 chain ranks the catalog as JAX's int8 path
    does, at initialization and on the trained head: the two top-50
    agreements with their own float32 chains within NOISE, and the int8
    scores within the int8 parity gate."""
    jax_agree, port_agree, jq, tq = fidelity[when]
    print(f'C0 {when}: top-50 agreement with f32, JAX int8 {jax_agree:.4f}, '
          f'port int8 {port_agree:.4f}')
    assert abs(port_agree - jax_agree) <= NOISE, (jax_agree, port_agree)
    diff = np.abs(tq - jq)
    assert (diff > AGREE).mean() <= MAX_FLIPPED, (diff > AGREE).mean()
    assert diff.max() <= FLIP_TOL, diff.max()


def test_training_moved_the_head(fidelity):
    """The head was trained: the losses are finite and fell, and int8's
    agreement moved from its value at initialization."""
    train_losses, val_losses = fidelity['losses']
    assert np.isfinite(train_losses).all() and np.isfinite(val_losses).all()
    assert train_losses[-1] < train_losses[0]
    assert fidelity['after'][1] != fidelity['before'][1]
