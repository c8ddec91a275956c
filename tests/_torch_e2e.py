"""Shared fixtures of the end-to-end path's parity tests
(``tests/test_torch_e2e*.py``), on the CPU.

Tiny towers, as JAX's own tests use them
(tests/unit/test_multimodal_training.py:156-290): a 2-stage ResNet
(embedding 8, stages 16 and 32, one block each) on 32 px images, a
1-layer text tower at length 8 and, for contrastive learning, a 1-layer
CLIP text tower; the scorer with BatchNorm, 3 numerical features and
dropout 0. Every parameter of the Flax tree is drawn from a numpy seed
(ResNet's frozen BatchNorm statistics away from 0 and 1) and carried into
the port by ``utils/flax_convert.end_to_end_state_dict``; both packages
then run the same numpy batch in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixelrec_multimodal_tpu.config import (
    ImageAugmentationConfig as JaxAugmentation,
)
from pixelrec_multimodal_tpu.encoders import clip as jclip
from pixelrec_multimodal_tpu.encoders import resnet as jresnet
from pixelrec_multimodal_tpu.encoders import text_models as jtext
from pixelrec_multimodal_tpu.models import end_to_end as jend
from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.training import e2e_steps as je2e
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch.config import ImageAugmentationConfig
from pixelrec_multimodal_tpu_torch.encoders import clip as tclip
from pixelrec_multimodal_tpu_torch.encoders import resnet as tresnet
from pixelrec_multimodal_tpu_torch.encoders import text_models as ttext
from pixelrec_multimodal_tpu_torch.models import end_to_end as tend
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)
from pixelrec_multimodal_tpu_torch.training import e2e_steps as te2e
from pixelrec_multimodal_tpu_torch.training import optimizers as topt
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    end_to_end_state_dict,
)

N_USERS, N_ITEMS, N_TAGS, NUMF = 10, 24, 4, 3
B, IMG, LEN = 8, 32, 8
RESNET = dict(embedding_size=8, hidden_sizes=(16, 32), depths=(1, 1))
# The hash tokenizer's ids run to BERT's vocabulary (the dataset test).
TEXT = dict(vocab_size=30522, hidden_size=16, num_layers=1, num_heads=2,
            intermediate_size=32, max_position_embeddings=16)
CLIP_TEXT = dict(vocab_size=40, hidden_size=16, intermediate_size=32,
                 num_layers=1, num_heads=2, max_position_embeddings=LEN)
TOL = 1e-5
# JAX's step key; its augmentation draws from fold_in(STEP_KEY, 1).
STEP_KEY = jax.random.PRNGKey(1)
# See tests/test_torch_train.py: Adam moves an entry whose gradient sums to
# nearly nothing by up to lr either way on a rounding of that sum.
LR, ADAM_LR = 1e-2, 1e-3
ADAM_MAX_SHARE, ADAM_PAST_TOL = 2e-3, ADAM_LR
# Entries whose gradient is analytically zero: the bias in front of the
# train-mode BatchNorm (the batch mean takes it out) and the attention key
# biases (softmax is shift invariant). Adam's first step moves each by
# about lr either way on the sign of a rounding, so the two packages'
# values may lie 2 lr apart there.
ZERO_GRADIENT = ('scorer.prediction_network.Dense_0.bias',
                 'language_encoder.layer_0.attention.key.bias',
                 'clip_text_encoder.layer_0.attention.key.bias')


def scorer_kw(contrastive):
    return dict(n_users=N_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
                num_numerical_features=NUMF, embedding_dim=8,
                vision_feature_dim=RESNET['hidden_sizes'][-1],
                language_feature_dim=TEXT['hidden_size'],
                clip_text_feature_dim=CLIP_TEXT['hidden_size'],
                use_contrastive=contrastive, fusion_hidden_dims=(16,),
                fusion_type='concatenate', use_batch_norm=True,
                dropout_rate=0.0)


class TinyJaxE2E(jend.EndToEndRecommender):
    """JAX's end-to-end model with the tiny towers (its tests' idiom)."""

    def setup(self):
        self.vision_encoder = self._maybe_remat(
            jresnet.ResNetTower(jresnet.ResNetConfig(**RESNET)))
        self.language_encoder = self._maybe_remat(
            jtext.TextTransformer(jtext.TextEncoderConfig(**TEXT)))
        if self.use_clip_text:
            self.clip_text_encoder = self._maybe_remat(
                jclip.CLIPTextTower(jclip.CLIPTextConfig(**CLIP_TEXT)))


def jax_model(contrastive=False):
    return TinyJaxE2E(scorer=JaxRecommender(**scorer_kw(contrastive)),
                      vision_model_name='tiny', language_model_name='tiny',
                      use_clip_text=contrastive)


def port_model(contrastive=False, remat=False):
    return tend.EndToEndRecommender(
        MultimodalRecommender(**scorer_kw(contrastive), device='cpu'),
        vision_encoder=tresnet.ResNetTower(tresnet.ResNetConfig(**RESNET)),
        language_encoder=ttext.TextTransformer(
            ttext.TextEncoderConfig(**TEXT)),
        clip_text_encoder=(tclip.CLIPTextTower(
            tclip.CLIPTextConfig(**CLIP_TEXT)) if contrastive else None),
        remat_encoders=remat)


def _draw(name, shape, rng):
    if name == 'kernel':
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ('scale', 'var'):
        return rng.uniform(0.5, 1.5, shape)
    if name in ('bias', 'mean'):
        return 0.1 * rng.standard_normal(shape)
    if name == 'temperature':
        return np.full(shape, 0.07)
    return 0.5 * rng.standard_normal(shape)  # tables, position tokens


def jax_variables(contrastive=False, seed=0):
    """Every leaf of the tiny model's Flax tree drawn from a numpy seed,
    the scorer's BatchNorm statistics too."""
    shapes = jax.eval_shape(
        lambda: jax_model(contrastive).init(
            jax.random.PRNGKey(0), *(jnp.zeros((2,), jnp.int32),) * 3,
            **dummy_inputs(contrastive), return_embeddings=contrastive))
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                _draw(k, v.shape, rng).astype(np.float32)
                for k, v in tree.items()}
    return fill(dict(shapes['params'])), fill(dict(shapes['batch_stats']))


def dummy_inputs(contrastive):
    """Two rows of the model's inputs, for its shapes."""
    kw = dict(image=jnp.zeros((2, 3, IMG, IMG)),
              text_input_ids=jnp.ones((2, LEN), jnp.int32),
              text_attention_mask=jnp.ones((2, LEN), jnp.int32),
              numerical_features=jnp.zeros((2, NUMF)))
    if contrastive:
        kw['clip_text_input_ids'] = jnp.ones((2, LEN), jnp.int32)
        kw['clip_text_attention_mask'] = jnp.ones((2, LEN), jnp.int32)
    return kw


def raw_batch(contrastive=False, seed=0):
    """A batch of B rows with raw inputs; row 1's tokens padded after 5."""
    rng = np.random.default_rng(seed)
    batch = dict(
        user_idx=rng.integers(0, N_USERS, B).astype(np.int32),
        item_idx=rng.integers(0, N_ITEMS, B).astype(np.int32),
        tag_idx=rng.integers(0, N_TAGS, B).astype(np.int32),
        label=rng.integers(0, 2, B).astype(np.float32),
        weight=(rng.random(B) > 0.2).astype(np.float32),
        image=rng.standard_normal((B, 3, IMG, IMG)).astype(np.float32))
    mask = np.ones((B, LEN), np.int32)
    mask[1, 5:] = 0
    ids = rng.integers(2, 200, (B, LEN)).astype(np.int32) * mask
    batch.update(text_input_ids=ids, text_attention_mask=mask)
    if contrastive:
        eot = CLIP_TEXT['vocab_size'] - 1
        cids = rng.integers(1, eot, (B, LEN)).astype(np.int32)
        cids[:, -1] = eot
        cids[1, 4], cids[1, 5:] = eot, 0
        batch.update(clip_text_input_ids=cids, clip_text_attention_mask=mask)
    return batch


def numerical_table(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (N_ITEMS, NUMF)).astype(np.float32)


def loaded_port(params, batch_stats, contrastive=False, remat=False):
    model = port_model(contrastive, remat)
    res = model.load_state_dict(end_to_end_state_dict(params, batch_stats),
                                strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith('num_batches_tracked') for k in res.missing_keys)
    return model


def held(ref: dict, got: dict, adam: bool = False) -> int:
    """Tensors by name equal within TOL, Adam's few sign-sensitive entries
    aside; returns the count past TOL."""
    past = total = 0
    for k, r in ref.items():
        d = (r - got[k].detach()).abs()
        if adam and k in ZERO_GRADIENT:
            assert d.max() <= 2.1 * ADAM_LR, (k, d.max())
            continue
        past += int((d > TOL).sum())
        total += d.numel()
        assert d.max() <= (ADAM_PAST_TOL if adam else TOL), (k, d.max())
    assert past <= (ADAM_MAX_SHARE * total if adam else 0), (past, total)
    return past


def port_sd(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith('num_batches_tracked')}


class Pair:
    """One JAX train step and one port train step from the same tree."""

    def __init__(self, kind, lr, contrastive=False, freeze=None,
                 contrastive_weight=0.1):
        self.params, self.stats = jax_variables(contrastive)
        self.jmodel = jax_model(contrastive)
        jtx = jopt.build_optimizer(kind, lr)
        ttx = topt.build_optimizer(kind, lr)
        if freeze is not None:
            jtx = jopt.with_frozen(jtx, jend.trainable_mask(self.params,
                                                            *freeze))
        self.tmodel = loaded_port(self.params, self.stats, contrastive)
        if freeze is not None:
            ttx = topt.with_frozen(ttx, tend.trainable_mask(self.tmodel,
                                                            *freeze))
        self.jstate = jsteps.TrainState.create(
            apply_fn=self.jmodel.apply, params=self.params,
            batch_stats=self.stats, tx=jtx)
        self.tstate = te2e.init_e2e_train_state(self.tmodel, ttx)
        self.jstep, self.tstep = self.step_fns(contrastive_weight)

    def step_fns(self, contrastive_weight, augmentation=None):
        """Both packages' train steps; ``augmentation`` is the config's
        fields, JAX's and the port's config made from them."""
        num = numerical_table()
        aug = {} if augmentation is None else dict(
            augmentation_config=JaxAugmentation(**augmentation))
        jstep = je2e.make_e2e_step_fns(
            self.jmodel, {'numerical': jnp.asarray(num)},
            contrastive_weight=contrastive_weight, **aug)[0]
        if aug:
            aug = dict(augmentation_config=ImageAugmentationConfig(
                **augmentation))
        tstep = te2e.make_e2e_step_fns(
            self.tmodel, {'numerical': torch.from_numpy(num)},
            contrastive_weight=contrastive_weight, **aug)[0]
        return jstep, tstep

    def step(self, batch, steps=None, draws=None):
        """One step of both packages on ``batch``, by default the Pair's
        own; ``draws`` go to the port's augmentation."""
        jstep, tstep = steps or (self.jstep, self.tstep)
        self.jstate, jm = jstep(
            self.jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            STEP_KEY)
        self.tstate, tm = tstep(self.tstate, batch, draws=draws)
        return ({k: float(v) for k, v in jm.items()},
                {k: float(v) for k, v in tm.items()})

    def jax_sd(self) -> dict:
        return end_to_end_state_dict(
            jax.tree.map(np.asarray, self.jstate.params),
            jax.tree.map(np.asarray, self.jstate.batch_stats))


def assert_metrics(jm, tm, tol=1e-6):
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=tol, atol=tol,
                                   err_msg=k)


