"""The port's frozen encoder towers against the JAX package's, on the CPU.

Each of the nine towers at two or three layers and narrow widths: random
parameters in the JAX tower's Flax tree, drawn from a numpy seed (layer
scales, LayerNorm scales and frozen BatchNorm statistics away from their
initial constants, so every block counts), carried into the port tower by
``utils/flax_convert.load_encoder_params``, the same numpy-seeded inputs
through both; pooled output and last hidden state at JAX's own tolerance
(tests/unit/test_encoders.py). Also the stems, the DINOv2 interpolation
matrix, MPNet's buckets, the position ids, the HF checkpoint loader
against JAX's converters, and one full-geometry ResNet-50.
"""
import dataclasses
import os
import sys

# transformers would otherwise import TensorFlow where it is installed.
os.environ.setdefault('USE_TF', '0')

import jax  # noqa: E402
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.encoders import clip as jclip
from pixelrec_multimodal_tpu.encoders import common as jcommon
from pixelrec_multimodal_tpu.encoders import convert as jconvert
from pixelrec_multimodal_tpu.encoders import convnext as jconvnext
from pixelrec_multimodal_tpu.encoders import dinov2 as jdinov2
from pixelrec_multimodal_tpu.encoders import registry as jregistry
from pixelrec_multimodal_tpu.encoders import resnet as jresnet
from pixelrec_multimodal_tpu.encoders import text_models as jtext
from pixelrec_multimodal_tpu_torch.encoders import clip as tclip
from pixelrec_multimodal_tpu_torch.encoders import common as tcommon
from pixelrec_multimodal_tpu_torch.encoders import convert as tconvert
from pixelrec_multimodal_tpu_torch.encoders import convnext as tconvnext
from pixelrec_multimodal_tpu_torch.encoders import dinov2 as tdinov2
from pixelrec_multimodal_tpu_torch.encoders import registry as tregistry
from pixelrec_multimodal_tpu_torch.encoders import resnet as tresnet
from pixelrec_multimodal_tpu_torch.encoders import text_models as ttext
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    encoder_state_dict,
    load_encoder_params,
)

TOL = dict(rtol=2e-4, atol=2e-4)          # tests/unit/test_encoders.py:47
FULL_TOL = dict(rtol=2e-3, atol=2e-3)     # test_encoders_fullsize.py:58

def _draw(name, shape, rng):
    """A random value for a Flax leaf of this name and shape."""
    if name == 'kernel':
        return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
    if name in ('scale', 'layerscale1', 'layerscale2', 'layer_scale'):
        return 1.0 + 0.2 * rng.standard_normal(shape)
    if name == 'var':
        return rng.uniform(0.5, 1.5, shape)
    if name in ('bias', 'mean'):
        return 0.1 * rng.standard_normal(shape)
    return 0.5 * rng.standard_normal(shape)  # tables, class/position tokens


def jax_params(module, *args, seed=0):
    """Random parameters of ``module`` in its Flax tree (shapes from
    ``jax.eval_shape`` of its init), drawn from a numpy seed: every leaf,
    LayerNorm scales, layer scales and BatchNorm statistics included,
    away from its initial constant."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else
                _draw(k, v.shape, rng).astype(np.float32)
                for k, v in tree.items()}
    return fill(dict(shapes['params']))


def both(jmodule, tmodule, *args):
    """(JAX outputs, port outputs) of the two towers on the same inputs,
    the port tower loaded from the JAX tower's parameters."""
    params = jax_params(jmodule, *args)
    jout = jax.jit(jmodule.apply)({'params': params}, *args)
    load_encoder_params(tmodule, params)
    with torch.no_grad():
        tout = tmodule(*(torch.from_numpy(np.asarray(a)) for a in args))
    return ([np.asarray(o) for o in jout],
            [o.float().numpy().astype(str(o.dtype).split('.')[-1])
             if o.dtype == torch.bfloat16 else o.numpy() for o in tout])


def images(batch=2, size=28, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, 3, size, size)).astype(np.float32)


def token_ids(batch=2, seq=12, vocab=100, pad_from=8, pad_id=0, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(pad_id + 2, vocab, (batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    ids[1, pad_from:] = pad_id
    mask[1, pad_from:] = 0
    return ids, mask


def text_pair(key, **small):
    """The JAX and port text towers of ``TEXT_CONFIGS[key]`` cut to
    ``small`` widths."""
    cfg = dataclasses.replace(jtext.TEXT_CONFIGS[key], **small)
    tcfg = ttext.TextEncoderConfig(**dataclasses.asdict(cfg))
    return jtext.TextTransformer(cfg), ttext.TextTransformer(tcfg), cfg


SMALL_TEXT = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                  intermediate_size=64, max_position_embeddings=48)


@pytest.mark.parametrize('key,seq,layers', [
    ('bert', 12, 2), ('sentence-bert', 12, 3), ('roberta', 12, 2),
    ('mpnet', 40, 2)])
def test_text_towers(key, seq, layers):
    """BERT, MiniLM, RoBERTa (offset positions) and MPNet (no token types,
    relative bias, 40 tokens so buckets past the exact range occur)."""
    jm, tm, cfg = text_pair(key, **dict(SMALL_TEXT, num_layers=layers))
    ids, mask = token_ids(seq=seq, pad_from=seq - 5, pad_id=cfg.pad_token_id)
    (jl, jp), (tl, tp) = both(jm, tm, ids, mask)
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert hasattr(tm, 'token_type_embeddings') == (cfg.type_vocab_size > 0)
    assert hasattr(tm, 'relative_attention_bias') == cfg.use_relative_bias


def test_clip_vision_tower():
    c = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
             image_size=28, patch_size=14)
    (jl, jp), (tl, tp) = both(
        jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**c)),
        tclip.CLIPVisionTower(tclip.CLIPVisionConfig(**c)), images())
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_clip_text_tower_eot_pooling():
    """Causal and padding bias; EOT at the first maximum of the ids (row 1
    holds its maximum twice)."""
    c = dict(vocab_size=100, hidden_size=32, intermediate_size=64,
             num_layers=3, num_heads=2, max_position_embeddings=16)
    rng = np.random.default_rng(0)
    ids = np.zeros((2, 12), np.int32)
    mask = np.zeros((2, 12), np.int32)
    for b, length in enumerate((12, 8)):
        ids[b, 0] = 98
        ids[b, 1:length - 1] = rng.integers(5, 90, length - 2)
        ids[b, length - 1] = 99
        mask[b, :length] = 1
    ids[1, 3] = 99
    (jl, jp), (tl, tp) = both(
        jclip.CLIPTextTower(jclip.CLIPTextConfig(**c)),
        tclip.CLIPTextTower(tclip.CLIPTextConfig(**c)), ids, mask)
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_array_equal(tp[1], tl[1, 3])


def test_dinov2_tower_interpolates_positions():
    """A 4x4 stored grid interpolated to the 2x2 grid of 28 px."""
    c = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14,
             pos_embed_grid=4)
    (jl, jp), (tl, tp) = both(
        jdinov2.Dinov2Tower(jdinov2.Dinov2Config(**c)),
        tdinov2.Dinov2Tower(tdinov2.Dinov2Config(**c)), images())
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize('size', [64, 63])
def test_resnet_tower(size):
    """Even inputs: JAX runs its space-to-depth stem; odd: its canonical
    stem. The port runs the canonical 7x7/2 conv on both."""
    c = dict(embedding_size=8, hidden_sizes=(16, 32), depths=(2, 2))
    (jl, jp), (tl, tp) = both(
        jresnet.ResNetTower(jresnet.ResNetConfig(**c)),
        tresnet.ResNetTower(tresnet.ResNetConfig(**c)), images(size=size))
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize('size,s2d', [(16, True), (15, False)])
def test_resnet_stem(size, s2d):
    """The port's stem against JAX's ConvBN with the space-to-depth
    rewrite (even) and the canonical conv (odd), on NHWC inputs there."""
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    jm = jresnet.ConvBN(8, 7, 2, space_to_depth=s2d)
    params = jax_params(jm, x)
    ref = np.asarray(jm.apply({'params': params}, x))
    tm = tresnet.ConvBN(3, 8, 7, 2)
    load_encoder_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_convnext_tower():
    c = dict(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 2, 1))
    (jl, jp), (tl, tp) = both(
        jconvnext.ConvNextTower(jconvnext.ConvNextConfig(**c)),
        tconvnext.ConvNextTower(tconvnext.ConvNextConfig(**c)),
        images(size=64))
    np.testing.assert_allclose(tp, jp, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)


def test_convnext_same_padding_on_uneven_input():
    """Flax's SAME padding of the 4x4/4 stem on 30 px (8 patches, the odd
    pixels after) and of the 2x2/2 downsamples on odd grids."""
    c = dict(hidden_sizes=(8, 16), depths=(1, 1))
    (jl, jp), (tl, tp) = both(
        jconvnext.ConvNextTower(jconvnext.ConvNextConfig(**c)),
        tconvnext.ConvNextTower(tconvnext.ConvNextConfig(**c)),
        images(size=30))
    assert tl.shape == jl.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(tp, jp, **TOL)


def bf16_pair(kind):
    """(JAX tower, port tower, inputs) at narrow widths in bfloat16."""
    import jax.numpy as jnp
    bf = dict(jax=jnp.bfloat16, torch=torch.bfloat16)
    if kind == 'mpnet':
        cfg = dataclasses.replace(jtext.TEXT_CONFIGS['mpnet'], **SMALL_TEXT)
        return (jtext.TextTransformer(cfg, dtype=bf['jax']),
                ttext.TextTransformer(ttext.TextEncoderConfig(
                    **dataclasses.asdict(cfg)), dtype=bf['torch']),
                token_ids(seq=20, pad_from=15, pad_id=1))
    if kind == 'resnet':
        c = dict(embedding_size=8, hidden_sizes=(16, 32), depths=(1, 1))
        return (jresnet.ResNetTower(jresnet.ResNetConfig(**c),
                                    dtype=bf['jax']),
                tresnet.ResNetTower(tresnet.ResNetConfig(**c),
                                    dtype=bf['torch']), (images(size=32),))
    c = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
             image_size=28, patch_size=14)
    return (jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**c),
                                  dtype=bf['jax']),
            tclip.CLIPVisionTower(tclip.CLIPVisionConfig(**c),
                                  dtype=bf['torch']), (images(),))


@pytest.mark.parametrize('kind', ['mpnet', 'resnet', 'clip'])
def test_bfloat16_towers(kind):
    """``dtype=bfloat16``: the products and convolutions in bf16, as the
    JAX towers' ``dtype``: the same output dtypes, the values within a
    few bf16 steps of JAX's (the two round their bf16 sums in other
    orders)."""
    jm, tm, args = bf16_pair(kind)
    jout, tout = both(jm, tm, *args)
    for got, ref in zip(tout, jout):
        assert str(got.dtype) == str(ref.dtype), (got.dtype, ref.dtype)
        got, ref = got.astype(np.float32), ref.astype(np.float32)
        np.testing.assert_allclose(got, ref, rtol=5e-2,
                                   atol=5e-2 * np.abs(ref).max())


@pytest.mark.parametrize('src,dst', [(37, 16), (37, 8), (7, 16)])
def test_bicubic_resize_matrix_bit_for_bit(src, dst):
    ref = np.asarray(jdinov2.bicubic_resize_matrix(src, dst))
    got = tdinov2.bicubic_resize_matrix(src, dst)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('T', [12, 128, 512])
def test_relative_position_bucket(T):
    """MPNet's buckets at up to its 512 tokens, equal to JAX's."""
    pos = np.arange(T)
    rel = pos[None, :] - pos[:, None]
    ref = np.asarray(jtext.relative_position_bucket(rel.astype(np.int32)))
    got = ttext.relative_position_bucket(torch.from_numpy(rel)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_position_ids_and_biases():
    ids, mask = token_ids(seq=10, pad_from=6, pad_id=1)
    np.testing.assert_array_equal(
        tcommon.create_position_ids_from_input_ids(
            torch.from_numpy(ids), 1).numpy(),
        np.asarray(jcommon.create_position_ids_from_input_ids(ids, 1)))
    np.testing.assert_array_equal(
        tcommon.padding_attention_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jcommon.padding_attention_bias(mask)))
    np.testing.assert_array_equal(
        tcommon.causal_attention_bias(7).numpy(),
        np.asarray(jcommon.causal_attention_bias(7)))
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    for name, fn in tcommon.ACT2FN.items():
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                                   np.asarray(jcommon.ACT2FN[name](x)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_registry_matches_jax():
    """The same towers, configurations and pooled widths by key (the
    full-size port towers built on the meta device, allocated nowhere)."""
    with torch.device('meta'):
        registry_matches_jax()


def registry_matches_jax():
    for key in ('clip', 'dino', 'resnet', 'convnext'):
        tm = tregistry.build_vision_encoder(key)
        jm = jregistry.build_vision_encoder(key)
        assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
        assert type(tm).__name__ == type(jm).__name__
        assert tregistry.pooled_dim('vision', key) == \
            jregistry.pooled_dim('vision', key)
    for key in jtext.TEXT_CONFIGS:
        assert dataclasses.asdict(tregistry.build_language_encoder(
            key).config) == dataclasses.asdict(jtext.TEXT_CONFIGS[key])
        assert tregistry.pooled_dim('language', key) == \
            jregistry.pooled_dim('language', key)
    assert dataclasses.asdict(tregistry.build_clip_text_encoder().config) \
        == dataclasses.asdict(jclip.CLIPTextConfig())
    assert tregistry.pooled_dim('clip_text', 'clip') == 512
    assert tregistry.build_vision_encoder(
        'resnet', dtype=torch.bfloat16).stem.conv.compute_dtype \
        == torch.bfloat16
    with pytest.raises(ValueError):
        tregistry.build_vision_encoder('vgg')
    with pytest.raises(ValueError):
        tregistry.build_language_encoder('gpt')


# --------------------------------------------------------- HF checkpoints
def _hf_models():
    """Random-init HF models at narrow widths but the layer counts
    ``load_pretrained_params`` converts, by (modality, key)."""
    import transformers as tf
    small = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    return {
        ('language', 'sentence-bert'): lambda: tf.BertModel(tf.BertConfig(
            vocab_size=100, num_hidden_layers=6, **small)),
        ('language', 'roberta'): lambda: tf.RobertaModel(tf.RobertaConfig(
            vocab_size=100, num_hidden_layers=12, pad_token_id=1,
            type_vocab_size=1, max_position_embeddings=20, **small)),
        ('language', 'mpnet'): lambda: tf.MPNetModel(tf.MPNetConfig(
            vocab_size=100, num_hidden_layers=12,
            max_position_embeddings=20, **small)),
        ('vision', 'resnet'): lambda: tf.ResNetModel(tf.ResNetConfig(
            embedding_size=8, hidden_sizes=[16, 16, 16, 16],
            depths=[3, 4, 6, 3])),
        ('vision', 'convnext'): lambda: tf.ConvNextModel(tf.ConvNextConfig(
            hidden_sizes=[8, 8, 8, 8], depths=[3, 3, 27, 3])),
        ('vision', 'dino'): lambda: tf.Dinov2Model(tf.Dinov2Config(
            num_hidden_layers=12, image_size=28, patch_size=14, **small)),
        ('vision', 'clip'): lambda: tf.CLIPVisionModel(tf.CLIPVisionConfig(
            hidden_size=32, num_hidden_layers=12, num_attention_heads=2,
            intermediate_size=64, image_size=28, patch_size=14)),
        ('clip_text', 'clip'): lambda: tf.CLIPTextModel(tf.CLIPTextConfig(
            vocab_size=100, hidden_size=32, num_hidden_layers=12,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=16)),
    }


@pytest.mark.parametrize('entry', [
    ('language', 'sentence-bert'), ('language', 'roberta'),
    ('language', 'mpnet'), ('vision', 'resnet'), ('vision', 'convnext'),
    ('vision', 'dino'), ('vision', 'clip'), ('clip_text', 'clip')],
    ids=lambda e: '-'.join(e))
def test_load_pretrained_params_against_jax(monkeypatch, entry):
    """A random-init HF model stands in for the local checkpoint: the
    port's state dict equals JAX's converted tree bit for bit; a load of
    a checkpoint on the disk that fails raises in the port, where JAX
    gives None (random weights would follow); with no checkpoint on the
    disk the port returns None without calling transformers at all."""
    import transformers
    torch.manual_seed(0)
    hf = _hf_models()[entry]().eval()
    class_name = jconvert._HF_CLASSES[entry][0]
    cls = getattr(transformers, class_name)

    def tried(*a, **kw):
        pytest.fail('transformers was asked for a checkpoint not on disk')
    monkeypatch.setattr(cls, 'from_pretrained', tried)
    assert tconvert.load_pretrained_params(*entry) is None

    def local(*a, **kw):
        assert kw['local_files_only'] and \
            kw['adapter_kwargs'] == {'local_files_only': True}
        return hf
    monkeypatch.setattr(tconvert, 'hf_files_present', lambda name: True)
    monkeypatch.setattr(cls, 'from_pretrained', local)
    got = tconvert.load_pretrained_params(*entry)
    monkeypatch.setattr(cls, 'from_pretrained',
                        lambda *a, **kw: hf if kw.get('local_files_only')
                        else pytest.fail('a download was tried'))
    ref = encoder_state_dict(jconvert.load_pretrained_params(*entry))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k

    def missing(*a, **kw):
        raise OSError('not in the local cache')
    monkeypatch.setattr(cls, 'from_pretrained', missing)
    with pytest.raises(OSError, match='not in the local cache'):
        tconvert.load_pretrained_params(*entry)
    assert jconvert.load_pretrained_params(*entry) is None
    monkeypatch.setitem(sys.modules, 'transformers', None)
    assert tconvert.load_pretrained_params(*entry) is None
    assert tconvert.load_pretrained_params('vision', 'vgg') is None


def test_resnet50_full_geometry():
    """ResNet-50 at 224 px, batch 1: at JAX's full-size tolerance."""
    x = images(batch=1, size=224)
    (_, jp), (_, tp) = both(jresnet.ResNetTower(), tresnet.ResNetTower(), x)
    assert tp.shape == (1, 2048)
    np.testing.assert_allclose(tp, jp, **FULL_TOL)
