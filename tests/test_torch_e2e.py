"""The port's end-to-end model (``models/end_to_end.py``) against the JAX
package's, on the CPU: the converted state dict, eval-mode scores and
embeddings and every gradient at 1e-5, remat, the trainable mask,
``build_end_to_end_model`` and the non-finite skip of
``training/e2e_steps.py``. The tiny towers and their numpy-seeded Flax
tree are ``tests/_torch_e2e.py``'s;
the train steps against JAX's are ``test_torch_e2e_steps.py`` (SGD, and
an augmented step on a dataset's batch) and ``test_torch_e2e_adam.py``
(AdamW).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.models import end_to_end as jend
from pixelrec_multimodal_tpu_torch import config as tconfig
from pixelrec_multimodal_tpu_torch.encoders import clip as tclip
from pixelrec_multimodal_tpu_torch.encoders import resnet as tresnet
from pixelrec_multimodal_tpu_torch.encoders import text_models as ttext
from pixelrec_multimodal_tpu_torch.models import end_to_end as tend
from pixelrec_multimodal_tpu_torch.training import e2e_steps as te2e
from pixelrec_multimodal_tpu_torch.training import optimizers as topt
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    end_to_end_state_dict,
)
from tests._torch_e2e import (
    CLIP_TEXT,
    LR,
    RESNET,
    TEXT,
    TOL,
    jax_model,
    jax_variables,
    loaded_port,
    numerical_table,
    port_model,
    port_sd,
    raw_batch,
)


def test_end_to_end_state_dict_names():
    """Every tensor of the port's model is set, under the Flax subtree's
    name; ResNet's statistics land on parameters (the repaired
    ``FrozenBatchNorm``), the scorer's on its BatchNorm buffers."""
    params, stats = jax_variables(contrastive=True)
    sd = end_to_end_state_dict(params, stats)
    model = port_model(contrastive=True)
    assert sorted(sd) == sorted(port_sd(model))
    names = dict(model.named_parameters())
    for key in ('vision_encoder.stem.bn.running_mean',
                'vision_encoder.stage_1_block_0.conv2.bn.running_var'):
        assert key in names and key in sd
    np.testing.assert_array_equal(
        sd['vision_encoder.stem.bn.running_var'].numpy(),
        params['vision_encoder']['stem']['bn']['var'])
    assert 'scorer.prediction_network.BatchNorm_0.running_mean' in dict(
        model.named_buffers())
    with pytest.raises(KeyError, match='no end-to-end subtree'):
        end_to_end_state_dict({'other': {}})


@pytest.mark.parametrize('contrastive', [False, True])
def test_forward_matches_jax(contrastive):
    """Eval-mode scores (and the contrastive embeddings) at 1e-5."""
    params, stats = jax_variables(contrastive)
    batch = raw_batch(contrastive)
    idx = [batch[k] for k in ('user_idx', 'item_idx', 'tag_idx')]
    raw = {k: v for k, v in batch.items()
           if k not in ('user_idx', 'item_idx', 'tag_idx', 'label',
                        'weight')}
    num = numerical_table()[batch['item_idx']]
    apply = jax.jit(jax_model(contrastive).apply,
                    static_argnames=('train', 'return_embeddings'))
    jout = apply(
        {'params': params, 'batch_stats': stats}, *map(jnp.asarray, idx),
        numerical_features=jnp.asarray(num), train=False,
        return_embeddings=contrastive,
        **{k: jnp.asarray(v) for k, v in raw.items()})
    model = loaded_port(params, stats, contrastive)
    with torch.no_grad():
        tout = model(*map(torch.from_numpy, idx),
                     numerical_features=torch.from_numpy(num),
                     return_embeddings=contrastive,
                     **{k: torch.from_numpy(v) for k, v in raw.items()})
    jout = jout if contrastive else (jout,)
    tout = tout if contrastive else (tout,)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def test_gradients_match_jax():
    """The gradient of the eval-mode BCE with respect to every parameter,
    the ResNet stem's canonical 7x7 kernel among them (JAX computes the
    stem as a space-to-depth 4x4 conv of the same parameter)."""
    params, stats = jax_variables()
    batch = raw_batch()
    num = numerical_table()[batch['item_idx']]
    inputs = {k: v for k, v in batch.items() if k not in ('label', 'weight')}
    jmodel = jax_model()

    def loss(p):
        scores = jmodel.apply({'params': p, 'batch_stats': stats},
                              numerical_features=jnp.asarray(num),
                              train=False,
                              **{k: jnp.asarray(v) for k, v in inputs.items()})
        return jnp.mean(scores)

    jgrads = end_to_end_state_dict(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(params)))
    model = loaded_port(params, stats)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = model(tin.pop('user_idx'), tin.pop('item_idx'), tin.pop('tag_idx'),
                numerical_features=torch.from_numpy(num), **tin)
    names, ps = zip(*model.named_parameters())
    tgrads = dict(zip(names, torch.autograd.grad(out.mean(), ps,
                                                 allow_unused=True)))
    assert sorted(tgrads) == sorted(jgrads)
    stem = 'vision_encoder.stem.conv.weight'
    assert float(jgrads[stem].abs().max()) > 1e-4
    for k, g in jgrads.items():
        t = torch.zeros_like(g) if tgrads[k] is None else tgrads[k]
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(t.numpy(), g.numpy(), rtol=0,
                                   atol=TOL * scale, err_msg=k)


def test_remat_equals_no_remat():
    """Recompute changes no value: one SGD step with and without remat
    gives the same loss and parameters; with remat the towers' forward
    saves fewer tensors for the backward."""
    params, stats = jax_variables()
    batch = raw_batch()
    results = []
    for remat in (False, True):
        model = loaded_port(params, stats, remat=remat)
        state = te2e.init_e2e_train_state(model,
                                          topt.build_optimizer('sgd', LR))
        step = te2e.make_e2e_step_fns(
            model, {'numerical': torch.from_numpy(numerical_table())})[0]
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(1) or t, lambda t: t):
            _, m = step(state, batch)
        results.append((float(m['total_loss']), port_sd(model), len(saved)))
    (loss0, sd0, n0), (loss1, sd1, n1) = results
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert n1 < n0


@pytest.mark.parametrize('freeze', [(True, True), (False, True),
                                    (True, False), (False, False)])
def test_trainable_mask_names(freeze):
    """The port's mask, by name, is JAX's mask tree carried across; the
    CLIP text tower follows ``freeze_vision``."""
    params, _ = jax_variables(contrastive=True)
    jmask = jend.trainable_mask(params, *freeze)
    ref = end_to_end_state_dict(jax.tree.map(
        lambda m, p: np.full(p.shape, m, np.float32), jmask, params))
    got = tend.trainable_mask(port_model(contrastive=True), *freeze)
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert bool(ref[k].all()) == v and bool(ref[k].any()) == v, k
    assert tend.trainable_mask(list(got), *freeze) == got
    assert got['scorer.temperature']
    assert got['clip_text_encoder.final_layer_norm.weight'] == (not freeze[0])


def test_nonfinite_loss_skips_the_update():
    """A NaN label makes the loss NaN (a NaN pixel would not: the scorer
    maps non-finite scores to finite ones): the port's step leaves every
    parameter, the optimizer state and the scorer's BatchNorm statistics
    as they were, and does not count the step."""
    params, stats = jax_variables()
    model = loaded_port(params, stats)
    state = te2e.init_e2e_train_state(model,
                                      topt.build_optimizer('adamw', LR))
    step = te2e.make_e2e_step_fns(model, {})[0]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = raw_batch()
    batch['label'][0] = np.nan
    _, m = step(state, batch)
    assert not np.isfinite(float(m['total_loss']))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(state.step) == 0 and not state.opt_state.mu.any()


def test_build_end_to_end_model(monkeypatch):
    """``build_end_to_end_model`` puts the config's towers (tiny ones
    patched in for the registry's) in front of ``build_model``'s scorer,
    the CLIP text tower only with contrastive CLIP, in ``encoder_dtype``,
    with random weights from the seed and remat threaded through."""
    monkeypatch.setattr(tend, 'build_vision_encoder', lambda key, dtype:
                        tresnet.ResNetTower(tresnet.ResNetConfig(**RESNET),
                                            dtype=dtype))
    monkeypatch.setattr(tend, 'build_language_encoder', lambda key, dtype:
                        ttext.TextTransformer(ttext.TextEncoderConfig(**TEXT),
                                              dtype=dtype))
    monkeypatch.setattr(tend, 'build_clip_text_encoder', lambda dtype:
                        tclip.CLIPTextTower(tclip.CLIPTextConfig(**CLIP_TEXT),
                                            dtype=dtype))
    cfg = tconfig.ModelConfig(vision_model='resnet',
                              language_model='sentence-bert',
                              embedding_dim=8, use_contrastive=True,
                              fusion_hidden_dims=[16])
    m = tend.build_end_to_end_model(cfg, 4, 6, 2, 0, remat_encoders=True,
                                    device='cpu')
    assert m.remat_encoders and not m.use_clip_text
    assert m.scorer.vision_feature_dim == 2048
    assert m.vision_encoder.stem.conv.compute_dtype == torch.float32
    cfg.vision_model = 'clip'
    c = tend.build_end_to_end_model(cfg, 4, 6, 2, 0,
                                    encoder_dtype=torch.bfloat16,
                                    device='cpu')
    assert c.use_clip_text and c.scorer.contrastive_active
    assert not c.remat_encoders
    assert c.clip_text_encoder.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in c.parameters())
    c2 = tend.build_end_to_end_model(cfg, 4, 6, 2, 0, device='cpu')
    for (k, a), (_, b) in zip(c.state_dict().items(),
                              c2.state_dict().items()):
        assert torch.equal(a, b), k
    cfg.vision_model, cfg.language_model = None, 'sentence-bert'
    t = tend.build_end_to_end_model(cfg, 4, 6, 2, 0, device='cpu')
    assert sorted(n for n, _ in t.named_children()) == [
        'language_encoder', 'scorer']
