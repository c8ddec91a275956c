"""Parity of the port's fused pairwise-MLP module with the JAX package:
head building tensor for tensor, the float32 plain path against the XLA
fallback, the bf16 plain path against the Pallas kernel in interpret mode,
and the CUDA wrapper's dispatch rules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.models.multimodal import activation_fn
from pixelrec_multimodal_tpu.ops import pairwise_mlp as jpm
from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
from tests._torch_port import make_pair

N_ITEMS = 40
ACTIVATIONS = ['relu', 'gelu', 'tanh', 'leaky_relu', 'silu']
FINALS = ['sigmoid', 'tanh', 'none']


def heads(activation='relu', final='sigmoid', use_batch_norm=True):
    jmodel, variables, tmodel = make_pair(N_ITEMS, activation, final,
                                          use_batch_norm=use_batch_norm)
    return (jpm.build_factorized_head(variables, jmodel),
            tpm.build_factorized_head(tmodel), jmodel, variables, tmodel)


def rows(h1, B=16, C=128, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, h1)).astype(np.float32),
            rng.standard_normal((C, h1)).astype(np.float32))


@pytest.mark.parametrize('use_batch_norm', [True, False])
def test_head_matches_jax_tensor_for_tensor(use_batch_norm):
    """Same host-side float32 numpy math: equal to float32 rounding."""
    jh, th, jmodel, variables, tmodel = heads(use_batch_norm=use_batch_norm)
    jk, jb = jpm.fold_prediction_mlp(variables, jmodel)
    tk, tb = tpm.fold_prediction_mlp(tmodel)
    for a, b in zip(jk + jb, tk + tb):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert set(th) == set(jh) | {'kernel'}  # + the CUDA kernel's tensors
    for key in ('b1', 'w_user', 'w_item'):
        np.testing.assert_allclose(th[key].numpy(), np.asarray(jh[key]),
                                   rtol=1e-6, atol=1e-7)
    assert len(th['layers']) == len(jh['layers'])
    for (tw, tbias), (jw, jbias) in zip(th['layers'], jh['layers']):
        assert tuple(tw.shape) == jw.shape  # 128-lane padding kept
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tbias.numpy(), np.asarray(jbias),
                                   rtol=1e-6, atol=1e-7)
    for key in ('fusion', 'activation', 'final_activation', 'b1_folded'):
        assert th[key] == jh[key]
    h1, b1, layers = tpm.pack_mlp_chain(tk, tb, len(tk) - 1)
    assert h1 == 128 and b1.shape == (128,)
    assert [tuple(w.shape) for w, _ in layers] == [(128, 128), (128, 128)]


def test_first_layer_rows_match_jax():
    jh, th, *_ = heads()
    rng = np.random.default_rng(4)
    item_flat = rng.standard_normal((9, th['w_item'].shape[0])).astype(
        np.float32)
    user_emb = rng.standard_normal((5, th['w_user'].shape[0])).astype(
        np.float32)
    np.testing.assert_allclose(
        tpm.compute_item_first(th, torch.from_numpy(item_flat)).numpy(),
        np.asarray(jpm.compute_item_first(jh, jnp.asarray(item_flat))),
        atol=1e-5)
    np.testing.assert_allclose(
        tpm.compute_user_first(th, torch.from_numpy(user_emb)).numpy(),
        np.asarray(jpm.compute_user_first(jh, jnp.asarray(user_emb))),
        atol=1e-5)


@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_f32_matches_xla(activation, final):
    """Float32 plain path == xla_pairwise_scores (atol 1e-5: float32 sums
    in another order)."""
    jh, th, *_ = heads(activation, final)
    uf, itf = rows(th['b1'].shape[0], B=6, C=20)
    ref = jpm.xla_pairwise_scores(jh, jnp.asarray(uf), jnp.asarray(itf))
    out = tpm.pairwise_scores_plain(th, torch.from_numpy(uf),
                                    torch.from_numpy(itf))
    assert out.shape == (6, 20) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# The bf16 plain path against the Pallas kernel in interpret mode. The
# assembly add, the bias add, the bf16 rounding of each layer's output and
# the last f32 dot are the same rounding points, so relu (the flagship
# activation, exact in any precision) agrees to float32 rounding of
# differently ordered sums: atol 1e-6. The other activations are
# evaluated by XLA's CPU bf16 arithmetic one operation at a time, each
# result rounded to bf16 (leaky_relu's slope too), while the port and the
# CUDA kernel evaluate them in float32 on the bf16 input and round once:
# the scores then differ by a few bf16 steps carried through the chain,
# atol 2e-2 on scores of order 1 (the bf16 chain itself is 1e-2 from the
# float32 chain at these widths). The next test pins those activations'
# rounding points.
BF16_TOL = {'relu': 1e-6}


@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_bf16_matches_pallas_interpret(activation, final):
    jh, th, *_ = heads(activation, final)
    uf, itf = rows(th['b1'].shape[0])  # one 16 x 128 Pallas tile
    ref = jpm.pallas_pairwise_scores(
        jh, jnp.asarray(uf), jnp.asarray(itf), tile_users=16,
        tile_items=128, compute_dtype=jnp.bfloat16, interpret=True)
    out = tpm.pairwise_scores_plain(th, torch.from_numpy(uf),
                                    torch.from_numpy(itf), torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=BF16_TOL.get(activation, 2e-2))


def kernel_rounding_reference(jh, uf, itf):
    """The Pallas kernel's math in JAX (its ``_mlp_chain``) with each
    activation evaluated in float32 on its bf16 input and rounded to bf16
    once, as the CUDA kernel and the port's bf16 plain version do."""
    bf16 = jnp.bfloat16
    f = activation_fn(jh['activation'])

    def act(x):
        return f(x.astype(jnp.float32)).astype(bf16)

    x = (jnp.asarray(uf).astype(bf16)[:, None, :]
         + jnp.asarray(itf).astype(bf16)[None, :, :])
    x = act(x).reshape(uf.shape[0] * itf.shape[0], -1)
    refs = [t for layer in jh['layers'] for t in layer]
    return jpm._mlp_chain(x, refs, len(jh['layers']), act,
                          jh['final_activation'], bf16).reshape(
                              uf.shape[0], itf.shape[0])


# Against that reference only float32 summation order differs, which can
# move a hidden activation to the neighbouring bf16 value: atol 1e-3 on
# scores of order 1. The float32 plain version is at least 1.6e-3 away for
# every activation and final here, so the limit tells bf16 from float32.
ROUNDING_TOL = 1e-3


@pytest.mark.parametrize('final', FINALS)
@pytest.mark.parametrize('activation', ACTIVATIONS)
def test_plain_bf16_rounds_where_the_kernel_does(activation, final):
    jh, th, *_ = heads(activation, final)
    uf, itf = rows(th['b1'].shape[0])
    ref = np.asarray(kernel_rounding_reference(jh, uf, itf))
    uf_t, itf_t = torch.from_numpy(uf), torch.from_numpy(itf)
    out = tpm.pairwise_scores_plain(th, uf_t, itf_t, torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref, atol=ROUNDING_TOL)
    f32 = tpm.pairwise_scores_plain(th, uf_t, itf_t, torch.float32)
    assert np.abs(f32.numpy() - ref).max() > ROUNDING_TOL


def test_candidate_scores_match_xla():
    jh, th, *_ = heads('gelu', 'sigmoid')
    h1 = th['b1'].shape[0]
    rng = np.random.default_rng(5)
    uf = rng.standard_normal((4, h1)).astype(np.float32)
    cand = rng.standard_normal((4, 7, h1)).astype(np.float32)
    ref = jpm.xla_candidate_scores(jh, jnp.asarray(uf), jnp.asarray(cand))
    out = tpm.candidate_scores(th, torch.from_numpy(uf),
                               torch.from_numpy(cand))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_wrapper_dispatch_on_cpu():
    """CPU tensors take the float32 plain path and launch nothing; other
    devices and unfolded heads raise."""
    _, th, *_ = heads()
    uf, itf = rows(th['b1'].shape[0], B=3, C=5)
    uf, itf = torch.from_numpy(uf), torch.from_numpy(itf)
    before = tpm.pairwise_scores.launches
    out = tpm.pairwise_scores(th, uf, itf)
    assert tpm.pairwise_scores.launches == before
    torch.testing.assert_close(out, tpm.pairwise_scores_plain(th, uf, itf))
    with pytest.raises(ValueError, match='cuda or cpu'):
        tpm.pairwise_scores(th, uf.to('meta'), itf.to('meta'))
    with pytest.raises(ValueError, match='b1 folded'):
        tpm.pairwise_scores(dict(th, b1_folded=False), uf, itf)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        tpm.pairwise_scores_plain(th, uf, itf, torch.float16)


@pytest.mark.parametrize('activation,final,codes', [
    ('relu', 'sigmoid', (0, 0)), ('gelu', 'tanh', (1, 1)),
    ('silu', 'none', (4, 2))])
def test_kernel_chain_layout(activation, final, codes):
    """The tensors the kernel reads, built on the host from the head: the
    hidden weights back to back in bf16, biases and the live last column
    rounded to bf16 (held as float32), b_last unrounded, the width list
    and the activation codes of csrc/pairwise_mlp.cu."""
    _, th, *_ = heads(activation, final)
    h1 = th['b1'].shape[0]
    chain = th['kernel']  # built once with the head
    hidden = th['layers'][:-1]
    w_last, b_last = th['layers'][-1]
    assert chain['widths'].tolist() == [h1] + [w.shape[1] for w, _ in hidden]
    assert chain['n_hidden'] == len(hidden) == 1
    assert chain['w'].dtype == torch.bfloat16
    torch.testing.assert_close(chain['w'], torch.cat(
        [w.to(torch.bfloat16).reshape(-1) for w, _ in hidden]), rtol=0,
        atol=0)
    torch.testing.assert_close(chain['b'], hidden[0][1].to(
        torch.bfloat16).float(), rtol=0, atol=0)
    torch.testing.assert_close(chain['w_last'], w_last[:, 0].to(
        torch.bfloat16).float(), rtol=0, atol=0)
    assert chain['b_last'].tolist() == [b_last[0].item()]
    assert (chain['act'], chain['final']) == codes
    again = tpm.kernel_chain(th, 'cpu')
    assert set(again) == set(chain)
    for key in ('w', 'b', 'w_last', 'b_last'):
        torch.testing.assert_close(again[key], chain[key], rtol=0, atol=0)


def test_kernel_chain_rejects_what_the_kernel_does_not_take():
    _, th, *_ = heads()
    h1 = th['b1'].shape[0]
    w, b = th['layers'][0]
    bad = dict(th, layers=[(w[:, :40], b[:40]), (th['layers'][1][0][:40],
                                                  th['layers'][1][1])])
    with pytest.raises(ValueError, match='multiples of 16'):
        tpm.kernel_chain(bad)
    deep = dict(th, layers=[(torch.zeros(h1, h1), torch.zeros(h1))]
                * (tpm.MAX_HIDDEN + 1) + [th['layers'][-1]])
    with pytest.raises(ValueError, match='at most'):
        tpm.kernel_chain(deep)
    with pytest.raises(ValueError, match='input width'):
        tpm.kernel_chain(dict(th, b1=torch.zeros(h1 + 16)))
