"""The port's top-K primitives against the JAX ones. Values are compared
exactly; index sets, not tie order (approx_max_k and torch.topk may order
equal values differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.ops import topk as jtopk
from pixelrec_multimodal_tpu_torch.ops import topk as ttopk


def candidates(B, n, seed, pad=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, n)).astype(np.float32)
    if pad:
        v[:, -pad:] = ttopk.NEG_INF  # padding entries, as the scan masks them
    i = rng.permutation(10 * n)[:n].astype(np.int32)
    return v, np.broadcast_to(i, (B, n)).copy()


def test_neg_inf_and_init_match():
    assert ttopk.NEG_INF == jtopk.NEG_INF
    jv, ji = jtopk.init_topk(3, 5)
    tv, ti = ttopk.init_topk(3, 5)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize('k,n,pad', [(5, 40, 0), (10, 30, 25), (8, 8, 3)])
def test_merge_matches_jax(k, n, pad):
    """A running carry (itself a merge of a padded chunk) merged with a
    second chunk, the way the catalog scan uses it."""
    B = 6
    v1, i1 = candidates(B, n, 1, pad)
    v2, i2 = candidates(B, n, 2, pad)
    jc = jtopk.merge_topk(*jtopk.init_topk(B, k), jnp.asarray(v1),
                          jnp.asarray(i1), k)
    jv, ji = jtopk.merge_topk(*jc, jnp.asarray(v2), jnp.asarray(i2), k)
    tc = ttopk.merge_topk(*ttopk.init_topk(B, k), torch.from_numpy(v1),
                          torch.from_numpy(i1), k)
    tv, ti = ttopk.merge_topk(*tc, torch.from_numpy(v2),
                              torch.from_numpy(i2), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for a, b, vals in zip(ti.numpy(), np.asarray(ji), tv.numpy()):
        live = vals > ttopk.NEG_INF / 2  # padding ties: any -1 / pad index
        assert set(a[live]) == set(b[live])


def test_topk_2d_matches_jax():
    v, _ = candidates(4, 50, 3)
    jv, ji = jtopk.topk_2d(jnp.asarray(v), 7)
    tv, ti = ttopk.topk_2d(torch.from_numpy(v), 7)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
