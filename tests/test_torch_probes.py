"""The probes P1-P3 (``pixelrec_multimodal_tpu_torch/probes``) against the
JAX package's Pallas probe bodies in ``scripts/profile_vpu_roofline.py``
and ``scripts/profile_int8_mxu.py``, run in Pallas interpret mode on the
CPU at small sizes: the scripts are imported by path and their module
globals (ROWS, K) patched down; the grid runs two instances over the same
block, as the scripts' grids do. Same numpy-seeded inputs on both sides.
The card's kernels are held to these plain versions in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr

ROOT = Path(__file__).resolve().parents[1]


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f'_probe_script_{name}', ROOT / 'scripts' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VPU = load_script('profile_vpu_roofline')
MXU = load_script('profile_int8_mxu')


def interpret(kernel, ins, out_shape, grid=2):
    """``kernel`` over ``grid`` instances of the same whole-array blocks, in
    interpret mode."""
    call = pl.pallas_call(
        kernel, grid=(grid,),
        in_specs=[pl.BlockSpec(a.shape, lambda i, n=a.ndim: (0,) * n)
                  for a in ins],
        out_specs=pl.BlockSpec(out_shape.shape, lambda i: (0, 0)),
        out_shape=out_shape, interpret=True)
    return np.asarray(jax.jit(call)(*ins))


# P1: the FMA chain rounds twice per step on the JAX side (a multiply, an
# add) and in the plain version alike, and the exp chain calls XLA's exp
# against torch's; with |x| < 0.9 each chain contracts, so an ulp per step
# stays an ulp or so: within 1e-6 of the value's scale after K 24.
@pytest.mark.parametrize('kind', ['fma', 'exp'])
def test_chain_plain_matches_pallas(kind, monkeypatch):
    K = 24
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (16, 128)).astype(
        np.float32)
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    kernel = VPU.fma_chain_kernel if kind == 'fma' else VPU.exp_chain_kernel
    fn, _ = VPU.run_chain(kernel, x.shape, K, 2)  # the script's own call
    ref = np.asarray(fn(jnp.asarray(x)))
    before = tvr.vpu_chain.launches
    out = tvr.vpu_chain(torch.from_numpy(x), K, kind).numpy()
    assert tvr.vpu_chain.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


# P2 rounds every product and sum on its own on both sides, in the same
# order: equal to float32 rounding (1e-6 of the value's scale).
def test_bcast_plain_matches_pallas():
    K, TB, TC = 6, 2, 16
    rng = np.random.default_rng(1)
    w = rng.standard_normal((TB, TC)).astype(np.float32)
    v = rng.standard_normal((TC, tvr.BC_DP)).astype(np.float32)
    ref = interpret(functools.partial(VPU.bcast_mul_acc_kernel, K=K),
                    (jnp.asarray(w), jnp.asarray(v)),
                    jax.ShapeDtypeStruct((TB, TC), jnp.float32))
    out = tvr.vpu_bcast(torch.from_numpy(w), torch.from_numpy(v), K).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


# Both of P2's instances take the plain version on the CPU (the fused one
# is held to it within a tolerance on the card, the unfused one bit for
# bit); the arguments that choose an instance are checked before the
# device is.
@pytest.mark.parametrize('fused', [True, False])
def test_bcast_instances_take_the_plain_path_on_cpu(fused):
    w, v = tvr.bcast_inputs('cpu', seed=2)
    before = tvr.vpu_bcast.launches
    for entries in tvr.BC_ENTRIES:
        out = tvr.vpu_bcast(w, v, 5, fused=fused, _entries=entries)
        assert torch.equal(out, tvr.bcast_plain(w, v, 5))
    assert tvr.vpu_bcast.launches == before
    with pytest.raises(ValueError, match='fused'):
        tvr.vpu_bcast(w, v, 5, fused=int(fused))
    with pytest.raises(ValueError, match='entries'):
        tvr.vpu_bcast(w, v, 5, fused=fused, _entries=64)
    with pytest.raises(ValueError, match='cuda or cpu'):
        tvr.vpu_bcast(w.to('meta'), v.to('meta'), 5, fused=fused)
    assert tvr.vpu_bcast.launches == before


def mxu_reference(mode, x, w1, w2, monkeypatch, rows, k):
    monkeypatch.setattr(MXU, 'ROWS', rows)
    monkeypatch.setattr(MXU, 'K', k)
    kernel = (MXU.bf16_chain_kernel if mode == 'bf16' else functools.partial(
        MXU.int8_chain_kernel, rescale=mode == 'int8_rescale'))
    return interpret(kernel, (x, w1, w2),
                     jax.ShapeDtypeStruct((rows, MXU.H3), jnp.float32))


# P3's int8 modes: exact integer products on both sides, each float32 step
# rounded once in the same order: equal bit for bit. The bf16 mode: the
# float32 sums of x @ w1 and h @ w2 run in another order than XLA's, so a
# rounding of h or of the fold to bf16 (2^-8) lands on the neighbouring
# value now and then, which moves an output by about 3e-4 of its scale:
# within 1e-3 of the scale after K 3.
@pytest.mark.parametrize('mode', tmx.MODES)
def test_mxu_plain_matches_pallas(mode, monkeypatch):
    rows, k = 32, 3
    x, w1, w2 = tmx.inputs(mode, 'cpu', rows=rows, seed=2)
    if mode == 'bf16':
        jx = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                   for t in (x, w1, w2))
    else:
        jx = tuple(jnp.asarray(t.numpy()) for t in (x, w1, w2))
    ref = mxu_reference(mode, *jx, monkeypatch, rows, k)
    before = tmx.mxu_chain.launches
    out = tmx.mxu_chain(x, w1, w2, mode, k).numpy()
    assert tmx.mxu_chain.launches == before
    if mode == 'bf16':
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max())
    else:
        np.testing.assert_array_equal(out, ref)


def hand_packed(ws, ks, chunk):
    """The wgmma packing of the layers ``ws`` (numpy [K, N] each) by hand:
    W^T zero-padded to [N64, K rounded to ks], tile (k slice of ks, column
    group of 64) at (k // ks * N64 / 64 + n // 64) * 64 * ks past the
    layer's offset, row n of a tile ks elements (128 bytes) whose chunks of
    ``chunk`` elements are swizzled by n % 8."""
    parts = []
    for w in ws:
        k, n = w.shape
        kp, n64 = -(-k // ks) * ks, -(-n // 64) * 64
        layer = np.zeros(kp * n64, w.dtype)
        kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing='ij')
        idx = (((kk // ks) * (n64 // 64) + nn // 64) * 64 * ks
               + (nn % 64) * ks + (((kk % ks) // chunk) ^ (nn % 8)) * chunk
               + kk % chunk)
        layer[idx] = w
        parts.append(layer)
    return np.concatenate(parts)


# P3's weights reach the kernel packed as the pair kernels' wgmma chains
# read theirs: bf16 in 64 x 64 tiles of 8-element chunks, int8 (each layer
# transposed, as an int8 chain keeps it) in 64 x 128 tiles of 16-code
# chunks; held at small widths (w1 [K, N1] with K past one k slice, N1 and
# N2 not multiples of 128) against the hand packing.
@pytest.mark.parametrize('mode', tmx.MODES)
def test_mxu_weights_are_packed_as_the_chains(mode):
    rng = np.random.default_rng(4)
    shapes = ((192, 96), (96, 64)) if mode == 'bf16' else ((256, 96),
                                                          (96, 64))
    if mode == 'bf16':
        ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(torch.bfloat16) for s in shapes]
        expect = hand_packed([w.float().numpy() for w in ws], 64, 8)
        got = tmx.pack_weights(*ws, mode).float().numpy()
    else:
        ws = [torch.from_numpy(rng.integers(-127, 127, s).astype(np.int8))
              for s in shapes]
        expect = hand_packed([w.numpy() for w in ws], 128, 16)
        got = tmx.pack_weights(*ws, mode).numpy()
    assert got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


def test_probes_refuse_what_they_do_not_take():
    """Other devices, types and shapes raise; nothing falls back or counts
    a launch."""
    x = tvr.chain_inputs('cpu')
    counts = (tvr.vpu_chain.launches, tvr.vpu_bcast.launches,
              tmx.mxu_chain.launches)
    with pytest.raises(ValueError, match='cuda or cpu'):
        tvr.vpu_chain(x.to('meta'), 8)
    with pytest.raises(ValueError, match='even K'):
        tvr.vpu_chain(x, 7)
    with pytest.raises(ValueError, match='kind'):
        tvr.vpu_chain(x, 8, 'tanh')
    w, v = tvr.bcast_inputs('cpu')
    with pytest.raises(ValueError, match='cuda or cpu'):
        tvr.vpu_bcast(w.to('meta'), v.to('meta'), 4)
    t = tmx.inputs('int8_raw', 'cpu', rows=16)
    with pytest.raises(ValueError, match='mode'):
        tmx.mxu_chain(*t, 'int4')
    with pytest.raises(ValueError, match='cuda or cpu'):
        tmx.mxu_chain(*(a.to('meta') for a in t), 'int8_raw')
    assert (tvr.vpu_chain.launches, tvr.vpu_bcast.launches,
            tmx.mxu_chain.launches) == counts
    assert tmx.flops(8192, 8, 64) == 2 * 8192 * (512 * 256 + 256 * 128) * 512


def test_slope_ms_interleaves_and_keeps_each_least(monkeypatch):
    """The rate probes' two times are read in turn, ``rounds`` times each,
    and each is the least of its readings: a slow first reading (a card
    still ramping up its clock) moves neither, so it cannot widen the
    slope's rate."""
    import pixelrec_multimodal_tpu_torch.probes as probes
    order, readings = [], {'lo': [1.6, 1.3, 1.35], 'hi': [3.5, 3.45, 3.4]}

    def fake_ms(fn, reps):
        key = fn()
        order.append(key)
        return readings[key][sum(k == key for k in order) - 1]

    monkeypatch.setattr(probes, 'cuda_ms', fake_ms)
    assert probes.slope_ms(lambda: 'lo', lambda: 'hi', 10, rounds=3) == (
        1.3, 3.4)
    assert order == ['lo', 'hi'] * 3
