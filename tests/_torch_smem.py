"""The kernels' shared memory per block, counted by hand from their layout
(``ops/csrc/mlp_chain.cuh``, ``mlp_chain_int8.cuh``,
``mlp_chain_wgmma.cuh``, ``mlp_chain_wgmma_int8.cuh``,
``attention_common.cuh``), with the signature of
``ops/pairwise_mlp.py:block_bytes``, which asks the kernel's own launch
set-up. The CPU tests stand it in for the card's count (``hand_count``);
``tests/test_torch_cuda.py`` holds the card's count to it. Imports neither
JAX nor the JAX package."""
from typing import Sequence, Tuple

import pytest

from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm

TILE_ITEMS = 16                       # items per tile; a block: rows / 16 users
RING_BYTES = 3 * 32 * (128 + 8) * 2   # bf16 weight ring: 3 x 32 x 136
RING_BYTES_INT8 = 3 * 128 * (64 + 16)  # int8 weight ring: 3 x 128 x 80
# the wgmma chain (the bf16 modes of K1, K2 and K3, and K4, K5 and K6, at
# 128 and 64 rows; the pair kernels' 64-row block only where it fits, else
# the mma.sync chain's): ring stages of 64 k x 128 columns of bf16 (16 KB),
# as many as the 232,448 B a block may take leave after the buffers and the
# 64 B of barriers, from two k slices' (4 at 128 rows, 8 at 64) to 8; the
# four warpgroups cover a group of 32,768 / rows columns (256 at 128 rows,
# 512 at 64) in one sweep
WGMMA_SMEM = 232448
WGMMA_BARRIER_BYTES = 64
SUU_PAD = 8                           # columns of the per-user self-logits


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def chain_smem_bytes(widths: Sequence[int], rows: int, scratch: int = 0,
                     int8: bool = False) -> int:
    """A block of ``rows`` pair rows on the chain of ``widths`` (its layer
    0's input width first, then each hidden layer's output): the two
    activation buffers, the even-indexed widths in buffer A and the odd
    ones in B, each row padded (bf16: 8 elements; int8: 16 bytes, and the
    last hidden layer's partial sums of the last dot, one float per
    128-column pass and column group, in place of its output), then the
    weight ring or the assembly's ``scratch`` bytes, whichever is larger."""
    n_hidden = len(widths) - 1
    if int8:
        groups = 16 // (rows // 16)
        sizes = [0, 0]
        for i, w in enumerate(widths):
            if i < n_hidden:
                row = w + 16
            else:
                row = _round_up(4 * groups * _round_up(w, 128) // 128,
                                32) + 16
            sizes[i % 2] = max(sizes[i % 2], row)
        return rows * (sizes[0] + sizes[1]) + max(RING_BYTES_INT8, scratch)
    stride_a = max(widths[0::2]) + 8
    stride_b = max(widths[1::2]) + 8 if n_hidden else 0
    return rows * (stride_a + stride_b) * 2 + max(RING_BYTES, scratch)


def wgmma_layout(widths: Sequence[int], rows: int) -> Tuple[int, ...]:
    """The wgmma chain's buffers and ring for a block of 128 or 64 rows:
    (columns of buffer A, of buffer B, ring stages, bytes a stage). Buffer
    A holds the first input; a layer whose output fits one group writes it
    over its input, any other into the other buffer; each buffer is as wide
    as the widest it holds, rounded up to 64 columns (swizzled blocks, no
    padding)."""
    group = 32768 // rows
    cols, cur = [_round_up(widths[0], 64), 0], 0
    for n in widths[1:]:
        if n > group:
            cur ^= 1
        cols[cur] = max(cols[cur], _round_up(n, 64))
    stage = 64 * 128 * 2
    left = WGMMA_SMEM - WGMMA_BARRIER_BYTES - rows * sum(cols) * 2
    return (cols[0], cols[1], min(8, max(2 * 256 // rows, left // stage)),
            stage)


def wgmma_chain_smem_bytes(widths: Sequence[int], rows: int,
                           scratch: int = 0) -> int:
    """A block of 128 or 64 rows on the wgmma chain of ``widths``: the two
    activation buffers (``wgmma_layout``), then the ring and its barriers,
    or the assembly's ``scratch`` bytes, whichever is larger."""
    cols_a, cols_b, stages, stage = wgmma_layout(widths, rows)
    return rows * (cols_a + cols_b) * 2 + max(
        stages * stage + WGMMA_BARRIER_BYTES, scratch)


def wgmma_int8_layout(widths: Sequence[int], rows: int) -> Tuple[int, ...]:
    """The s8 wgmma chain's buffers and ring (``mlp_chain_wgmma_int8.cuh``:
    K1q, K2q and K3q) for a block of 128 or 64 rows, as ``wgmma_layout`` with
    widths in bytes, one byte a code: (bytes of a row of buffer A, of
    buffer B, ring stages, bytes a stage). Each buffer is as wide as the
    widest it holds, rounded up to 128 bytes (a swizzle atom); the last
    hidden layer's partial sums of the last dot take the place of its codes
    and fewer bytes. A stage holds one k slice of 128 codes x 128 columns,
    16 KB as in bf16."""
    group = 32768 // rows
    cols, cur = [_round_up(widths[0], 128), 0], 0
    for n in widths[1:]:
        if n > group:
            cur ^= 1
        cols[cur] = max(cols[cur], _round_up(n, 128))
    stage = 128 * 128
    left = WGMMA_SMEM - WGMMA_BARRIER_BYTES - rows * sum(cols)
    return (cols[0], cols[1], min(8, max(2 * 256 // rows, left // stage)),
            stage)


def wgmma_int8_chain_smem_bytes(widths: Sequence[int], rows: int,
                                scratch: int = 0) -> int:
    """A block of 128 or 64 rows on the s8 wgmma chain of ``widths``: the
    two code buffers (``wgmma_int8_layout``), then the ring and its
    barriers, or the assembly's ``scratch`` bytes, whichever is larger."""
    bytes_a, bytes_b, stages, stage = wgmma_int8_layout(widths, rows)
    return rows * (bytes_a + bytes_b) + max(
        stages * stage + WGMMA_BARRIER_BYTES, scratch)


def pair_scratch_bytes(name: str, h1: int, rows: int) -> int:
    """The assembly's scratch of a pair kernel's block (it lives in the
    weight ring until the chain starts): K1 the tile's users' bf16 rows; K2
    their f32 rows and every pair row's gates; K3 their f32 rows and
    coefficients and every pair row's (p0, 1/Z)."""
    users = rows // TILE_ITEMS
    return {'pairwise_mlp': users * h1 * 2,
            'gated_pairwise_mlp': (users * h1 + rows * tpm.GATE_PAD) * 4,
            'gated_factored_mlp': (users * (h1 + tpm.GATE_PAD)
                                   + 2 * rows) * 4}[name]


def attention_smem_bytes(name: str, widths: Sequence[int], rows: int,
                         H: int, Mi: int) -> int:
    """K4 (``attention_mlp``), K5 (``attention_gram_mlp``) or K6
    (``attention_screen_mlp``): the chain's (widths from d on; the wgmma
    chain's at 128 and 64 rows), its ring grown by the part
    of the assembly's scratch (the rows / 16 user rows, each pair's
    coefficients (K6: token 0's only) and, for K5, its cross-Grams and,
    where its rows do not fit in buffer A, its statistics, all f32) that
    passes buffer B."""
    gram, screen = name == 'attention_gram_mlp', name == 'attention_screen_mlp'
    wgmma = rows >= 64
    d = widths[0]
    n_vo = Mi * H
    n_usc = 2 + 2 * H + H * H if gram else 0
    urow = -(-((3 + H) * (d + 4) + SUU_PAD + n_usc) // 4) * 4
    ncoef = (H * (Mi + 1) + (0 if screen else 2 * n_vo)) | 1
    nx = (max(n_vo * (1 + H) + (n_vo + Mi) * H, 2 + H + n_vo + Mi) | 1
          if gram else 0)
    ng = (n_vo + 1 + H + 2 * (Mi + 1)) | 1 if gram else 0
    if wgmma:
        cols_a, cols_b = wgmma_layout(widths, rows)[:2]
    else:
        cols_a = max(widths[0::2]) + 8
        cols_b = max(widths[1::2]) + 8 if len(widths) > 1 else 0
    stats = 0 if 2 * ng <= cols_a else rows * ng * 4
    scratch = (rows // TILE_ITEMS * urow + rows * (ncoef + nx)) * 4 + stats
    past_b = max(0, scratch - rows * cols_b * 2)
    if wgmma:
        return wgmma_chain_smem_bytes(widths, rows, past_b)
    return chain_smem_bytes(widths, rows, past_b)


def pair_chain_kind(name: str, widths: Sequence[int], rows: int,
                    int8: bool) -> str:
    """The chain a pair kernel's block runs, by hand: the bf16 modes of K1,
    K2 and K3 the wgmma chain, and their int8 modes (K1q, K2q, K3q) the s8
    wgmma chain, at 128 rows and at 64 where that block (buffers, at least
    two k slices' stages, the kernel's own scratch over the ring) fits, the
    mode's mma.sync chain otherwise."""
    if rows < 64:
        return 'mma.sync'
    count = wgmma_int8_chain_smem_bytes if int8 else wgmma_chain_smem_bytes
    need = count(widths, rows, pair_scratch_bytes(name, widths[0], rows))
    return 'wgmma' if rows == 128 or need <= WGMMA_SMEM else 'mma.sync'


def block_bytes(name: str, widths: Sequence[int], rows: int,
                mode: Tuple[int, ...]) -> int:
    """``tpm.block_bytes`` by hand: mode (int8,) for the pair kernels, (H,
    Mi) for the attention kernels."""
    widths = [int(w) for w in widths]
    if name.startswith('attention'):
        return attention_smem_bytes(name, widths, rows, *mode)
    scratch, int8 = pair_scratch_bytes(name, widths[0], rows), bool(mode[0])
    if pair_chain_kind(name, widths, rows, int8) == 'wgmma':
        count = wgmma_int8_chain_smem_bytes if int8 else wgmma_chain_smem_bytes
        return count(widths, rows, scratch)
    return chain_smem_bytes(widths, rows, scratch, int8)


@pytest.fixture
def hand_count(monkeypatch):
    """``tpm.block_bytes`` replaced by the hand count, so that the row
    choice runs on the CPU; the cached choices are cleared around it."""
    monkeypatch.setattr(tpm, 'block_bytes', block_bytes)
    tpm.block_rows.cache_clear()
    yield block_bytes
    tpm.block_rows.cache_clear()
