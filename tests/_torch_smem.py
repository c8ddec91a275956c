"""The kernels' shared memory per block, counted by hand from their layout
(``ops/csrc/mlp_chain.cuh``, ``mlp_chain_int8.cuh``,
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
    (``attention_screen_mlp``): the chain's (widths from d on), its ring
    grown by the part of the assembly's scratch (the rows / 16 user rows,
    each pair's coefficients (K6: token 0's only) and, for K5, its
    cross-Grams, all f32) that passes buffer B."""
    gram, screen = name == 'attention_gram_mlp', name == 'attention_screen_mlp'
    d = widths[0]
    n_vo = Mi * H
    n_usc = 2 + 2 * H + H * H if gram else 0
    urow = -(-((3 + H) * (d + 4) + SUU_PAD + n_usc) // 4) * 4
    ncoef = (H * (Mi + 1) + (0 if screen else 2 * n_vo)) | 1
    nx = (max(n_vo * (1 + H) + (n_vo + Mi) * H, 2 + H + n_vo + Mi) | 1
          if gram else 0)
    scratch = (rows // TILE_ITEMS * urow + rows * (ncoef + nx)) * 4
    buf_b = rows * (max(widths[1::2]) + 8) * 2
    return chain_smem_bytes(widths, rows, max(0, scratch - buf_b))


def block_bytes(name: str, widths: Sequence[int], rows: int,
                mode: Tuple[int, ...]) -> int:
    """``tpm.block_bytes`` by hand: mode (int8,) for the pair kernels, (H,
    Mi) for the attention kernels."""
    widths = [int(w) for w in widths]
    if name.startswith('attention'):
        return attention_smem_bytes(name, widths, rows, *mode)
    return chain_smem_bytes(widths, rows,
                            pair_scratch_bytes(name, widths[0], rows),
                            bool(mode[0]))


@pytest.fixture
def hand_count(monkeypatch):
    """``tpm.block_bytes`` replaced by the hand count, so that the row
    choice runs on the CPU; the cached choices are cleared around it."""
    monkeypatch.setattr(tpm, 'block_bytes', block_bytes)
    tpm.block_rows.cache_clear()
    yield block_bytes
    tpm.block_rows.cache_clear()
