# pixelrec_multimodal_tpu_torch/probes/int8_mxu.py
"""Probe P3: the rate of the pair kernels' product loop, bf16 and int8.

Counterpart of ``scripts/profile_int8_mxu.py`` (its Pallas kernels
``bf16_chain_kernel`` and ``int8_chain_kernel``), with the kernel in
``probes/csrc/int8_mxu.cu``, built on the pair kernels' own product loop:
the wgmma chain of ``ops/csrc/mlp_chain_wgmma.cuh`` in bf16 and its s8 form
(``mlp_chain_wgmma_int8.cuh``) in int8, the weights packed as
``ops/pairwise_mlp.py:wgmma_weights`` packs a chain (``pack_weights``).
Per row of x [8,192, 512], K = 8 steps of ``z = relu(x @ w1) @ w2``
([512, 256], [256, 128]) summed into acc [8,192, 128] f32, each z folded
back into x's first 128 columns, in three modes:

  * ``bf16``: bf16 operands, f32 sums, h and the fold rounded to bf16;
  * ``int8_raw``: int8 operands, int32 sums, h = int8(h32 >> 8) and the fold
    int8(z32 >> 6), both wrapping; acc += z32 / 4096;
  * ``int8_rescale``: h = int8(clip(relu(h32 / 16384) * 4, -127, 127)),
    truncated toward zero; otherwise as raw.

The Pallas grid runs 64 instances over the same rows; the kernel's grid does
too (``INSTANCES``). A block holds 128 rows where x, h, acc and the ring fit
(int8), else 64 (bf16): ``block_rows``. The rate (``measure``) is the
tensor-core operations 2 * R * (512 * 256 + 256 * 128) * K * instances over
the launch's time. Beside it, as yardsticks the port never calls:
``torch.matmul`` of the same bf16 chain, one square bf16 product of 8,192^3
and ``torch._int_mm`` of an 8,192^3 int8 product.

The plain version (``chain_plain``) is the same function on tensors. Its
int8 products are exact (float64: every sum is an integer below 2^53) and
every float32 step rounds once as the kernel's does, so the int8 modes agree
bit for bit; the bf16 mode's float32 sums run in another order than the
tensor cores', which moves a bf16 rounding now and then.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..ops import _build
from ..ops.pairwise_mlp import _check_tensor, _device_of, wgmma_weights
from . import cuda_ms

H1, H2, H3 = 512, 256, 128
ROWS = 8192          # rows of x (the Pallas tile's 64 users x 128 items)
K = 8                # chain steps per instance
INSTANCES = 64       # passes over all the rows (the Pallas grid)
MODES = ('bf16', 'int8_raw', 'int8_rescale')
SQUARE = 8192        # the library yardsticks' square product
# Tensor-core operations of one warpgroup-wide wgmma: m64n128k16 bf16 and
# m64n128k32 s8 (two per multiply-add).
MMA_OPS = {'bf16': 2 * 64 * 128 * 16, 'int8': 2 * 64 * 128 * 32}


def flops(rows: int = ROWS, k: int = K, instances: int = INSTANCES) -> int:
    """Tensor-core operations of one launch."""
    return 2 * rows * (H1 * H2 + H2 * H3) * k * instances


def chain_plain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                mode: str, k: int = K) -> torch.Tensor:
    """P3's function: x [R, 512], w1 [512, 256], w2 [256, 128] (bf16 in the
    bf16 mode, int8 otherwise) -> acc [R, 128] float32."""
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
    acc = torch.zeros((x.shape[0], H3), dtype=torch.float32, device=x.device)
    if mode == 'bf16':
        bf16 = torch.bfloat16
        w1f, w2f = w1.to(bf16).float(), w2.to(bf16).float()
        x = x.to(bf16)
        for _ in range(k):
            h = torch.relu(x.float() @ w1f).to(bf16)
            z = h.float() @ w2f
            acc = acc + z
            x = torch.cat([z.to(bf16), x[:, H3:]], dim=1)
        return acc
    w1d, w2d = w1.double(), w2.double()
    x = x.to(torch.int8)
    for _ in range(k):
        h32 = (x.double() @ w1d).to(torch.int64)
        if mode == 'int8_raw':
            h = (h32 >> 8).to(torch.int8)
        else:
            hf = torch.relu(h32.float() * (1.0 / 16384.0))
            h = torch.clamp(hf * 4.0, -127.0, 127.0).to(torch.int8)
        z32 = (h.double() @ w2d).to(torch.int64)
        acc = acc + z32.float() * (1.0 / 4096.0)
        x = torch.cat([(z32 >> 6).to(torch.int8), x[:, H3:]], dim=1)
    return acc


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, mode: str
                 ) -> torch.Tensor:
    """w1 [K, N1] and w2 [N1, N2] (bf16 in the bf16 mode, int8 otherwise)
    packed for the kernel's wgmma chain, as ``wgmma_weights`` packs the
    chain [K, N1, N2] of that mode (an int8 chain keeps each layer's
    weights transposed, [N, K])."""
    int8 = mode != 'bf16'
    layers = (w.t() if int8 else w for w in (w1, w2))
    return wgmma_weights({
        'int8': int8, 'widths': np.asarray(
            (w1.shape[0], w1.shape[1], w2.shape[1]), np.int32),
        'w': torch.cat([w.contiguous().reshape(-1) for w in layers])})


def _lib():
    lib = _build.load('int8_mxu')
    if lib.int8_mxu_forward.argtypes is None:
        lib.int8_mxu_forward.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.int8_mxu_block_rows.argtypes = [ctypes.c_int]
        lib.int8_mxu_block_bytes.argtypes = [ctypes.c_int] * 2
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def block_rows(mode: str) -> int:
    """The rows of the probe's block in ``mode``, as its library chooses
    them by fit: 128 where x, h, acc and the ring fit, else 64."""
    return _lib().int8_mxu_block_rows(MODES.index(mode))


def block_bytes(mode: str, rows: int) -> int:
    """The shared memory of the probe's block of ``rows`` rows in ``mode``,
    as its launch counts it; negative where that block does not fit."""
    return _lib().int8_mxu_block_bytes(MODES.index(mode), rows)


def _launch(x: torch.Tensor, packed: torch.Tensor, mode: str, k: int,
            instances: int, rows: Optional[int]) -> torch.Tensor:
    """One launch of the probe on x's device, in blocks of ``rows`` rows
    (``block_rows`` by default)."""
    lib = _lib()
    rows = block_rows(mode) if rows is None else rows
    out = torch.empty((x.shape[0], H3), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.int8_mxu_forward(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), x.shape[0], k,
            MODES.index(mode), instances, rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f'P3 probe failed: '
                           f'{lib.kernel_error_string(err).decode()} ({err})')
    mxu_chain.launches += 1
    return out


def mxu_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              mode: str, k: int = K, instances: int = 1,
              _block_rows: Optional[int] = None) -> torch.Tensor:
    """P3: CUDA tensors launch the probe (``instances`` passes over all the
    rows, each writing the same acc; ``_block_rows`` forces a block of 64
    rows where 128 is chosen); CPU tensors take ``chain_plain``. Anything
    else raises. ``mxu_chain.launches`` counts launches."""
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')
    device = _device_of('mxu_chain', x, w1, w2)
    if device is None:
        return chain_plain(x, w1, w2, mode, k)
    dtype = torch.bfloat16 if mode == 'bf16' else torch.int8
    _check_tensor('x', x, device, dtype, -1, (H1,))
    _check_tensor('w1', w1, device, dtype, H1, (H2,))
    _check_tensor('w2', w2, device, dtype, H2, (H3,))
    return _launch(x, pack_weights(w1, w2, mode), mode, k, instances,
                   _block_rows)


mxu_chain.launches = 0


def inputs(mode: str, device, rows: int = ROWS, seed: int = 0):
    """(x, w1, w2) as the Pallas script draws them from ``seed``: bf16
    standard normals (the weights times 0.05), or int8 in [-127, 127)."""
    rng = np.random.default_rng(seed)
    if mode == 'bf16':
        arrays = (rng.standard_normal((rows, H1)),
                  rng.standard_normal((H1, H2)) * 0.05,
                  rng.standard_normal((H2, H3)) * 0.05)
        return tuple(torch.from_numpy(a.astype(np.float32))
                     .to(torch.bfloat16).to(device) for a in arrays)
    arrays = (rng.integers(-127, 127, (rows, H1)),
              rng.integers(-127, 127, (H1, H2)),
              rng.integers(-127, 127, (H2, H3)))
    return tuple(torch.from_numpy(a.astype(np.int8)).to(device)
                 for a in arrays)


def library_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                  mode: str, k: int = K) -> torch.Tensor:
    """The same chain through PyTorch's own products (a yardstick, never
    called by the port): ``torch.matmul`` in bf16 (f32 outputs rounded as
    the probe rounds them), ``torch._int_mm`` in int8 (the weights
    column-major, the layout cuBLASLt's int8 products take fastest)."""
    if mode != 'bf16':
        w1, w2 = (w.t().contiguous().t() for w in (w1, w2))
    acc = torch.zeros((x.shape[0], H3), dtype=torch.float32, device=x.device)
    for _ in range(k):
        if mode == 'bf16':
            h = torch.relu(torch.matmul(x, w1))
            z = torch.matmul(h, w2)
            acc += z.float()
            x = torch.cat([z, x[:, H3:]], dim=1)
        else:
            h32 = torch._int_mm(x, w1)
            if mode == 'int8_raw':
                h = (h32 >> 8).to(torch.int8)
            else:
                h = torch.clamp(torch.relu(h32.float() * (1 / 16384)) * 4,
                                -127, 127).to(torch.int8)
            z32 = torch._int_mm(h, w2)
            acc += z32.float() * (1 / 4096)
            x = torch.cat([(z32 >> 6).to(torch.int8), x[:, H3:]], dim=1)
    return acc


def measure(mode: str, rows: int = ROWS, instances: int = INSTANCES,
            reps: int = 5, tensors: Optional[tuple] = None,
            block: Optional[int] = None) -> dict:
    """P3's rate in ``mode`` on the card: the mean time of one launch of
    ``instances`` passes over ``rows`` rows (the weights packed once,
    before), in blocks of ``block`` rows (``block_rows`` by default), and
    its tensor-core operations per second (TFLOP/s in bf16, TOP/s in int8)
    and ``wgmma`` instructions per second (``mma_per_s``), beside the time
    of ``library_chain`` for the same work."""
    x, w1, w2 = inputs(mode, 'cuda', rows) if tensors is None else tensors
    block = block_rows(mode) if block is None else block
    packed = pack_weights(w1, w2, mode)
    ms = cuda_ms(lambda: _launch(x, packed, mode, K, instances, block), reps)
    lib_ms = cuda_ms(lambda: [library_chain(x, w1, w2, mode)
                              for _ in range(instances)], 1)
    n = flops(rows, K, instances)
    return {'probe': 'P3', 'mode': mode, 'rows': rows, 'k': K,
            'instances': instances, 'block_rows': block,
            'block_bytes': block_bytes(mode, block), 'ms': ms,
            'ops_per_s': n / (ms * 1e-3),
            'mma_per_s': n / (ms * 1e-3) / MMA_OPS[
                'bf16' if mode == 'bf16' else 'int8'],
            'library_chain_ms': lib_ms,
            'library_chain_ops_per_s': n / (lib_ms * 1e-3)}


def measure_square(reps: int = 10) -> dict:
    """The library's peaks: one 8,192^3 ``torch.matmul`` in bf16 and one
    ``torch._int_mm`` in int8, operations per second. ``_int_mm`` is timed
    with its second operand column-major, the layout cuBLASLt's int8
    products take fastest, and row-major beside it."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    a = torch.randn(SQUARE, SQUARE, device='cuda', generator=gen,
                    dtype=torch.bfloat16)
    q = torch.randint(-127, 127, (SQUARE, SQUARE), device='cuda',
                      generator=gen, dtype=torch.int8)
    n = 2 * SQUARE ** 3
    mm_ms = cuda_ms(lambda: torch.matmul(a, a), reps)
    int_ms = cuda_ms(lambda: torch._int_mm(q, q.t()), reps)
    return {'square': SQUARE, 'matmul_bf16_ms': mm_ms,
            'matmul_bf16_ops_per_s': n / (mm_ms * 1e-3),
            'int_mm_ms': int_ms, 'int_mm_ops_per_s': n / (int_ms * 1e-3),
            'int_mm_row_major_b_ms': cuda_ms(lambda: torch._int_mm(q, q),
                                             reps)}
