# pixelrec_multimodal_tpu_torch/probes/vpu_roofline.py
"""Probes P1 and P2: the card's float32 rates outside the tensor cores.

Counterpart of ``scripts/profile_vpu_roofline.py`` (its Pallas kernels
``fma_chain_kernel``, ``exp_chain_kernel`` and ``bcast_mul_acc_kernel``),
with the kernels in ``probes/csrc/vpu_roofline.cu``:

  * P1 (``vpu_chain``): over a [512, 128] f32 block, two interleaved chains
    of K / 2 steps per element, ``a = a*x + 1`` (FMA) or ``a += exp(x -
    a*1e-6)`` (EXP), in a grid of ``steps`` passes of the same block. The
    rate is the slope between K 64 and 192 (``measure_chain``): element-ops
    per second as the Pallas script counts them, one per chain step, which
    on the card is one FFMA instruction (FMA) or one expf, one MUFU.EX2
    (EXP).
  * P2 (``vpu_bcast``): [TB 8, TC 128] weights times [TC, dp 128] vectors
    accumulated into [TB, TC, dp], each step's weight ``acc[..., 0]*1e-6 +
    1``; the slope between K 16 and 48 (``measure_bcast``). The Pallas
    script counts a multiply and an add as two element-ops. The fused
    instance issues them as one FFMA, so its instructions are half its
    element-ops; the unfused instance (K4's pattern, FMUL then FADD) issues
    two, as many as its element-ops.

The plain versions repeat the probes' arithmetic on tensors, each product
and sum rounded on its own: P2's unfused instance rounds where its plain
version does (bit for bit); P2's fused instance and P1's FMA round once
where the plain version rounds twice, and P1's EXP calls the card's expf
where the plain version calls ``torch.exp``, so they agree to a relative
tolerance.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops import _build
from ..ops.pairwise_mlp import _check_tensor, _device_of
from . import cuda_ms, slope_ms

SHAPE = (512, 128)        # P1's block
K_LO, K_HI = 64, 192      # P1's chain lengths
STEPS = 8192              # passes over the block (the Pallas grid)
BC_TB, BC_TC, BC_DP = 8, 128, 128   # P2's weights [TB, TC], vectors [TC, dp]
BC_K_LO, BC_K_HI = 16, 48           # P2's chain lengths
BC_ENTRIES = (32, 16)               # P2's entries a thread; the first is used
KINDS = ('fma', 'exp')


# ----------------------------------------------------------- plain versions
def chain_plain(x: torch.Tensor, K: int, kind: str = 'fma') -> torch.Tensor:
    """P1's function on a block x (f32): ``a + b`` after K / 2 steps of each
    chain, each product and sum rounded on its own."""
    if kind not in KINDS:
        raise ValueError(f'kind must be one of {KINDS}, got {kind!r}')
    x = x.float()
    if kind == 'fma':
        a, b = x, x + 0.5
        for _ in range(K // 2):
            a = a * x + 1.0
            b = b * x + 2.0
    else:
        a, b = x, x * 0.5
        for _ in range(K // 2):
            a = a + torch.exp(x - a * 1e-6)
            b = b + torch.exp(x - b * 1e-6)
    return a + b


def bcast_plain(w: torch.Tensor, v: torch.Tensor, K: int) -> torch.Tensor:
    """P2's function: w [..., TB, TC], v [TC, dp] -> acc[..., 0] [..., TB,
    TC] after K steps, ``acc = acc + s * v`` with ``s = acc[..., 0] * 1e-6 +
    1``."""
    w, v = w.float(), v.float()
    acc = w[..., None] * v
    for _ in range(K - 1):
        s = acc[..., 0] * 1e-6 + 1.0
        acc = acc + s[..., None] * v
    return acc[..., 0]


# ---------------------------------------------------------------- wrappers
def _lib():
    lib = _build.load('vpu_roofline')
    if lib.vpu_chain_forward.argtypes is None:
        lib.vpu_chain_forward.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.vpu_bcast_forward.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str):
    if err:
        raise RuntimeError(f'{what} probe failed: '
                           f'{lib.kernel_error_string(err).decode()} ({err})')


def vpu_chain(x: torch.Tensor, K: int, kind: str = 'fma',
              steps: int = 1) -> torch.Tensor:
    """P1 on a block x (f32, its element count a multiple of 4) -> out of
    x's shape: CUDA tensors launch the probe (``steps`` passes of the block,
    each writing the same out); CPU tensors take ``chain_plain`` (one pass).
    ``vpu_chain.launches`` counts launches."""
    if kind not in KINDS or K < 2 or K % 2:
        raise ValueError(f'P1 takes kind in {KINDS} and an even K >= 2, got '
                         f'{kind!r}, {K}')
    device = _device_of('vpu_chain', x)
    if device is None:
        return chain_plain(x, K, kind)
    flat = x.reshape(-1)
    _check_tensor('x', flat, device, torch.float32, -1, ())
    if flat.numel() % 4:
        raise ValueError(f'P1 takes a block of a multiple of 4 elements, got '
                         f'{flat.numel()}')
    out = torch.empty_like(flat)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.vpu_chain_forward(
            flat.data_ptr(), out.data_ptr(), flat.numel(), K,
            int(kind == 'exp'), steps,
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, 'P1')
    vpu_chain.launches += 1
    return out.reshape(x.shape)


vpu_chain.launches = 0


def vpu_bcast(w: torch.Tensor, v: torch.Tensor, K: int, steps: int = 1,
              fused: bool = True, _entries: int = BC_ENTRIES[0]
              ) -> torch.Tensor:
    """P2: w [TB, TC], v [TC, 128] (f32) -> [TB, TC]: CUDA tensors launch
    the probe (``steps`` passes; ``fused``: one FFMA a multiply-add, else
    K4's FMUL then FADD), CPU tensors take ``bcast_plain``. ``_entries``
    (one of BC_ENTRIES) sets the entries a thread carries, for the sweep.
    ``vpu_bcast.launches`` counts launches."""
    if K < 1:
        raise ValueError(f'P2 takes K >= 1, got {K}')
    if not isinstance(fused, bool):
        raise ValueError(f'P2 takes fused True or False, got {fused!r}')
    if _entries not in BC_ENTRIES:
        raise ValueError(f'P2 takes entries a thread in {BC_ENTRIES}, got '
                         f'{_entries}')
    device = _device_of('vpu_bcast', w, v)
    if device is None:
        return bcast_plain(w, v, K)
    TB, TC = w.shape
    _check_tensor('w', w, device, torch.float32, TB, (TC,), align=4)
    _check_tensor('v', v, device, torch.float32, TC, (BC_DP,))
    out = torch.empty((TB, TC), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        err = lib.vpu_bcast_forward(
            w.data_ptr(), v.data_ptr(), out.data_ptr(), None, TB, TC, K, steps,
            int(fused), _entries,
            torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, err, 'P2')
    vpu_bcast.launches += 1
    return out


vpu_bcast.launches = 0


# ------------------------------------------------------------ measurement
def chain_inputs(device, seed: int = 0) -> torch.Tensor:
    """P1's block: uniform in [-0.9, 0.9) from ``seed`` (the chains then
    neither overflow nor vanish)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(SHAPE, generator=gen) * 1.8 - 0.9).to(device)


def bcast_inputs(device, seed: int = 0):
    """P2's (w [TB, TC], v [TC, dp]), standard normal from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(BC_TB, BC_TC, generator=gen).to(device),
            torch.randn(BC_TC, BC_DP, generator=gen).to(device))


def measure_chain(kind: str, x: Optional[torch.Tensor] = None,
                  steps: int = STEPS, reps: int = 10) -> dict:
    """P1's rate on the card: the slope of the mean launch time between
    K_LO and K_HI over ``steps`` passes of the block (``slope_ms``).
    Element-ops (chain steps) per second, which are FFMA instructions (FMA)
    or MUFU.EX2 instructions (EXP) per second."""
    x = chain_inputs('cuda') if x is None else x
    n = x.numel() * steps
    t_lo, t_hi = slope_ms(lambda: vpu_chain(x, K_LO, kind, steps),
                          lambda: vpu_chain(x, K_HI, kind, steps), reps)
    rate = n * (K_HI - K_LO) / ((t_hi - t_lo) * 1e-3)
    return {'probe': 'P1', 'kind': kind, 'block': list(x.shape),
            'steps': steps, 'k': [K_LO, K_HI], 'ms': [t_lo, t_hi],
            'element_ops_per_s': rate,
            ('ffma_per_s' if kind == 'fma' else 'exp_per_s'): rate,
            'instructions': ('FFMA' if kind == 'fma'
                             else 'MUFU.EX2 (one per expf)')}


def measure_bcast(w: Optional[torch.Tensor] = None,
                  v: Optional[torch.Tensor] = None, steps: int = STEPS,
                  reps: int = 10, fused: bool = True,
                  _entries: int = BC_ENTRIES[0]) -> dict:
    """P2's rate on the card: the slope of the mean launch time between
    BC_K_LO and BC_K_HI over ``steps`` passes (``slope_ms``).
    ``element_ops_per_s`` counts as the Pallas script does, a multiply and an
    add each per entry and step; ``instructions_per_s`` counts what the card issues for them: one
    FFMA a multiply-add when fused (half the element-ops), an FMUL and an
    FADD when not (as many as the element-ops)."""
    if w is None:
        w, v = bcast_inputs('cuda')
    TB, TC = w.shape

    def run(K):
        return vpu_bcast(w, v, K, steps, fused, _entries)

    t_lo, t_hi = slope_ms(lambda: run(BC_K_LO), lambda: run(BC_K_HI), reps)
    ops = steps * TB * TC * BC_DP * 2
    rate = ops * (BC_K_HI - BC_K_LO) / ((t_hi - t_lo) * 1e-3)
    return {'probe': 'P2', 'fused': fused, 'entries_per_thread': _entries,
            'shape': [TB, TC, BC_DP], 'steps': steps,
            'k': [BC_K_LO, BC_K_HI], 'ms': [t_lo, t_hi],
            'element_ops_per_s': rate,
            'instructions_per_s': rate / 2 if fused else rate,
            'instructions': 'FFMA' if fused else 'FMUL + FADD'}
