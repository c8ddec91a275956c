# pixelrec_multimodal_tpu_torch/probes/__init__.py
"""Hopper counterparts of the JAX package's Pallas measurement probes.

``vpu_roofline`` (P1: FMA and exp chains; P2: the broadcast
multiply-accumulate of the attention assembly) and ``int8_mxu`` (P3: the
pair kernels' bf16 and int8 product loop) measure the card's rates; their
CUDA sources are in ``probes/csrc`` and build through ``ops/_build.py``.
Each probe has a plain PyTorch version of the same function, a wrapper that
launches its kernel for CUDA tensors (the plain version for CPU tensors,
anything else raises) with a ``.launches`` count, and a ``measure_*``
function that times it on the card. ``scripts/torch_profile_int8_mxu.py``
and ``scripts/torch_profile_vpu_roofline.py`` print the rates;
``chip_smoke.py`` divides every kernel's bound by them.
"""
from typing import Callable, Tuple

import torch


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls after one
    warm-up, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def slope_ms(lo: Callable[[], object], hi: Callable[[], object], reps: int,
             rounds: int = 5) -> Tuple[float, float]:
    """Mean milliseconds of ``lo`` and of ``hi``, each the least of
    ``rounds`` interleaved ``cuda_ms`` readings. A rate taken from the slope
    between the two divides by their difference, so a clock that moves
    between two single readings (the card ramping up from idle, or easing
    under load) can push it past what the card can issue; interleaving
    exposes both to the same drift, and the least reading of each is the
    one taken at the card's highest clock."""
    t_lo, t_hi = [], []
    for _ in range(rounds):
        t_lo.append(cuda_ms(lo, reps))
        t_hi.append(cuda_ms(hi, reps))
    return min(t_lo), min(t_hi)
