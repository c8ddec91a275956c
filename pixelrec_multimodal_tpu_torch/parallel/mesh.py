# pixelrec_multimodal_tpu_torch/parallel/mesh.py
"""Sharding helpers. Only the padding arithmetic is ported so far; the
multi-GPU layer (torch.distributed) is a later slice."""
from __future__ import annotations


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (and >= m)."""
    return max(m, ((n + m - 1) // m) * m)
