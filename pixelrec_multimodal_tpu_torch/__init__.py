# pixelrec_multimodal_tpu_torch/__init__.py
"""PyTorch and CUDA port of ``pixelrec_multimodal_tpu`` for NVIDIA Hopper.

The module layout mirrors the JAX package, so each module here has its
counterpart at the same path there. The port imports neither JAX nor the
JAX package. Entry points run on the CUDA device unless the caller passes
``device='cpu'``; on the CPU every kernel runs its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ['resolve_device']
