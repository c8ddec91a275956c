# pixelrec_multimodal_tpu_torch/parallel/__init__.py
from .mesh import pad_to_multiple

__all__ = ['pad_to_multiple']
