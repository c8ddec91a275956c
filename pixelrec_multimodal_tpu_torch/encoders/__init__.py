"""The frozen encoder towers in PyTorch: the eight backbones of the JAX
package's encoder zoo and CLIP's text tower, and the precompute of the
item embedding tables (``precompute.py``)."""
from .registry import (  # noqa: F401
    build_clip_text_encoder,
    build_language_encoder,
    build_vision_encoder,
    pooled_dim,
)
