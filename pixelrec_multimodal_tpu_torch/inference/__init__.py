# pixelrec_multimodal_tpu_torch/inference/__init__.py
"""Inference layer: the catalog scorer and the recommender API."""
from .recommender import Recommender  # noqa: F401
from .scorer import CatalogScorer  # noqa: F401
