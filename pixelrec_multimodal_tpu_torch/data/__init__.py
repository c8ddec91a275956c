"""Data layer: the dataset, negative sampling, tokenization, the item
feature store and the prefetching loader."""
from .loader import PrefetchLoader, prefetch_to_device  # noqa: F401
