"""Data layer: the dataset, negative sampling, tokenization, the item
feature store, the prefetching loader, the splitting strategies, the
preprocessing helpers, the feature cache and CSV files read and written
on numpy columns."""
from .loader import PrefetchLoader, prefetch_to_device  # noqa: F401
