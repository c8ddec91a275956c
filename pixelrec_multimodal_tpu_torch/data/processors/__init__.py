"""Data processors. The numerical processor is ported; the image, text
and filter processors come with later slices (ROADMAP items A1, A12)."""
from .numerical_processor import NumericalProcessor  # noqa: F401
