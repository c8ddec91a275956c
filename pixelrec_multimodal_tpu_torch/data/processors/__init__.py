"""Data processors: numerical, text, image (online mode) and filtering,
exported as the JAX package exports them."""
from .data_filter import DataFilter  # noqa: F401
from .image_processor import (  # noqa: F401
    ImagePreprocessSpec,
    ImageProcessor,
    PREPROCESS_SPECS,
    normalize_chw,
    resize_and_center_crop,
)
from .numerical_processor import NumericalProcessor  # noqa: F401
from .text_processor import TextProcessor  # noqa: F401
