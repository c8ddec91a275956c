"""Data processors: numerical, text and filtering, exported as the JAX
package exports them. The image processor comes with the image tier
(ROADMAP item A12)."""
from .data_filter import DataFilter  # noqa: F401
from .numerical_processor import NumericalProcessor  # noqa: F401
from .text_processor import TextProcessor  # noqa: F401
