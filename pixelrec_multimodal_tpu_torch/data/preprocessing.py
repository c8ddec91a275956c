# pixelrec_multimodal_tpu_torch/data/preprocessing.py
"""Standalone host-side preprocessing utilities.

Counterpart of ``pixelrec_multimodal_tpu/data/preprocessing.py`` on numpy
and the standard library: word-level text augmentation, numerical scaling
(with the port's scalers in scikit-learn's arithmetic,
``processors/numerical_processor.py``), HTML stripping, unicode
normalization and the image checks of the image tier's offline mode.

The image checks take a decoder (``data/image_codecs.py``): PIL's verify
and load and ``img.size``, as in JAX, or nvJPEG on the card where PIL is
missing. The decoder is chosen before the per-file ``try``
(``image_decoder``), so a missing decoder raises instead of marking every
file corrupt.
"""
from __future__ import annotations

import random
import re
import unicodedata
from typing import Any, Optional, Tuple

import numpy as np

from .image_codecs import ImageCodecMissing, image_decoder
from .processors.numerical_processor import MinMaxScaler, StandardScaler

_HTML_TAG_RE = re.compile(r'<.*?>')


def augment_text(text: str, augmentation_type: str = 'random_delete',
                 delete_prob: float = 0.1, swap_prob: float = 0.1,
                 rng: Optional[random.Random] = None) -> str:
    """Word-level text augmentation: random deletion or adjacent swaps,
    drawing from ``rng`` (the ``random`` module when None)."""
    words = text.split()
    if not words or augmentation_type == 'none':
        return text
    r = rng if rng is not None else random

    if augmentation_type == 'random_delete':
        kept = [w for w in words if r.random() > delete_prob]
        return " ".join(kept)
    if augmentation_type == 'random_swap':
        out = list(words)
        for i in range(len(out) - 1):
            if r.random() < swap_prob:
                out[i], out[i + 1] = out[i + 1], out[i]
        return " ".join(out)
    return text


def normalize_features(features: np.ndarray, method: str = 'standardization',
                       scaler: Optional[Any] = None
                       ) -> Tuple[np.ndarray, Optional[Any]]:
    """Scale a numerical feature array, fitting a scaler when none is given.

    Returns (normalized, scaler-or-None): 'standardization' | 'min_max' |
    'log1p' | 'none'. A 1-D array is scaled as one column.
    """
    if not isinstance(features, np.ndarray) or features.size == 0 or method == 'none':
        return features, None

    x = features.reshape(-1, 1) if features.ndim == 1 else features

    if method in ('standardization', 'min_max'):
        fitted = scaler
        if fitted is None:
            fitted = StandardScaler() if method == 'standardization' else MinMaxScaler()
            return fitted.fit(x).transform(x), fitted
        return fitted.transform(x), fitted

    if method == 'log1p':
        if np.any(x < 0):
            print("Warning: log1p transform applied to data with negative values. "
                  "Results might be NaN.")
        return np.log1p(x), None

    print(f"Warning: Unknown or 'none' normalization method '{method}'. "
          "Returning original features.")
    return features, None


def remove_html_tags(text: str) -> str:
    """Strip HTML tags; anything but a string comes back unchanged."""
    if not isinstance(text, str):
        return text
    return _HTML_TAG_RE.sub('', text)


def normalize_unicode_text(text: str) -> str:
    """NFKC-normalize a string; anything but a string comes back
    unchanged."""
    if not isinstance(text, str):
        return text
    return unicodedata.normalize('NFKC', text)


def is_image_corrupted(image_path: str, decoder=None) -> bool:
    """True if the file fails ``decoder``'s full decode (PIL: verify, then
    load). The decoder defaults to ``image_decoder()``, chosen outside the
    ``try``; ``ImageCodecMissing`` (a format the decoder cannot read)
    passes through."""
    decoder = decoder or image_decoder()
    try:
        return decoder.corrupted(image_path)
    except ImageCodecMissing:
        raise
    except Exception:
        return True


def check_image_dimensions(image_path: str, min_width: int, min_height: int,
                           decoder=None) -> bool:
    """True if the image is at least min_width x min_height; False when
    its size cannot be read."""
    decoder = decoder or image_decoder()
    try:
        w, h = decoder.size(image_path)
        return w >= min_width and h >= min_height
    except ImageCodecMissing:
        raise
    except Exception:
        return False
