# pixelrec_multimodal_tpu_torch/data/processors/text_processor.py
"""Text processing: offline cleaning and online tokenization.

Counterpart of ``pixelrec_multimodal_tpu/data/processors/
text_processor.py`` with no pandas: tables are dicts of numpy columns or
DataFrames (``data/columns.py``), and a row is any mapping. The online
path tokenizes through the port's offline-capable front-end
(``data/tokenization.py``) into fixed-shape numpy int32 arrays.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import numpy as np

from ...config import MODEL_CONFIGS, OfflineTextCleaningConfig, TextAugmentationConfig
from ..columns import as_columns, is_missing
from .. import preprocessing
from ..tokenization import get_tokenizer

_WS_RE = re.compile(r'\s+')


def _as_text(col: np.ndarray) -> List[str]:
    """pandas 3's ``astype(str).fillna('')``: missing cells (which
    ``astype(str)`` keeps missing) become '', every other cell its
    ``str``."""
    col = np.asarray(col)
    missing = is_missing(col)
    return ['' if m else str(v) for v, m in zip(col, missing)]


class TextProcessor:
    """Dual-mode text processor (online tokenization / offline cleaning)."""

    def __init__(
        self,
        model_name: Optional[str] = None,
        augmentation_config: Optional[TextAugmentationConfig] = None,
        cleaning_config: Optional[OfflineTextCleaningConfig] = None,
        max_length: Optional[int] = None,
    ):
        self.cleaning_config = cleaning_config
        self.augmentation_config = augmentation_config
        self.model_name = model_name

        if model_name:
            if model_name not in MODEL_CONFIGS['language']:
                raise ValueError(
                    f"Configuration for language model '{model_name}' not found.")
            self.online_config = MODEL_CONFIGS['language'][model_name]
            self.tokenizer = get_tokenizer(model_name, max_length=max_length)
            self.max_length = self.tokenizer.model_max_length
        else:
            self.online_config = None
            self.tokenizer = None
            self.max_length = None

    # ------------------------------------------------------------ online mode
    def process_text(self, text: str) -> Dict[str, np.ndarray]:
        """Tokenize one string into padded ids + mask."""
        if not self.tokenizer:
            raise RuntimeError(
                "TextProcessor not initialized for online mode. Provide 'model_name'.")
        ids, mask = self.tokenizer.encode(text, self.max_length)
        return {'text_input_ids': ids, 'text_attention_mask': mask}

    def get_placeholder_tensors(self) -> Dict[str, np.ndarray]:
        if not self.max_length:
            raise RuntimeError(
                "TextProcessor not initialized for online mode. Provide 'model_name'.")
        return {
            'text_input_ids': np.zeros(self.max_length, dtype=np.int32),
            'text_attention_mask': np.zeros(self.max_length, dtype=np.int32),
        }

    # ----------------------------------------------------------- offline mode
    def clean_text_field(self, text: str) -> str:
        """Apply the configured cleaning steps to one string."""
        if not self.cleaning_config:
            raise RuntimeError(
                "TextProcessor not initialized for offline mode. "
                "Provide 'cleaning_config'.")
        if not isinstance(text, str):
            text = str(text) if text is not None else ''
        if self.cleaning_config.remove_html:
            text = preprocessing.remove_html_tags(text)
        if self.cleaning_config.normalize_unicode:
            text = preprocessing.normalize_unicode_text(text)
        if self.cleaning_config.to_lowercase:
            text = text.lower()
        return _WS_RE.sub(' ', text).strip()

    def clean_dataframe_text_columns(self, df, text_columns: List[str]
                                     ) -> Dict[str, np.ndarray]:
        """A copy of the table (dict of numpy columns) with the named text
        columns cleaned; a missing cell becomes '' before cleaning."""
        out = {k: v.copy() for k, v in as_columns(df).items()}
        for col in text_columns:
            if col in out:
                cleaned = np.empty(len(out[col]), dtype=object)
                cleaned[:] = [self.clean_text_field(t)
                              for t in _as_text(out[col])]
                out[col] = cleaned
        return out

    def get_combined_text(self, row: Mapping, text_columns: List[str],
                          separator: str = ' ') -> str:
        """Join the non-empty text fields of a row (any mapping)."""
        parts = []
        for col in text_columns:
            if col in row and not is_missing(np.array([row[col]],
                                                      dtype=object))[0]:
                t = str(row[col]).strip()
                if t:
                    parts.append(t)
        return separator.join(parts)
