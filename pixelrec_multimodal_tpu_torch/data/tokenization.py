# pixelrec_multimodal_tpu_torch/data/tokenization.py
"""Offline-capable tokenization: a copy of the JAX package's
``data/tokenization.py``.

A locally cached Hugging Face tokenizer is used when ``transformers`` imports
and its files load with ``local_files_only=True`` (``transformers`` is
imported only inside ``_try_hf_tokenizer``, and only where the tokenizer's
files are on the disk); otherwise a deterministic hash tokenizer takes
its place, whose ids equal the JAX package's bit for bit. Either way the
arrays have one schema: fixed-length int32 ``input_ids`` and
``attention_mask`` padded to the model's max length.
"""
from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import MODEL_CONFIGS

# Fixed sequence lengths per language model key. The reference pads to the HF
# tokenizer's model_max_length (text_processor.py:49,72-78); these are those
# values. CLIP's contrastive text stream is fixed at 77 (dataset.py:296-299).
MODEL_MAX_LENGTHS = {
    'sentence-bert': 512,
    'mpnet': 512,
    'bert': 512,
    'roberta': 512,
}
CLIP_TEXT_MAX_LENGTH = 77

_WORD_RE = re.compile(r"[\w']+|[^\w\s]", re.UNICODE)


class HashTokenizer:
    """Deterministic, vocabulary-free tokenizer.

    Splits on words/punctuation and maps each token to a stable bucket id via
    blake2b. Produces BERT-style [CLS] ... [SEP] sequences. Used when real HF
    tokenizer files are unavailable; ids are stable across processes and
    platforms (unlike Python's salted ``hash``).
    """

    def __init__(self, model_max_length: int = 512, vocab_size: int = 30522,
                 cls_id: int = 101, sep_id: int = 102, pad_id: int = 0):
        self.model_max_length = model_max_length
        self.vocab_size = vocab_size
        self.cls_id = cls_id
        self.sep_id = sep_id
        self.pad_id = pad_id
        self._special = {cls_id, sep_id, pad_id}
        # Regular ids = vocab minus specials; specials may sit anywhere
        # (BERT: low ids; CLIP: bos/eos at the end of the vocab).
        self._num_regular = vocab_size - len(self._special)

    def _token_id(self, token: str) -> int:
        digest = hashlib.blake2b(token.encode('utf-8'), digest_size=8).digest()
        bucket = int.from_bytes(digest, 'little') % self._num_regular
        # Skip over special ids to land on a regular slot.
        for special in sorted(self._special):
            if bucket >= special:
                bucket += 1
        return bucket

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.model_max_length
        words = _WORD_RE.findall(text.lower())[: L - 2]
        ids = [self.cls_id] + [self._token_id(w) for w in words] + [self.sep_id]
        n = len(ids)
        input_ids = np.full((L,), self.pad_id, dtype=np.int32)
        input_ids[:n] = ids
        mask = np.zeros((L,), dtype=np.int32)
        mask[:n] = 1
        return input_ids, mask


class HFTokenizerAdapter:
    """Wraps a Hugging Face tokenizer behind the same ``encode`` interface."""

    def __init__(self, hf_tokenizer, model_max_length: Optional[int] = None):
        self._tok = hf_tokenizer
        self.model_max_length = model_max_length or min(
            int(getattr(hf_tokenizer, 'model_max_length', 512)), 100_000)

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        L = max_length or self.model_max_length
        out = self._tok(text, padding='max_length', truncation=True, max_length=L)
        return (np.asarray(out['input_ids'], dtype=np.int32),
                np.asarray(out['attention_mask'], dtype=np.int32))


def hf_files_present(hf_name: str) -> bool:
    """Whether ``hf_name`` is a local directory or has a snapshot in the
    Hugging Face cache: without one, a ``local_files_only`` load fails, so
    ``transformers`` is not imported at all (the tokenizers here, the
    encoder checkpoints in ``encoders/convert.py``)."""
    if Path(hf_name).is_dir():
        return True
    env = os.environ
    hub = (env.get('HF_HUB_CACHE') or env.get('TRANSFORMERS_CACHE')
           or str(Path(env.get('HF_HOME', Path.home() / '.cache'
                                / 'huggingface')) / 'hub'))
    return (Path(hub) / ('models--' + hf_name.replace('/', '--'))).is_dir()


def _try_hf_tokenizer(hf_name: str, max_length: Optional[int]):
    if not hf_files_present(hf_name):
        return None
    try:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(hf_name, local_files_only=True)
        return HFTokenizerAdapter(tok, max_length)
    except Exception:
        return None


def get_tokenizer(model_key: str, max_length: Optional[int] = None,
                  allow_fallback: bool = True):
    """Tokenizer for a language model key from MODEL_CONFIGS (or a raw HF name).

    Prefers a locally cached HF tokenizer for exact vocab parity; falls back to
    :class:`HashTokenizer` when offline.
    """
    if model_key in MODEL_CONFIGS['language']:
        hf_name = MODEL_CONFIGS['language'][model_key]['name']
        default_len = MODEL_MAX_LENGTHS.get(model_key, 512)
    else:
        hf_name = model_key
        default_len = 512
    L = max_length or default_len

    tok = _try_hf_tokenizer(hf_name, L)
    if tok is not None:
        return tok
    if not allow_fallback:
        raise RuntimeError(
            f"No local HF tokenizer for '{hf_name}' and fallback disabled.")
    return HashTokenizer(model_max_length=L)


def get_clip_tokenizer(max_length: int = CLIP_TEXT_MAX_LENGTH,
                       allow_fallback: bool = True):
    """Tokenizer for the CLIP contrastive text stream (fixed 77 tokens).

    Uses CLIP's BPE ids when available locally; hash fallback uses CLIP-style
    special ids (bos 49406 / eos 49407).
    """
    tok = _try_hf_tokenizer(MODEL_CONFIGS['vision']['clip']['name'], max_length)
    if tok is not None:
        tok.model_max_length = max_length
        return tok
    if not allow_fallback:
        raise RuntimeError("No local CLIP tokenizer and fallback disabled.")
    return HashTokenizer(model_max_length=max_length, vocab_size=49408,
                         cls_id=49406, sep_id=49407, pad_id=0)


def batch_encode(tokenizer, texts: List[str], max_length: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
    """Encode a list of texts into stacked fixed-shape id/mask arrays."""
    L = max_length or tokenizer.model_max_length
    ids = np.empty((len(texts), L), dtype=np.int32)
    mask = np.empty((len(texts), L), dtype=np.int32)
    for i, t in enumerate(texts):
        ids[i], mask[i] = tokenizer.encode(t, L)
    return {'input_ids': ids, 'attention_mask': mask}
