# pixelrec_multimodal_tpu_torch/ops/attention_cascade.py
"""Attention-fusion scoring of per-user candidate lists.

Counterpart of the exact rescoring in
``pixelrec_multimodal_tpu/ops/attention_cascade.py``
(``xla_attention_candidate_scores``). The cascade's screens, calibration
and funnel are not ported yet (ROADMAP item A9, the cascade slice).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .attention_scorer import attention_scores_plain


def attention_candidate_scores(head: dict, user_side: Sequence[torch.Tensor],
                               cand_side: Sequence[torch.Tensor]
                               ) -> torch.Tensor:
    """Exact attention scores of per-user candidate lists, float32:
    user_side (raw, q, k, vo, suu) [B, ...] and the per-item tables
    gathered per user, cand_side (raw, q, k, vo, sexp, dm) [B, C, ...] ->
    [B, C]. Each user pairs only with its own rows: the stream form's
    float32 math, ``attention_scores_plain``, which broadcasts [B, C, ...]
    item rows that way. The JAX package takes the full softmax over the
    item-item logits instead, which agrees up to float32 rounding."""
    return attention_scores_plain(head, user_side, cand_side[:6],
                                  torch.float32)
