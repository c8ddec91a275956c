# pixelrec_multimodal_tpu_torch/inference/scorer.py
"""Full-catalog pair scoring on the card.

Counterpart of ``CatalogScorer`` in
``pixelrec_multimodal_tpu/inference/scorer.py``, concatenate, gated and
attention fusion:

  * the item tower (item and tag embeddings plus modality projections) is
    computed once for the padded catalog, streamed host -> device in
    chunks, and kept on the device as ``[n_pad, M, D]``;
  * the BN-folded, factorized head turns it into per-item tables once per
    catalog: concat ``item_first [n_pad, h1]``; gated ``item_first
    [n_pad, Mi*h1]`` and ``item_gates [n_pad, GATE_PAD]``, plus, for the
    factored variant, ``T [n_pad, Mi, h1]`` bf16 and ``igb [n_pad,
    GATE_PAD]`` (``ops/pairwise_mlp.py:factor_gated_tables``); attention
    the d-wide per-item attention tables, plus the scalar table for the
    gram variant (``ops/attention_scorer.py``);
  * ``top_k`` scans the catalog in item chunks: one fused kernel launch
    scores a user block against a chunk (``ops/pairwise_mlp.py``: K1 for
    concat, K2 for exact gated, K3 for factored gated;
    ``ops/attention_scorer.py``: K4 for stream attention, K5 for gram
    attention), and a running top-k merges each chunk (``ops/topk.py``),
    so the [users, items] matrix is never held whole.

Blocks and chunks may be ragged: the kernel masks its own edges, so user
blocks are not padded to size classes (the JAX package pads them to keep
one compiled shape per class; PyTorch compiles nothing per shape).
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.attention_cascade import attention_candidate_scores
from ..ops.attention_scorer import (
    attention_scores,
    attention_scores_gram,
    build_attention_head,
    check_kernel_fits,
    compute_item_side_attention,
    compute_user_side_attention,
)
from ..ops.pairwise_mlp import (
    GATE_PAD,
    build_factorized_head,
    candidate_scores,
    candidate_scores_gated,
    compute_item_first,
    compute_item_side_gated,
    compute_user_first,
    compute_user_side_gated,
    factor_gated_tables,
    factor_gated_user,
    pairwise_scores,
    pairwise_scores_gated,
    pairwise_scores_gated_factored,
)
from ..ops.topk import NEG_INF, init_topk, merge_topk
from ..parallel.mesh import pad_to_multiple

# (item_chunk, user_chunk) by device type. CUDA: the fastest pair of
# scripts/torch_chunk_sweep.py on the H100 (PERF.md, "Layers"); the sweep
# is flat within 2% because the kernel takes nearly all the time. CPU:
# small blocks that keep the plain float32 path's [users x chunk x h1]
# activations bounded.
DEFAULT_CHUNKS = {'cuda': (8192, 8192), 'cpu': (8192, 64)}

# The gated variant ``gated_variant=None`` resolves to. On the H100 the
# exact kernel (K2) serves bench.py's geometry faster than the factored one
# (K3), 246.6M against 241.2M pairs/s (chip_smoke.py, PERF.md); on the CPU
# the JAX package also runs 'exact' off the TPU.
DEFAULT_GATED_VARIANT = 'exact'

# The attention variant ``attention_variant=None`` resolves to: the kernel
# that serves bench.py's geometry faster on the H100 (chip_smoke.py,
# PERF.md). The JAX package's TPU default, 'gram', was measured on a TPU.
DEFAULT_ATTENTION_VARIANT = 'stream'

# Pairs of gathered candidate rows scored at once by the attention
# candidate path (~14 KB of tables and ~2 KB of temporaries per pair).
_ATTENTION_CANDIDATE_PAIRS = 1 << 16

_CASCADE_NOT_PORTED = (
    'is not ported yet: the attention cascade (screen kernel K6, the '
    'additive screen, calibration and the funnel) is the cascade slice, '
    'ROADMAP item A9 / B7')


@contextlib.contextmanager
def _exact_f32():
    """No autograd, and the float32 products outside the kernel (item
    tower, compute_item_first, user rows, candidate scoring) in full float32
    as in the JAX reference: ``torch.backends.cuda.matmul.allow_tf32`` is
    False inside and restored on the way out, so the process's own setting
    is left as it was."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class CatalogScorer:
    """Scores users against the full catalog with a fixed trained model.

    ``fast_path=False`` scores through the model's own layers
    (``score_from_towers``) instead of the factorized head and kernel.
    ``precision`` other than ``'bf16'`` and ``mesh`` are not ported yet.
    The model is moved to ``device`` and put in eval mode. Every call runs
    its float32 products with TF32 off (``_exact_f32``).

    ``gated_variant`` picks the kernel of a gated model's fast path:
    ``'exact'`` (K2) or ``'factored'`` (K3, approximate: bf16 tables and
    coefficients); ``None`` is ``DEFAULT_GATED_VARIANT``. It is fixed here:
    ``'factored'`` raises where its tables would pass ``_FACTORED_BYTES``,
    and no call switches variants. ``self.gated_variant`` holds the
    variant every call runs (None without a gated fast path).

    ``attention_variant`` picks the kernel of an attention model's fast
    path: ``'stream'`` (K4) or ``'gram'`` (K5, which needs the scalar
    tables too); ``None`` is ``DEFAULT_ATTENTION_VARIANT``, resolved here
    and held in ``self.attention_variant`` (None without an attention fast
    path). On the card the variant's kernel must take the model: K5 keeps
    per-pair cross-Grams in shared memory and refuses 8 heads, or d 128
    and wider at the flagship chain (``check_kernel_fits``), so ``'gram'``
    raises here for such a model, before any table is built. The generic
    path of an attention model (``fast_path=False``) scores at most 64
    users per block, as the JAX package does: the model's attention holds
    [users x items x H x T x T] intermediates.
    """

    # Rows of raw encoder features moved host -> device per item-tower step.
    _TOWER_BUILD_CHUNK = 65536
    # Device memory the factored gated tables may take (T and igb).
    _FACTORED_BYTES = 16 << 30

    def __init__(self, model, feature_store,
                 item_chunk: Optional[int] = None,
                 user_chunk: Optional[int] = None,
                 mesh=None, fast_path: bool = True,
                 precision: str = 'bf16',
                 gated_variant: Optional[str] = None,
                 attention_variant: Optional[str] = None,
                 device: Union[str, torch.device] = 'cuda'):
        if mesh is not None:
            raise NotImplementedError(
                'catalog sharding over several devices is not ported yet '
                '(ROADMAP item A11)')
        if precision != 'bf16':
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet: int8 scoring is "
                "ROADMAP item A10 (kernels K1q, K2q, K3q)")
        if gated_variant not in (None, 'exact', 'factored'):
            raise ValueError(f"gated_variant must be 'exact', 'factored' or "
                             f"None, got {gated_variant!r}")
        if attention_variant not in (None, 'stream', 'gram'):
            raise ValueError(f"attention_variant must be 'stream', 'gram' or "
                             f"None, got {attention_variant!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.store = feature_store
        self.n_items = feature_store.n_items
        self.precision = precision
        default_items, default_users = DEFAULT_CHUNKS[self.device.type]
        item_chunk = item_chunk or default_items
        self.item_chunk = min(item_chunk, pad_to_multiple(self.n_items, 128))
        self.n_pad = pad_to_multiple(self.n_items, self.item_chunk)
        self.user_chunk = user_chunk or default_users
        if model.fusion_type == 'attention' and not fast_path:
            self.user_chunk = min(self.user_chunk, 64)
        self._pad_mask = np.zeros(self.n_pad, dtype=bool)
        self._pad_mask[self.n_items:] = True  # True = invalid (padding)

        with _exact_f32():
            self._item_feats = self._build_item_tower()  # [n_pad, M, D]
            # Fused factorized head. ``_item_fast`` is the tuple of per-item
            # tables (concat: (item_first,); gated: (item_first,
            # item_gates)); ``_scan_tables`` the tuple the kernel scans
            # (the factored gated variant: (T, igb); else ``_item_fast``).
            self._head = None
            self._item_fast = self._scan_tables = None
            self.gated_variant = self.attention_variant = None
            if fast_path and self.model.fusion_type == 'attention':
                head = self._head = build_attention_head(self.model)
                self.attention_variant = (attention_variant
                                          or DEFAULT_ATTENTION_VARIANT)
                if self.device.type == 'cuda':
                    check_kernel_fits(head, self.attention_variant == 'gram')
                self._item_fast = self._scan_tables = self._build_item_fast(
                    partial(compute_item_side_attention, head,
                            with_gram=self.attention_variant == 'gram'))
            elif fast_path:
                head = self._head = build_factorized_head(self.model)
                if head['fusion'] == 'concatenate':
                    self._item_fast = self._build_item_fast(
                        lambda feats: (compute_item_first(
                            head, feats.reshape(feats.shape[0], -1)),))
                else:
                    self.gated_variant = (gated_variant
                                          or DEFAULT_GATED_VARIANT)
                    self._check_factored_budget()
                    self._item_fast = self._build_item_fast(
                        partial(compute_item_side_gated, head))
                self._scan_tables = self._item_fast
                if self.gated_variant == 'factored':
                    self._scan_tables = self._build_item_fast(
                        lambda feats: factor_gated_tables(
                            head, *compute_item_side_gated(head, feats)))

    def _check_factored_budget(self):
        """Raise if the factored variant's tables (T bf16, igb f32) would
        pass ``_FACTORED_BYTES``."""
        head = self._head
        nbytes = self.n_pad * (head['n_item_mods'] * head['h1'] * 2
                               + GATE_PAD * 4)
        if self.gated_variant == 'factored' \
                and nbytes > self._FACTORED_BYTES:
            raise ValueError(
                f'the factored gated tables would take {nbytes} bytes, past '
                f'the budget of {self._FACTORED_BYTES}; use '
                f"gated_variant='exact'")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- item tower
    def _build_item_tower(self) -> torch.Tensor:
        """Item tower over the padded catalog. Rows past n_items are built
        from item 0, tag 0 and zero features, as in the JAX scorer; a
        missing feature table gives zero features."""
        t = self.store.tables
        n, n_pad = self.n_items, self.n_pad
        chunk = min(self._TOWER_BUILD_CHUNK, n_pad)
        names = [('vision_features', 'vision_emb',
                  self.model.vision_feature_dim),
                 ('language_features', 'language_emb',
                  self.model.language_feature_dim),
                 ('numerical_features', 'numerical',
                  self.model.num_numerical_features)]
        parts = []
        for start in range(0, n_pad, chunk):
            rows = min(chunk, n_pad - start)
            live = max(0, min(start + rows, n) - start)

            def padded(arr, dtype):
                out = np.zeros((rows,) + arr.shape[1:], dtype)
                out[:live] = arr[start:start + live]
                return self._tensor(out)

            idx = np.zeros(rows, np.int64)
            idx[:live] = np.arange(start, start + live)
            kw = {}
            for kwname, table, dim in names:
                if not dim:
                    continue
                kw[kwname] = (padded(t[table], np.float32) if table in t
                              else torch.zeros((rows, dim),
                                               device=self.device))
            parts.append(self.model.item_tower(
                self._tensor(idx), padded(t['tag_idx'], np.int64), **kw))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def _build_item_fast(self, compute: Callable
                         ) -> Tuple[torch.Tensor, ...]:
        """Apply a per-item table compute over the padded catalog in
        chunks written into preallocated tables, so the transient memory is
        one chunk's temporaries."""
        n_pad = self.n_pad
        chunk = min(self._TOWER_BUILD_CHUNK, n_pad)
        first = compute(self._item_feats[:chunk])
        outs = tuple(torch.empty((n_pad,) + f.shape[1:], dtype=f.dtype,
                                 device=self.device) for f in first)
        for o, f in zip(outs, first):
            o[:chunk] = f
        for start in range(chunk, n_pad, chunk):
            for o, p in zip(outs, compute(
                    self._item_feats[start:start + chunk])):
                o[start:start + chunk] = p
        return outs

    # ---------------------------------------------------- generic (no head)
    def _score_block(self, item_block: torch.Tensor,
                     user_idx: torch.Tensor) -> torch.Tensor:
        """[C, M, D] items x [B] users -> [B, C] through the model."""
        B, C = user_idx.shape[0], item_block.shape[0]
        user_emb = self.model.user_tower(user_idx)
        ue = user_emb[:, None, :].expand(B, C, user_emb.shape[-1])
        it = item_block[None].expand((B,) + tuple(item_block.shape))
        return self.model.score_from_towers(
            ue.reshape(B * C, -1),
            it.reshape((B * C,) + tuple(item_block.shape[1:]))).reshape(B, C)

    def _generic_topk_body(self, user_idx: torch.Tensor,
                           invalid_mask: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming exact top-k through the model; invalid_mask [B, n_pad]
        (True = seen or padding) is excluded."""
        B, C = user_idx.shape[0], self.item_chunk
        carry = init_topk(B, k, self.device)
        for off in range(0, self.n_pad, C):
            s = self._score_block(self._item_feats[off:off + C], user_idx)
            s = s.masked_fill(invalid_mask[:, off:off + C], NEG_INF)
            idx = torch.arange(off, off + C, dtype=torch.int32,
                               device=self.device).expand(B, C)
            carry = merge_topk(*carry, s, idx, k)
        return carry

    # ------------------------------------------------------ fast (factorized)
    def _fast_user_side(self, user_idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
        """User tower + the user-side rows the scan's kernel takes: concat
        (user_first,); gated (user_first, user_gates), or (user_first,
        a) for the factored variant; attention (raw, q, k, vo, suu), plus
        the scalar table for the gram variant."""
        user_emb = self.model.user_tower(user_idx)
        if self._head['fusion'] == 'attention':
            return compute_user_side_attention(
                self._head, user_emb,
                with_gram=self.attention_variant == 'gram')
        if self._head['fusion'] == 'concatenate':
            return (compute_user_first(self._head, user_emb),)
        side = compute_user_side_gated(self._head, user_emb)
        if self.gated_variant == 'factored':
            return factor_gated_user(self._head, *side)
        return side

    def _fast_pair_scores(self, user_side: Tuple[torch.Tensor, ...],
                          chunk: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """[B, C] pair scores for one chunk of ``_scan_tables`` through the
        fused kernel (its plain float32 version for CPU tensors)."""
        if self._head['fusion'] == 'attention':
            if self.attention_variant == 'gram':
                return attention_scores_gram(self._head, user_side, chunk)
            return attention_scores(self._head, user_side, chunk)
        if self._head['fusion'] == 'concatenate':
            return pairwise_scores(self._head, user_side[0], chunk[0])
        if self.gated_variant == 'factored':
            return pairwise_scores_gated_factored(self._head, *user_side,
                                                  *chunk)
        return pairwise_scores_gated(self._head, *user_side, *chunk)

    def _fast_topk_body(self, user_idx: torch.Tensor,
                        seen_items: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming exact top-k over the catalog through the fused kernel.

        seen_items: [B, H] per-user excluded item positions padded with -1
        (a compact form of the seen mask: no dense [B, n_pad] transfer).
        """
        B, C = user_idx.shape[0], self.item_chunk
        user_side = self._fast_user_side(user_idx)
        rows = torch.arange(B, device=self.device)[:, None].expand(
            seen_items.shape)
        carry = init_topk(B, k, self.device)
        for off in range(0, self.n_pad, C):
            s = self._fast_pair_scores(
                user_side, tuple(a[off:off + C] for a in self._scan_tables))
            if off + C > self.n_items:  # catalog padding
                s[:, max(0, self.n_items - off):] = NEG_INF
            if seen_items.shape[1] > 0:
                local = seen_items.long() - off
                hit = (local >= 0) & (local < C)
                s[rows[hit], local[hit]] = NEG_INF
            idx = torch.arange(off, off + C, dtype=torch.int32,
                               device=self.device).expand(B, C)
            carry = merge_topk(*carry, s, idx, k)
        return carry

    # --------------------------------------------------------------- user API
    def top_k(self, user_indices: np.ndarray, k: int,
              seen_mask: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k items for each user.

        seen_mask: optional [B, n_items] bool (True = exclude). Returns
        (scores [B, k], item positions [B, k]; -1 where fewer than k valid).
        """
        user_indices = np.asarray(user_indices, np.int32)
        out_v, out_i = [], []
        with _exact_f32():
            for s in range(0, len(user_indices), self.user_chunk):
                users = user_indices[s:s + self.user_chunk]
                B = len(users)
                users_t = self._tensor(users.astype(np.int64))
                if self._head is not None:
                    seen = np.zeros((B, 0), dtype=np.int32)
                    if seen_mask is not None:
                        lists = [np.flatnonzero(r)
                                 for r in seen_mask[s:s + self.user_chunk]]
                        seen = np.full((B, max(map(len, lists), default=0)),
                                       -1, dtype=np.int32)
                        for bi, r in enumerate(lists):
                            seen[bi, :len(r)] = r
                    v, i = self._fast_topk_body(users_t, self._tensor(seen), k)
                else:
                    invalid = np.broadcast_to(self._pad_mask,
                                              (B, self.n_pad)).copy()
                    if seen_mask is not None:
                        invalid[:, :self.n_items] |= \
                            seen_mask[s:s + self.user_chunk]
                    v, i = self._generic_topk_body(
                        users_t, self._tensor(invalid), k)
                v, i = v.cpu().numpy(), i.cpu().numpy()
                i[v <= float(NEG_INF) / 2] = -1
                out_v.append(v)
                out_i.append(i)
        return np.concatenate(out_v), np.concatenate(out_i)

    def score_full(self, user_indices: np.ndarray) -> np.ndarray:
        """Dense [B, n_items] score matrix (ranking eval / analysis)."""
        user_indices = np.asarray(user_indices, np.int32)
        C = self.item_chunk
        rows = []
        with _exact_f32():
            for s in range(0, len(user_indices), self.user_chunk):
                users_t = self._tensor(
                    user_indices[s:s + self.user_chunk].astype(np.int64))
                if self._head is not None:
                    user_side = self._fast_user_side(users_t)
                    parts = [self._fast_pair_scores(
                        user_side, tuple(a[off:off + C]
                                         for a in self._scan_tables))
                        for off in range(0, self.n_pad, C)]
                else:
                    parts = [self._score_block(self._item_feats[off:off + C],
                                               users_t)
                             for off in range(0, self.n_pad, C)]
                rows.append(torch.cat(parts, dim=1)[:, :self.n_items]
                            .cpu().numpy())
        return np.concatenate(rows)

    def score_candidates(self, user_indices: np.ndarray,
                         candidate_idx: np.ndarray,
                         candidate_mask: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """Scores for per-user candidate lists ([B, C] padded with 0s).

        candidate_mask: [B, C] bool, True = valid entry; invalid entries
        score NEG_INF. The fused path gathers the precomputed first-layer
        rows (gated: and gate rows) and runs the float32 chain (the JAX
        package's ``xla_candidate_scores``, ``xla_candidate_scores_gated``);
        gated candidates take the exact math whatever ``gated_variant``.
        Attention gathers its per-item tables and scores them in float32
        (``ops/attention_cascade.py:attention_candidate_scores``), in user
        sub-blocks of at most ``_ATTENTION_CANDIDATE_PAIRS`` pairs.
        """
        user_indices = np.asarray(user_indices, np.int32)
        candidate_idx = np.asarray(candidate_idx, np.int32)
        out = []
        with _exact_f32():
            for s in range(0, len(user_indices), self.user_chunk):
                users_t = self._tensor(
                    user_indices[s:s + self.user_chunk].astype(np.int64))
                cands = self._tensor(
                    candidate_idx[s:s + self.user_chunk].astype(np.int64))
                if self._head is not None:
                    user_emb = self.model.user_tower(users_t)
                    if self._head['fusion'] == 'attention':
                        v = self._attention_candidates(user_emb, cands)
                    elif self._head['fusion'] == 'concatenate':
                        v = candidate_scores(
                            self._head,
                            compute_user_first(self._head, user_emb),
                            self._item_fast[0][cands])
                    else:
                        v = candidate_scores_gated(
                            self._head,
                            compute_user_side_gated(self._head, user_emb),
                            self._item_fast[0][cands],
                            self._item_fast[1][cands])
                else:
                    B, C = cands.shape
                    user_emb = self.model.user_tower(users_t)
                    ue = user_emb[:, None, :].expand(B, C, user_emb.shape[-1])
                    feats = self._item_feats[cands]  # [B, C, M, D]
                    v = self.model.score_from_towers(
                        ue.reshape(B * C, -1),
                        feats.reshape((B * C,) + tuple(feats.shape[2:]))
                    ).reshape(B, C)
                v = v.cpu().numpy()
                if candidate_mask is not None:
                    v = np.where(candidate_mask[s:s + self.user_chunk], v,
                                 float(NEG_INF))
                out.append(v)
        return np.concatenate(out)

    def _attention_candidates(self, user_emb: torch.Tensor,
                              cands: torch.Tensor) -> torch.Tensor:
        """[B] users x [B, C] candidate positions -> [B, C] float32
        attention scores on gathered table rows, in user sub-blocks."""
        side = compute_user_side_attention(self._head, user_emb)
        step = max(1, _ATTENTION_CANDIDATE_PAIRS // max(1, cands.shape[1]))
        return torch.cat([
            attention_candidate_scores(
                self._head, tuple(t[s:s + step] for t in side),
                tuple(t[cands[s:s + step]] for t in self._item_fast[:6]))
            for s in range(0, cands.shape[0], step)])

    # ------------------------------------------------ attention cascade
    def top_k_cascade(self, *args, **kwargs):
        raise NotImplementedError(f'top_k_cascade {_CASCADE_NOT_PORTED}')

    def calibrate_cascade(self, *args, **kwargs):
        raise NotImplementedError(f'calibrate_cascade {_CASCADE_NOT_PORTED}')

    def calibrate_funnel(self, *args, **kwargs):
        raise NotImplementedError(f'calibrate_funnel {_CASCADE_NOT_PORTED}')

    def auto_cascade(self, *args, **kwargs):
        raise NotImplementedError(f'auto_cascade {_CASCADE_NOT_PORTED}')
