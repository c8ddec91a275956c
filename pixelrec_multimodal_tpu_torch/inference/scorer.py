# pixelrec_multimodal_tpu_torch/inference/scorer.py
"""Full-catalog pair scoring on the card.

Counterpart of ``CatalogScorer`` in
``pixelrec_multimodal_tpu/inference/scorer.py``, concatenate fusion:

  * the item tower (item and tag embeddings plus modality projections) is
    computed once for the padded catalog, streamed host -> device in
    chunks, and kept on the device as ``[n_pad, M, D]``;
  * the BN-folded, factorized head turns it into per-item first-layer rows
    ``[n_pad, h1]`` once per catalog;
  * ``top_k`` scans the catalog in item chunks: one fused kernel launch
    scores a user block against a chunk (``ops/pairwise_mlp.py``), and a
    running top-k merges each chunk (``ops/topk.py``), so the
    [users, items] matrix is never held whole.

Blocks and chunks may be ragged: the kernel masks its own edges, so user
blocks are not padded to size classes (the JAX package pads them to keep
one compiled shape per class; PyTorch compiles nothing per shape).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pairwise_mlp import (
    build_factorized_head,
    candidate_scores,
    compute_item_first,
    compute_user_first,
    pairwise_scores,
)
from ..ops.topk import NEG_INF, init_topk, merge_topk
from ..parallel.mesh import pad_to_multiple

# (item_chunk, user_chunk) by device type. CUDA: the fastest pair of
# scripts/torch_chunk_sweep.py on the H100 (PERF.md, "Layers"); the sweep
# is flat within 2% because the kernel takes nearly all the time. CPU:
# small blocks that keep the plain float32 path's [users x chunk x h1]
# activations bounded.
DEFAULT_CHUNKS = {'cuda': (8192, 8192), 'cpu': (8192, 64)}


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
    """

    # Rows of raw encoder features moved host -> device per item-tower step.
    _TOWER_BUILD_CHUNK = 65536

    def __init__(self, model, feature_store,
                 item_chunk: Optional[int] = None,
                 user_chunk: Optional[int] = None,
                 mesh=None, fast_path: bool = True,
                 precision: str = 'bf16',
                 device: Union[str, torch.device] = 'cuda'):
        if mesh is not None:
            raise NotImplementedError(
                'catalog sharding over several devices is not ported yet '
                '(ROADMAP item A11)')
        if precision != 'bf16':
            raise NotImplementedError(
                f"precision={precision!r} is not ported yet: int8 scoring is "
                "ROADMAP item A10 (kernel K1q)")
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
        self._pad_mask = np.zeros(self.n_pad, dtype=bool)
        self._pad_mask[self.n_items:] = True  # True = invalid (padding)

        with _exact_f32():
            self._item_feats = self._build_item_tower()  # [n_pad, M, D]
            # Fused factorized head; ``_item_fast`` is the tuple of per-item
            # tables (concat: (item_first [n_pad, h1],)).
            self._head = None
            self._item_fast = None
            if fast_path:
                self._head = build_factorized_head(self.model)
                self._item_fast = self._build_item_fast(
                    lambda feats: (compute_item_first(
                        self._head, feats.reshape(feats.shape[0], -1)),))

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
        """User tower + user-side first-layer rows."""
        return (compute_user_first(self._head,
                                   self.model.user_tower(user_idx)),)

    def _fast_pair_scores(self, user_side: Tuple[torch.Tensor, ...],
                          chunk: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """[B, C] pair scores for one item chunk through the fused kernel
        (its plain float32 version for CPU tensors)."""
        return pairwise_scores(self._head, user_side[0], chunk[0])

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
                user_side, tuple(a[off:off + C] for a in self._item_fast))
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
                                         for a in self._item_fast))
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
        rows and runs the float32 chain (the JAX package's
        ``xla_candidate_scores``).
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
                    uf = self._fast_user_side(users_t)[0]
                    v = candidate_scores(self._head, uf,
                                         self._item_fast[0][cands])
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
