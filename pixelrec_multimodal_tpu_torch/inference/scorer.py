# pixelrec_multimodal_tpu_torch/inference/scorer.py
"""Full-catalog pair scoring on the card.

Counterpart of ``CatalogScorer`` in
``pixelrec_multimodal_tpu/inference/scorer.py``, concatenate, gated and
attention fusion, int8 scoring of the first two, and the attention
cascade:

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
    concat, K2 for exact gated, K3 for factored gated, or their int8 modes
    K1q, K2q, K3q with ``precision='int8'``;
    ``ops/attention_scorer.py``: K4 for stream attention, K5 for gram
    attention), and a running top-k merges each chunk (``ops/topk.py``),
    so the [users, items] matrix is never held whole;
  * for an attention model, ``top_k_cascade`` screens the catalog the same
    way through a cheaper kernel (K6, the token-0 screen, or K1 on the
    additive screen's rows; ``ops/attention_cascade.py``), then rescores
    each user's top candidates exactly on gathered table rows, and
    ``auto_cascade`` installs a calibrated plan that ``top_k`` then routes
    through.

Blocks and chunks may be ragged: the kernel masks its own edges, so user
blocks are not padded to size classes (the JAX package pads them to keep
one compiled shape per class; PyTorch compiles nothing per shape).

With a ``mesh`` (``parallel/mesh.py``) the catalog is sharded over its
'model' axis and the user rows of a call over its 'data' axis, as the JAX
package's ``shard_map`` does: each rank builds and holds only its
``n_pad / model_size`` rows of every item table and scans them with global
ids, the k candidates of each shard merge through one all-gather over
'model' (``ops/topk.py:gather_topk``), and the rows over 'data' are
all-gathered, so every rank returns the whole result. Candidates that may
lie on any shard (``score_candidates``, the cascade's rescore) are scored
by the rank that holds them, the others writing NEG_INF, and merged by one
max all-reduce over 'model' of the [users, candidates] scores: the traffic
scales with the candidates, not the catalog.
"""
from __future__ import annotations

import contextlib
import sys
import time
from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.attention_cascade import (
    attention_candidate_scores,
    attention_screen_candidate_scores,
    attention_screen_scores,
    compute_screen_additive_items,
    compute_screen_additive_user,
    compute_screen_tail,
    screen_additive_head,
)
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
    INT8_MIN_CHAIN_FLOPS_PER_LANE,
    INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT,
    build_factorized_head,
    calibrate_head_ranges,
    calibrate_head_ranges_gated,
    candidate_scores,
    check_pair_kernel_fits,
    candidate_scores_gated,
    compute_item_first,
    compute_item_side_gated,
    compute_user_first,
    compute_user_side_gated,
    factor_gated_tables,
    factor_gated_user,
    int8_chain_flops_per_lane,
    pairwise_scores,
    pairwise_scores_gated,
    pairwise_scores_gated_factored,
    quantize_head,
)
from ..ops.topk import NEG_INF, gather_topk, init_topk, merge_topk
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    agree_max,
    all_gather,
    all_reduce,
    batch_sharding,
    owned_rows,
    pad_to_multiple,
)

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

# Bytes of gathered table rows per user sub-block of the attention
# candidate paths (the cascade's rescore and the funnel's candidate screen,
# score_candidates); their temporaries take about as much again. On the
# H100 budgets of 128 MiB to 4 GiB time within 10% of each other, and 1 GiB
# within 2.4% of the fastest at a quarter of its memory
# (scripts/torch_kernel_bench.py rescore, PERF.md).
_CANDIDATE_BLOCK_BYTES = 1 << 30

SCREENS = ('additive', 'token0', 'funnel')


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
    ``mesh`` (``parallel/mesh.py:Mesh``) shards the catalog over its
    'model' axis and the users of a call over 'data' (module docstring);
    every rank of the mesh makes the same calls in the same order, and
    each returns the whole result. Under a mesh ``n_pad`` is a multiple of
    ``item_chunk`` x the model axis, and the gated variant is
    ``'exact'`` (``'factored'`` raises), as in the JAX package; the
    precision, the kernel and its block are those of one device. The model
    is moved to ``device`` and put in eval mode. Every call runs its
    float32 products with TF32 off (``_exact_f32``).

    ``precision``: ``'bf16'``, or opt-in int8 scoring of a concatenate or
    gated fast path (``'int8'`` or ``'int8!'``; anything else, an attention
    model or ``fast_path=False`` raises ValueError). The head's hidden
    chain is quantized once here from ranges calibrated on a sample of the
    catalog's pairs (``_quantize``), and ``top_k``, ``score_full`` and
    ``score_candidates`` then score in int8: on the card through the
    kernels' int8 mode (K1q, K2q, K3q), on the CPU through the plain int8
    chain in float32. Scores are approximate. ``'int8'`` passes the
    auto-precision gate first and may serve bf16 (``_resolve_precision``);
    ``'int8!'`` forces int8. ``self.precision`` holds what is served.

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
    path). The generic
    path of an attention model (``fast_path=False``) scores at most 64
    users per block, as the JAX package does: the model's attention holds
    [users x items x H x T x T] intermediates.

    On the card the fast path's kernel must take the head in a block of
    128, 64, 32 or 16 pair rows (``check_kernel_fits`` for attention,
    ``check_pair_kernel_fits`` for concatenate and gated, in the precision
    served): the rows, which every launch of that kernel on this head then
    reads (``ops/pairwise_mlp.py:block_rows``, chosen once per shape), are
    held in ``self.block_rows`` (None off the card), and a head that fits
    no block raises ValueError here, before any table is built. Any head whose d is a multiple of 16 up to 512 and whose
    block fits in 16 rows is served.

    An attention fast path also serves the cascade (``top_k_cascade``,
    ``calibrate_cascade``, ``calibrate_funnel``, ``auto_cascade``,
    ``disable_cascade``) in either variant; its screen tables are built on
    first use. Any other scorer raises ValueError there.
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
        if mesh is not None and gated_variant == 'factored':
            raise ValueError("gated_variant='factored' is not served under "
                             "a mesh: the meshed gated path is 'exact', as "
                             "the JAX package's")
        if precision not in ('bf16', 'int8', 'int8!'):
            raise ValueError(f"precision must be 'bf16', 'int8' or "
                             f"'int8!' (force), got {precision!r}")
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
        self.mesh = mesh
        self._model_size = mesh.shape[MODEL_AXIS] if mesh is not None else 1
        self._data_size = mesh.shape[DATA_AXIS] if mesh is not None else 1
        default_items, default_users = DEFAULT_CHUNKS[self.device.type]
        item_chunk = item_chunk or default_items
        self.item_chunk = min(item_chunk, pad_to_multiple(self.n_items, 128))
        self.n_pad = pad_to_multiple(self.n_items,
                                     self.item_chunk * self._model_size)
        # This rank's rows of the catalog: [_base, _base + n_local).
        self.n_local = self.n_pad // self._model_size
        self._base = (mesh.index(MODEL_AXIS) * self.n_local
                      if mesh is not None else 0)
        self.user_chunk = user_chunk or default_users
        if model.fusion_type == 'attention' and not fast_path:
            self.user_chunk = min(self.user_chunk, 64)
        self._pad_mask = np.zeros(self.n_pad, dtype=bool)
        self._pad_mask[self.n_items:] = True  # True = invalid (padding)
        # The cascade's per-item screen tables and the additive screen's K1
        # head, built on first use (_ensure_screen); the plan auto_cascade
        # installs ({'screen', 'n_candidates', 'k', ...}), through which
        # top_k routes requests with k <= its k.
        self._screen_tail = self._screen_add = self._screen_head = None
        self._cascade_plan: Optional[Dict] = None
        self.auto_cascade_report: Optional[Dict] = None

        with _exact_f32():
            # The fused head, the precision served and, on the card, the
            # kernel's block, before any table is built.
            self._head = None
            self.gated_variant = self.attention_variant = None
            self.block_rows = None
            if fast_path and self.model.fusion_type == 'attention':
                head = self._head = build_attention_head(self.model)
                self.attention_variant = (attention_variant
                                          or DEFAULT_ATTENTION_VARIANT)
            elif fast_path:
                head = self._head = build_factorized_head(self.model)
                if head['fusion'] == 'gated':
                    self.gated_variant = (gated_variant
                                          or DEFAULT_GATED_VARIANT)
                    self._check_factored_budget()
            self.precision = self._resolve_precision(precision)
            if self._head is not None and self.device.type == 'cuda':
                self.block_rows = (
                    check_kernel_fits(head, self.attention_variant == 'gram')
                    if self.attention_variant else check_pair_kernel_fits(
                        head, self.gated_variant, self.precision == 'int8'))

            self._item_feats = self._build_item_tower()  # [n_local, M, D]
            # ``_item_fast`` is the tuple of per-item tables (concat:
            # (item_first,); gated: (item_first, item_gates)); attention:
            # the d-wide tables); ``_scan_tables`` the tuple the kernel
            # scans (the factored gated variant: (T, igb); else
            # ``_item_fast``).
            self._item_fast = self._scan_tables = None
            if self.attention_variant:
                self._item_fast = self._scan_tables = self._build_item_fast(
                    partial(compute_item_side_attention, head,
                            with_gram=self.attention_variant == 'gram'))
            elif self._head is not None:
                if head['fusion'] == 'concatenate':
                    self._item_fast = self._build_item_fast(
                        lambda feats: (compute_item_first(
                            head, feats.reshape(feats.shape[0], -1)),))
                else:
                    self._item_fast = self._build_item_fast(
                        partial(compute_item_side_gated, head))
                self._scan_tables = self._item_fast
                if self.gated_variant == 'factored':
                    self._scan_tables = self._build_item_fast(
                        lambda feats: factor_gated_tables(
                            head, *compute_item_side_gated(head, feats)))
            if self.precision == 'int8':
                self._quantize()

    def _resolve_precision(self, precision: str) -> str:
        """'bf16' or 'int8'. int8 takes a fused concatenate or gated head
        (ValueError otherwise). The auto-precision gate: below
        ``INT8_MIN_CHAIN_FLOPS_PER_LANE`` (a gated head) or
        ``INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT`` (a concatenate head)
        hidden-chain operations per first-layer lane, where the H100
        measured the int8 kernel no faster than the bf16 one, 'int8' warns
        on stderr and serves bf16; 'int8!' quantizes whatever the head has
        past its first layer, and raises where that is no hidden layer
        (before the kernels' fit is checked, on the CPU and the card
        alike)."""
        if precision == 'bf16':
            return precision
        if self._head is None or self._head['fusion'] not in (
                'concatenate', 'gated'):
            raise ValueError(
                "precision='int8' requires a fused concatenate or gated head "
                f'(fusion_type={self.model.fusion_type!r}, fast_path head '
                f"{'missing' if self._head is None else 'present'})")
        rho = int8_chain_flops_per_lane(self._head)
        flip = (INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT
                if self._head['fusion'] == 'concatenate'
                else INT8_MIN_CHAIN_FLOPS_PER_LANE)
        if precision == 'int8' and rho < flip:
            print(f"CatalogScorer: precision='int8' requested but the head "
                  f'is below the int8 flip point measured on the H100 '
                  f'(hidden-chain operations per first-layer lane {rho:.0f} '
                  f'< {flip}: there the int8 kernel is no faster than the '
                  f'bf16 one; PERF.md). Serving in bf16; pass '
                  f"precision='int8!' to force.", file=sys.stderr)
            return 'bf16'
        if len(self._head['layers']) < 2:
            raise ValueError(
                "precision='int8!': an int8 head carries one quantized layer "
                '(qlayers) per hidden layer, at least one; this head has no '
                'hidden layer between the first layer and the last dot '
                f'(fusion_hidden_dims {list(self.model.fusion_hidden_dims)})')
        return 'int8'

    def _quantize(self):
        """Calibrate each hidden layer's input range on the JAX package's
        sample (``np.random.default_rng(0)``: min(64, n_users) users
        without replacement, then the sorted min(1024, n_items) items),
        through the exact tables (gated: ``(item_first, item_gates)``
        whatever the variant), and put the head in int8 mode."""
        head, model = self._head, self.model
        rng = np.random.default_rng(0)
        cal_users = rng.choice(model.n_users, size=min(64, model.n_users),
                               replace=False).astype(np.int64)
        cal_items = self._tensor(np.sort(rng.choice(
            self.n_items, size=min(1024, self.n_items),
            replace=False)).astype(np.int64))
        user_emb = model.user_tower(self._tensor(cal_users))
        if head['fusion'] == 'gated':
            ranges = calibrate_head_ranges_gated(
                head, compute_user_side_gated(head, user_emb),
                tuple(self._global_rows(t, cal_items)
                      for t in self._item_fast))
        else:
            ranges = calibrate_head_ranges(
                head, compute_user_first(head, user_emb),
                self._global_rows(self._item_fast[0], cal_items))
        quantize_head(head, ranges)

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

    def _global_rows(self, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (global item positions) of an item table; under a
        mesh each rank holds only its rows, so the owner gives each row and
        the others zeros, summed over 'model' (``owned_rows``)."""
        if self.mesh is None:
            return table[idx]
        return owned_rows(self.mesh, table, idx, self._base)

    def item_rows(self, idx: np.ndarray) -> torch.Tensor:
        """The item tower's rows [len(idx), M, D] of global item positions
        ``idx`` (the representations MMR compares), on every rank."""
        with torch.no_grad():
            return self._global_rows(self._item_feats,
                                     self._tensor(idx.astype(np.int64)))

    def _owned_scores(self, score: Callable, cands: torch.Tensor
                      ) -> torch.Tensor:
        """[b, C] scores of global candidate positions ``cands`` (>= 0),
        ``score`` taking local positions. Under a mesh the rank that holds
        a candidate scores it and the others write NEG_INF; one max
        all-reduce over 'model' of the [b, C] scores merges them."""
        if self.mesh is None:
            return score(cands)
        own = (cands >= self._base) & (cands < self._base + self.n_local)
        v = score(torch.where(own, cands - self._base, 0))
        v = v.float().masked_fill(~own, NEG_INF).contiguous()
        return all_reduce(self.mesh, MODEL_AXIS, v, 'max')

    def _user_blocks(self, n: int):
        """(start, size, rows) of each block of ``user_chunk`` of ``n``
        users: ``rows`` are the positions this rank scores. Under a mesh
        the block is padded to a multiple of the 'data' axis (-1: padding,
        scored as the block's first user, as the JAX package pads) and
        each data coordinate takes its share."""
        for s in range(0, n, self.user_chunk):
            B = min(self.user_chunk, n - s)
            rows = np.arange(s, s + B)
            if self.mesh is not None:
                Bp = pad_to_multiple(B, self._data_size)
                rows = np.concatenate([rows, np.full(Bp - B, -1)])
                rows = rows[batch_sharding(self.mesh, Bp)]
            yield s, B, rows

    def _users_of(self, user_indices: np.ndarray, s: int,
                  rows: np.ndarray) -> torch.Tensor:
        return self._tensor(user_indices[np.where(rows >= 0, rows, s)]
                            .astype(np.int64))

    def _whole_block(self, t: torch.Tensor, B: int) -> np.ndarray:
        """This rank's rows of a user block, all-gathered over 'data' into
        the block's B rows, on the host."""
        if self.mesh is not None:
            t = all_gather(self.mesh, DATA_AXIS, t, dim=0)
        return t[:B].cpu().numpy()

    # ------------------------------------------------------------- item tower
    def _build_item_tower(self) -> torch.Tensor:
        """Item tower over this rank's rows of the padded catalog. Rows
        past n_items are built from item 0, tag 0 and zero features, as in
        the JAX scorer; a missing feature table gives zero features."""
        t = self.store.tables
        n, lo, hi = self.n_items, self._base, self._base + self.n_local
        chunk = min(self._TOWER_BUILD_CHUNK, hi - lo)
        names = [('vision_features', 'vision_emb',
                  self.model.vision_feature_dim),
                 ('language_features', 'language_emb',
                  self.model.language_feature_dim),
                 ('numerical_features', 'numerical',
                  self.model.num_numerical_features)]
        parts = []
        for start in range(lo, hi, chunk):
            rows = min(chunk, hi - start)
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

    def _build_item_fast(self, compute: Callable,
                         sources: Optional[Sequence[torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, ...]:
        """Apply a per-item table compute over this rank's rows of the
        padded catalog in chunks written into preallocated tables, so the
        transient memory is one chunk's temporaries. ``compute`` takes a
        chunk of each of ``sources`` (default: the item tower)."""
        sources = (self._item_feats,) if sources is None else tuple(sources)
        n_rows = sources[0].shape[0]
        chunk = min(self._TOWER_BUILD_CHUNK, n_rows)
        first = compute(*(t[:chunk] for t in sources))
        outs = tuple(torch.empty((n_rows,) + f.shape[1:], dtype=f.dtype,
                                 device=self.device) for f in first)
        for o, f in zip(outs, first):
            o[:chunk] = f
        for start in range(chunk, n_rows, chunk):
            for o, p in zip(outs, compute(
                    *(t[start:start + chunk] for t in sources))):
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
        """Streaming exact top-k through the model over this rank's rows;
        invalid_mask [B, n_local] (True = seen or padding) is excluded."""
        B, C = user_idx.shape[0], self.item_chunk
        carry = init_topk(B, k, self.device)
        for off in range(0, self.n_local, C):
            s = self._score_block(self._item_feats[off:off + C], user_idx)
            s = s.masked_fill(invalid_mask[:, off:off + C], NEG_INF)
            g = self._base + off
            idx = torch.arange(g, g + C, dtype=torch.int32,
                               device=self.device).expand(B, C)
            carry = merge_topk(*carry, s, idx, k)
        return carry

    def _invalid_rows(self, seen_mask: Optional[np.ndarray],
                      rows: np.ndarray) -> np.ndarray:
        """[len(rows), n_local] bool over this rank's catalog rows: True
        for padding items and the seen items of each user row (none for
        a padding row, -1)."""
        lo, hi = self._base, self._base + self.n_local
        invalid = np.broadcast_to(self._pad_mask[lo:hi],
                                  (len(rows), self.n_local)).copy()
        if seen_mask is not None:
            cols = seen_mask[np.maximum(rows, 0), lo:min(hi, self.n_items)]
            cols[rows < 0] = False
            invalid[:, :cols.shape[1]] |= cols
        return invalid

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
                        seen_items: torch.Tensor, k: int,
                        screen: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming exact top-k over this rank's rows of the catalog
        through the fused kernel, with global ids.

        seen_items: [B, H] per-user excluded global item positions padded
        with -1 (a compact form of the seen mask: no dense [B, n_pad]
        transfer).
        ``screen`` scores through a cascade screen instead (its tables
        built): ``'token0'`` scans (k, vo, tail) through K6, ``'additive'``
        the additive item table through K1 against the user rows, computed
        once per user block.
        """
        B, C = user_idx.shape[0], self.item_chunk
        user_side = self._fast_user_side(user_idx)
        if screen == 'token0':
            tables = self._item_fast[:6] + (self._screen_tail,)

            def score(chunk):
                return attention_screen_scores(self._head, user_side,
                                               chunk[:6], chunk[6])
        elif screen == 'additive':
            tables = (self._screen_add,)
            uf = compute_screen_additive_user(self._head, user_side)

            def score(chunk):
                return pairwise_scores(self._screen_head, uf, chunk[0])
        elif screen is None:
            tables = self._scan_tables
            score = partial(self._fast_pair_scores, user_side)
        else:
            raise ValueError(f"a scan screens with 'token0' or 'additive', "
                             f'got {screen!r}')
        rows = torch.arange(B, device=self.device)[:, None].expand(
            seen_items.shape)
        carry = init_topk(B, k, self.device)
        for off in range(0, self.n_local, C):
            g = self._base + off  # the chunk's first global id
            s = score(tuple(a[off:off + C] for a in tables))
            if g + C > self.n_items:  # catalog padding
                s[:, max(0, self.n_items - g):] = NEG_INF
            if seen_items.shape[1] > 0:
                local = seen_items.long() - g
                hit = (local >= 0) & (local < C)
                s[rows[hit], local[hit]] = NEG_INF
            idx = torch.arange(g, g + C, dtype=torch.int32,
                               device=self.device).expand(B, C)
            carry = merge_topk(*carry, s, idx, k)
        return carry

    def _seen_items(self, seen_mask: Optional[np.ndarray],
                    rows: np.ndarray) -> torch.Tensor:
        """The compact seen lists of the users at ``rows`` of the request
        on the device: [len(rows), H] item positions padded with -1 (H = 0
        without a mask; no item for a padding row, -1)."""
        B = len(rows)
        seen = np.zeros((B, 0), dtype=np.int32)
        if seen_mask is not None:
            lists = [np.flatnonzero(seen_mask[r]) if r >= 0
                     else np.zeros(0, np.int64) for r in rows]
            seen = np.full((B, max(map(len, lists), default=0)), -1,
                           dtype=np.int32)
            for bi, r in enumerate(lists):
                seen[bi, :len(r)] = r
        return self._tensor(seen)

    # --------------------------------------------------------------- user API
    def top_k(self, user_indices: np.ndarray, k: int,
              seen_mask: Optional[np.ndarray] = None,
              _screen: Optional[str] = None,
              _exact: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k items for each user.

        seen_mask: optional [B, n_items] bool (True = exclude). Returns
        (scores [B, k], item positions [B, k]; -1 where fewer than k valid).
        _screen (private; for the cascade and its calibration): rank by a
        cascade screen, ``'token0'`` or ``'additive'``, instead of the
        exact scores. _exact (private; for calibration): bypass an
        installed cascade plan.

        With an ``auto_cascade`` plan installed (attention fusion), requests
        with k <= the plan's k go through ``top_k_cascade``: the returned
        scores stay exact (the rescore is the exact attention math), and
        the items equal the full scan's wherever the calibrated screen
        recall holds.
        """
        user_indices = np.asarray(user_indices, np.int32)
        plan = self._cascade_plan
        if plan is not None and _screen is None and not _exact \
                and k <= plan['k']:
            return self.top_k_cascade(
                user_indices, k, n_candidates=plan['n_candidates'],
                seen_mask=seen_mask, screen=plan['screen'],
                funnel_c1=plan.get('c1'), _calibrated=True)
        if _screen is not None:
            self._ensure_screen(_screen)
        out_v, out_i = [], []
        with _exact_f32():
            for s, B, rows in self._user_blocks(len(user_indices)):
                users_t = self._users_of(user_indices, s, rows)
                if self._head is not None:
                    v, i = self._fast_topk_body(
                        users_t, self._seen_items(seen_mask, rows), k,
                        _screen)
                else:
                    v, i = self._generic_topk_body(
                        users_t, self._tensor(self._invalid_rows(seen_mask,
                                                                 rows)), k)
                if self.mesh is not None:
                    v, i = gather_topk(v, i, k, self.mesh)
                v, i = self._whole_block(v, B), self._whole_block(i, B)
                i[v <= float(NEG_INF) / 2] = -1
                out_v.append(v)
                out_i.append(i)
        return np.concatenate(out_v), np.concatenate(out_i)

    def score_full(self, user_indices: np.ndarray) -> np.ndarray:
        """Dense [B, n_items] score matrix (ranking eval / analysis). Under
        a mesh each rank scores its catalog columns for its users, and the
        matrix is all-gathered over 'model', then over 'data'."""
        user_indices = np.asarray(user_indices, np.int32)
        C = self.item_chunk
        out = []
        with _exact_f32():
            for s, B, rows in self._user_blocks(len(user_indices)):
                users_t = self._users_of(user_indices, s, rows)
                if self._head is not None:
                    user_side = self._fast_user_side(users_t)
                    parts = [self._fast_pair_scores(
                        user_side, tuple(a[off:off + C]
                                         for a in self._scan_tables))
                        for off in range(0, self.n_local, C)]
                else:
                    parts = [self._score_block(self._item_feats[off:off + C],
                                               users_t)
                             for off in range(0, self.n_local, C)]
                dense = torch.cat(parts, dim=1)
                if self.mesh is not None:
                    dense = all_gather(self.mesh, MODEL_AXIS, dense, dim=1)
                out.append(self._whole_block(dense, B)[:, :self.n_items])
        return np.concatenate(out)

    def score_candidates(self, user_indices: np.ndarray,
                         candidate_idx: np.ndarray,
                         candidate_mask: Optional[np.ndarray] = None
                         ) -> np.ndarray:
        """Scores for per-user candidate lists ([B, C] padded with 0s).

        candidate_mask: [B, C] bool, True = valid entry; invalid entries
        score NEG_INF. The fused path gathers the precomputed first-layer
        rows (gated: and gate rows) and runs the float32 chain, or the int8
        chain in float32 for an int8 scorer (the JAX package's
        ``xla_candidate_scores``, ``xla_candidate_scores_gated``); gated
        candidates take the exact math whatever ``gated_variant``.
        Attention gathers its per-item tables and scores them in float32
        (``ops/attention_cascade.py:attention_candidate_scores``), in user
        sub-blocks of at most ``_CANDIDATE_BLOCK_BYTES`` of gathered rows.
        Under a mesh each candidate is scored by the rank that holds it
        (``_owned_scores``).
        """
        user_indices = np.asarray(user_indices, np.int32)
        candidate_idx = np.asarray(candidate_idx, np.int32)
        out = []
        with _exact_f32():
            for s, B, rows in self._user_blocks(len(user_indices)):
                users_t = self._users_of(user_indices, s, rows)
                cands = self._tensor(candidate_idx[
                    np.where(rows >= 0, rows, s)].astype(np.int64))
                user_emb = self.model.user_tower(users_t)
                score = self._candidate_fn(user_emb)
                v = self._whole_block(self._owned_scores(score, cands), B)
                if candidate_mask is not None:
                    v = np.where(candidate_mask[s:s + B], v, float(NEG_INF))
                out.append(v)
        return np.concatenate(out)

    def _candidate_fn(self, user_emb: torch.Tensor) -> Callable:
        """The [b, C] scores of local candidate positions for users with
        tower rows ``user_emb``: the fused head's float32 chain on the
        gathered first-layer rows, attention's exact math on the gathered
        tables, or the model's own layers on the gathered item tower."""
        head = self._head
        if head is not None and head['fusion'] == 'attention':
            return partial(self._attention_candidates, user_emb)
        if head is not None and head['fusion'] == 'concatenate':
            user_first = compute_user_first(head, user_emb)
            return lambda c: candidate_scores(head, user_first,
                                              self._item_fast[0][c])
        if head is not None:
            side = compute_user_side_gated(head, user_emb)
            return lambda c: candidate_scores_gated(
                head, side, self._item_fast[0][c], self._item_fast[1][c])

        def generic(c):
            B, C = c.shape
            ue = user_emb[:, None, :].expand(B, C, user_emb.shape[-1])
            feats = self._item_feats[c]  # [B, C, M, D]
            return self.model.score_from_towers(
                ue.reshape(B * C, -1),
                feats.reshape((B * C,) + tuple(feats.shape[2:]))
            ).reshape(B, C)
        return generic

    def _gathered_blocks(self, score: Callable, user_emb: torch.Tensor,
                         cands: torch.Tensor,
                         tables: Sequence[torch.Tensor]) -> torch.Tensor:
        """[B] users x [B, C] candidate positions -> [B, C] float32:
        ``score(user_side, rows)`` on the rows of ``tables`` gathered per
        user, in user sub-blocks of at most ``_CANDIDATE_BLOCK_BYTES`` of
        gathered rows (at least one user)."""
        side = compute_user_side_attention(self._head, user_emb)
        row_bytes = sum(t[0].numel() * t.element_size() for t in tables)
        step = max(1, _CANDIDATE_BLOCK_BYTES
                   // max(1, cands.shape[1] * row_bytes))
        return torch.cat([
            score(tuple(t[s:s + step] for t in side),
                  tuple(t[cands[s:s + step]] for t in tables))
            for s in range(0, cands.shape[0], step)])

    def _attention_candidates(self, user_emb: torch.Tensor,
                              cands: torch.Tensor) -> torch.Tensor:
        """Exact attention scores of per-user candidates, the cascade's
        rescore: the rows of (raw, q, k, vo) gathered per user through
        ``attention_candidate_scores``."""
        return self._gathered_blocks(
            partial(attention_candidate_scores, self._head), user_emb, cands,
            self._item_fast[:4])

    def _screen_candidates(self, user_emb: torch.Tensor,
                           cands: torch.Tensor) -> torch.Tensor:
        """Token-0 screen scores of per-user candidates, the funnel's middle
        stage: the rows of (k, vo, tail) gathered per user through
        ``attention_screen_candidate_scores``."""
        return self._gathered_blocks(
            lambda side, rows: attention_screen_candidate_scores(
                self._head, side, rows[:2], rows[2]),
            user_emb, cands,
            (self._item_fast[2], self._item_fast[3], self._screen_tail))

    # ------------------------------------------------ attention cascade
    def _ensure_screen(self, screen: str):
        """Build, once, the tables of ``screen``: the per-item screen tail
        [n_pad, d] (``compute_screen_tail``), and for ``'additive'`` (and
        the funnel) the additive item rows [n_pad, h1] and their K1 head.
        Raise ValueError without an attention fast path."""
        if self._head is None or self._head['fusion'] != 'attention':
            raise ValueError(
                'cascade screening requires the fused attention head '
                f'(fusion_type={self.model.fusion_type!r}, fast_path head '
                f"{'missing' if self._head is None else 'present'})")
        if screen not in SCREENS:
            raise ValueError(f'screen must be one of {SCREENS}, got '
                             f'{screen!r}')
        head = self._head
        with _exact_f32():
            if self._screen_tail is None:
                self._screen_tail = self._build_item_fast(
                    lambda *tabs: (compute_screen_tail(head, tabs),),
                    self._item_fast[:6])[0]
            if screen != 'token0' and self._screen_add is None:
                self._screen_add = self._build_item_fast(
                    lambda tail: (compute_screen_additive_items(head, tail),),
                    (self._screen_tail,))[0]
                self._screen_head = screen_additive_head(head)

    @staticmethod
    def _final_topk(scores: torch.Tensor, ids: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-k of rescored candidates: fewer than k columns pad
        with NEG_INF and -1; empty slots give -1 ids."""
        if ids.shape[1] < k:
            pad = k - ids.shape[1]
            scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        v, pos = torch.topk(scores, k, dim=1)
        i = torch.gather(ids, 1, pos)
        return v, i.masked_fill(v <= NEG_INF / 2, -1)

    def _cascade_block(self, users_t: torch.Tensor, seen: torch.Tensor,
                       k: int, n_cand: int, screen: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One user block of the two-stage cascade: screen scan, top-C,
        exact rescore, final top-k. The screen value masks too: a screen
        surfaces seen or padding items as NEG_INF tie-fills when fewer than
        C items are live, and the rescore must not bring them back."""
        sv, si = self._fast_topk_body(users_t, seen, n_cand, screen)
        scores = self._attention_candidates(self.model.user_tower(users_t),
                                            si.long().clamp(min=0))
        scores = scores.masked_fill((si < 0) | (sv <= NEG_INF / 2), NEG_INF)
        return self._final_topk(scores, si, k)

    def _funnel_block(self, users_t: torch.Tensor, seen: torch.Tensor,
                      k: int, c1: int, c2: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One user block of the three-stage funnel: additive screen scan to
        C1 survivors, the token-0 screen on them to C2, exact rescore,
        final top-k; masked after each screen as ``_cascade_block``."""
        sv1, si1 = self._fast_topk_body(users_t, seen, c1, 'additive')
        user_emb = self.model.user_tower(users_t)
        s2 = self._screen_candidates(user_emb, si1.long().clamp(min=0))
        s2 = s2.masked_fill((si1 < 0) | (sv1 <= NEG_INF / 2), NEG_INF)
        v2, pos2 = torch.topk(s2, c2, dim=1)
        si2 = torch.gather(si1, 1, pos2).masked_fill(v2 <= NEG_INF / 2, -1)
        scores = self._attention_candidates(user_emb, si2.long().clamp(min=0))
        return self._final_topk(scores.masked_fill(si2 < 0, NEG_INF), si2, k)

    def _candidate_blocks(self, score_of: Callable, user_indices: np.ndarray,
                          cand_idx: np.ndarray) -> np.ndarray:
        """Scores of per-user candidate lists in user blocks, ``score_of``
        (the user tower rows, local candidate positions) -> [b, C]
        (invalid ids < 0 are scored at item 0; callers mask them)."""
        out = []
        with _exact_f32():
            for s, B, rows in self._user_blocks(len(user_indices)):
                users_t = self._users_of(user_indices, s, rows)
                cands = self._tensor(np.clip(
                    cand_idx[np.where(rows >= 0, rows, s)], 0, None).astype(
                        np.int64))
                user_emb = self.model.user_tower(users_t)
                out.append(self._whole_block(self._owned_scores(
                    partial(score_of, user_emb), cands), B))
        return np.concatenate(out)

    def _screen_candidate_blocks(self, user_indices: np.ndarray,
                                 cand_idx: np.ndarray) -> np.ndarray:
        """Token-0 screen scores of per-user candidate lists."""
        return self._candidate_blocks(self._screen_candidates, user_indices,
                                      cand_idx)

    def _meshed_cascade(self, user_indices: np.ndarray, k: int,
                        n_candidates: int, seen_mask: Optional[np.ndarray],
                        screen: str, funnel_c1: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The cascade under a mesh, in stages as the JAX package's: the
        sharded screen scan with its merge at C (the funnel: the additive
        scan at C1, then the token-0 screen on the survivors and a host
        top-C2), then the rescore on the sharded tables and a host top-k
        (stable: ties keep the screen's order)."""
        if screen == 'funnel':
            _, si = self.top_k(user_indices, funnel_c1, seen_mask,
                               _screen='additive')
            s2 = self._screen_candidate_blocks(user_indices, si)
            s2 = np.where(si < 0, float(NEG_INF), s2)
            pos2 = np.argsort(-s2, kind='stable', axis=1)[:, :n_candidates]
            v2 = np.take_along_axis(s2, pos2, axis=1)
            si = np.take_along_axis(si, pos2, axis=1)
            si[v2 <= float(NEG_INF) / 2] = -1
        else:
            _, si = self.top_k(user_indices, n_candidates, seen_mask,
                               _screen=screen)
        scores = self._candidate_blocks(self._attention_candidates,
                                        user_indices, si)
        scores = np.where(si < 0, float(NEG_INF), scores).astype(np.float32)
        if si.shape[1] < k:  # tiny catalogs: pad to k
            pad = ((0, 0), (0, k - si.shape[1]))
            scores = np.pad(scores, pad, constant_values=float(NEG_INF))
            si = np.pad(si, pad, constant_values=-1)
        pos = np.argsort(-scores, kind='stable', axis=1)[:, :k]
        v = np.take_along_axis(scores, pos, axis=1)
        i = np.take_along_axis(si, pos, axis=1)
        i[v <= float(NEG_INF) / 2] = -1
        return v, i

    def top_k_cascade(self, user_indices: np.ndarray, k: int,
                      n_candidates: Optional[int] = None,
                      seen_mask: Optional[np.ndarray] = None,
                      screen: str = 'additive',
                      funnel_c1: Optional[int] = None,
                      _calibrated: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Cascaded top-k for attention fusion: screen the catalog with a
        cheap scorer, then rescore each user's top ``n_candidates`` exactly
        and return their exact top-k (scores [B, k], item positions [B, k];
        -1 where fewer than k valid).

        screen: ``'additive'`` (K1 on the additive screen's rows, both
        attention limits frozen; the weakest recall per C), ``'token0'``
        (K6: the user token's attention row exact) or ``'funnel'``
        (additive screen to ``funnel_c1`` survivors, the token-0 screen on
        them to ``n_candidates``, exact rescore). The result equals the
        exact ``top_k`` whenever the screen's recall at n_candidates
        covers the exact top-k: measure it with ``calibrate_cascade`` or
        ``calibrate_funnel``. Defaults: C = max(8k, 256) for token0 and the
        funnel's C2, max(16k, 1024) for additive (an explicit smaller C
        warns on stderr), C1 = max(8 C2, 4096).
        """
        self._ensure_screen(screen)
        user_indices = np.asarray(user_indices, np.int32)
        add_floor = max(16 * k, 1024)
        if n_candidates is None:
            n_candidates = (add_floor if screen == 'additive'
                            else max(8 * k, 256))
        elif (screen == 'additive' and n_candidates < add_floor
              and n_candidates < self.n_items and not _calibrated):
            # The additive screen drops all user-item attention coupling,
            # so a C calibrated for the token-0 screen loses recall here.
            print(f'CatalogScorer.top_k_cascade: n_candidates='
                  f'{n_candidates} is below the additive screen\'s '
                  f'operating floor {add_floor} (16*k, min 1024). If this '
                  f"C was calibrated against screen='token0', re-run "
                  f"calibrate_cascade(screen='additive'): the additive "
                  f'screen needs a larger C for the same recall.',
                  file=sys.stderr)
        n_candidates = min(n_candidates, self.n_items)
        if screen == 'funnel':
            if funnel_c1 is None:
                funnel_c1 = max(8 * n_candidates, 4096)
            funnel_c1 = min(max(funnel_c1, n_candidates), self.n_items)
        if self.mesh is not None:
            return self._meshed_cascade(user_indices, k, n_candidates,
                                        seen_mask, screen, funnel_c1)
        out_v, out_i = [], []
        with _exact_f32():
            for s in range(0, len(user_indices), self.user_chunk):
                users = user_indices[s:s + self.user_chunk]
                users_t = self._tensor(users.astype(np.int64))
                seen = self._seen_items(seen_mask,
                                        np.arange(s, s + len(users)))
                if screen == 'funnel':
                    v, i = self._funnel_block(users_t, seen, k, funnel_c1,
                                              n_candidates)
                else:
                    v, i = self._cascade_block(users_t, seen, k,
                                               n_candidates, screen)
                out_v.append(v.cpu().numpy())
                out_i.append(i.cpu().numpy())
        return np.concatenate(out_v), np.concatenate(out_i)

    def calibrate_cascade(self, user_indices: np.ndarray, k: int,
                          candidate_grid=(128, 256, 512, 1024),
                          seen_mask: Optional[np.ndarray] = None,
                          screen: str = 'additive') -> Dict[int, float]:
        """Measured screen recall on a user sample: the share of each
        user's exact top-k found in the screen's top-C, for each C of
        ``candidate_grid``. The cascade is exact only as far as this recall
        reaches; pick the smallest C with recall 1.0, with a margin.
        ``screen`` is ``'additive'`` or ``'token0'``."""
        if screen not in ('additive', 'token0'):
            raise ValueError(f"screen must be 'additive' or 'token0', got "
                             f'{screen!r}')
        self._ensure_screen(screen)
        user_indices = np.asarray(user_indices, np.int32)
        grid = sorted({min(int(c), self.n_items) for c in candidate_grid})
        _, ei = self.top_k(user_indices, k, seen_mask, _exact=True)
        _, si = self.top_k(user_indices, grid[-1], seen_mask, _screen=screen)
        out = {}
        for cc in grid:
            hits = total = 0
            for b in range(len(ei)):
                exact = set(ei[b][ei[b] >= 0].tolist())
                if not exact:
                    continue
                scr = set(si[b, :cc][si[b, :cc] >= 0].tolist())
                hits += len(exact & scr)
                total += len(exact)
            out[cc] = hits / max(total, 1)
        return out

    def calibrate_funnel(self, user_indices: np.ndarray, k: int,
                         c1_grid=(1024, 2048, 4096),
                         c2_grid=(256, 512, 1024),
                         seen_mask: Optional[np.ndarray] = None
                         ) -> Dict[Tuple[int, int], float]:
        """Measured funnel recall on a user sample: the share of each
        user's exact top-k that survives the additive screen's top-C1 and
        then the token-0 screen's top-C2 among those survivors, for every
        (C1, C2) with C2 <= C1. One additive pass at max(c1_grid) and one
        token-0 pass over its survivors give the whole grid: the survivors
        of a smaller C1 are a prefix of the additive ranking. Bounded above
        by the additive screen's recall at C1."""
        self._ensure_screen('funnel')
        user_indices = np.asarray(user_indices, np.int32)
        c1s = sorted({min(int(c), self.n_items) for c in c1_grid})
        c2s = sorted({min(int(c), self.n_items) for c in c2_grid})
        D = c1s[-1]
        _, ei = self.top_k(user_indices, k, seen_mask, _exact=True)
        _, ai = self.top_k(user_indices, D, seen_mask, _screen='additive')
        s2 = self._screen_candidate_blocks(user_indices, ai)
        s2 = np.where(ai < 0, float(NEG_INF), s2)
        hits = {(c1, c2): 0 for c1 in c1s for c2 in c2s if c2 <= c1}
        total = 0
        for b in range(len(ei)):
            ks = ei[b][ei[b] >= 0]
            if not len(ks):
                continue
            total += len(ks)
            a_rank = np.full(self.n_items, D, np.int32)
            valid = ai[b] >= 0
            a_rank[ai[b][valid]] = np.flatnonzero(valid).astype(np.int32)
            ks_a = a_rank[ks]
            ks_t = np.where(ks_a < D, s2[b][np.minimum(ks_a, D - 1)],
                            float(NEG_INF))
            for c1 in c1s:
                # an item's rank among the C1 survivors = #{better screen}
                prefix = np.sort(s2[b, :c1])
                better = c1 - np.searchsorted(prefix, ks_t, side='right')
                alive = ks_a < c1
                for c2 in c2s:
                    if c2 <= c1:
                        hits[(c1, c2)] += int(np.sum(alive & (better < c2)))
        return {pair: h / max(total, 1) for pair, h in hits.items()}

    def auto_cascade(self, user_indices: np.ndarray, k: int,
                     sample_users: int = 512,
                     recall_target: float = 1.0,
                     safety: float = 2.0,
                     seen_mask: Optional[np.ndarray] = None,
                     max_candidate_frac: float = 0.125,
                     min_speedup: float = 1.05) -> Optional[Dict]:
        """Calibrate the cascade on a sample of ``user_indices`` and install
        the plan that ``top_k`` then routes through (requests with k' <= k).

        For each screen the smallest C of a grid capped at
        ``max_candidate_frac`` of the catalog whose measured recall reaches
        ``recall_target`` (the funnel: the cheapest (C1, C2), C1 up to a
        quarter of the catalog), times ``safety``. The additive screen is
        preferred unless token0 reaches the target at a C at least 4x
        smaller. Each qualifying plan is then timed against the exact
        ``top_k`` on the sample (one warm call each first), and the fastest
        is installed only if it measures at least ``min_speedup`` x the
        exact scan. Returns the plan, or None (nothing installed) when no
        screen reaches the target or none is fast enough. Re-run after
        changing the catalog or the model. ``self.auto_cascade_report``
        keeps what the call measured: the sample size, the grid, each
        screen's recalls, the funnel's, and the timed plans with the exact
        scan's seconds.
        """
        if self._head is None or self._head['fusion'] != 'attention':
            raise ValueError(
                'auto_cascade requires the fused attention head '
                f'(fusion_type={self.model.fusion_type!r})')
        user_indices = np.asarray(user_indices, np.int32)
        if len(user_indices) > sample_users:
            pos = np.random.default_rng(0).choice(
                len(user_indices), size=sample_users, replace=False)
            sample = user_indices[pos]
            sample_mask = None if seen_mask is None else seen_mask[pos]
        else:
            sample, sample_mask = user_indices, seen_mask
        c_cap = max(int(self.n_items * max_candidate_frac), 1)
        grid = [c for c in (256, 512, 1024, 2048, 4096, 8192)
                if c <= c_cap] or [c_cap]
        report = self.auto_cascade_report = {
            'sample_users': len(sample), 'grid': grid, 'recall': {},
            'funnel_recall': None, 'plans': [], 'exact_seconds': None}
        chosen = {}
        additive_cheap = False
        for tier in ('additive', 'token0'):
            rec = report['recall'][tier] = self.calibrate_cascade(
                sample, k, candidate_grid=grid, seen_mask=sample_mask,
                screen=tier)
            ok = [c for c, r in sorted(rec.items()) if r >= recall_target]
            if ok:
                chosen[tier] = (ok[0], rec[ok[0]])
            if tier == 'additive' and ok and ok[0] <= grid[0] * 4:
                additive_cheap = True
                break  # the additive screen is cheap enough already
        funnel = None
        if not additive_cheap:
            # The funnel's survivors see only the candidate screen, not the
            # rescore, so C1 may reach a quarter of the catalog.
            c1_max = max(self.n_items // 4, 1)
            c1_grid = [c for c in (1024, 2048, 4096, 8192, 16384)
                       if c <= c1_max] or [c1_max]
            rec_f = report['funnel_recall'] = self.calibrate_funnel(
                sample, k, c1_grid=c1_grid, c2_grid=grid,
                seen_mask=sample_mask)
            ok_f = [p for p, r in rec_f.items() if r >= recall_target]
            if ok_f:
                # the candidate screen's cost is linear in C1, the
                # rescore's per pair ~4x the candidate screen's
                c1, c2 = min(ok_f, key=lambda p: p[0] + 4 * p[1])
                funnel = (c1, c2, rec_f[(c1, c2)])
        if not chosen and funnel is None:
            print(f'auto_cascade: no screen reached recall '
                  f'>={recall_target} within C<={grid[-1]} on the '
                  f'{len(sample)}-user sample; keeping the exact full '
                  f'scan.', file=sys.stderr)
            self._cascade_plan = None
            return None
        plans = []
        if chosen:
            tier = ('additive' if 'additive' in chosen
                    and ('token0' not in chosen
                         or chosen['token0'][0] * 4 > chosen['additive'][0])
                    else 'token0')
            c0, recall = chosen[tier]
            plans.append({'screen': tier,
                          'n_candidates': min(int(c0 * safety),
                                              self.n_items),
                          'calibrated_c': c0, 'recall': recall})
        if funnel is not None:
            c1, c2, rec = funnel
            c1s = min(int(c1 * safety), self.n_items)
            plans.append({'screen': 'funnel',
                          'n_candidates': min(int(c2 * safety), c1s),
                          'c1': c1s, 'calibrated_c': c2,
                          'calibrated_c1': c1, 'recall': rec})
        # The speed gate: both calls return numpy, so the host clock waits
        # for the card. Under a mesh every rank takes the slowest rank's
        # times, so that all install the same plan.
        self.top_k(sample, k, seen_mask=sample_mask, _exact=True)
        t0 = time.perf_counter()
        self.top_k(sample, k, seen_mask=sample_mask, _exact=True)
        t_exact = report['exact_seconds'] = self._agreed(
            time.perf_counter() - t0)
        report['plans'] = plans
        for p in plans:
            kw = dict(n_candidates=p['n_candidates'], screen=p['screen'],
                      seen_mask=sample_mask, funnel_c1=p.get('c1'),
                      _calibrated=True)
            self.top_k_cascade(sample, k, **kw)
            t0 = time.perf_counter()
            self.top_k_cascade(sample, k, **kw)
            p['measured_speedup'] = round(
                t_exact / max(self._agreed(time.perf_counter() - t0), 1e-9),
                3)
        best = max(plans, key=lambda p: p['measured_speedup'])
        if best['measured_speedup'] < min_speedup:
            print(f"auto_cascade: screen={best['screen']} "
                  f"C={best['n_candidates']} reaches recall "
                  f"{best['recall']:.4f} but measured only "
                  f"{best['measured_speedup']:.2f}x the exact scan on the "
                  f'{len(sample)}-user sample; keeping the exact full '
                  f'scan.', file=sys.stderr)
            self._cascade_plan = None
            return None
        self._cascade_plan = dict(best, k=k, sample_users=len(sample))
        c1_note = f" C1={best['c1']}" if best['screen'] == 'funnel' else ''
        print(f"auto_cascade: screen={best['screen']} "
              f"C={best['n_candidates']}{c1_note} (calibrated "
              f"recall@{best['calibrated_c']}={best['recall']:.4f} at k={k} "
              f'on {len(sample)} users, safety x{safety:g}, measured '
              f"{best['measured_speedup']:.2f}x the exact scan); top_k now "
              f'routes through the cascade.', file=sys.stderr)
        return dict(self._cascade_plan)

    def _agreed(self, seconds: float) -> float:
        """The slowest rank's ``seconds`` under a mesh (else ``seconds``)."""
        if self.mesh is None:
            return seconds
        return agree_max(self.mesh, seconds, self.device)

    def disable_cascade(self) -> None:
        """Drop an installed ``auto_cascade`` plan: ``top_k`` returns to the
        exact full scan."""
        self._cascade_plan = None
