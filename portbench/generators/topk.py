"""The top-K traffic generator: one client in a closed loop, each request
``CatalogScorer.top_k(users, k, seen_mask)`` of the port, as its generate
job (``filter_seen``) or its full-catalog evaluation (no mask) makes it.

Set-up makes the weights, the item features and the users' histories from
the seed, loads the weights into the port's model by state-dict name,
hands the features to the port's ``ItemFeatureStore`` and builds the
``CatalogScorer`` (its item tables), then serves warm-up requests of the
window's own shapes. Each request draws its users from the seed; with the
seen filter the client sets its users' history bits in one reused
``[users, n_items]`` bool buffer and clears them before the next request.

The check, once the window has closed: every request's rows are well
formed (k distinct valid items, finite non-increasing scores) and serve no
seen item (``bad_rows``); then, with the program freed, the plain
reference scores every item in float32 for a sample of the served rows
drawn from the seed (with the longest history among them), and on the
logit scale, over the standard deviation of the reference's logits: the
widest gap by which a served item lies below the reference's k-th best
unseen item (``rank_gap``), the widest and the mean gap between a served
score and the reference's score of that item (``score_gap``,
``score_err``), and the share of served items outside the reference's
top k (``miss_share``).

Options (for ``calibrate.py``, never in the benchmark's runs): ``control``
``'fp8'`` puts the plain reference, every product computed in float8
(``float8_product``), in the scorer's place; ``precision`` reaches the
port's scorer (``'int8!'``, its own int8 path).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import inputs
from ..reference.model import Model, TopK, exact, float8_product
from .common import Phases, free_device, port_model


class Traffic:
    unit = 'pairs'

    def __init__(self, cell, seed: int, device,
                 options: Optional[dict] = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        self.options = options or {}
        self.k = self.cfg['top_k']
        self.n_users, self.n_items = self.cfg['n_users'], self.cfg['n_items']
        self.per_request = self.traffic['users_per_request']
        self.filter_seen = self.traffic['filter_seen']
        self.results: List[tuple] = []
        self._set = None

    # ------------------------------------------------------------- set-up
    def setup(self):
        from pixelrec_multimodal_tpu_torch.data.feature_store import (
            ItemFeatureStore,
        )
        from pixelrec_multimodal_tpu_torch.inference.scorer import (
            CatalogScorer,
        )
        cfg, dev = self.cfg, self.device
        self.phases = lap = Phases()
        self.weights = inputs.make_weights(cfg, self.seed, dev)
        self.feats = inputs.make_features(cfg, self.seed, dev)
        lap.lap('inputs')
        model = port_model(cfg, self.weights, dev)
        lap.lap('port_model')
        store = ItemFeatureStore(self.n_items,
                                 np.arange(self.n_items).astype(str))
        host = self.feats['packed'].cpu().numpy()
        off = 0
        for name, width in inputs.feature_widths(cfg).items():
            table = 'numerical' if name == 'numerical' else f'{name}_emb'
            store.tables[table] = host[:, off:off + width]
            off += width
        store.tables['tag_idx'] = self.feats['tag'].cpu().numpy()
        lap.lap('feature_store')
        if self.options.get('control') == 'fp8':
            # the control: the reference in float8 in the scorer's place
            self.scorer = TopK(Model(cfg, self.weights, float8_product),
                               self.feats)
        else:
            self.scorer = CatalogScorer(
                model, store,
                precision=self.options.get('precision', 'bf16'), device=dev)
        lap.lap('scorer')
        self.mask = None
        if self.filter_seen:
            self.indptr, self.items = inputs.make_histories(
                cfg, self.traffic['history'], self.seed, dev)
            self.mask = np.zeros((self.per_request, self.n_items), bool)
        lap.lap('histories')
        self.stream = inputs.request_users(self.n_users, self.per_request,
                                           self.seed)
        for _ in range(self.traffic['warmup_requests']):
            self.prepare()
            self.call()
        self.results.clear()
        lap.lap('warmup')

    # ------------------------------------------------------------- window
    def prepare(self):
        """The client's work before a request: its users, and their bits of
        the seen mask (the last request's cleared)."""
        self.users = next(self.stream)
        if self.mask is not None:
            if self._set is not None:
                self.mask[self._set] = False
            self._set = inputs.rows_of(self.indptr, self.items, self.users)
            self.mask[self._set] = True

    def call(self) -> float:
        v, i = self.scorer.top_k(self.users, self.k, seen_mask=self.mask)
        self.results.append((self.users, v, i))
        return float(len(self.users) * self.n_items)

    # -------------------------------------------------------------- check
    def bad_rows(self) -> List[int]:
        """Rows of each request that are not well formed or serve a seen
        item."""
        out = []
        for users, v, i in self.results:
            bad = np.zeros(len(users), bool)
            if v.shape != (len(users), self.k) or i.shape != v.shape:
                out.append(len(users))
                continue
            valid = (i >= 0) & (i < self.n_items)
            bad |= ~valid.all(axis=1)
            bad |= ~np.isfinite(v).all(axis=1)
            bad |= (np.diff(v, axis=1) > 0).any(axis=1)
            srt = np.sort(i, axis=1)
            bad |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
            if self.filter_seen:
                rows, cols = inputs.rows_of(self.indptr, self.items, users)
                self.mask[:] = False
                self.mask[rows, cols] = True
                hit = np.take_along_axis(self.mask, np.where(valid, i, 0),
                                         axis=1) & valid
                bad |= hit.any(axis=1)
            out.append(int(bad.sum()))
        return out

    def sample(self) -> np.ndarray:
        """(request, row) pairs to hold against the reference, drawn from
        the seed; with the seen filter, the row of the longest history
        served among them."""
        n = self.traffic['check_rows']
        pairs = [(r, j) for r, (u, _, _) in enumerate(self.results)
                 for j in range(len(u))]
        pick = inputs.rng(self.seed, 'sample').choice(
            len(pairs), size=min(n, len(pairs)), replace=False)
        chosen = [pairs[p] for p in pick]
        if self.filter_seen:
            lengths = [self.indptr[u + 1] - self.indptr[u]
                       for u, _, _ in self.results]
            r = int(np.argmax([ln.max() for ln in lengths]))
            longest = (r, int(np.argmax(lengths[r])))
            if longest not in chosen:
                chosen[-1] = longest
        return np.array(chosen)

    def release(self):
        """Free the program's state before the reference runs."""
        del self.scorer
        free_device(self.device)

    def readings(self) -> Dict[str, float]:
        """The numbers the check compares (module docstring)."""
        bad = self.bad_rows()
        chosen = self.sample()
        users = np.array([self.results[r][0][j] for r, j in chosen])
        served_v = np.stack([self.results[r][1][j] for r, j in chosen])
        served_i = np.stack([self.results[r][2][j] for r, j in chosen])
        self.release()
        idx = torch.from_numpy(np.clip(served_i, 0, self.n_items - 1)
                               .astype(np.int64)).to(self.device)
        served = torch.from_numpy(served_v).to(self.device).double()
        if self.cfg['model']['final_activation'] == 'sigmoid':
            served = torch.logit(served)
        out = {'bad_rows': float(sum(bad)), 'attempted': len(self.results),
               'failed': sum(1 for b in bad if b),
               'rows_compared': len(chosen)}
        with exact():
            ref = Model(self.cfg, self.weights)
            logits = ref.score_users(torch.from_numpy(users).to(self.device),
                                     ref.catalog(self.feats),
                                     final=False).double()
        if self.filter_seen:
            rows, cols = inputs.rows_of(self.indptr, self.items, users)
            logits[torch.from_numpy(rows).to(self.device),
                   torch.from_numpy(cols.astype(np.int64)).to(self.device)] = \
                float('-inf')
        # gaps on the logit scale, over the spread of the reference's logits
        scale = logits[torch.isfinite(logits)].std()
        top = torch.topk(logits, self.k, dim=1)
        ref_served = torch.gather(logits, 1, idx)
        err = (served - ref_served).abs() / scale
        hits = (idx[:, :, None] == top.indices[:, None, :]).any(dim=2)
        out.update(
            rank_gap=float(((top.values[:, -1:] - ref_served) / scale)
                           .clamp(min=0).max()),
            score_gap=float(err.max()), score_err=float(err.mean()),
            miss_share=float(1.0 - hits.float().mean()))
        return out
