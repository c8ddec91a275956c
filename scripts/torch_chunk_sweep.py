#!/usr/bin/env python3
"""Chunk-size sweep of the PyTorch port's CatalogScorer on one CUDA card.

    python3 scripts/torch_chunk_sweep.py

Times ``top_k`` (8,192 users, k=50, 65,536 items: bench.py's geometry and
chip_smoke.py's flagship model) for each (item_chunk, user_chunk) pair:
one warm-up, then the median of 3 runs by the host clock (``top_k`` ends
in a device-to-host copy, so the work is done when it returns). Prints one
JSON line per pair; the defaults in inference/scorer.py come from it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import N_MODEL_USERS, N_USERS, SEED, TOP_K, build_flagship  # noqa: E402
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer  # noqa: E402

ITEM_CHUNKS = (4096, 8192, 16384, 65536)
USER_CHUNKS = (1024, 8192)


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps({'card': smi}), flush=True)
    model, store = build_flagship()
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    for item_chunk in ITEM_CHUNKS:
        for user_chunk in USER_CHUNKS:
            scorer = CatalogScorer(model, store, item_chunk=item_chunk,
                                   user_chunk=user_chunk)
            scorer.top_k(users, TOP_K)
            times = []
            for _ in range(3):
                t0 = time.time()
                scorer.top_k(users, TOP_K)
                times.append(time.time() - t0)
            med = statistics.median(times)
            print(json.dumps({
                'item_chunk': item_chunk, 'user_chunk': user_chunk,
                'seconds': times, 'pairs_per_sec': N_USERS * 65536 / med,
                'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}),
                flush=True)
            del scorer
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()


if __name__ == '__main__':
    main()
