#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/torch_kernel_bench.py

1. ``layers``: the pairwise kernel at the flagship block (256 users x 8,192
   items, relu, sigmoid, random weights from a seed) with the chain cut
   after the assembly (h1 512 -> 1), after the first hidden layer
   (512 -> 256 -> 1) and whole (512 -> 256 -> 128 -> 1). The differences
   between the three times are the cost of each hidden layer. CUDA-event
   timing, mean of 20 launches after a warm-up.
2. ``profile``: one ``CatalogScorer.top_k`` call at bench.py's geometry
   (chip_smoke.py's flagship model, 8,192 users, 65,536 items, k=50) under
   ``torch.profiler``: device time by kernel name, the union of device
   busy intervals, and the device's idle share of the call's wall time.

Prints one JSON line per measurement, the card's ``nvidia-smi`` name and
power limit first. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    N_MODEL_USERS,
    N_USERS,
    SEED,
    TOP_K,
    build_flagship,
    cuda_ms,
    random_head,
)

B, C = 256, 8192
CHAINS = ((512,), (512, 256), (512, 256, 128))


def emit(what: str, **fields):
    print(json.dumps({'what': what, **fields}), flush=True)


def time_layers(dev):
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import pairwise_scores
    gen = torch.Generator().manual_seed(SEED + 3)
    uf = torch.randn(B, 512, generator=gen).to(dev)
    itf = torch.randn(C, 512, generator=gen).to(dev)
    for widths in CHAINS:
        head = random_head(widths, 'relu', 'sigmoid', gen, dev)
        mma = sum(2 * k * n for k, n in zip(widths[:-1], widths[1:]))
        with torch.no_grad():
            ms = cuda_ms(lambda: pairwise_scores(head, uf, itf), reps=20)
        emit('layers', widths=list(widths), B=B, C=C, ms=ms,
             mma_tflops=B * C * mma / (ms * 1e-3) / 1e12)


def profile_top_k(dev):
    from torch.profiler import ProfilerActivity, profile

    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    model, store = build_flagship()
    scorer = CatalogScorer(model, store)
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    scorer.top_k(users, TOP_K)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.top_k(users, TOP_K)  # ends in a device-to-host copy
        wall_s = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(float)
    spans = []
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -float('inf')
    for s, t in sorted(spans):  # union of busy intervals
        if t > end:
            busy_us += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit('profile', users=N_USERS, items=scorer.n_items, k=TOP_K,
         item_chunk=scorer.item_chunk, user_chunk=scorer.user_chunk,
         wall_ms=wall_s * 1e3, device_events=len(device),
         device_busy_ms=busy_us / 1e3,
         idle_share=1 - busy_us / 1e3 / (wall_s * 1e3),
         device_ms_by_name=[[n[:80], ms] for n, ms in top])


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_kernel_bench: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    emit('card', nvidia_smi=smi, torch=torch.__version__)
    dev = torch.device('cuda')
    time_layers(dev)
    profile_top_k(dev)
    return 0


if __name__ == '__main__':
    sys.exit(main())
