#!/usr/bin/env python3
"""Where a train step's time goes: the port's frozen train path on one CUDA
card at ``chip_smoke.py``'s train phase (the JAX package's training profile
geometry: 16 batches of 32,768 an epoch, bf16, dropout 0.1, AdamW).

    python3 scripts/torch_train_profile.py

Runs a warm-up epoch, times one epoch by the host clock (ms a step), then
profiles one more with ``torch.profiler`` and prints one JSON line: the
device time a step summed over the kernels, the device's idle share of the
unprofiled step (1 - device time / step time), the kernel launches a step,
and the device time by kind of kernel (elementwise, reductions, matrix
products, gathers and scatters (the embeddings' backward among them),
sorts, concatenations), with the card's ``nvidia-smi`` name
and power limit. The profiler's own host cost lengthens the profiled epoch,
so its wall time is not the step time. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# kind of kernel by a word of its name, first match
KINDS = (('matrix products', ('gemm', 'gemv', 'nvjet', 'cutlass',
                               'splitKreduce')),
         ('sorts', ('RadixSort', 'Unique', 'cub::')),
         ('concatenations', ('CatArray',)),
         ('gathers and scatters', ('gather', 'scatter', 'index', 'embedding',
                                   'grad_weight', 'segment')),
         ('reductions', ('reduce_kernel', 'norm')),
         ('elementwise', ('elementwise',)))


def kind_of(name: str) -> str:
    for kind, words in KINDS:
        if any(w in name for w in words):
            return kind
    return 'other'


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_train_profile: no CUDA device', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pixelrec_multimodal_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_step_fns,
    )
    from torch.profiler import ProfilerActivity, profile
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    tables, batches = cs.train_data(
        torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    model = cs.train_model(dev)
    state = init_train_state(model, build_optimizer(
        'adamw', cs.TRAIN_LR, cs.TRAIN_WD, gradient_clip=cs.TRAIN_CLIP))
    _, _, train_epoch, _ = make_step_fns(model, tables, use_contrastive=False,
                                         return_epoch_fns=True)
    drop = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    state, _ = train_epoch(state, batches, drop)  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    state, _ = train_epoch(state, batches, drop)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / cs.TRAIN_BATCHES * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = train_epoch(state, batches, drop)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'trace.json'
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())['traceEvents']
    kernels = [e for e in events
               if e.get('ph') == 'X' and e.get('cat') == 'kernel']
    if not kernels:
        raise RuntimeError('the profiler recorded no kernel on the card')
    by_kind = collections.Counter()
    for e in kernels:
        by_kind[kind_of(e['name'])] += e['dur']
    n = cs.TRAIN_BATCHES
    device_ms = sum(e['dur'] for e in kernels) / n / 1e3
    print(json.dumps({
        'what': 'train_profile', 'batch': cs.TRAIN_BATCH, 'steps': n,
        'step_ms': step_ms, 'device_ms_per_step': device_ms,
        'idle_share': 1.0 - device_ms / step_ms,
        'kernels_per_step': len(kernels) / n,
        'device_ms_per_step_by_kind': {
            k: v / n / 1e3 for k, v in by_kind.most_common()},
        'nvidia_smi': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
