#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 scripts/torch_kernel_bench.py [layers] [profile] [rescore] [int8]

1. ``layers``: each pair-scoring kernel (K1 concat, K2 exact gated, K3
   factored gated with M = 6 modalities) at the flagship block (256 users x
   8,192 items, relu, sigmoid, random weights from a seed) with the chain
   cut after the assembly (h1 512 -> 1), after the first hidden layer
   (512 -> 256 -> 1) and whole (512 -> 256 -> 128 -> 1). The differences
   between the three times are the cost of each hidden layer; each
   kernel's chain (whole less the cut after the assembly) is printed with
   its ms and TFLOP/s and the chain it runs (wgmma or mma.sync). The attention
   kernels (K4 stream, K5 gram, K6 token-0 screen; d 64, 4 heads, Mi 5)
   the same way: cut after the assembly (the last dot on the fused vector,
   64 -> 1), after w1 (64 -> 512 -> 1) and whole, then each kernel's chain
   (whole less the cut after the assembly: the chain's products, epilogues
   and last dot) with its ms and TFLOP/s and the chain it runs (wgmma or
   mma.sync). CUDA-event timing, mean of 20 launches after a warm-up.
2. ``profile``: one ``CatalogScorer.top_k`` call at bench.py's geometry
   (chip_smoke.py's flagship model, 8,192 users, 65,536 items, k=50) under
   ``torch.profiler``, for the concat model, for its gated twin in each
   variant and for its attention twin in each variant: device time by
   kernel name, the union of device busy intervals, and the device's idle
   share of the call's wall time. Then one ``top_k_cascade`` call of the
   attention twin per tier at the tier defaults (8,192 users), its device
   time split by kernel name into the screen kernel, the
   merge (top-k selection and its copies), the gathers of candidate rows
   and the rest (the rescore's and the candidate screen's products,
   softmax, LayerNorm and chain), and the host (wall less device busy).
3. ``rescore``: the cascade's exact rescore (``_attention_candidates``)
   of 1,024 users x 1,024 candidates and the funnel's candidate screen of
   256 users x 4,096, at user sub-blocks sized by gathered-row budgets of
   128 MiB to 4 GiB (``_CANDIDATE_BLOCK_BYTES``): seconds, pairs/s,
   gathered bytes/s and peak device memory.
4. ``int8``: the int8 modes K1q, K2q, K3q at the flagship block as in
   ``layers`` (the int8 mode takes at least one hidden layer: the chain cut
   after the first hidden layer, then whole), beside their bf16 modes on
   the same weights; then one profiled ``top_k`` call per int8 cell
   (``precision='int8!'``: concat, gated exact, gated factored) as in
   ``profile``.

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
    assembly_only_chain,
    build_flagship,
    cuda_ms,
    random_attention_head,
    random_attention_rows,
    random_gated_rows,
    random_head,
)

B, C = 256, 8192
CHAINS = ((512,), (512, 256), (512, 256, 128))


def emit(what: str, **fields):
    print(json.dumps({'what': what, **fields}), flush=True)


def time_layers(dev):
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        chain_kind,
        kernel_chain,
        pairwise_scores,
        pairwise_scores_gated,
        pairwise_scores_gated_factored,
    )
    gen = torch.Generator().manual_seed(SEED + 3)
    h1 = CHAINS[0][0]
    uf = torch.randn(B, h1, generator=gen).to(dev)
    itf = torch.randn(C, h1, generator=gen).to(dev)
    times = defaultdict(dict)
    for widths in CHAINS:
        head = random_head(widths, 'relu', 'sigmoid', gen, dev,
                           n_item_mods=5)
        head['kernel'] = kernel_chain(head)  # built once, as a scorer's
        exact, factored = random_gated_rows(head, B, C, gen, dev)
        mma = sum(2 * k * n for k, n in zip(widths[:-1], widths[1:]))
        for kernel, fn, args in (('K1', pairwise_scores, (uf, itf)),
                                 ('K2', pairwise_scores_gated, exact),
                                 ('K3', pairwise_scores_gated_factored,
                                  factored)):
            with torch.no_grad():
                ms = cuda_ms(lambda: fn(head, *args), reps=20)
            emit('layers', kernel=kernel, widths=list(widths), B=B, C=C,
                 ms=ms, mma_tflops=B * C * mma / (ms * 1e-3) / 1e12)
            times[kernel][len(widths)] = (ms, mma)
    names = {'K1': 'pairwise_mlp', 'K2': 'gated_pairwise_mlp',
             'K3': 'gated_factored_mlp'}
    for kernel, by_depth in times.items():
        (whole, mma), (cut, _) = by_depth[len(CHAINS[-1])], by_depth[1]
        emit('chain', kernel=kernel, widths=list(CHAINS[-1]), B=B, C=C,
             chain=chain_kind(names[kernel], 128, CHAINS[-1]),
             ms=whole - cut,
             tflops=B * C * mma / ((whole - cut) * 1e-3) / 1e12)


def time_attention_layers(dev):
    """K4, K5 and K6 at the flagship block, the chain cut after the
    assembly, after w1 and whole."""
    from pixelrec_multimodal_tpu_torch.ops.attention_cascade import (
        attention_screen_scores,
        compute_screen_tail,
    )
    from pixelrec_multimodal_tpu_torch.ops.attention_scorer import (
        attention_scores,
        attention_scores_gram,
    )
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        chain_kind,
        kernel_chain,
    )
    gen = torch.Generator().manual_seed(SEED + 4)
    d, heads = 64, 4
    times = defaultdict(dict)
    for widths in ((), CHAINS[0], CHAINS[-1]):
        head = random_attention_head(d, heads, widths or CHAINS[0], 'relu',
                                     'sigmoid', gen, dev)
        if not widths:  # no hidden layer: the last dot on the fused vector
            head['kernel'] = assembly_only_chain(d, gen, dev)
        else:  # built once, as a scorer's
            head['kernel'] = kernel_chain(head)
        users, items = random_attention_rows(head, B, C, gen, dev, True)
        tail = compute_screen_tail(head, items)
        chain = (d,) + tuple(widths)
        mma = sum(2 * k * n for k, n in zip(chain[:-1], chain[1:]))
        for kernel, fn, nu in (
                ('K4', attention_scores, 5), ('K5', attention_scores_gram, 6),
                ('K6', lambda h, u, it: attention_screen_scores(h, u, it,
                                                                tail), 5)):
            with torch.no_grad():
                ms = cuda_ms(lambda: fn(head, users[:nu], items[:nu + 1]),
                             reps=20)
            emit('layers', kernel=kernel, widths=list(chain), B=B, C=C,
                 ms=ms, mma_tflops=B * C * mma / (ms * 1e-3) / 1e12)
            times[kernel][len(widths)] = (ms, mma)
    names = {'K4': 'attention_mlp', 'K5': 'attention_gram_mlp',
             'K6': 'attention_screen_mlp'}
    for kernel, by_depth in times.items():
        (whole, mma), (cut, _) = by_depth[len(CHAINS[-1])], by_depth[0]
        emit('chain', kernel=kernel, widths=[d, *CHAINS[-1]], B=B, C=C,
             chain=chain_kind(names[kernel], 128), ms=whole - cut,
             tflops=B * C * mma / ((whole - cut) * 1e-3) / 1e12)


def time_layers_int8(dev):
    """K1q, K2q and K3q against K1, K2 and K3 on the same weights at the
    flagship block, the chain cut after the first hidden layer and whole."""
    from chip_smoke import int8_head
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores,
        pairwise_scores_gated,
        pairwise_scores_gated_factored,
    )
    gen = torch.Generator().manual_seed(SEED + 6)
    h1 = CHAINS[0][0]
    uf = torch.randn(B, h1, generator=gen).to(dev)
    itf = torch.randn(C, h1, generator=gen).to(dev)
    for widths in CHAINS[1:]:
        head, qhead = int8_head(widths, 'relu', 'sigmoid', gen, dev,
                                n_item_mods=5)
        exact, factored = random_gated_rows(head, B, C, gen, dev)
        mma = sum(2 * k * n for k, n in zip(widths[:-1], widths[1:]))
        for kernel, fn, args in (('K1', pairwise_scores, (uf, itf)),
                                 ('K2', pairwise_scores_gated, exact),
                                 ('K3', pairwise_scores_gated_factored,
                                  factored)):
            with torch.no_grad():
                ms = {mode: cuda_ms(lambda: fn(h, *args), reps=20)
                      for mode, h in (('bf16', head), ('int8', qhead))}
            emit('layers_int8', kernel=kernel + 'q', widths=list(widths),
                 B=B, C=C, ms=ms['int8'], bf16_ms=ms['bf16'],
                 int8_over_bf16=ms['int8'] / ms['bf16'],
                 int8_tops=B * C * mma / (ms['int8'] * 1e-3) / 1e12)


def device_time(prof, wall_s):
    """(device ms by kernel name, busy ms: the union of the device
    intervals, idle share of ``wall_s``) of a profiled window."""
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
    return by_name, busy_us / 1e3, 1 - busy_us / 1e3 / (wall_s * 1e3)


def profile_top_k(dev, fusion_type='concatenate', gated_variant=None,
                  attention_variant=None, precision='bf16'):
    from torch.profiler import ProfilerActivity, profile

    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    model, store = build_flagship(fusion_type=fusion_type)
    scorer = CatalogScorer(model, store, gated_variant=gated_variant,
                           attention_variant=attention_variant,
                           precision=precision)
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    scorer.top_k(users, TOP_K)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.top_k(users, TOP_K)  # ends in a device-to-host copy
        wall_s = time.perf_counter() - t0
    by_name, busy_ms, idle = device_time(prof, wall_s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit('profile', fusion_type=fusion_type, precision=scorer.precision,
         gated_variant=scorer.gated_variant,
         attention_variant=scorer.attention_variant, users=N_USERS,
         items=scorer.n_items, k=TOP_K,
         item_chunk=scorer.item_chunk, user_chunk=scorer.user_chunk,
         wall_ms=wall_s * 1e3, device_busy_ms=busy_ms, idle_share=idle,
         device_ms_by_name=[[n[:80], ms] for n, ms in top])
    return scorer if fusion_type == 'attention' else None


# Device kernels of a cascade call by part, from their names: the screen
# kernels (K6, K1), the merge (torch.topk's kernels and the copies of its
# concatenations), the gathers of candidate rows (indexing kernels); the
# rest is the rescore's and the candidate screen's math.
PARTS = (('screen', ('screen_kernel', 'pairwise_mlp_kernel')),
         ('merge', ('topk', 'sort', 'Sort', 'radix', 'CatArray')),
         ('gathers', ('index', 'Index', 'gather')))


def part_of(name: str) -> str:
    for part, keys in PARTS:
        if any(k in name for k in keys):
            return part
    return 'rescore'


def profile_cascade(dev, scorer):
    """One top_k_cascade call per tier at the tier defaults, its device
    time split into PARTS and the host's share."""
    from torch.profiler import ProfilerActivity, profile
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    for tier in ('token0', 'additive', 'funnel'):
        scorer.top_k_cascade(users, TOP_K, screen=tier)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            scorer.top_k_cascade(users, TOP_K, screen=tier)
            wall_s = time.perf_counter() - t0
        by_name, busy_ms, idle = device_time(prof, wall_s)
        parts = defaultdict(float)
        for name, ms in by_name.items():
            parts[part_of(name)] += ms
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        emit('profile_cascade', screen=tier, users=N_USERS,
             items=scorer.n_items, k=TOP_K, wall_ms=wall_s * 1e3,
             device_busy_ms=busy_ms, idle_share=idle,
             host_ms=wall_s * 1e3 - busy_ms, device_ms_by_part=dict(parts),
             device_ms_by_name=[[n[:80], ms] for n, ms in top])


def time_rescore(dev, scorer):
    """The rescore and the candidate screen at gathered-row budgets per
    user sub-block."""
    from pixelrec_multimodal_tpu_torch.inference import scorer as sc
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    scorer._ensure_screen('token0')
    saved = sc._CANDIDATE_BLOCK_BYTES
    for path, n_users, n_cand, fn, tables in (
            ('rescore', 1024, 1024, scorer._attention_candidates,
             scorer._item_fast[:4]),
            ('candidate_screen', 256, 4096, scorer._screen_candidates,
             (scorer._item_fast[2], scorer._item_fast[3],
              scorer._screen_tail))):
        _, cands = scorer.top_k(users[:n_users], n_cand, _screen='token0')
        row_bytes = sum(t[0].numel() * t.element_size() for t in tables)
        with torch.no_grad():
            emb = scorer.model.user_tower(
                torch.from_numpy(users[:n_users].astype(np.int64)).to(dev))
            ct = torch.from_numpy(cands.astype(np.int64)).to(dev)
            for budget in (1 << 27, 1 << 28, 1 << 29, 1 << 30, 1 << 31,
                           1 << 32):
                sc._CANDIDATE_BLOCK_BYTES = budget
                fn(emb, ct)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                fn(emb, ct)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                emit('rescore', path=path, users=n_users, candidates=n_cand,
                     budget_bytes=budget, users_per_block=max(
                         1, budget // (n_cand * row_bytes)),
                     seconds=sec, pairs_per_sec=n_users * n_cand / sec,
                     gathered_bytes_per_pair=row_bytes,
                     gathered_bytes_per_sec=n_users * n_cand * row_bytes
                     / sec, peak_extra_bytes=torch.cuda.max_memory_allocated()
                     - base)
    sc._CANDIDATE_BLOCK_BYTES = saved


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_kernel_bench: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    emit('card', nvidia_smi=smi, torch=torch.__version__)
    dev = torch.device('cuda')
    parts = set(sys.argv[1:]) or {'layers', 'profile', 'rescore', 'int8'}
    if 'layers' in parts:
        time_layers(dev)
        time_attention_layers(dev)
    stream = None
    if 'profile' in parts:
        profile_top_k(dev)
        for variant in ('exact', 'factored'):
            profile_top_k(dev, 'gated', variant)
        profile_top_k(dev, 'attention', attention_variant='gram')
        stream = profile_top_k(dev, 'attention', attention_variant='stream')
        profile_cascade(dev, stream)
    if 'rescore' in parts:
        if stream is None:
            from pixelrec_multimodal_tpu_torch.inference.scorer import (
                CatalogScorer,
            )
            stream = CatalogScorer(*build_flagship(fusion_type='attention'),
                                   attention_variant='stream')
        time_rescore(dev, stream)
    if 'int8' in parts:
        time_layers_int8(dev)
        profile_top_k(dev, precision='int8!')
        for variant in ('exact', 'factored'):
            profile_top_k(dev, 'gated', variant, precision='int8!')
    return 0


if __name__ == '__main__':
    sys.exit(main())
