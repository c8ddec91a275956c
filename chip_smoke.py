#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pixelrec_multimodal_tpu_torch/ops/
csrc`` into ``build/kernels/``, holds each kernel against its plain PyTorch
version on the card, drives the main path (full-catalog top-K serving of
the flagship concatenate-fusion model at bench.py's geometry, random
weights from a seed), checks what comes out against the plain version, and
times the kernel. Every phase prints one JSON line; any failure raises and
exits non-zero. The second-to-last line is the ``kernels`` JSON object and
the last line is ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result. It imports nothing of JAX.
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

sys.path.insert(0, str(Path(__file__).resolve().parent))

# bench.py's geometry: the flagship model and the served catalog.
N_ITEMS, N_USERS, N_MODEL_USERS, TOP_K = 65536, 8192, 4096, 50
EMB, VISION_DIM, LANG_DIM, NUM_FEAT, N_TAGS = 64, 2048, 384, 7, 64
HIDDEN = (512, 256, 128)
SEED = 0

# NVIDIA H100 SXM data sheet (dense): bf16 tensor-core rate, float32 rate
# outside the tensor cores, HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Kernel-vs-plain tolerance, relative to max(1, |score|): the kernel and
# pairwise_scores_plain(bfloat16) round at the same points and differ only
# in the order of the float32 sums; a hidden activation may then round to
# the neighbouring bf16 value (2**-8 relative), which moves a score by
# well under 2e-3 of its scale.
KERNEL_TOL = 2e-3
# Main path against the plain bf16 version at the full catalog: mean top-50
# overlap. The 50th and 51st of 65,536 scores can lie closer together than
# the kernel's rounding differences, so an item may swap at the boundary.
MIN_OVERLAP = 0.95


def emit(phase: str, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_flagship(seed: int = SEED, device='cuda'):
    """(model, store) at bench.py's geometry: random weights from ``seed``,
    BatchNorm with non-trivial running statistics, bf16 compute."""
    from pixelrec_multimodal_tpu_torch.data.feature_store import (
        ItemFeatureStore,
    )
    from pixelrec_multimodal_tpu_torch.models.multimodal import (
        MultimodalRecommender,
    )
    gen = torch.Generator().manual_seed(seed)
    model = MultimodalRecommender(
        n_users=N_MODEL_USERS, n_items=N_ITEMS, n_tags=N_TAGS,
        num_numerical_features=NUM_FEAT, embedding_dim=EMB,
        vision_feature_dim=VISION_DIM, language_feature_dim=LANG_DIM,
        use_contrastive=False, fusion_hidden_dims=HIDDEN,
        fusion_type='concatenate', use_batch_norm=True, dropout_rate=0.0,
        dtype=torch.bfloat16, generator=gen, device=device)
    with torch.no_grad():
        for i in range(len(HIDDEN)):
            bn = getattr(model.prediction_network, f'BatchNorm_{i}')
            n = bn.num_features
            bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            bn.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            bn.weight.copy_(torch.rand(n, generator=gen) + 0.5)
            bn.bias.copy_(torch.randn(n, generator=gen) * 0.1)
    rng = np.random.default_rng(seed)
    store = ItemFeatureStore(N_ITEMS, np.arange(N_ITEMS).astype(str))
    store.tables['tag_idx'] = rng.integers(0, N_TAGS, N_ITEMS).astype(np.int32)
    store.tables['numerical'] = rng.standard_normal(
        (N_ITEMS, NUM_FEAT), dtype=np.float32)
    store.tables['vision_emb'] = rng.standard_normal(
        (N_ITEMS, VISION_DIM), dtype=np.float32)
    store.tables['language_emb'] = rng.standard_normal(
        (N_ITEMS, LANG_DIM), dtype=np.float32)
    return model, store


def pair_ops(head: dict, h1: int) -> tuple:
    """Operations per pair, split by the unit that runs them: (the hidden
    products, on the tensor cores; the assembly add + act + bf16 rounding
    over h1 and the one-column dot, outside them). Their sum is bench.py's
    formula, 329,472 at the flagship head."""
    hidden = head['layers'][:-1]
    return (sum(2 * w.shape[0] * w.shape[1] for w, _ in hidden),
            3 * h1 + 2 * head['layers'][-1][0].shape[0])


def random_head(widths, activation, final, gen, device):
    """A folded head of the given widths with random weights (the kernel
    check at widths other than the flagship's)."""
    layers = []
    for k, n in zip(widths[:-1], widths[1:]):
        layers.append(((torch.randn(k, n, generator=gen) / k ** 0.5),
                       torch.randn(n, generator=gen) * 0.05))
    w_last = torch.zeros(widths[-1], 128)
    w_last[:, 0] = torch.randn(widths[-1], generator=gen) / widths[-1] ** 0.5
    layers.append((w_last, torch.randn(128, generator=gen) * 0.1))
    return {'layers': [(w.to(device), b.to(device)) for w, b in layers],
            'activation': activation, 'final_activation': final,
            'b1': torch.zeros(widths[0], device=device), 'b1_folded': True}


def kernel_error(head, uf, itf) -> tuple:
    """(max |kernel - plain bf16|, tolerance) over a block."""
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        pairwise_scores,
        pairwise_scores_plain,
    )
    out = pairwise_scores(head, uf, itf)
    torch.cuda.synchronize()
    ref = torch.cat([pairwise_scores_plain(head, uf, itf[c:c + 2048],
                                           torch.bfloat16)
                     for c in range(0, itf.shape[0], 2048)], dim=1)
    if not torch.isfinite(out).all():
        raise AssertionError('kernel produced non-finite scores')
    err = (out - ref).abs().max().item()
    return err, KERNEL_TOL * max(1.0, ref.abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device (torch.cuda.is_available() is '
            'False); nothing was run')
        return 2
    from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.ops.pairwise_mlp import (
        ACTIVATIONS,
        compute_user_first,
        kernel_chain,
        pairwise_scores,
        pairwise_scores_plain,
    )
    from pixelrec_multimodal_tpu_torch.ops.topk import NEG_INF

    t_start = time.time()
    dev = torch.device('cuda')
    # ---- 1. card
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit('card', nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- 2. build every kernel source, one nvcc each, in parallel
    t0 = time.time()
    libs = _build.build(_build.all_sources())
    for lib in libs.values():
        log(lib.with_suffix('.log').read_text())
    emit('build', seconds=round(time.time() - t0, 3),
         libraries=[str(p.relative_to(_build.BUILD_DIR.parents[1]))
                    for p in libs.values()])

    # ---- set-up of the main path (catalog tables built on the card)
    t0 = time.time()
    model, store = build_flagship()
    scorer = CatalogScorer(model, store)
    torch.cuda.synchronize()
    head = scorer._head
    h1 = head['b1'].shape[0]
    item_first = scorer._item_fast[0]
    users = np.random.default_rng(SEED + 1).integers(
        0, N_MODEL_USERS, N_USERS).astype(np.int32)
    with torch.no_grad():
        user_first = compute_user_first(head, model.user_tower(
            torch.from_numpy(users.astype(np.int64)).to(dev)))
    emit('setup', seconds=round(time.time() - t0, 3),
         item_chunk=scorer.item_chunk, user_chunk=scorer.user_chunk,
         n_pad=scorer.n_pad, h1=h1)

    # ---- 3. kernel against its plain version
    t0 = time.time()
    with torch.no_grad():
        flag_err, flag_tol = kernel_error(head, user_first[:200],
                                          item_first[:8000])
        emit('kernel_vs_plain', widths='flagship', B=200, C=8000,
             max_abs_err=flag_err, tol=flag_tol)
        if not flag_err <= flag_tol:
            raise AssertionError(f'flagship kernel error {flag_err} > '
                                 f'{flag_tol}')
        gen = torch.Generator().manual_seed(SEED + 2)
        worst = 0.0
        for widths in ((48, 32, 16), (128, 256), (64,)):
            for act in ACTIVATIONS:
                for final in ('sigmoid', 'tanh', 'none'):
                    h = random_head(widths, act, final, gen, dev)
                    uf = torch.randn(37, widths[0], generator=gen).to(dev)
                    itf = torch.randn(301, widths[0], generator=gen).to(dev)
                    err, tol = kernel_error(h, uf, itf)
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise AssertionError(
                            f'kernel error {err} > {tol} at widths '
                            f'{widths}, {act}/{final}')
        emit('kernel_vs_plain', widths='small, every activation x final',
             combos=3 * len(ACTIVATIONS) * 3, worst_err_over_tol=worst,
             seconds=round(time.time() - t0, 3))

    # ---- 4. the main path: top_k for 8,192 users over 65,536 items
    scorer.top_k(users, TOP_K)  # warm-up
    pairwise_scores.launches = 0
    times = []
    for _ in range(3):
        t0 = time.time()
        v, i = scorer.top_k(users, TOP_K)
        times.append(time.time() - t0)
    launches = pairwise_scores.launches
    per_call = (-(-N_USERS // scorer.user_chunk)
                * (scorer.n_pad // scorer.item_chunk))
    if launches != 3 * per_call:
        raise AssertionError(f'kernel launches {launches} != expected '
                             f'{3 * per_call}')
    if v.shape != (N_USERS, TOP_K) or not np.isfinite(v).all() \
            or (i < 0).any() or (i >= N_ITEMS).any() \
            or (np.diff(v, axis=1) > 0).any():
        raise AssertionError('top_k output malformed')
    median = statistics.median(times)
    emit('main_path', users=N_USERS, items=N_ITEMS, k=TOP_K,
         seconds=times, median_seconds=median,
         pairs_per_sec=N_USERS * N_ITEMS / median,
         kernel_launches=launches, expected_launches=3 * per_call)

    # Output against the plain bf16 version over the full catalog, 64 users.
    with torch.no_grad():
        ref = torch.cat([pairwise_scores_plain(head, user_first[:64],
                                               item_first[c:c + 4096],
                                               torch.bfloat16)
                         for c in range(0, N_ITEMS, 4096)], dim=1)
        ref_v, ref_i = torch.topk(ref, TOP_K, dim=1)
        f32 = torch.cat([pairwise_scores_plain(head, user_first[:64],
                                               item_first[c:c + 4096])
                         for c in range(0, N_ITEMS, 4096)], dim=1)
        f32_i = torch.topk(f32, TOP_K, dim=1)[1].cpu().numpy()
    ref_v, ref_i = ref_v.cpu().numpy(), ref_i.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / TOP_K
                             for a, b in zip(i[:64], ref_i)]))
    overlap_f32 = float(np.mean([len(set(a) & set(b)) / TOP_K
                                 for a, b in zip(i[:64], f32_i)]))
    value_err = float(np.abs(v[:64] - ref_v).max())
    full_err = float(np.abs(scorer.score_full(users[:64])
                            - ref.cpu().numpy()).max())
    emit('main_path_vs_plain', users=64, items=N_ITEMS,
         top50_overlap_vs_plain_bf16=overlap, min_overlap=MIN_OVERLAP,
         top50_value_max_abs_diff=value_err,
         score_full_max_abs_diff=full_err, tol=KERNEL_TOL,
         top50_overlap_vs_plain_f32=overlap_f32)
    if overlap < MIN_OVERLAP or not value_err <= KERNEL_TOL \
            or not full_err <= KERNEL_TOL:
        raise AssertionError('main path disagrees with the plain version')
    if v.min() <= NEG_INF / 2:
        raise AssertionError('masked scores in the top-k')

    # ---- 5. kernel time at one flagship-width call
    B, C = 256, 8192
    uf, itf = user_first[:B].contiguous(), item_first[:C]
    with torch.no_grad():
        ms = cuda_ms(lambda: pairwise_scores(head, uf, itf), reps=20)
        plain_ms = cuda_ms(lambda: pairwise_scores_plain(
            head, uf, itf, torch.bfloat16), reps=3)
        a = torch.randn(8192, 8192, device=dev, dtype=torch.bfloat16)
        mm_ms = cuda_ms(lambda: a @ a, reps=10)
    measured_peak = 2 * 8192 ** 3 / (mm_ms * 1e-3)
    mma_flops, other_ops = (B * C * n for n in pair_ops(head, h1))
    flops = mma_flops + other_ops
    chain = kernel_chain(head)  # the tensors the kernel reads
    n_bytes = ((B + C) * h1 * 4 + B * C * 4 + sum(
        chain[k].numel() * chain[k].element_size()
        for k in ('w', 'b', 'w_last', 'b_last')))
    op_ms = max(mma_flops / PEAK_BF16_FLOPS, other_ops / PEAK_F32_FLOPS) * 1e3
    byte_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    line = {
        'name': 'pairwise_mlp', 'route': 'cuda',
        'source': 'pixelrec_multimodal_tpu_torch/ops/csrc/pairwise_mlp.cu',
        'replaces': 'pixelrec_multimodal_tpu/ops/pairwise_mlp.py:421',
        'tpu': 'ops/pairwise_mlp.py:_pairwise_kernel',
        'launches': launches, 'max_abs_err': flag_err, 'tol': flag_tol,
        'ms': ms, 'kernel_ms': ms, 'plain_ms': plain_ms,
        'bound_ms': max(op_ms, byte_ms),
        'bound_by': 'operations' if op_ms >= byte_ms else 'bytes',
        'bound_ms_measured_peak': mma_flops / measured_peak * 1e3,
        'library_ms': None,
        'library_note': 'no single PyTorch call computes the fused '
                        'assembly + Dense chain + one-column reduce',
        'shape': [B, C], 'tflops': flops / (ms * 1e-3) / 1e12,
        'measured_bf16_matmul_tflops': measured_peak / 1e12,
        'datasheet_bf16_tflops': PEAK_BF16_FLOPS / 1e12,
    }
    emit('timing', seconds_total=round(time.time() - t_start, 3))
    print(json.dumps({'kernels': [line]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
