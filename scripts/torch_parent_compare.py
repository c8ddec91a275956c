#!/usr/bin/env python3
"""The pair-scoring kernels K1-K6, the int8 modes K1q-K3q and the probes
P1-P3 of another checkout against this one's, on one CUDA card.

    python3 scripts/torch_parent_compare.py OTHER_CHECKOUT

Builds ``pairwise_mlp.cu`` (K1), ``gated_pairwise_mlp.cu`` (K2),
``gated_factored_mlp.cu`` (K3), ``attention_mlp.cu`` (K4),
``attention_gram_mlp.cu`` (K5) and ``attention_screen_mlp.cu`` (K6) from
``OTHER_CHECKOUT/pixelrec_multimodal_tpu_torch/ops/csrc``, and
``probes/csrc/vpu_roofline.cu`` (P1, P2) and ``probes/csrc/int8_mxu.cu``
(P3), from that checkout (for example a
parent commit unpacked with ``git archive``) into ``build/other/``, beside
this checkout's builds, and runs both through this checkout's wrappers on
the same inputs at the 256 x 8,192 block: the flagship chain [512, 256,
128] (relu, sigmoid, random weights from a seed) on seeded rows for K1,
on the gated rows of M = 6 modalities for K2 and K3, and after the
flagship attention head (d 64, 4 heads) for K4, K5 and K6 (with its
screen tail), and the int8 modes of K1-K3 on the same rows with the
flagship chain quantized, K1q also in a forced block of 64 rows of this
checkout against the other's 128-row K1q, and K1q on the wide chain
[1024, 512, 256] (``K1q_wide``, relu, sigmoid, rows of h1 1,024) in the
block each checkout chooses, and P1 (the FMA and exp chains), P2 (fused,
and K4's unfused pattern: ``P2_unfused``) and P3 in each mode at the
Pallas scripts' sizes. A checkout whose P2 takes no ``fused`` argument
(one design, unfused) runs that design for both; its fused row is then
the two designs' times, and only the unfused one is held bit for bit.
Prints one JSON
line per measurement, the card's ``nvidia-smi`` name and power limit
first: whether the scores are equal bit for bit; for K1-K6, whose chains
may differ between the checkouts (the wgmma chain against the mma.sync
chain), the kernel-against-plain gates of ``chip_smoke.py``
between the two builds' scores (every pair within KERNEL_TOL of the score
scale, at most MAX_DIFFERING_PER_LAYER of the pairs per hidden layer past
AGREE) and the mean top-50 overlap of each user's row (>= MIN_OVERLAP);
then each kernel's mean of 20 launches (CUDA events) in turns, other,
this, this, other, and this checkout's time over the other's. The C
interface of the two builds' entry points must be the same, but for the
block's pair rows and the packed weights of the kernels on the wgmma
chain: a checkout whose kernels take no rows (every block 128 rows) is
called without them, with this checkout's count of the block's shared
memory, and only where that count chooses 128 rows; one whose K1-K6 take
no packed weights (no ``<name>_chain_kind``) is called without them, and
so is one whose K1q, K2q and K3q take none (their int8 block of 128 rows
on the flagship chain runs mma.sync there: ``<name>_block_chain_kind``).
The int8 modes are held bit for bit: the s8 wgmma chain keeps the
mma.sync chain's 128-row float32 order, at 128 rows and at 64.
Exits 2 without a CUDA device, 1 if an int8 mode (K1q-K3q, K1q at 64 rows)
or P1, P2 unfused or P3 differs from the other checkout's or one of K1-K6
fails a gate.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    AGREE,
    HIDDEN,
    KERNEL_TOL,
    MAX_DIFFERING_PER_LAYER,
    MIN_OVERLAP,
    SEED,
    TIME_B,
    TIME_C,
    WIDE_HIDDEN,
    cuda_ms,
    random_attention_head,
    random_attention_rows,
    random_gated_rows,
    int8_head,
    random_head,
)

KERNELS = ('pairwise_mlp', 'gated_pairwise_mlp', 'gated_factored_mlp',
           'attention_mlp', 'attention_gram_mlp', 'attention_screen_mlp')
PROBES = ('vpu_roofline', 'int8_mxu')  # P1 and P2, P3, in probes/csrc
# the kernels that take the packed weights, and where: the argument's
# place counted from the end of the entry point's arguments (the int8 entry
# points of K1, K2 and K3 take them at the same place as their bf16 ones)
PACKED = {'pairwise_mlp': 14, 'gated_pairwise_mlp': 15,
          'gated_factored_mlp': 15, 'attention_mlp': 16,
          'attention_gram_mlp': 16, 'attention_screen_mlp': 16}
PACKED_INT8 = ('pairwise_mlp', 'gated_pairwise_mlp', 'gated_factored_mlp')
# held to the other checkout by the gates, not bits (their chain may be
# another one there)
GATED = ('K1', 'K2', 'K3', 'K4', 'K5', 'K6')
# neither bits nor gates: P2 fused against a checkout whose P2 has one
# design (chip_smoke.py holds each checkout's to its plain version)
UNHELD = ('P2',)
TOP = 50


def emit(what: str, **fields):
    print(json.dumps({'what': what, **fields}), flush=True)


class WithoutRows:
    """A library whose entry points take no block rows (a checkout from
    before the kernels chose their block): its ``<name>_forward`` drops the
    rows argument the wrappers pass, which must be 128, and its
    ``<name>_block_bytes`` is this checkout's (``this``)."""

    def __init__(self, lib, this):
        self._lib, self._this = lib, this
        self._calls = {}

    def __getattr__(self, attr):
        if attr.endswith('_block_bytes'):
            return getattr(self._this, attr)
        fn = getattr(self._lib, attr)
        if not attr.endswith('_forward'):
            return fn
        if attr not in self._calls:
            def call(*args):
                if args[-2] != 128:
                    raise ValueError(f'{attr} of the other checkout takes '
                                     f'128-row blocks only, got {args[-2]}')
                if fn.argtypes is None:
                    fn.argtypes = call.argtypes[:-2] + call.argtypes[-1:]
                    fn.restype = ctypes.c_int
                return fn(*args[:-2], args[-1])
            call.argtypes = None
            self._calls[attr] = call
        return self._calls[attr]


class WithoutPackedWeights:
    """A library whose entry points ``entries`` (``<name>_forward`` of
    K1-K6, ``<name>_int8_forward`` of K1q-K3q) take no packed weights
    (a checkout from before that mode's wgmma chain): each drops the
    pointer to them, which the wrappers pass PACKED[name] arguments from
    the end (after the LayerNorm affine, or after the pair kernels' item
    rows)."""

    def __init__(self, lib, name, entries):
        self._lib, self._name, self._entries = lib, name, set(entries)
        self._calls = {}

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr not in self._entries:
            return fn
        if attr not in self._calls:
            def call(*args):
                i = len(args) - PACKED[self._name]
                if fn.argtypes is None:
                    fn.argtypes = call.argtypes[:i] + call.argtypes[i + 1:]
                    fn.restype = ctypes.c_int
                return fn(*args[:i], *args[i + 1:])
            call.argtypes = None
            self._calls[attr] = call
        return self._calls[attr]


class BcastWithoutFused:
    """The P2 library of a checkout whose ``vpu_bcast_forward`` takes no
    ``fused`` and ``entries`` arguments (one design, K4's unfused
    pattern): each call drops them."""

    def __init__(self, lib):
        self._lib = lib
        fn = lib.vpu_bcast_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(*args):
            return fn(*args[:8], args[-1])
        call.argtypes = None  # the wrappers set this one's; fn keeps its own
        self.vpu_bcast_forward = call

    def __getattr__(self, attr):
        return getattr(self._lib, attr)


def unpacked_entries(lib, name: str) -> list:
    """The entry points of ``lib`` (``csrc/<name>.cu`` of another checkout)
    that take no packed weights though this checkout's do: ``<name>_forward``
    where it has no ``<name>_chain_kind``; ``<name>_int8_forward`` of K1,
    K2 and K3 where its 128-row int8 block on the flagship chain runs
    mma.sync."""
    entries = []
    if name in PACKED and not hasattr(lib, f'{name}_chain_kind'):
        entries.append(f'{name}_forward')
    kind = getattr(lib, f'{name}_block_chain_kind', None)
    if name in PACKED_INT8:
        wd = np.asarray(HIDDEN, np.int32)
        if kind is not None:
            kind.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int]
            kind.restype = ctypes.c_int
        if kind is None or kind(len(wd) - 1, wd.ctypes.data, 1, 128) != 2:
            entries.append(f'{name}_int8_forward')
    return entries


def compile_other(checkout: Path) -> dict:
    """The other checkout's kernels and probes, built in parallel: their
    paths."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    package = checkout / 'pixelrec_multimodal_tpu_torch'
    src = package / 'ops' / 'csrc'
    out = _build.BUILD_DIR.parent / 'other'
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-I', str(src), '-o',
         str(out / f'{n}.so'),
         str((package / 'probes' / 'csrc' if n in PROBES else src)
             / f'{n}.cu')], stdout=subprocess.DEVNULL)
        for n in KERNELS + PROBES}
    for n, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f'{n} of {checkout} did not build')
    return {n: out / f'{n}.so' for n in KERNELS + PROBES}


def build_other(checkout: Path, this: dict) -> dict:
    """The other checkout's kernels, built and loaded; ``this`` is this
    checkout's, by name."""
    libs = {}
    for n, path in compile_other(checkout).items():
        lib = ctypes.CDLL(str(path))
        if n in PROBES:
            source = (checkout / 'pixelrec_multimodal_tpu_torch' / 'probes'
                      / 'csrc' / f'{n}.cu').read_text()
            if n == 'vpu_roofline' and 'int fused' not in source:
                lib = BcastWithoutFused(lib)
            libs[n] = lib
            continue
        if not hasattr(lib, f'{n}_block_bytes'):
            lib = WithoutRows(lib, this[n])
        entries = unpacked_entries(lib, n)
        if entries:
            lib = WithoutPackedWeights(lib, n, entries)
        libs[n] = lib
    return libs


def gates(other: torch.Tensor, this: torch.Tensor, n_hidden: int) -> dict:
    """``this`` against ``other`` under chip_smoke.py's kernel-against-plain
    gates, and the mean top-50 overlap of their rows."""
    scale = max(1.0, other.abs().max().item())
    diff = (this - other).abs()
    share = (diff > AGREE * scale).float().mean().item()
    a = torch.topk(other, TOP, dim=1)[1].cpu().numpy()
    b = torch.topk(this, TOP, dim=1)[1].cpu().numpy()
    overlap = sum(len(set(x) & set(y)) for x, y in zip(a, b)) / a.size
    held = (diff.max().item() <= KERNEL_TOL * scale
            and share <= MAX_DIFFERING_PER_LAYER * n_hidden
            and overlap >= MIN_OVERLAP)
    return {'max_abs_diff': diff.max().item(), 'tol': KERNEL_TOL * scale,
            'share_over_agree': share,
            'max_share': MAX_DIFFERING_PER_LAYER * n_hidden,
            'top50_overlap': overlap, 'min_overlap': MIN_OVERLAP,
            'held': held}


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_parent_compare: no CUDA device', file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    emit('card', nvidia_smi=smi, torch=torch.__version__)
    this = {n: _build.load(n) for n in KERNELS + PROBES}
    libs = {'other': build_other(Path(sys.argv[1]), this), 'this': this}

    def use(tag):  # route the wrappers' launches (and block choice) to one
        _build._loaded.update(libs[tag])
        tpm.block_rows.cache_clear()

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED + 7)
    with torch.no_grad():
        pair_head = random_head(HIDDEN, 'relu', 'sigmoid', gen, dev,
                                n_item_mods=5)
        pair_head['kernel'] = tpm.kernel_chain(pair_head)  # as a scorer's
        exact, factored = random_gated_rows(pair_head, TIME_B, TIME_C, gen,
                                            dev)
        concat = (torch.randn(TIME_B, HIDDEN[0], generator=gen).to(dev),
                  torch.randn(TIME_C, HIDDEN[0], generator=gen).to(dev))
        head = random_attention_head(64, 4, HIDDEN, 'relu', 'sigmoid', gen,
                                     dev)
        head['kernel'] = tpm.kernel_chain(head)  # built once, as a scorer's
        users, items = random_attention_rows(head, TIME_B, TIME_C, gen, dev,
                                             True)
        tail = tac.compute_screen_tail(head, items)
        _, qhead = int8_head(HIDDEN, 'relu', 'sigmoid', gen, dev,
                             n_item_mods=5)
        _, qwide = int8_head(WIDE_HIDDEN, 'relu', 'sigmoid', gen, dev)
        wide = (torch.randn(TIME_B, WIDE_HIDDEN[0], generator=gen).to(dev),
                torch.randn(TIME_C, WIDE_HIDDEN[0], generator=gen).to(dev))
        chain_x = tvr.chain_inputs(dev, SEED)
        bcast_wv = tvr.bcast_inputs(dev, SEED)
        mxu = {m: tmx.inputs(m, dev, seed=SEED) for m in tmx.MODES}
        # kernel: a call of this checkout's wrapper on the shared inputs
        calls = {
            'K1': lambda: tpm.pairwise_scores(pair_head, *concat),
            'K2': lambda: tpm.pairwise_scores_gated(pair_head, *exact),
            'K3': lambda: tpm.pairwise_scores_gated_factored(pair_head,
                                                             *factored),
            'K4': lambda: tas.attention_scores(head, users[:5], items[:6]),
            'K5': lambda: tas.attention_scores_gram(head, users, items),
            'K6': lambda: tac.attention_screen_scores(head, users[:5],
                                                      items[:6], tail),
            'K1q': lambda: tpm.pairwise_scores(qhead, *concat),
            'K2q': lambda: tpm.pairwise_scores_gated(qhead, *exact),
            'K3q': lambda: tpm.pairwise_scores_gated_factored(qhead,
                                                              *factored),
            'K1q_wide': lambda: tpm.pairwise_scores(qwide, *wide),
            'P1_fma': lambda: tvr.vpu_chain(chain_x, tvr.K_HI, 'fma',
                                            tvr.STEPS),
            'P1_exp': lambda: tvr.vpu_chain(chain_x, tvr.K_HI, 'exp',
                                            tvr.STEPS),
            'P2': lambda: tvr.vpu_bcast(*bcast_wv, tvr.BC_K_HI, tvr.STEPS),
            'P2_unfused': lambda: tvr.vpu_bcast(*bcast_wv, tvr.BC_K_HI,
                                                tvr.STEPS, fused=False),
            **{f'P3_{m}': (lambda m=m: tmx.mxu_chain(
                *mxu[m], m, instances=tmx.INSTANCES)) for m in tmx.MODES}}
        scores, wide_rows = {}, {}
        for tag in ('other', 'this'):
            use(tag)
            scores[tag] = {k: fn().clone() for k, fn in calls.items()}
            wide_rows[tag] = tpm.block_rows('pairwise_mlp', WIDE_HIDDEN, (1,))
        equal = {k: bool(torch.equal(scores['other'][k], scores['this'][k]))
                 for k in calls}
        # K1q in a 64-row block of this checkout against the other's 128
        use('this')
        k1q_64 = lambda: tpm.pairwise_scores(qhead, *concat,  # noqa: E731
                                             _block_rows=64)
        equal['K1q_64_vs_128'] = bool(torch.equal(scores['other']['K1q'],
                                                  k1q_64()))
        emit('scores', shape=[TIME_B, TIME_C], k1q_wide_rows=wide_rows,
             **{f'{k}_bit_equal': v for k, v in equal.items()})
        held = {k: gates(scores['other'][k], scores['this'][k],
                         head['kernel']['n_hidden']) for k in GATED}
        for k, g in held.items():
            emit('gates', kernel=k, shape=[TIME_B, TIME_C], **g)
        times = {k: {'other': [], 'this': []} for k in calls}
        for tag in ('other', 'this', 'this', 'other'):
            use(tag)
            for k, fn in calls.items():
                times[k][tag].append(cuda_ms(fn, reps=20))
        shapes = {'P1_fma': [tvr.STEPS, *chain_x.shape],
                  'P1_exp': [tvr.STEPS, *chain_x.shape],
                  'P2': [tvr.STEPS, tvr.BC_TB, tvr.BC_TC, tvr.BC_DP],
                  'P2_unfused': [tvr.STEPS, tvr.BC_TB, tvr.BC_TC,
                                 tvr.BC_DP],
                  **{f'P3_{m}': [tmx.INSTANCES, tmx.ROWS, tmx.H1]
                     for m in tmx.MODES}}
        for k, t in times.items():
            emit('time', kernel=k, shape=shapes.get(k, [TIME_B, TIME_C]),
                 ms=t, this_over_other=sum(t['this']) / sum(t['other']))
        use('this')
        ms_64 = cuda_ms(k1q_64, reps=20)
        emit('time', kernel='K1q', block_rows=64, shape=[TIME_B, TIME_C],
             ms=ms_64, over_this_128=ms_64 / (sum(times['K1q']['this']) / 2))
    return 0 if all(v for k, v in equal.items()
                    if k not in GATED + UNHELD) \
        and all(g['held'] for g in held.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
