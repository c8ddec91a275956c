#!/usr/bin/env python3
"""Where the time goes inside the kernels on the wgmma chains (K1 concat,
K2 exact and K3 factored gated, their int8 modes K1q (in blocks of 128
and of 64 rows), K2q and K3q, K4 stream and K5 gram attention, K6 the
token-0 screen), phase by phase, and what the attention kernels' grid
order costs, on one CUDA card.

    python3 scripts/torch_phase_profile.py [OTHER_CHECKOUT]

Builds altered copies of ``ops/csrc/pairwise_mlp.cu`` (K1),
``gated_pairwise_mlp.cu`` (K2), ``gated_factored_mlp.cu`` (K3),
``attention_mlp.cu`` (K4), ``attention_gram_mlp.cu`` (K5) and
``attention_screen_mlp.cu`` (K6) under ``build/phase/``:

* ``phases``: thread 0 of every block reads ``clock64()`` after each
  block-wide barrier of the kernel's body (and after the chain) and adds
  the difference to a device counter per phase; each phase is named by the
  kernel functions it calls (K1: the user rows, the assembly, the chain;
  K2 and K3: the user rows, the gates (K2) or coefficients (K3), the
  assembly, the chain, the copy with one more barrier before the gates or
  coefficients; K1q, K2q and K3q the same phases of the same copy, their
  assembly ending in its quantize to codes and their chain the s8 one,
  which quantizes every later layer's input; K4 and K6: the user rows,
  logits, softmax, assembly,
  chain; K5: the user rows, logits and cross-Grams, softmax, its
  statistics, the combination, the chain);
* ``items_fastest`` (K4, K5, K6): the kernel as built, with the grid order
  of ``attention_common.cuh`` turned round, item tiles along x, so that the
  blocks of one user tile run together instead of those of one item tile
  (K1's, K2's and K3's grids have them so already).

With OTHER_CHECKOUT (for example a parent commit unpacked with ``git
archive``), its kernels get the ``phases`` copy too, built with its own
headers and called through this checkout's wrappers as
``scripts/torch_parent_compare.py`` calls them, so that the shares before
and after a change print side by side. The copies replace the built
kernels in this process only. Each kernel scores the flagship block (256
users x 8,192 items; K1 and K1q on seeded rows of h1 512, K2 and K3 on
seeded gated rows of h1 512 and M = 6, the others d 64, 4 heads, Mi 5;
the chain [512, 256, 128], relu, sigmoid, random weights from a seed).
Prints one JSON line per checkout and kernel: the mean SM cycles per block
of each phase and its share, the kernel's time by CUDA events as built and
with the counters (and, for this checkout, with the other grid order, and
whether it gives the same scores bit for bit); beside the card's
``nvidia-smi`` name and power limit. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    SEED,
    cuda_ms,
    int8_head,
    random_attention_head,
    random_attention_rows,
    random_gated_rows,
    random_head,
)
from scripts.torch_parent_compare import (  # noqa: E402
    WithoutPackedWeights,
    unpacked_entries,
)

B, C = 256, 8192
# (kernel, source, kernel function): the int8 modes share their source;
# K1q@64 is K1q in a forced block of 64 rows
KERNELS = (('K1', 'pairwise_mlp', 'pairwise_mlp_kernel'),
           ('K1q', 'pairwise_mlp', 'pairwise_mlp_kernel'),
           ('K1q@64', 'pairwise_mlp', 'pairwise_mlp_kernel'),
           ('K2', 'gated_pairwise_mlp', 'gated_pairwise_kernel'),
           ('K3', 'gated_factored_mlp', 'gated_factored_kernel'),
           ('K2q', 'gated_pairwise_mlp', 'gated_pairwise_kernel'),
           ('K3q', 'gated_factored_mlp', 'gated_factored_kernel'),
           ('K4', 'attention_mlp', 'attention_kernel'),
           ('K5', 'attention_gram_mlp', 'attention_gram_kernel'),
           ('K6', 'attention_screen_mlp', 'screen_kernel'))
# The kernel functions a phase may call, by the name it is printed under.
PHASE_NAMES = {
    'load_users': 'user rows', 'pair_logits': 'logits',
    'cross_grams': 'cross-Grams', 'softmax_coefs': 'softmax',
    'gram_stats': 'statistics', 'gram_sums': 'statistics: sums',
    'gram_tokens': 'statistics: tokens',
    'gram_weights': 'statistics: weights', 'stream_assemble': 'assembly',
    'gram_combine': 'combination', 'screen_assemble': 'assembly',
    'scratch_of': 'user rows', 'act_pair': 'assembly', 'run_chain': 'chain',
    'run_chain_of': 'chain', 'run_chain_int8': 'chain',
    'run_chain_int8_of': 'chain', 'run_chain_wgmma_int8': 'chain',
    'pair_gates': 'gates',
    'pair_coefs': 'coefficients', 'act_to_bf16x4': 'assembly'}
# Calls that start a phase of their own in the profiled copy: a barrier is
# put before them (K2's gates and K3's coefficients follow the user rows
# with none between).
SPLIT_BEFORE = re.compile(r'\b(pair_gates|pair_coefs)(?=<)')
COUNTERS = '''
__device__ unsigned long long phase_cycles[16];
#define PHASE_START long long phase_t = clock64(); int phase_k = 0;
#define PHASE_MARK if (threadIdx.x == 0) { const long long now = clock64(); \\
  atomicAdd(&phase_cycles[phase_k], (unsigned long long)(now - phase_t)); \\
  phase_t = now; } ++phase_k;
'''
READER = '''
extern "C" int phase_read(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
extern "C" int phase_reset() {
  unsigned long long zero[16] = {0};
  return cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
'''


def instrumented(src: str, kernel: str) -> tuple:
    """``src`` (a kernel source) with a phase mark after every barrier of
    ``kernel``'s body and at its end, after its chain (whichever chain the
    mode calls, in whichever branch), and the names of the phases."""
    start = src.index(f'{kernel}(')
    origin = re.compile(r'tile_origin(<TB>)?\(&u0, &c0\);'
                        r'|u0 = blockIdx\.y \* TB;').search(src, start)
    begin, end = origin.end(), src.index('\n}\n', origin.end())
    body = SPLIT_BEFORE.sub(r'__syncthreads();\n  \1', src[begin:end])
    names = []
    for segment in body.split('__syncthreads();'):
        calls = [PHASE_NAMES[m] for m in re.findall(r'\b(\w+)(?:<[^;()]*>)?\(',
                                                    segment)
                 if m in PHASE_NAMES]
        names.append(' and '.join(dict.fromkeys(calls)) or
                     f'phase {len(names)}')
    body = ('\n  PHASE_START' + body.replace('__syncthreads();',
                                            '__syncthreads();\n  PHASE_MARK')
            + '\n  __syncthreads();\n  PHASE_MARK')
    out = src[:begin] + body + src[end:]
    include = re.findall(r'#include "[^"]+"\n', out)[-1]
    return out.replace(include, include + COUNTERS, 1) + READER, names


def items_fastest_header(csrc: Path) -> str:
    """``attention_common.cuh`` with the item tiles along the grid's x and
    the user tiles along y, as the chain's own launch set-up lays them
    out."""
    src = (csrc / 'attention_common.cuh').read_text()
    for old, new in (
            ('  if (grid->x > 65535) return cudaErrorInvalidConfiguration;\n'
             '  *grid = dim3(grid->y, grid->x);\n', ''),
            ('*u0 = blockIdx.x * TB;\n  *c0 = blockIdx.y * TC;',
             '*u0 = blockIdx.y * TB;\n  *c0 = blockIdx.x * TC;')):
        if old not in src:
            raise RuntimeError('attention_common.cuh changed: the grid '
                               'order copy needs updating')
        src = src.replace(old, new)
    return src


def build(tag: str, name: str, source: str, csrc: Path,
          header: Optional[str] = None) -> ctypes.CDLL:
    """``source`` built into ``build/phase/<tag>/<name>.so`` with the
    headers of ``csrc``; ``header``, when given, is the
    ``attention_common.cuh`` it includes (the source's own directory comes
    first in the include search)."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    out = ROOT / 'build' / 'phase' / tag
    out.mkdir(parents=True, exist_ok=True)
    if header is not None:
        (out / 'attention_common.cuh').write_text(header)
    src = out / f'{name}.cu'
    src.write_text(source)
    lib = out / f'{name}.so'
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-I', str(csrc),
                    '-o', str(lib), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def routed(lib, name: str):
    """``lib`` as this checkout's wrappers call it (packed weights dropped
    for a checkout whose entry point takes none)."""
    entries = unpacked_entries(lib, name)
    return WithoutPackedWeights(lib, name, entries) if entries else lib


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_phase_profile: no CUDA device', file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.ops import attention_cascade as tac
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    from pixelrec_multimodal_tpu_torch.ops import pairwise_mlp as tpm
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED + 5)
    head = random_attention_head(64, 4, (512, 256, 128), 'relu', 'sigmoid',
                                 gen, dev)
    head['kernel'] = tpm.kernel_chain(head)  # built once, as a scorer's
    users, items = random_attention_rows(head, B, C, gen, dev, True)
    tail = tac.compute_screen_tail(head, items)
    pair = random_head((512, 256, 128), 'relu', 'sigmoid', gen, dev)
    pair['kernel'] = tpm.kernel_chain(pair)
    uf = torch.randn(B, 512, generator=gen).to(dev)
    itf = torch.randn(C, 512, generator=gen).to(dev)
    gated = random_head((512, 256, 128), 'relu', 'sigmoid', gen, dev,
                        n_item_mods=5)
    gated['kernel'] = tpm.kernel_chain(gated)
    exact, factored = random_gated_rows(gated, B, C, gen, dev)
    _, qgated = int8_head((512, 256, 128), 'relu', 'sigmoid', gen, dev,
                          n_item_mods=5)
    _, qpair = int8_head((512, 256, 128), 'relu', 'sigmoid', gen, dev)
    calls = {'K1': lambda: tpm.pairwise_scores(pair, uf, itf),
             'K1q': lambda: tpm.pairwise_scores(qpair, uf, itf),
             'K1q@64': lambda: tpm.pairwise_scores(qpair, uf, itf,
                                                   _block_rows=64),
             'K2': lambda: tpm.pairwise_scores_gated(gated, *exact),
             'K3': lambda: tpm.pairwise_scores_gated_factored(gated,
                                                             *factored),
             'K2q': lambda: tpm.pairwise_scores_gated(qgated, *exact),
             'K3q': lambda: tpm.pairwise_scores_gated_factored(qgated,
                                                              *factored),
             'K4': lambda: tas.attention_scores(head, users[:5], items[:6]),
             'K5': lambda: tas.attention_scores_gram(head, users, items),
             'K6': lambda: tac.attention_screen_scores(
                 head, users[:5], items[:6], tail)}
    checkouts = [('this', _build.CSRC)]
    if len(sys.argv) > 1:
        checkouts.insert(0, ('other', Path(sys.argv[1]) / 'pixelrec_'
                             'multimodal_tpu_torch' / 'ops' / 'csrc'))
    built = {}  # (checkout, source): the phases copy and its phase names
    for tag, csrc in checkouts:
        for kid, name, kernel in KERNELS:
            call = calls[kid]
            tile_users = 4 if kid.endswith('@64') else 8  # a block's
            blocks = -(-B // tile_users) * -(-C // 16)
            line = {'what': 'phases', 'checkout': tag, 'kernel': kid,
                    'nvidia_smi': smi, 'B': B, 'C': C, 'blocks': blocks}
            with torch.no_grad():
                _build._loaded.pop(name, None)
                if tag == 'this':
                    line['ms'] = cuda_ms(call, reps=20)
                if tag == 'this' and kid in ('K4', 'K5', 'K6'):
                    ref = call()
                    _build._loaded[name] = build(
                        'items_fastest', name,
                        (csrc / f'{name}.cu').read_text(), csrc,
                        items_fastest_header(csrc))
                    line['ms_item_tiles_fastest'] = cuda_ms(call, reps=20)
                    line['item_tiles_fastest_same_scores'] = bool(
                        torch.equal(call(), ref))
                if (tag, name) not in built:  # the int8 mode shares it
                    source, phases = instrumented(
                        (csrc / f'{name}.cu').read_text(), kernel)
                    built[tag, name] = (build(f'phases_{tag}', name, source,
                                              csrc), phases)
                lib, phases = built[tag, name]
                _build._loaded[name] = routed(lib, name)
                line['ms_with_counters'] = cuda_ms(call, reps=3)
                lib.phase_reset()
                call()
                torch.cuda.synchronize()
                raw = (ctypes.c_ulonglong * 16)()
                if lib.phase_read(raw):
                    raise RuntimeError('phase_read failed')
                _build._loaded.pop(name)
                if tag == 'this':
                    line['ms_again'] = cuda_ms(call, reps=20)
            cycles = [raw[k] / blocks for k in range(len(phases))]
            total = sum(cycles)
            line['cycles_per_block'] = dict(zip(phases, cycles))
            line['share'] = {p: c / total for p, c in zip(phases, cycles)}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
