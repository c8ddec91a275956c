#!/usr/bin/env python3
"""Where the time goes inside the attention kernels K4 and K5, phase by
phase, and what the grid order costs, on one CUDA card.

    python3 scripts/torch_phase_profile.py

Builds two altered copies of ``ops/csrc/attention_mlp.cu`` (K4) and
``ops/csrc/attention_gram_mlp.cu`` (K5) under ``build/phase/``:

* ``phases``: thread 0 of every block reads ``clock64()`` after each
  block-wide barrier of the kernel's body (and after the chain) and adds
  the difference to a device counter per phase;
* ``items_fastest``: the kernel as built, with the grid order of
  ``attention_common.cuh`` turned round, item tiles along x, so that the
  blocks of one user tile run together instead of those of one item tile.

The copies replace the built kernels in this process only. Each kernel
scores the flagship block (256 users x 8,192 items, d 64, 4 heads, Mi 5,
the chain [512, 256, 128], relu, sigmoid, random weights from a seed).
Prints one JSON line per kernel: the mean SM cycles per block of each
phase and its share; the kernel's time by CUDA events as built (before and
after the copies), with the counters and with the other grid order; and
whether the other order gives the same scores bit for bit; beside the
card's ``nvidia-smi`` name and power limit. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
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
    random_attention_head,
    random_attention_rows,
)

B, C = 256, 8192
KERNELS = {
    'attention_mlp': ('K4', 'attention_kernel',
                      ['user rows', 'logits', 'softmax', 'assembly',
                       'chain']),
    'attention_gram_mlp': ('K5', 'attention_gram_kernel',
                           ['user rows', 'logits and cross-Grams', 'softmax',
                            'statistics', 'combination', 'chain']),
}
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


def instrumented(name: str, kernel: str) -> str:
    """The source of ``csrc/<name>.cu`` with a phase mark after every
    barrier of ``kernel``'s body and after its chain."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    src = (_build.CSRC / f'{name}.cu').read_text()
    start = src.index(f'{kernel}(')
    begin = src.index('tile_origin(&u0, &c0);', start)
    end = src.index('run_chain(', begin)
    end = src.index(';', end) + 1
    body = src[begin:end].replace('__syncthreads();',
                                  '__syncthreads();\n  PHASE_MARK')
    body = body.replace('tile_origin(&u0, &c0);',
                        'tile_origin(&u0, &c0);\n  PHASE_START', 1)
    body += '\n  __syncthreads();\n  PHASE_MARK'
    out = src[:begin] + body + src[end:]
    include = '#include "attention_common.cuh"\n'
    return out.replace(include, include + COUNTERS, 1) + READER


def items_fastest_header() -> str:
    """``csrc/attention_common.cuh`` with the item tiles along the grid's x
    and the user tiles along y, as the chain's own launch set-up lays
    them out."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    src = (_build.CSRC / 'attention_common.cuh').read_text()
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


def build(tag: str, name: str, source: str,
          header: Optional[str] = None) -> ctypes.CDLL:
    """``source`` built into ``build/phase/<tag>/<name>.so``; ``header``,
    when given, is the ``attention_common.cuh`` it includes (the source's
    own directory comes first in the include search)."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    out = ROOT / 'build' / 'phase' / tag
    out.mkdir(parents=True, exist_ok=True)
    if header is not None:
        (out / 'attention_common.cuh').write_text(header)
    src = out / f'{name}.cu'
    src.write_text(source)
    lib = out / f'{name}.so'
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-I',
                    str(_build.CSRC), '-o', str(lib), str(src)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_phase_profile: no CUDA device', file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.ops import _build
    from pixelrec_multimodal_tpu_torch.ops import attention_scorer as tas
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(SEED + 5)
    head = random_attention_head(64, 4, (512, 256, 128), 'relu', 'sigmoid',
                                 gen, dev)
    users, items = random_attention_rows(head, B, C, gen, dev, True)
    calls = {'attention_mlp': lambda: tas.attention_scores(
                 head, users[:5], items[:6]),
             'attention_gram_mlp': lambda: tas.attention_scores_gram(
                 head, users, items)}
    blocks = -(-B // 8) * -(-C // 16)
    for name, (kid, kernel, phases) in KERNELS.items():
        with torch.no_grad():
            ms = cuda_ms(calls[name], reps=20)
            ref = calls[name]()
            _build._loaded[name] = build('items_fastest', name,
                                         (_build.CSRC / f'{name}.cu')
                                         .read_text(),
                                         items_fastest_header())
            items_ms = cuda_ms(calls[name], reps=20)
            same = bool(torch.equal(calls[name](), ref))
            lib = build('phases', name, instrumented(name, kernel))
            _build._loaded[name] = lib
            counted_ms = cuda_ms(calls[name], reps=3)
            lib.phase_reset()
            calls[name]()
            torch.cuda.synchronize()
            raw = (ctypes.c_ulonglong * 16)()
            if lib.phase_read(raw):
                raise RuntimeError('phase_read failed')
            _build._loaded.pop(name)
            ms_after = cuda_ms(calls[name], reps=20)
        cycles = [raw[k] / blocks for k in range(len(phases))]
        total = sum(cycles)
        print(json.dumps({
            'what': 'phases', 'kernel': kid, 'nvidia_smi': smi, 'B': B,
            'C': C, 'blocks': blocks, 'ms': ms, 'ms_again': ms_after,
            'ms_with_counters': counted_ms,
            'ms_item_tiles_fastest': items_ms,
            'item_tiles_fastest_same_scores': same,
            'cycles_per_block': dict(zip(phases, cycles)),
            'share': {p: c / total for p, c in zip(phases, cycles)}}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
