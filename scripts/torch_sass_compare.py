#!/usr/bin/env python3
"""The SASS of the pair-scoring kernels K1-K6 of another checkout against
this one's, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_compare.py OTHER_CHECKOUT

Builds both checkouts' ``pixelrec_multimodal_tpu_torch/ops/csrc`` kernels
(as ``scripts/torch_parent_compare.py`` does, into ``build/other/`` and
``build/kernels/``), disassembles them with ``cuobjdump -sass`` and prints
one JSON line per kernel function of this checkout's 128-row instance
(template argument TB = 8) that the other checkout has under the same name
without that argument (a checkout from before the kernels chose their
block): both instruction counts, the count of each opcode (modifiers
dropped) that differs, and whether the two instruction streams are the
same but for registers, addresses and constants. Needs no card.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.torch_parent_compare import KERNELS, compile_other  # noqa: E402

INSTR = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?'
                   r'([A-Z][A-Z0-9_.]*)([^;]*);')
FUNC = re.compile(r'Function : (\S+)')


def sass(lib: Path) -> dict:
    """{function: [(opcode with modifiers, operands)]} of a built library."""
    from pixelrec_multimodal_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).with_name('cuobjdump')
    text = subprocess.run([str(tool), '-sass', str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = FUNC.search(line)
        if m:
            # the anonymous namespace's hash differs between builds
            fn = re.sub(r'_GLOBAL__N__[0-9a-f]{8}', '_GLOBAL__N__',
                        m.group(1))
            out[fn] = []
            continue
        m = INSTR.search(line)
        if m and fn is not None:
            out[fn].append((m.group(1), m.group(2).strip()))
    return out


def shape(ops) -> list:
    """The instruction stream with registers, predicates, addresses and
    constants blanked."""
    blank = re.compile(r'\.L_x_\d+|\bU?R\d+\b|\bU?P\d+\b|0x[0-9a-f]+|\b\d+\b')
    return [(op, blank.sub('#', args)) for op, args in ops]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.ops import _build
    this = _build.build(KERNELS)
    other = compile_other(Path(sys.argv[1]))
    for n in KERNELS:
        mine, theirs = sass(this[n]), sass(other[n])
        for fn, ops in sorted(mine.items()):
            if 'ELi8' not in fn:
                continue
            twin = theirs.get(fn.replace('ELi8', '', 1))
            if twin is None:
                continue
            a = collections.Counter(op.split('.')[0] for op, _ in twin)
            b = collections.Counter(op.split('.')[0] for op, _ in ops)
            diff = {op: [a[op], b[op]] for op in sorted(set(a) | set(b))
                    if a[op] != b[op]}
            print(json.dumps({'source': n, 'function': fn[:120],
                              'instructions': [len(twin), len(ops)],
                              'opcodes_other_this': diff,
                              'same_stream': shape(twin) == shape(ops)}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
