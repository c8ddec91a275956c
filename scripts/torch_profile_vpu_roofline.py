#!/usr/bin/env python3
"""Probes P1 and P2 on one CUDA card: the float32 rates outside the tensor
cores (pixelrec_multimodal_tpu_torch/probes/vpu_roofline.py), the
counterpart of scripts/profile_vpu_roofline.py.

    python3 scripts/torch_profile_vpu_roofline.py

Builds probes/csrc/vpu_roofline.cu, holds each probe against its plain
version, then prints one JSON line per probe: P1's FMA and exp chains over
8,192 passes of a [512, 128] block, the slope between K 64 and 192 as
element-ops per second (FFMA and MUFU.EX2 instructions per second), and
P2's broadcast multiply-accumulate, the slope between K 16 and 48 as
element-ops per second (a multiply and an add each) and as instructions per
second, fused (one FFMA a multiply-add) and unfused (K4's FMUL then FADD),
for each choice of entries a thread (``BC_ENTRIES``, the sweep the kernel's
layout was chosen by), with its mean launch time at K 2 to 192 beside
(``ms_by_k``: a launch floor shows as times that do not grow with K). The
card's ``nvidia-smi`` name and power limit are
on every line. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_profile_vpu_roofline: no CUDA device', file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.probes import cuda_ms
    from pixelrec_multimodal_tpu_torch.probes import vpu_roofline as tvr
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    with torch.no_grad():
        x = tvr.chain_inputs('cuda')
        for kind in tvr.KINDS:
            out = tvr.vpu_chain(x, tvr.K_LO, kind, steps=2)
            ref = tvr.chain_plain(x, tvr.K_LO, kind)
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            print(json.dumps({**tvr.measure_chain(kind, x),
                              'rel_err_vs_plain': err, 'nvidia_smi': smi}),
                  flush=True)
        w, v = tvr.bcast_inputs('cuda')
        ref = tvr.bcast_plain(w, v, tvr.BC_K_HI)
        for entries in tvr.BC_ENTRIES:
            for fused in (True, False):
                out = tvr.vpu_bcast(w, v, tvr.BC_K_HI, steps=2, fused=fused,
                                    _entries=entries)
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                ms_by_k = {k: cuda_ms(lambda k=k: tvr.vpu_bcast(
                    w, v, k, tvr.STEPS, fused, entries), 10)
                    for k in (2, 16, 48, 96, 192)}
                print(json.dumps({
                    **tvr.measure_bcast(w, v, fused=fused, _entries=entries),
                    'ms_by_k': ms_by_k, 'rel_err_vs_plain': err,
                    'bit_equal': bool(torch.equal(out, ref)),
                    'nvidia_smi': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
