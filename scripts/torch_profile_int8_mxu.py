#!/usr/bin/env python3
"""Probe P3 on one CUDA card: the pair kernels' product loop, their wgmma
chains in bf16 and int8 (pixelrec_multimodal_tpu_torch/probes/int8_mxu.py),
the counterpart of scripts/profile_int8_mxu.py.

    python3 scripts/torch_profile_int8_mxu.py

Builds probes/csrc/int8_mxu.cu, holds each mode against its plain version
on 1,000 rows (int8: bit for bit), then times one launch of 64 instances
over x [8,192, 512] (K = 8 steps of relu(x @ w1) @ w2) per mode, in the
block its library chooses by fit and, where that is 128 rows (int8), in a
64-row block too, and prints one JSON line per mode and block with its
rate (TFLOP/s in bf16, TOP/s in int8), the
torch.matmul / torch._int_mm chain of the same work and the library's
square 8,192^3 products beside it, and the int8 / bf16 ratios; the card's
``nvidia-smi`` name and power limit are on every line. Exits 2 without a
CUDA device.
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
        print('torch_profile_int8_mxu: no CUDA device', file=sys.stderr)
        return 2
    from pixelrec_multimodal_tpu_torch.probes import int8_mxu as tmx
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    rates = {}
    with torch.no_grad():
        for mode in tmx.MODES:
            t = tmx.inputs(mode, 'cuda', rows=1000)
            out = tmx.mxu_chain(*t, mode, instances=2)
            ref = tmx.chain_plain(*t, mode)
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            for block in dict.fromkeys((tmx.block_rows(mode), 64)):
                r = tmx.measure(mode, block=block)
                rates.setdefault(mode, r['ops_per_s'])
                print(json.dumps({**r, 'rel_err_vs_plain': err,
                                  'bit_equal': bool(torch.equal(out, ref)),
                                  'tops': r['ops_per_s'] / 1e12,
                                  'nvidia_smi': smi}), flush=True)
        sq = tmx.measure_square()
    print(json.dumps({**sq, 'int8_raw_over_bf16': rates['int8_raw']
                      / rates['bf16'],
                      'int8_rescale_over_bf16': rates['int8_rescale']
                      / rates['bf16'], 'nvidia_smi': smi}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
