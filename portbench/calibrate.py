#!/usr/bin/env python3
"""The readings that the limits of a cell's correctness check are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 101 102 103] [--seconds 3]

In one process on the card: for each of ``--seeds`` a whole run of the
cell as the benchmark makes it (set-up, a window of ``--seconds``, the
check) and its readings, the lower side of each limit; for each of
``--control-seeds`` the control, which has to read as not correct: the
plain reference put in the port's place and computed in float8
(``float8_product``: operands e4m3, gradients e5m2, one scale a tensor),
the nearest precision below the configuration's bf16,
through the cell's own window and comparison for a top-K cell; beside it,
for the record, the port with its own int8 path switched on (``precision=
'int8!'``) for a top-K cell, and the fault of half of each batch left out
of the loss, the mean taken over the rest, for a training cell. One JSON
line each, on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import inputs, run, spec  # noqa: E402
from portbench.generators.train import compare, make_pool, take  # noqa: E402
from portbench.reference.model import float8_product  # noqa: E402
from portbench.reference.train import train_steps  # noqa: E402


def train_control(cell, seed: int, device) -> list:
    """Readings of the float8 reference and of the half-batch fault, each
    in the port's place, against the float32 reference."""
    cfg, traffic = cell.config, cell.traffic
    weights = inputs.make_weights(cfg, seed, device)
    feats = inputs.make_features(cfg, seed, device)
    pool = make_pool(cfg, traffic, feats['tag'], seed, device)
    n = traffic['check_steps']
    batches = [{k: v[0] for k, v in take(pool, s, s + 1).items()}
               for s in range(n)]

    def steps(**kw):
        return train_steps(cfg, weights, feats['packed'], batches,
                           inputs.generator(seed, 'dropout', device), **kw)

    ref = steps()
    half = cfg['training']['batch_size'] // 2
    out = []
    for name, kw in (('fp8', {'product': float8_product}),
                     ('half_batch', {'keep_rows': lambda b: {
                         k: v[:half] for k, v in b.items()}})):
        got = steps(**kw)
        out.append({'control': name, **compare(
            weights, got['losses'],
            {'grad1': got['grad1'], 'after': {**got['params'],
                                              **got['stats']}}, ref)})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--seconds', type=float, default=3.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    dev = torch.device('cuda', 0)

    def emit(line):
        print(json.dumps(line), flush=True)

    runs = [(s, None) for s in args.seeds]
    if cell.traffic['generator'] == 'topk':
        runs += [(s, o) for s in args.control_seeds
                 for o in ({'control': 'fp8'}, {'precision': 'int8!'})]
    for seed, options in runs:
        t0 = time.time()
        r, readings = run.run(cell, seed, args.seconds, False, dev, options)
        emit({'workload': args.workload, 'seed': seed,
              'control': next(iter((options or {}).values()), None),
              'checks': {k: v['value'] for k, v in r['checks'].items()},
              'readings': readings, 'metrics': r['metrics'],
              'attempted': r['attempted'], 'seconds': time.time() - t0})
    if cell.traffic['generator'] == 'train':
        for seed in args.control_seeds:
            for line in train_control(cell, seed, dev):
                emit({'workload': args.workload, 'seed': seed, **line})
    return 0


if __name__ == '__main__':
    sys.exit(main())
