#!/usr/bin/env python
"""How often do the cli-trained model's top-50 values pass their flip bound?

    python3 tests/recommend_flip_check.py [--runs 4] [--groups 12]

On one card (ROADMAP C4): each run trains a fresh model from the command
line (``chip_smoke.cli_phase``; the weights differ from run to run on the
card) and runs the recommend and evaluate phases on its workspace
(``chip_smoke.recommend_phase``, ``chip_smoke.evaluate_phase``). Right
after the cli phase's own check, ``--groups`` more groups of 64 users of
the same model go through ``top_k`` and ``check_against_plain``. For each
``*_vs_plain`` check it prints the largest difference of a top-50 pair of
the same item between the main path and the plain bf16 version (against
FLIP_TOL, both relative to max(1, |score|)), the pairs past KERNEL_TOL
against those allowed, the same largest difference between two plain bf16
versions that sum in other orders, and what ``chip_smoke.flip_explanation``
finds: the largest move one flippable bf16 rounding makes on a top-50
pair, and for each pair past KERNEL_TOL the residual after 0-3 greedy
flips. Decoys measure how often the explanation would account for a
difference that no rounding made: each explained pair's exact-sum score
moved by a random 1-3 x FLIP_TOL of its scale, explained the same way.
The last line is one JSON object with every run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

KEYS = ('top50_same_item_max_abs_diff', 'top50_pairs_past_tol',
        'top50_pairs_allowed_past_tol',
        'plain_other_order_top50_same_item_max_abs_diff',
        'score_full_vs_plain_f32_max_abs_diff',
        'plain_bf16_vs_plain_f32_max_abs_diff',
        'top50_exact_sums_vs_plain_max_rel_diff',
        'top50_max_single_flip_move', 'top50_flippable_per_pair_mean',
        'top50_flippable_per_pair_max',
        'top50_pairs_past_flip_tol_unexplained',
        'top50_pairs_past_tol_explained')
MOST = 3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    parser.add_argument('--runs', type=int, default=4)
    parser.add_argument('--groups', type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('recommend_flip_check: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    emit, check = chip_smoke.emit, chip_smoke.check_against_plain
    explain = chip_smoke.flip_explanation
    rng = np.random.default_rng(chip_smoke.SEED + 4)
    runs = []
    for run in range(args.runs):
        checks, decoys, failed = {}, [], []

        def keep(phase, **fields):
            if phase.endswith('_vs_plain'):
                checks[phase] = {k: fields[k] for k in KEYS if k in fields}
            emit(phase, **fields)

        def explain_with_decoys(chain, x, target, scale, rows, **kw):
            got = explain(chain, x, target, scale, rows, most=MOST)
            picked = list(rows) or list(rng.choice(len(target), 4, False))
            moved = got['exact'][picked] + rng.choice([-1, 1], len(picked)) \
                * rng.uniform(1, 3, len(picked)) * chip_smoke.FLIP_TOL \
                * scale[picked]
            fake = np.array(target, np.float64)
            fake[picked] = moved
            decoys.extend(e['residuals'] for e in explain(
                chain, x, fake, scale, picked, most=MOST)['explained']
                .values())
            return got

        def groups(scorer, plain, users, v, i, phase, **kw):
            try:
                check(scorer, plain, users, v, i, phase, **kw)
            except AssertionError as e:
                failed.append(str(e))
            if phase != 'cli_main_path_vs_plain':
                return
            pool = np.random.default_rng(run).permutation(
                scorer.model.n_users)
            for g in range(args.groups):
                us = np.sort(pool[g * 64:(g + 1) * 64]).astype(np.int32)
                gv, gi = scorer.top_k(us, chip_smoke.TOP_K)
                try:
                    check(scorer, plain, us, gv, gi,
                          f'cli_group{g}_vs_plain', **kw)
                except AssertionError as e:
                    failed.append(str(e))
        chip_smoke.emit = keep
        chip_smoke.check_against_plain = groups
        chip_smoke.flip_explanation = explain_with_decoys
        try:
            with tempfile.TemporaryDirectory() as tmp:
                chip_smoke.cli_phase(smi, dev, 1.0, workspace=Path(tmp))
                chip_smoke.recommend_phase(smi, dev, Path(tmp))
                chip_smoke.evaluate_phase(smi, dev, Path(tmp))
        except AssertionError as e:
            failed.append(str(e))
        finally:
            chip_smoke.emit, chip_smoke.check_against_plain = emit, check
            chip_smoke.flip_explanation = explain
        runs.append({'run': run, 'passed': not failed, 'failed': failed,
                     'checks': checks, 'decoy_residuals': decoys})
        print(json.dumps({'flip_check_run': runs[-1]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({'runs': len(runs),
                      'failed': sum(not r['passed'] for r in runs),
                      'flip_tol': chip_smoke.FLIP_TOL, 'nvidia_smi': smi,
                      'each': runs}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
