#!/usr/bin/env python
"""Does a model trained from the command line learn the cli phase's data?

    JAX_PLATFORMS=cpu python tests/cli_learning_check.py [--scale 16] [--tags 64]

On the CPU, both packages' command lines on one workspace copied twice:
``chip_smoke.cli_workspace`` (each user's positives drawn from items of
TRAINER_LIKED preferred tags; random resnet and sentence-bert tables; the
cli phase's config and CLI_EPOCHS) with the users, the items and the batch
divided by ``--scale``, so that an epoch keeps its number of batches, and
``--tags`` tags. The JAX ``scripts/create_splits.py``, ``train.py`` and
``evaluate.py`` run on one copy, the port's entry points on the other
(``--device cpu``); each best checkpoint is evaluated by its own package's
evaluate entry point (sampled retrieval on the validation file, 20 random
negatives a user, the train file as history), and so is each package's
random baseline. Prints one JSON object: each run's average NDCG, recall
and hit rate at k, and the training losses.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import chip_smoke  # noqa: E402

KEYS = ('avg_ndcg_at_k', 'avg_recall_at_k', 'avg_hit_rate_at_k',
        'num_users_evaluated')


def jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f'_jax_script_{name}', ROOT / 'scripts' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


def run(package: str, cfg: Path, out: Path) -> dict:
    """Split, train and evaluate with ``package``'s command line; then its
    random baseline."""
    if package == 'jax':
        split, train, evaluate = (jax_script(n) for n in
                                  ('create_splits', 'train', 'evaluate'))
    else:
        from pixelrec_multimodal_tpu_torch.scripts import (
            create_splits as split,
            evaluate,
            train,
        )
    quiet(split.main, str(cfg))
    trained = quiet(train.main, ['--config', str(cfg), '--device', 'cpu'])
    splits = cfg.parent / 'splits' / 'split_1'
    common = ['--config', str(cfg), '--test_data', str(splits / 'val.csv'),
              '--train_data', str(splits / 'train.csv'), '--device', 'cpu']
    got = {}
    for name, extra in (('model', []),
                        ('random', ['--recommender_type', 'random'])):
        res = quiet(evaluate.main, common + extra + [
            '--output', str(out / f'{package}_{name}.json')])
        got[name] = {k: res[k] for k in KEYS}
    losses = trained.get('train_losses') if isinstance(trained, dict) \
        else None
    got['train_losses'] = None if losses is None else [float(x)
                                                       for x in losses]
    return got


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[1])
    parser.add_argument('--scale', type=int, default=16,
                        help='divide the users, items and batch by this')
    parser.add_argument('--tags', type=int, default=chip_smoke.N_TAGS)
    parser.add_argument('--workdir', type=str, default=None,
                        help='keep the workspaces here (default: a '
                             'temporary directory)')
    args = parser.parse_args(argv)
    size = dict(n_users=chip_smoke.TRAIN_USERS // args.scale,
                n_items=chip_smoke.N_ITEMS // args.scale, n_tags=args.tags,
                batch=chip_smoke.TRAIN_BATCH // args.scale)
    with (tempfile.TemporaryDirectory() if args.workdir is None
          else contextlib.nullcontext(args.workdir)) as tmp:
        base = Path(tmp)
        made = chip_smoke.cli_workspace(base / 'seed', **size)
        out = {'size': size, 'epochs': chip_smoke.CLI_EPOCHS,
               'interactions': made['interactions']}
        for package in ('jax', 'torch'):
            shutil.copytree(base / 'seed', base / package)
            cfg = base / package / 'config.yaml'
            cfg.write_text(cfg.read_text().replace(str(base / 'seed'),
                                                   str(base / package)))
            out[package] = run(package, cfg, base)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
