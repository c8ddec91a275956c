# pixelrec_multimodal_tpu_torch/scripts/generate_recommendations.py
"""Top-K recommendation entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.generate_recommendations \\
        --config X.yaml [--users U1 U2 | --user_file F | --sample_users N] \\
        [--use_diversity] [--precision bf16|int8|int8!] [--device cpu]

Counterpart of the repo's ``scripts/generate_recommendations.py`` with no
JAX, pandas, scikit-learn or PyYAML: the same flags, the same target
users (the list, else the file, else a seeded sample, else the first
five), the same JSON report. It loads the processed CSV files, the
scaler, the encoders the port's train script pickled and the port's
checkpoint (``state.pt``), and serves on the CUDA device unless
``--device cpu`` is given; it raises without a card and on any other
device.

Over several devices, one rank a card (``parallel/mesh.py``):

    torchrun --nproc_per_node N -m \
        pixelrec_multimodal_tpu_torch.scripts.generate_recommendations \
        --config X.yaml --device cuda --model_parallel M

``--data_parallel``/``--model_parallel`` build the (data, model) mesh as
the JAX script does (``mesh_from_flags``: every rank on the data axis
unless given); the ranks start NCCL on ``cuda`` and gloo on ``cpu``. The
scorer shards the catalog over 'model' and the users over 'data'; every
rank computes, rank 0 alone prints and writes the report, and all ranks
pass a closing barrier.

Where the config enables the feature cache, the precomputed item tables
(``feature_tables.npz``, written by the train script's datasets or by
``ItemFeatureStore.save``) are loaded from its directory; a model that
takes vision or language features and finds no such table raises rather
than score zero features.
"""
from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import Config
from ..parallel import (
    barrier,
    init_distributed,
    is_main_rank,
    main_rank_stdout,
    mesh_from_flags,
)
from ..utils.logging import dump_json
from .evaluate import cascade_arg, create_recommender, load_dataset
from .train import setup_device


def load_model_and_data(config: Config, checkpoint_name: str = 'best_model',
                        mesh=None, precision: str = 'bf16',
                        cascade=None,
                        cascade_screen: str = 'additive',
                        cascade_recall: float = 1.0,
                        cascade_c1=None, device='cuda'):
    """(Recommender, dataset) rebuilt from the artifacts of a training
    run: the dataset (``evaluate.load_dataset``) and the model of the
    config with the checkpoint's weights (``evaluate.create_recommender``)."""
    dataset = load_dataset(config)
    return create_recommender(
        'multimodal', config, dataset, None, checkpoint_name, mesh=mesh,
        precision=precision, cascade=cascade, cascade_screen=cascade_screen,
        cascade_recall=cascade_recall, cascade_c1=cascade_c1,
        device=device), dataset


def resolve_users(args, dataset) -> List[str]:
    """CLI list > file > seeded random sample > first 5."""
    if args.users:
        return [str(u) for u in args.users]
    if args.user_file:
        with open(args.user_file) as f:
            return [line.strip() for line in f if line.strip()]
    all_users = [str(u) for u in dataset.user_encoder.classes_]
    if args.sample_users:
        rng = np.random.default_rng(42)
        n = min(args.sample_users, len(all_users))
        return list(rng.choice(all_users, size=n, replace=False))
    return all_users[:5]


def main(cli_args: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(
        description='Generate top-K recommendations')
    parser.add_argument('--config', type=str,
                        default='configs/simple_config.yaml',
                        help='Path to configuration file.')
    parser.add_argument('--users', type=str, nargs='+',
                        help='A list of user IDs to generate recommendations '
                             'for.')
    parser.add_argument('--user_file', type=str,
                        help='Path to a file containing user IDs, one per '
                             'line.')
    parser.add_argument('--sample_users', type=int,
                        help='Number of random users to sample from the '
                             'dataset.')
    parser.add_argument('--use_diversity', action='store_true',
                        help='Use a diversity-aware recommendation algorithm.')
    parser.add_argument('--diversity_weight', type=float, default=0.3,
                        help='MMR trade-off: 0 = pure relevance, '
                             '1 = pure diversity (default 0.3).')
    parser.add_argument('--output', type=str, default='recommendations.json',
                        help='Name of the output JSON file.')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--checkpoint_name', type=str, default='best_model',
                        help='Checkpoint to load.')
    parser.add_argument('--data_parallel', type=int, default=None,
                        help='Mesh data-axis size (default: all ranks / '
                             'model_parallel)')
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='Mesh model-axis size: shards the catalog '
                             '(item tables) across ranks')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'int8', 'int8!'],
                        help='Scoring precision. int8 quantizes the fused '
                             'concat/gated head (calibrated; below the '
                             'flip point it serves bf16); int8! forces '
                             'it. Scores are approximate.')
    parser.add_argument('--cascade', type=cascade_arg, default=None,
                        metavar='C|auto',
                        help='Attention fusion only: two-stage cascaded '
                             'top-K — screen the catalog with a cheap '
                             'kernel, exact-rescore the top C candidates '
                             'per user. "auto" calibrates C and the screen '
                             'tier on the users (measured recall, falls '
                             'back to the exact scan); an explicit C must '
                             'be calibrated against the selected '
                             '--cascade_screen tier with '
                             'CatalogScorer.calibrate_cascade.')
    parser.add_argument('--cascade_recall', type=float, default=1.0,
                        help='Recall target for --cascade auto: 1.0 '
                             '(default) = exact results only; < 1.0 '
                             'admits faster approximate screen tiers at '
                             'their measured recall.')
    parser.add_argument('--cascade_screen', type=str, default='additive',
                        choices=['additive', 'token0', 'funnel'],
                        help='Cascade screen tier for an explicit '
                             '--cascade C: additive, token0, or funnel '
                             '(additive to --cascade_c1 survivors, token0 '
                             'candidate screen to C, exact rescore). '
                             'Ignored by --cascade auto.')
    parser.add_argument('--cascade_c1', type=int, default=None,
                        help='Stage-1 survivor count for '
                             '--cascade_screen funnel (default 8*C, '
                             'floor 4096).')
    args = parser.parse_args(cli_args)
    if not 0.0 <= args.diversity_weight <= 1.0:
        parser.error(f"--diversity_weight must be in [0, 1], "
                     f"got {args.diversity_weight}")

    device = init_distributed(args.device)
    mesh = mesh_from_flags(args.data_parallel, args.model_parallel)
    with main_rank_stdout():
        output = _generate(args, setup_device(device), mesh)
    barrier(mesh)
    return output


def _generate(args, device, mesh) -> Dict[str, Any]:
    """The report of ``main``'s arguments, written on rank 0."""
    if mesh is not None:
        print(f"Device mesh: {mesh.shape}")
    config = Config.from_yaml(args.config)
    recommender, dataset = load_model_and_data(
        config, args.checkpoint_name, mesh=mesh, precision=args.precision,
        cascade=args.cascade, cascade_screen=args.cascade_screen,
        cascade_recall=args.cascade_recall, cascade_c1=args.cascade_c1,
        device=device)
    users = resolve_users(args, dataset)
    print(f"Generating recommendations for {len(users)} users "
          f"(top_k={config.recommendation.top_k}, "
          f"filter_seen={config.recommendation.filter_seen})")

    if args.use_diversity:
        print(f"Using diversity-aware MMR reranking "
              f"(diversity_weight={args.diversity_weight})")
        recs = recommender.get_diverse_recommendations_batch(
            users, top_k=config.recommendation.top_k,
            diversity_weight=args.diversity_weight,
            filter_seen=config.recommendation.filter_seen)
    else:
        recs = recommender.get_recommendations_batch(
            users, top_k=config.recommendation.top_k,
            filter_seen=config.recommendation.filter_seen)

    output = {
        'metadata': {
            'generated_at': datetime.now().isoformat(),
            'config': args.config,
            'num_users': len(users),
            'top_k': config.recommendation.top_k,
            'filter_seen': config.recommendation.filter_seen,
            'use_diversity': args.use_diversity,
            'vision_model': config.model.vision_model,
            'language_model': config.model.language_model,
        },
        'recommendations': {
            u: [{'item_id': i, 'score': s} for i, s in items]
            for u, items in recs.items()
        },
    }
    out_path = Path(config.results_dir) / args.output \
        if not Path(args.output).is_absolute() else Path(args.output)
    if is_main_rank():
        dump_json(output, out_path)
    print(f"Recommendations saved to {out_path}")
    return output


if __name__ == '__main__':
    main()
