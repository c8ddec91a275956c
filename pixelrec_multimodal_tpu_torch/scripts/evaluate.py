# pixelrec_multimodal_tpu_torch/scripts/evaluate.py
"""Evaluation entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.evaluate \\
        --config X.yaml --test_data test.csv [--train_data train.csv] \\
        [--recommender_type multimodal|random|popularity|item_knn|user_knn] \\
        [--eval_task retrieval|ranking] [--full_catalog | --no_sampling] \\
        [--precision bf16|int8|int8!] [--device cpu]

Counterpart of the repo's ``scripts/evaluate.py`` with no JAX, pandas,
scikit-learn or PyYAML: the same flags, the same evaluators, the same
results JSON (``--output``, under the config's results directory unless
the path names a directory) and predictions JSON (``--save_predictions``).
It rebuilds the dataset from a training run's artifacts (``load_dataset``,
which the generate entry point calls too), builds the learned recommender
from the port's checkpoint (``state.pt``) or one of the four baselines
(``create_recommender``), and evaluates on the CUDA device unless
``--device cpu`` is given; it raises without a card and on any other
device. ``--full_catalog`` ranks every test user over the whole catalog
through the scorer's top-K (kernel K1 for a concatenate head on the card,
K1q under ``--precision int8``).

Over several devices it runs as the generate entry point does (``torchrun
--nproc_per_node N -m pixelrec_multimodal_tpu_torch.scripts.evaluate ...
--model_parallel M``, one rank a card): the learned recommender's scorer
shards the catalog over the mesh, every rank evaluates, rank 0 alone
prints and writes the results, and all ranks pass a closing barrier.

Also the helpers the generate entry point imports from here, as the JAX
script does: checkpoint and encoder discovery and the ``--cascade``
argument type. The baselines are imported inside ``create_recommender``,
so that importing this module loads no scipy.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..config import Config
from ..data.columns import read_csv
from ..data.dataset import MultimodalDataset
from ..data.processors import NumericalProcessor
from ..evaluation.tasks import create_evaluator, get_task_from_string
from ..inference import Recommender
from ..models.multimodal import build_model
from ..parallel import (
    barrier,
    init_distributed,
    is_main_rank,
    main_rank_stdout,
    mesh_from_flags,
)
from ..utils.checkpointing import (
    STATE_FILE,
    find_checkpoint,
    load_checkpoint,
    load_model_state,
    normalize_checkpoint_name,
)
from ..utils.logging import dump_json
from .train import setup_device


def _refuse_orbax(path: Path):
    """A checkpoint directory the JAX package wrote (an Orbax ``state/``
    directory, no ``state.pt``) raises: the port reads only its own."""
    if (path / 'state').is_dir() and not (path / STATE_FILE).exists():
        raise ValueError(
            f'{path} holds a JAX-package checkpoint (an Orbax state/ '
            f'directory) and no {STATE_FILE}: the port cannot read it; '
            'train with pixelrec_multimodal_tpu_torch.scripts.train')


def find_model_checkpoint(config: Config,
                          checkpoint_name: str = 'best_model'
                          ) -> Optional[Path]:
    """Locate a checkpoint directory: the name, ``best_model`` and
    ``last_model`` under the model's directory, then the name under the
    checkpoint root, then any checkpoint under either. A named candidate
    that holds only a JAX-package checkpoint raises."""
    name = normalize_checkpoint_name(checkpoint_name)
    model_dir = Path(config.model_specific_checkpoint_dir)
    root = Path(config.checkpoint_dir)
    for c in (model_dir / name, model_dir / 'best_model',
              model_dir / 'last_model', root / name):
        _refuse_orbax(c)
        if (c / STATE_FILE).exists():
            return c
    found = find_checkpoint(model_dir)
    return found if found is not None else find_checkpoint(root)


def find_encoders(config: Config) -> Optional[Dict[str, object]]:
    """Load the pickled user, item (and tag) encoders from the shared
    encoders directory, the checkpoint root or the model's directory;
    None unless both the user and the item encoder are found. An encoder
    the JAX package pickled (scikit-learn's class) raises: the port's
    ``extract_encoders`` rewrites the encoders in the port's classes."""
    search_dirs = [Path(config.shared_encoders_dir),
                   Path(config.checkpoint_dir),
                   Path(config.model_specific_checkpoint_dir)]
    encoders = {}
    for name in ('user_encoder', 'item_encoder', 'tag_encoder'):
        for d in search_dirs:
            p = d / f'{name}.pkl'
            if p.exists():
                try:
                    encoders[name] = pickle.loads(p.read_bytes())
                except ImportError as e:
                    if not (e.name or '').startswith('sklearn'):
                        raise
                    raise ImportError(
                        f'{p} needs scikit-learn to unpickle (the JAX '
                        'package wrote it); rewrite the encoders in the '
                        "port's classes with `python -m "
                        'pixelrec_multimodal_tpu_torch.scripts.'
                        'extract_encoders --config <config>`') from e
                break
    if 'user_encoder' not in encoders or 'item_encoder' not in encoders:
        return None
    return encoders


def cascade_arg(v: str):
    """--cascade accepts an explicit candidate count or 'auto'."""
    return 'auto' if v == 'auto' else int(v)


def load_precomputed_tables(config: Config, store) -> None:
    """Load the cached item tables into ``store`` where the config
    enables the cache; raise if the model needs a vision or language
    table that is not there."""
    cache = config.data.cache_config
    if cache.enabled and cache.cache_directory:
        store.load_tables(cache.cache_directory)
    wanted = [t for t, m in (('vision_emb', config.model.vision_model),
                             ('language_emb', config.model.language_model))
              if m and not store.has(t)]
    if wanted:
        raise FileNotFoundError(
            f'no precomputed {wanted} for vision={config.model.vision_model}'
            f', language={config.model.language_model} under the cache '
            f'directory {cache.cache_directory!r} (enabled={cache.enabled})')


def load_dataset(config: Config) -> MultimodalDataset:
    """The dataset rebuilt from the artifacts of a training run: the
    processed CSV files, the scaler (whose fitted columns are the
    numerical features), the encoders and the precomputed item tables."""
    item_info = read_csv(config.data.processed_item_info_path)
    interactions = read_csv(config.data.processed_interactions_path)

    numerical_processor = NumericalProcessor()
    scaler = None
    feature_cols = config.data.numerical_features_cols
    if Path(config.data.scaler_path).exists():
        numerical_processor.load_scaler(Path(config.data.scaler_path))
        scaler = numerical_processor.scaler
        if numerical_processor.fitted_columns is not None:
            feature_cols = list(numerical_processor.fitted_columns)
    feature_cols = [c for c in feature_cols if c in item_info]

    encoders = find_encoders(config)
    dataset = MultimodalDataset(
        interactions_df=interactions,
        item_info_df=item_info,
        image_folder=(config.data.processed_image_destination_folder
                      or config.data.image_folder),
        vision_model_name=config.model.vision_model,
        language_model_name=config.model.language_model,
        create_negative_samples=False,
        numerical_feat_cols=feature_cols,
        categorical_feat_cols=config.data.categorical_features_cols,
        numerical_scaler=scaler,
        numerical_normalization_method=config.data.numerical_normalization_method,
        user_encoder=encoders.get('user_encoder') if encoders else None,
        item_encoder=encoders.get('item_encoder') if encoders else None,
        tag_encoder=encoders.get('tag_encoder') if encoders else None)
    load_precomputed_tables(config, dataset.feature_store)
    return dataset


def create_recommender(recommender_type: str, config: Config,
                       dataset: MultimodalDataset, train_data,
                       checkpoint_name: str = 'best_model', mesh=None,
                       precision: str = 'bf16', cascade=None,
                       cascade_screen: str = 'additive',
                       cascade_recall: float = 1.0, cascade_c1=None,
                       device='cuda'):
    """The recommender of ``recommender_type``: ``'multimodal'`` is the
    config's model with the checkpoint's weights behind a ``Recommender``
    on ``device``; the four baselines take their history from
    ``train_data`` (columns), else from the dataset's interactions."""
    if recommender_type == 'multimodal':
        model = build_model(config.model, dataset.n_users, dataset.n_items,
                            dataset.n_tags,
                            num_numerical_features=len(
                                dataset.numerical_feat_cols),
                            device=device)
        ckpt = find_model_checkpoint(config, checkpoint_name)
        if ckpt is None:
            raise FileNotFoundError(
                f"No model checkpoint found under {config.checkpoint_dir}")
        print(f"Loading checkpoint: {ckpt}")
        restored = load_checkpoint(ckpt.parent, ckpt.name, device=device)
        load_model_state(model, restored['state'])
        return Recommender(model, dataset, mesh=mesh, precision=precision,
                           cascade_candidates=cascade,
                           cascade_screen=cascade_screen,
                           cascade_recall=cascade_recall,
                           cascade_c1=cascade_c1, device=device)

    from ..inference.baseline_recommenders import (
        ItemKNNRecommender,
        PopularityRecommender,
        RandomRecommender,
        UserKNNRecommender,
    )
    baselines = {'random': RandomRecommender,
                 'popularity': PopularityRecommender,
                 'item_knn': ItemKNNRecommender,
                 'user_knn': UserKNNRecommender}
    if recommender_type not in baselines:
        raise ValueError(f"Unknown recommender type: {recommender_type}")
    history = train_data if train_data is not None else dataset.interactions
    return baselines[recommender_type](dataset,
                                       history_interactions_df=history)


def main(cli_args: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description='Evaluate a recommender')
    parser.add_argument('--config', type=str,
                        default='configs/simple_config.yaml',
                        help='Path to configuration file')
    parser.add_argument('--test_data', type=str, required=True,
                        help='Path to test data CSV file')
    parser.add_argument('--train_data', type=str,
                        help='Path to training data CSV file for user history')
    parser.add_argument('--output', type=str,
                        default='evaluation_results.json',
                        help='Path to save evaluation results')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--recommender_type', type=str, default='multimodal',
                        choices=['multimodal', 'random', 'popularity',
                                 'item_knn', 'user_knn'],
                        help='Recommender to evaluate')
    parser.add_argument('--eval_task', type=str, default='retrieval',
                        choices=['retrieval', 'ranking'],
                        help='Evaluation task')
    parser.add_argument('--save_predictions', type=str, default=None,
                        help='Path to save user-level predictions')
    parser.add_argument('--warmup_recommender_cache', action='store_true',
                        help="Warm-up the Recommender's feature cache "
                             '(accepted, as by the JAX script, and unused)')
    parser.add_argument('--num_workers', type=int, default=1,
                        help='Number of parallel workers for evaluation '
                             '(accepted and unused: the candidates are '
                             'scored in one batched call)')
    parser.add_argument('--use_sampling', action='store_true', default=True,
                        help='Use negative sampling for faster evaluation')
    parser.add_argument('--no_sampling', dest='use_sampling',
                        action='store_false',
                        help='Disable negative sampling (positives-only '
                             'candidates)')
    parser.add_argument('--full_catalog', action='store_true',
                        help="Retrieval task: rank each user's top-K over "
                             'the ENTIRE catalog (the scorer\'s blocked '
                             'top-K) instead of a sampled candidate set')
    parser.add_argument('--cascade', type=cascade_arg, default=None,
                        metavar='C|auto',
                        help='Attention fusion only: route full-catalog '
                             'top-K through the two-stage cascade (screen '
                             'top-C + exact rescore). "auto" calibrates C '
                             'and the tier on the users (measured recall, '
                             'exact-scan fallback); an explicit C must be '
                             'calibrated against the selected '
                             '--cascade_screen tier with '
                             'CatalogScorer.calibrate_cascade.')
    parser.add_argument('--cascade_screen', type=str, default='additive',
                        choices=['additive', 'token0', 'funnel'],
                        help='Cascade screen tier for an explicit C '
                             '(ignored by auto)')
    parser.add_argument('--cascade_c1', type=int, default=None,
                        help='Stage-1 survivor count for --cascade_screen '
                             'funnel (default 8*C, floor 4096)')
    parser.add_argument('--cascade_recall', type=float, default=1.0,
                        help='Recall target for --cascade auto: 1.0 '
                             '(default) = exact results only; < 1.0 '
                             'admits faster approximate screen tiers at '
                             'their measured recall.')
    parser.add_argument('--num_negatives', type=int, default=20,
                        help='Number of negative samples per positive item')
    parser.add_argument('--sampling_strategy', type=str, default='random',
                        choices=['random', 'popularity', 'popularity_inverse'],
                        help='Negative sampling strategy')
    parser.add_argument('--checkpoint_name', type=str,
                        default='best_model.pth',
                        help='Name of checkpoint file to load')
    parser.add_argument('--data_parallel', type=int, default=None,
                        help='Mesh data-axis size (default: all ranks / '
                             'model_parallel)')
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='Mesh model-axis size: shards the catalog '
                             '(item tables) across ranks')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'int8', 'int8!'],
                        help='Scoring precision for the multimodal '
                             'recommender. int8 quantizes the fused '
                             'concat/gated head (calibrated; below the '
                             'flip point it serves bf16); int8! forces it. '
                             'Scores are approximate.')
    args = parser.parse_args(cli_args)

    device = init_distributed(args.device)
    mesh = mesh_from_flags(args.data_parallel, args.model_parallel)
    with main_rank_stdout():
        results = _evaluate(args, setup_device(device), mesh)
    barrier(mesh)
    return results


def _evaluate(args, device, mesh) -> Dict[str, Any]:
    """The results of ``main``'s arguments, written on rank 0."""
    if mesh is not None:
        print(f"Device mesh: {mesh.shape}")
    config = Config.from_yaml(args.config)

    print(f"Loading test data from: {args.test_data}")
    test_data = read_csv(args.test_data)
    train_data = None
    if args.train_data:
        print(f"Loading training data from: {args.train_data}")
        train_data = read_csv(args.train_data)

    dataset = load_dataset(config)
    recommender = create_recommender(
        args.recommender_type, config, dataset, train_data,
        checkpoint_name=args.checkpoint_name, mesh=mesh,
        precision=args.precision, cascade=args.cascade,
        cascade_screen=args.cascade_screen,
        cascade_recall=args.cascade_recall, cascade_c1=args.cascade_c1,
        device=device)

    task = get_task_from_string(args.eval_task)
    evaluator = create_evaluator(
        task, recommender, test_data, config,
        use_sampling=args.use_sampling,
        num_negatives=args.num_negatives,
        sampling_strategy=args.sampling_strategy,
        full_catalog=args.full_catalog,
        num_workers=args.num_workers)

    results = evaluator.evaluate()
    evaluator.print_summary(results)

    predictions = results.pop('predictions', None)
    if args.save_predictions and predictions is not None and is_main_rank():
        dump_json(predictions, args.save_predictions)
        print(f"Predictions saved to {args.save_predictions}")

    output_path = Path(args.output)
    if not output_path.is_absolute() and not output_path.parent.name:
        output_path = Path(config.results_dir) / output_path
    results['evaluation_metadata'] = {
        'recommender_type': args.recommender_type,
        'eval_task': args.eval_task,
        'use_sampling': args.use_sampling,
        'full_catalog': args.full_catalog,
        'num_negatives': args.num_negatives,
        'sampling_strategy': args.sampling_strategy,
        'test_data': args.test_data,
        'config': args.config,
    }
    if is_main_rank():
        dump_json(results, output_path)
    print(f"Results saved to {output_path}")
    return results


if __name__ == '__main__':
    main()
