# pixelrec_multimodal_tpu_torch/scripts/hyperparameter_search.py
"""Hyperparameter search entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.hyperparameter_search --config X.yaml [--device cpu]

Counterpart of the repo's ``scripts/hyperparameter_search.py`` with no
JAX, pandas, PyYAML or optuna: the same search space and order of
``suggest_*`` calls (so the same seed draws the same trials), the
progressive 5%/20%/50%/full training files keyed on the trial number
(``create_training_subsets`` writes them), the both-None prune, a
directory per trial with its ``config.yaml`` and ``trial_summary.json``,
post-hoc epoch reports for ``--pruning``, storage and ``--resume``, and
``study_config.json``, ``best_params.json``, ``study_results.json`` and
``best_config.yaml`` written as the JAX script writes them. Each trial
trains through ``train.run_training``.

It always runs the port's native engine (``hpo/``): the JAX script's
optuna branch is not ported. The PNG diagnostics follow the JAX script's
native branch; where matplotlib is absent the script prints the JAX
script's warning and writes no PNG. It trains on the CUDA device unless
``--device cpu`` is given, and raises at once on any other device, and
on ``cuda`` without a card. A trial whose training raises still scores
the worst value, as in the JAX script.
"""
from __future__ import annotations

import argparse
import json
import logging
from datetime import datetime
from pathlib import Path
from typing import List, Optional

from ..config import Config
from ..data.columns import write_json_records
from ..device import resolve_device
from ..hpo import (
    MedianPruner,
    RandomSampler,
    TPESampler,
    TrialPruned,
    TrialState,
    create_study,
)
from ..hpo.visualization import save_study_visualizations
from .train import run_training


def create_objective(base_config_path: str, args: argparse.Namespace):
    """The objective of one trial: the JAX script's ``suggest_*`` calls in
    its order, the progressive subsets keyed on the trial number, the
    both-None prune, a trial directory with its ``config.yaml``, then
    ``run_training`` and the post-hoc epoch reports for the pruner. A
    trial whose training raises returns the worst value (``inf``, or
    ``-inf`` when maximizing), as the JAX script's does."""

    def objective(trial) -> float:
        config = Config.from_yaml(base_config_path)

        # --- progressive data subsets keyed on trial number (:56-92)
        base_split_dir = Path(config.data.train_data_path).parent
        subsets = {
            0.05: base_split_dir / 'train_05_percent.csv',
            0.20: base_split_dir / 'train_20_percent.csv',
            0.50: base_split_dir / 'train_50_percent.csv',
        }
        full_path = base_split_dir / 'train.csv'
        if not all(p.exists() for p in subsets.values()):
            print("Searched files in:", base_split_dir)
            print("\nWarning: Training subset files not found. Falling back "
                  "to full training data for all trials.")
        else:
            n = trial.number
            if n < args.trials_on_5_percent:
                fraction, path = 0.05, subsets[0.05]
            elif n < args.trials_on_20_percent:
                fraction, path = 0.20, subsets[0.20]
            elif n < args.trials_on_50_percent:
                fraction, path = 0.50, subsets[0.50]
            else:
                fraction, path = 1.0, full_path
            config.data.train_data_path = str(path)
            print(f"\n--- Trial {n}: Using {fraction * 100:.0f}% of training "
                  f"data ({path.name}) ---")
            trial.set_user_attr('data_fraction', fraction)
            trial.set_user_attr('train_data_path', path.name)

        # --- model combination with both-None pruning (:94-113)
        config.model.vision_model = trial.suggest_categorical(
            'vision_model', ['clip', 'resnet', 'convnext', None])
        config.model.language_model = trial.suggest_categorical(
            'language_model', ['sentence-bert', 'mpnet', 'bert', None])
        if config.model.vision_model is None and \
                config.model.language_model is None:
            raise TrialPruned("Both vision and language models cannot be None.")

        # --- hyperparameters (:116-231)
        config.training.learning_rate = trial.suggest_float(
            'learning_rate', 1e-5, 1e-2, log=True)
        config.training.batch_size = trial.suggest_categorical(
            'batch_size', [16, 32, 64, 128])
        config.training.weight_decay = trial.suggest_float(
            'weight_decay', 1e-6, 1e-2, log=True)
        config.training.gradient_clip = trial.suggest_float(
            'gradient_clip', 0.5, 5.0)
        config.model.num_attention_heads = trial.suggest_categorical(
            'num_attention_heads', [2, 4, 8])
        config.model.embedding_dim = trial.suggest_categorical(
            'embedding_dim', [64, 128, 256, 512])
        config.model.fusion_type = trial.suggest_categorical(
            'fusion_type', ['concatenate', 'attention', 'gated'])
        config.model.dropout_rate = trial.suggest_float(
            'dropout_rate', 0.1, 0.5)
        config.model.attention_dropout = trial.suggest_float(
            'attention_dropout', 0.0, 0.3)
        chosen = trial.suggest_categorical('fusion_hidden_dims', [
            '256, 128', '512, 256', '512, 256, 128', '256, 128, 64',
            '128, 64', '512', '256'])
        config.model.fusion_hidden_dims = [int(x) for x in chosen.split(',')]
        config.model.projection_hidden_dim = trial.suggest_categorical(
            'projection_hidden_dim', [None, 128, 256, 512])
        config.model.fusion_activation = trial.suggest_categorical(
            'fusion_activation', ['relu', 'gelu', 'tanh', 'leaky_relu'])
        config.model.use_batch_norm = trial.suggest_categorical(
            'use_batch_norm', [True, False])
        config.model.use_contrastive = trial.suggest_categorical(
            'use_contrastive', [True, False])
        config.model.contrastive_temperature = trial.suggest_float(
            'contrastive_temperature', 0.01, 0.5, log=True)
        config.training.contrastive_weight = trial.suggest_float(
            'contrastive_weight', 0.01, 1.0)
        config.training.bce_weight = trial.suggest_float(
            'bce_weight', 0.5, 1.0)
        config.training.optimizer_type = trial.suggest_categorical(
            'optimizer_type', ['adam', 'adamw', 'sgd'])
        config.training.adam_beta1 = trial.suggest_float(
            'adam_beta1', 0.8, 0.99)
        config.training.adam_beta2 = trial.suggest_float(
            'adam_beta2', 0.9, 0.999)
        config.training.adam_eps = trial.suggest_float(
            'adam_eps', 1e-9, 1e-7, log=True)
        config.training.use_lr_scheduler = trial.suggest_categorical(
            'use_lr_scheduler', [True, False])
        config.training.lr_scheduler_type = trial.suggest_categorical(
            'lr_scheduler_type', ['reduce_on_plateau', 'cosine', 'step'])
        config.training.lr_scheduler_factor = trial.suggest_float(
            'lr_scheduler_factor', 0.1, 0.9)

        # --- per-trial dirs + config (:234-242)
        trial_dir = Path(args.output_dir) / f"trial_{trial.number}"
        config.checkpoint_dir = str(trial_dir / 'checkpoints')
        config.results_dir = str(trial_dir / 'results')
        trial_config_path = trial_dir / 'config.yaml'
        trial_config_path.parent.mkdir(parents=True, exist_ok=True)
        config.to_yaml(str(trial_config_path))

        train_args = argparse.Namespace(
            config=str(trial_config_path), device=args.device, resume=None,
            use_wandb=args.use_wandb,
            wandb_project=(f"{args.wandb_project}_optuna"
                           if args.use_wandb else None),
            wandb_entity=args.wandb_entity if args.use_wandb else None,
            wandb_run_name=(f"trial_{trial.number + 1}"
                            if args.use_wandb else None),
            verbose=getattr(args, 'verbose', False),
            trial_info={
                'trial_number': trial.number,
                'trial_params': trial.params,
                'study_name': args.study_name,
                'optimization_direction': args.direction,
                'target_metric': args.optimize_metric,
            })

        try:
            print(f"\n{'=' * 60}\nStarting Trial {trial.number}\n"
                  f"Hyperparameters: {trial.params}\n{'=' * 60}\n")
            results = run_training(config, train_args)

            if args.optimize_metric == 'val_loss':
                best_metric = results.get('best_val_loss', float('inf'))
            elif args.optimize_metric in results.get('all_best_metrics', {}):
                best_metric = results['all_best_metrics'][args.optimize_metric]
            elif f'best_{args.optimize_metric}' in results:
                best_metric = results[f'best_{args.optimize_metric}']
            else:
                print(f"Warning: Metric {args.optimize_metric} not found. "
                      "Using val_loss.")
                best_metric = results.get('best_val_loss', float('inf'))

            # Post-hoc pruning reports (:292-299).
            for epoch, val_loss in enumerate(results.get('val_losses', [])):
                trial.report(val_loss, epoch)
                if trial.should_prune():
                    print(f"Trial {trial.number} pruned at epoch {epoch}")
                    raise TrialPruned()

            summary = {
                'trial_number': trial.number,
                'best_metric': best_metric,
                'metric_name': args.optimize_metric,
                'params': trial.params,
                'epochs_completed': results.get('epochs_completed', 0),
                'training_time': results.get('training_time', 0),
                'all_best_metrics': results.get('all_best_metrics', {}),
            }
            with open(trial_dir / 'trial_summary.json', 'w') as f:
                json.dump(summary, f, indent=2, default=str)
            return best_metric

        except TrialPruned:
            raise
        except Exception as e:
            print(f"Error in trial {trial.number}: {e}")
            import traceback
            traceback.print_exc()
            return float('inf') if args.direction == 'minimize' \
                else float('-inf')

    return objective


# Best-param -> config application map.
_PARAM_TARGETS = {
    'vision_model': ('model', 'vision_model'),
    'language_model': ('model', 'language_model'),
    'learning_rate': ('training', 'learning_rate'),
    'batch_size': ('training', 'batch_size'),
    'weight_decay': ('training', 'weight_decay'),
    'gradient_clip': ('training', 'gradient_clip'),
    'embedding_dim': ('model', 'embedding_dim'),
    'num_attention_heads': ('model', 'num_attention_heads'),
    'fusion_type': ('model', 'fusion_type'),
    'dropout_rate': ('model', 'dropout_rate'),
    'attention_dropout': ('model', 'attention_dropout'),
    'projection_hidden_dim': ('model', 'projection_hidden_dim'),
    'fusion_activation': ('model', 'fusion_activation'),
    'use_batch_norm': ('model', 'use_batch_norm'),
    'use_contrastive': ('model', 'use_contrastive'),
    'contrastive_temperature': ('model', 'contrastive_temperature'),
    'contrastive_weight': ('training', 'contrastive_weight'),
    'bce_weight': ('training', 'bce_weight'),
    'optimizer_type': ('training', 'optimizer_type'),
    'adam_beta1': ('training', 'adam_beta1'),
    'adam_beta2': ('training', 'adam_beta2'),
    'adam_eps': ('training', 'adam_eps'),
    'use_lr_scheduler': ('training', 'use_lr_scheduler'),
    'lr_scheduler_type': ('training', 'lr_scheduler_type'),
    'lr_scheduler_factor': ('training', 'lr_scheduler_factor'),
}


def apply_best_params(config: Config, params: dict) -> Config:
    for name, value in params.items():
        if name == 'fusion_hidden_dims':
            config.model.fusion_hidden_dims = [int(x) for x in
                                               value.split(',')]
        elif name in _PARAM_TARGETS:
            section, attr = _PARAM_TARGETS[name]
            setattr(getattr(config, section), attr, value)
    return config


def main(cli_args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description='Hyperparameter optimization for multimodal recommender')
    parser.add_argument('--config', type=str,
                        default='configs/simple_config.yaml',
                        help='Base configuration file')
    parser.add_argument('--n_trials', type=int, default=100,
                        help='Number of trials to run')
    parser.add_argument('--study_name', type=str, default=None,
                        help='Name for the study (default: auto-generated)')
    parser.add_argument('--storage', type=str, default=None,
                        help='Storage for distributed/resumable optimization')
    parser.add_argument('--direction', type=str, default='minimize',
                        choices=['minimize', 'maximize'],
                        help='Direction of optimization')
    parser.add_argument('--optimize_metric', type=str, default='val_loss',
                        help='Metric to optimize')
    parser.add_argument('--output_dir', type=str, default='optuna_trials',
                        help='Directory to save trial results')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--use_wandb', action='store_true',
                        help='Enable Weights & Biases logging for trials')
    parser.add_argument('--wandb_project', type=str,
                        default='MultimodalRecommender')
    parser.add_argument('--wandb_entity', type=str, default=None)
    parser.add_argument('--pruning', action='store_true',
                        help='Enable trial pruning')
    parser.add_argument('--resume', action='store_true',
                        help='Resume an existing study')
    parser.add_argument('--parallel', action='store_true',
                        help='Run trials in parallel threads '
                             '(n_jobs=-1)')
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--trials_on_5_percent', type=int, default=20)
    parser.add_argument('--trials_on_20_percent', type=int, default=50)
    parser.add_argument('--trials_on_50_percent', type=int, default=90)
    parser.add_argument('--sampler', type=str, default='tpe',
                        choices=['tpe', 'random'],
                        help='Search strategy: TPE (default) or pure '
                             'random (control/baseline runs)')
    parser.add_argument('--seed', type=int, default=42,
                        help='Sampler seed (reference seeds TPE at 42)')
    args = parser.parse_args(cli_args)
    resolve_device(args.device)  # other devices, and cuda without a card

    if args.study_name is None:
        args.study_name = ("multimodal_rec_study_"
                           f"{datetime.now().strftime('%Y%m%d_%H%M%S')}")
    logging.basicConfig(level=logging.INFO)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(args.output_dir) / 'study_config.json', 'w') as f:
        json.dump(vars(args), f, indent=2, default=str)

    print("\nStarting hyperparameter optimization (backend: native)")
    print(f"Study name: {args.study_name}")
    print(f"Number of trials: {args.n_trials}")
    print(f"Optimization direction: {args.direction}")
    print(f"Metric to optimize: {args.optimize_metric}")

    if args.sampler == 'random':
        sampler = RandomSampler(seed=args.seed)
    else:
        sampler = TPESampler(seed=args.seed)
    pruner = MedianPruner() if args.pruning else None
    study = create_study(study_name=args.study_name, storage=args.storage,
                         sampler=sampler, pruner=pruner,
                         direction=args.direction,
                         load_if_exists=args.resume)

    objective = create_objective(args.config, args)
    try:
        study.optimize(objective, n_trials=args.n_trials,
                       n_jobs=-1 if args.parallel else 1,
                       show_progress_bar=True)
    except KeyboardInterrupt:
        print("\nOptimization interrupted by user")

    print("\n" + "=" * 60)
    print("OPTIMIZATION COMPLETED")
    print("=" * 60)
    print(f"Number of finished trials: {len(study.trials)}")
    print(f"Number of pruned trials: "
          f"{len([t for t in study.trials if t.state == TrialState.PRUNED])}")
    print(f"Number of failed trials: "
          f"{len([t for t in study.trials if t.state == TrialState.FAIL])}")

    best = study.best_trial if study.trials else None
    if best is None:
        print("\nNo successful trials completed.")
        return study

    print(f"\nBest trial:\n  Number: {best.number}\n  "
          f"Value ({args.optimize_metric}): {best.value:.6f}")
    print("\nBest hyperparameters:")
    for k, v in best.params.items():
        print(f"  {k}: {v}")

    with open(Path(args.output_dir) / 'best_params.json', 'w') as f:
        json.dump({'trial_number': best.number, 'value': best.value,
                   'params': best.params,
                   'datetime': datetime.now().isoformat()}, f, indent=2)

    write_json_records(study.trials_dataframe(),
                       Path(args.output_dir) / 'study_results.json')

    # The PNG diagnostics; where matplotlib is absent the import inside
    # the plotting functions raises and the warning is printed instead.
    try:
        written = save_study_visualizations(
            study, args.output_dir, metric_name=args.optimize_metric)
        if written:
            print(f"\nVisualizations saved: "
                  f"{', '.join(Path(p).name for p in written)}")
    except Exception as e:
        print(f"\nWarning: Could not generate visualizations: {e}")

    best_config = apply_best_params(Config.from_yaml(args.config),
                                    best.params)
    best_config_path = Path(args.output_dir) / 'best_config.yaml'
    best_config.to_yaml(str(best_config_path))
    print(f"Best configuration saved to {best_config_path}")
    return study


if __name__ == '__main__':
    main()
