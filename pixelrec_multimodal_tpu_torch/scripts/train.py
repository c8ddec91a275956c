# pixelrec_multimodal_tpu_torch/scripts/train.py
"""Training entry point.

    python -m pixelrec_multimodal_tpu_torch.scripts.train --config X.yaml [--device cpu]

Counterpart of the repo's ``scripts/train.py`` with no JAX, pandas,
scikit-learn or PyYAML: the same 13 steps, flags, reusable
``run_training(config, args)`` and output files (the pickled user, item
and tag encoders in the shared encoders directory,
``results/training_metadata.json``, ``training_run_config.yaml`` and
``training_run_config_validated.yaml``). It trains on the CUDA device
unless ``--device cpu`` is given, and raises without a card; any other
device raises.

Over several devices it runs under ``torchrun`` (one rank a card, NCCL;
gloo with ``--device cpu``), the mesh built from ``--data_parallel`` and
``--model_parallel`` as the JAX script builds it (``mesh_from_flags``:
every rank on the data axis unless both are given), and the ``Trainer``
data-parallel over it. Every rank computes the same results; rank 0
alone prints and writes the files. Where the batch size does not divide
by the data axis, the JAX script shrinks the axis to the largest divisor
and leaves devices idle; here every rank takes a place in the mesh, so
the script raises before any work and names that divisor.

``--resume`` restores the checkpoint's weights, optimizer and scheduler
state before training (the JAX script's trainer keeps them aside and
trains from fresh weights; ROADMAP queue C). The pickled encoders and
scaler are the port's own classes (``data/label_encoder.py``, the numpy
scalers), which the JAX package cannot unpickle without the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pickle
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..config import Config
from ..data.columns import n_rows, read_csv
from ..data.dataset import MultimodalDataset
from ..data.processors import NumericalProcessor
from ..device import resolve_device
from ..models.multimodal import build_model
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    init_distributed,
    is_main_rank,
    main_rank_stdout,
    mesh_from_flags,
)
from ..training import Trainer
from ..utils.logging import maybe_wandb_init, wandb_available

TOTAL_STEPS = 13


def print_progress_header(step: int, title: str, total_steps: int = TOTAL_STEPS):
    print(f"\n{'=' * 60}\nSTEP {step}/{total_steps}: {title}\n{'=' * 60}")


def print_progress_footer(step_start: float):
    print(f"Step completed in {time.time() - step_start:.2f}s")


def setup_device(device: Optional[str]) -> torch.device:
    """The torch device to train on: ``cuda`` unless ``device`` says
    ``cpu``; raises without a card, and on any other device."""
    dev = resolve_device(device or 'cuda')
    name = (f" ({torch.cuda.get_device_name(dev)})" if dev.type == 'cuda'
            else '')
    print(f"Using torch device: {dev}{name}")
    return dev


def build_training_mesh(data_parallel: Optional[int], model_parallel: int,
                        batch_size: int):
    """The training mesh (batch rows over 'data'), None when trivial. The
    data axis must divide the batch size: where it does not, this raises
    and names the largest divisor below it (the JAX script shrinks the
    axis to it and leaves devices idle; a port rank outside the mesh
    would have no work)."""
    mesh = mesh_from_flags(data_parallel, model_parallel)
    if mesh is None:
        return None
    dp = mesh.shape[DATA_AXIS]
    if batch_size % dp:
        new_dp = dp
        while new_dp > 1 and batch_size % new_dp:
            new_dp -= 1
        raise ValueError(
            f"batch_size={batch_size} not divisible by data_parallel={dp};"
            f" the largest divisor is data_parallel={new_dp}: start "
            f"{new_dp * mesh.shape[MODEL_AXIS]} rank(s) with --data_parallel"
            f" {new_dp}")
    print(f"Device mesh: {mesh.shape}")
    return mesh


def run_training(config: Config, args: argparse.Namespace) -> Dict[str, Any]:
    """Execute the full training pipeline; reusable by a hyperparameter
    search. Beside the JAX script's results, ``results['seconds']`` holds
    the host seconds of the steps, ``results['epoch_seconds']`` the
    Trainer's split of each epoch and ``results['train_samples']`` the
    training samples an epoch."""
    data_config = config.data
    model_config = config.model
    training_config = config.training
    original_numerical = list(data_config.numerical_features_cols)
    seconds: Dict[str, float] = {}

    # STEP 3: wandb
    step_start = time.time()
    print_progress_header(3, "Initializing Weights & Biases")
    if getattr(args, 'use_wandb', False):
        if wandb_available():
            run_name = args.wandb_run_name
            if not run_name:
                combo = f"{model_config.vision_model}_{model_config.language_model}"
                dataset_name = Path(data_config.train_data_path).parent.name
                run_name = (f"{combo}_{dataset_name}_"
                            f"{datetime.now().strftime('%Y%m%d_%H%M%S')}")
            wandb_config = {
                'model_config': dataclasses.asdict(model_config),
                'training_config': dataclasses.asdict(training_config),
            }
            if isinstance(getattr(args, 'trial_info', None), dict):
                wandb_config['hyperparameter_search_info'] = args.trial_info
            maybe_wandb_init(project=args.wandb_project,
                             entity=args.wandb_entity, name=run_name,
                             config=wandb_config)
        else:
            print("Warning: wandb not installed. Proceeding without W&B logging.")
            args.use_wandb = False
    else:
        print("W&B logging disabled")
    print_progress_footer(step_start)

    # STEP 4: device + mesh
    print_progress_header(4, "Setting up Device")
    step_start = time.time()
    device = setup_device(init_distributed(getattr(args, 'device', None)
                                           or 'cuda'))
    mesh = build_training_mesh(getattr(args, 'data_parallel', None),
                               getattr(args, 'model_parallel', 1),
                               training_config.batch_size)
    writes = is_main_rank()
    print_progress_footer(step_start)

    # STEP 5: data
    print_progress_header(5, "Loading Data")
    step_start = time.time()
    print(f"Loading training data from: {data_config.train_data_path}")
    train_data = read_csv(data_config.train_data_path)
    print(f"Training interactions: {n_rows(train_data):,}")
    print(f"Loading validation data from: {data_config.val_data_path}")
    val_data = read_csv(data_config.val_data_path)
    print(f"Validation interactions: {n_rows(val_data):,}")
    print(f"Loading item information from: {data_config.processed_item_info_path}")
    item_info = read_csv(data_config.processed_item_info_path)
    print(f"Total items: {n_rows(item_info):,}")
    all_interactions = read_csv(data_config.processed_interactions_path)
    seconds['read_csv'] = time.time() - step_start
    print_progress_footer(step_start)

    # STEP 6: numerical feature validation
    print_progress_header(6, "Validating Numerical Features")
    step_start = time.time()
    valid_numerical = [c for c in data_config.numerical_features_cols
                       if c in item_info]
    missing = [c for c in data_config.numerical_features_cols
               if c not in item_info]
    if missing:
        print(f"Warning: missing numerical features in item_info: {missing}")
        print(f"Continuing with available features: {valid_numerical}")
    data_config.numerical_features_cols = valid_numerical
    num_numerical = len(valid_numerical)
    print(f"Number of numerical features to use: {num_numerical}")
    print_progress_footer(step_start)

    # STEP 7: feature-store/cache settings
    print_progress_header(7, "Initializing Feature Store")
    step_start = time.time()
    cache_enabled = data_config.cache_config.enabled
    cache_dir = (data_config.cache_config.cache_directory
                 if cache_enabled else None)
    if cache_enabled:
        print(f"Feature store enabled. Disk tier dir: {cache_dir} "
              f"(use_disk={data_config.cache_config.use_disk})")
    else:
        print("Feature caching disabled.")
    print_progress_footer(step_start)

    # STEP 8: scaler
    print_progress_header(8, "Preparing Numerical Scaler")
    step_start = time.time()
    numerical_processor = NumericalProcessor()
    scaler_path = Path(data_config.scaler_path)
    if scaler_path.exists():
        print(f"Loading existing scaler from: {scaler_path}")
        numerical_processor.load_scaler(scaler_path)
    elif valid_numerical:
        print(f"Fitting new scaler for features: {valid_numerical}")
        numerical_processor.fit_scaler(
            item_info, valid_numerical,
            method=data_config.numerical_normalization_method)
        if writes:
            scaler_path.parent.mkdir(parents=True, exist_ok=True)
            numerical_processor.save_scaler(scaler_path)
        print(f"Scaler saved to: {scaler_path}")
    else:
        print("No numerical features found. Skipping scaler fitting.")
    fitted_scaler = numerical_processor.scaler if valid_numerical else None
    print_progress_footer(step_start)

    # STEP 9: datasets
    print_progress_header(9, "Creating Datasets")
    step_start = time.time()
    image_folder = (data_config.processed_image_destination_folder
                    or data_config.image_folder)
    common = dict(
        item_info_df=item_info,
        image_folder=image_folder,
        vision_model_name=model_config.vision_model,
        language_model_name=model_config.language_model,
        numerical_feat_cols=valid_numerical,
        categorical_feat_cols=data_config.categorical_features_cols,
        numerical_scaler=fitted_scaler,
        numerical_normalization_method=data_config.numerical_normalization_method,
    )
    print("Creating temporary dataset to fit all encoders...")
    full_dataset = MultimodalDataset(
        interactions_df=all_interactions, create_negative_samples=False,
        cache_features=False, **common)
    shared = dict(
        user_encoder=full_dataset.user_encoder,
        item_encoder=full_dataset.item_encoder,
        tag_encoder=full_dataset.tag_encoder,
        cache_features=cache_enabled, cache_dir=cache_dir,
        cache_max_items=data_config.cache_config.max_memory_items,
        cache_to_disk=data_config.cache_config.use_disk,
        negative_sampling_strategy=data_config.negative_sampling_strategy,
        negative_sampling_ratio=data_config.negative_sampling_ratio)
    print("Creating training dataset...")
    train_dataset = MultimodalDataset(
        interactions_df=train_data, create_negative_samples=True,
        is_train_mode=True,
        text_augmentation_config=data_config.text_augmentation,
        image_augmentation_config=data_config.image_augmentation,
        **shared, **common)
    print("Creating validation dataset...")
    val_dataset = MultimodalDataset(
        interactions_df=val_data, create_negative_samples=True,
        is_train_mode=False, **shared, **common)

    data_stats = {
        'train_interactions': n_rows(train_data),
        'val_interactions': n_rows(val_data),
        'total_users': full_dataset.n_users,
        'total_items': full_dataset.n_items,
        'total_tags': full_dataset.n_tags,
        'numerical_features': num_numerical,
    }
    print("\nDataset statistics:")
    for k, v in data_stats.items():
        print(f"  {k}: {v:,}")
    seconds['datasets'] = time.time() - step_start
    print_progress_footer(step_start)

    # STEP 10: batch pipeline (the item features are gathered on the device)
    print_progress_header(10, "Preparing Batch Pipeline")
    step_start = time.time()
    print(f"Batch size: {training_config.batch_size}; "
          f"{train_dataset.num_batches(training_config.batch_size)} train / "
          f"{val_dataset.num_batches(training_config.batch_size)} val batches "
          "per epoch (item features gathered on device)")
    print_progress_footer(step_start)

    # STEP 11: model
    print_progress_header(11, "Initializing Model")
    step_start = time.time()
    print("Creating MultimodalRecommender with:")
    print(f"  Vision model: {model_config.vision_model}")
    print(f"  Language model: {model_config.language_model}")
    print(f"  Embedding dim: {model_config.embedding_dim}")
    print(f"  Users: {full_dataset.n_users:,}")
    print(f"  Items: {full_dataset.n_items:,}")
    print(f"  Tags: {full_dataset.n_tags:,}")
    model = build_model(model_config, full_dataset.n_users,
                        full_dataset.n_items, full_dataset.n_tags,
                        num_numerical_features=num_numerical, device=device)
    print_progress_footer(step_start)

    # STEP 12: trainer + encoders + config snapshot
    print_progress_header(12, "Initializing Trainer")
    step_start = time.time()
    trainer = Trainer(model=model, config=config,
                      checkpoint_dir=config.checkpoint_dir,
                      use_contrastive=config.model.use_contrastive,
                      trial_info=getattr(args, 'trial_info', None),
                      mesh=mesh)
    if getattr(args, 'resume', None):
        print(f"\nResuming from checkpoint: {args.resume}")
        trainer.load_checkpoint(args.resume)

    print("Saving encoders to shared directory...")
    encoders_dir = trainer.get_encoders_dir()
    if writes:
        with open(encoders_dir / 'user_encoder.pkl', 'wb') as f:
            pickle.dump(full_dataset.user_encoder, f)
        with open(encoders_dir / 'item_encoder.pkl', 'wb') as f:
            pickle.dump(full_dataset.item_encoder, f)
        if full_dataset.tag_encoder is not None:
            with open(encoders_dir / 'tag_encoder.pkl', 'wb') as f:
                pickle.dump(full_dataset.tag_encoder, f)
    print(f"Encoders saved to {encoders_dir}")

    validated_config_path = Path(config.results_dir) / \
        'training_run_config_validated.yaml'
    if writes:
        config.to_yaml(str(validated_config_path))
    print(f"Updated configuration saved to {validated_config_path}")
    print_progress_footer(step_start)

    # STEP 13: train
    print_progress_header(13, "Starting Training")
    step_start = time.time()
    training_start = time.time()
    train_losses, val_losses = trainer.train(
        train_dataset, val_dataset,
        epochs=training_config.epochs,
        lr=training_config.learning_rate,
        weight_decay=training_config.weight_decay,
        patience=training_config.patience,
        gradient_clip=training_config.gradient_clip,
        optimizer_type=training_config.optimizer_type,
        adam_beta1=training_config.adam_beta1,
        adam_beta2=training_config.adam_beta2,
        adam_eps=training_config.adam_eps,
        use_lr_scheduler=training_config.use_lr_scheduler,
        lr_scheduler_type=training_config.lr_scheduler_type,
        lr_scheduler_patience=training_config.lr_scheduler_patience,
        lr_scheduler_factor=training_config.lr_scheduler_factor,
        lr_scheduler_min_lr=training_config.lr_scheduler_min_lr,
        batch_size=training_config.batch_size,
        gradient_accumulation_steps=training_config.gradient_accumulation_steps)
    training_time = time.time() - training_start
    seconds['train'] = training_time
    seconds['checkpoint_writes'] = sum(e['checkpoint']
                                       for e in trainer.epoch_seconds)

    finite_val = [v for v in val_losses if not math.isnan(v)]
    results: Dict[str, Any] = {
        'best_val_loss': min(finite_val) if finite_val else float('inf'),
        'final_val_loss': val_losses[-1] if val_losses else float('inf'),
        'best_train_loss': min(train_losses) if train_losses else float('inf'),
        'final_train_loss': train_losses[-1] if train_losses else float('inf'),
        'epochs_completed': len(train_losses),
        'training_time': training_time,
        'model_path': str(trainer.get_model_checkpoint_dir()),
        'train_losses': train_losses,
        'val_losses': val_losses,
        'all_best_metrics': trainer.get_all_best_metrics(),
    }

    total_params = sum(p.numel() for p in trainer.model.parameters())
    device_info = {'devices': [str(device)], 'backend': device.type}
    if mesh is not None:
        device_info['mesh'] = mesh.shape
    if device.type == 'cuda':
        device_info['name'] = torch.cuda.get_device_name(device)
    training_metadata = {
        'training_completed': True,
        'completion_time': datetime.now().isoformat(),
        'training_duration_hours': training_time / 3600,
        'epochs_completed': results['epochs_completed'],
        'final_train_loss': results['final_train_loss'],
        'final_val_loss': results['final_val_loss'],
        'best_train_loss': results['best_train_loss'],
        'best_val_loss': results['best_val_loss'],
        'model_config': dataclasses.asdict(model_config),
        'training_config': dataclasses.asdict(training_config),
        'data_stats': data_stats,
        'model_params': {
            'total_parameters': int(total_params),
            'trainable_parameters': int(total_params),
            'frozen_parameters': 0,
        },
        'device_info': device_info,
        'numerical_features_validation': {
            'original_config_features': original_numerical,
            'validated_features': valid_numerical,
            'num_features_used': num_numerical,
            'missing_features': missing,
        },
        'all_best_metrics': results['all_best_metrics'],
    }
    metadata_path = Path(config.results_dir) / 'training_metadata.json'
    config_save_path = Path(config.results_dir) / 'training_run_config.yaml'
    if writes:
        metadata_path.parent.mkdir(parents=True, exist_ok=True)
        with open(metadata_path, 'w') as f:
            json.dump(training_metadata, f, indent=2, default=str)
        config.to_yaml(str(config_save_path))
    print(f"Training metadata saved to {metadata_path}")
    print(f"Configuration saved to {config_save_path}")
    print_progress_footer(step_start)

    results['metadata'] = training_metadata
    results['seconds'] = seconds
    results['epoch_seconds'] = trainer.epoch_seconds
    results['train_samples'] = len(train_dataset)
    return results


def main(cli_args: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description='Train the multimodal recommender')
    parser.add_argument('--config', type=str,
                        default='configs/simple_config.yaml',
                        help='Path to configuration file')
    parser.add_argument('--resume', type=str, default=None,
                        help='Path to checkpoint to resume from')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Torch device: 'cuda' (the default) or 'cpu'")
    parser.add_argument('--use_wandb', action='store_true',
                        help='Enable Weights & Biases logging')
    parser.add_argument('--wandb_project', type=str,
                        default='MultimodalRecommender',
                        help='Weights & Biases project name')
    parser.add_argument('--wandb_entity', type=str, default=None,
                        help='Weights & Biases entity (username or team)')
    parser.add_argument('--wandb_run_name', type=str, default=None,
                        help='Weights & Biases run name for this training')
    parser.add_argument('--verbose', action='store_true',
                        help='Enable verbose output')
    parser.add_argument('--data_parallel', type=int, default=None,
                        help='Mesh data-axis size (default: all ranks / '
                             'model_parallel); shards batches for dp '
                             'training')
    parser.add_argument('--model_parallel', type=int, default=1,
                        help='Mesh model-axis size (its ranks compute '
                             'alike in training)')
    args = parser.parse_args(cli_args)
    init_distributed(args.device)
    with main_rank_stdout():
        results = _train(args)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    return results


def _train(args: argparse.Namespace) -> Dict[str, Any]:
    """``main``'s pipeline on its parsed arguments."""
    print_progress_header(1, "Loading Configuration")
    step_start = time.time()
    config = Config.from_yaml(args.config)
    print(f"Configuration loaded from: {args.config}")
    print_progress_footer(step_start)

    print_progress_header(2, "Validating Paths")
    step_start = time.time()
    for p in (config.data.train_data_path, config.data.val_data_path,
              config.data.processed_item_info_path):
        if not Path(p).exists():
            raise FileNotFoundError(f"Required data file not found: {p}")
    print_progress_footer(step_start)

    results = run_training(config, args)
    print(f"\nTraining complete in {results['training_time']:.1f}s; "
          f"best val loss {results['best_val_loss']:.4f}")
    return results


if __name__ == '__main__':
    main()
