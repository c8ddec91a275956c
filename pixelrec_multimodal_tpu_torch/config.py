# pixelrec_multimodal_tpu_torch/config.py
"""Hierarchical dataclass configuration with YAML round-trip.

The port's own copy of ``pixelrec_multimodal_tpu/config.py`` (which is
framework-free): the same sections, fields, defaults and legacy flat cache
keys, so the same YAML files load in both packages. ``from_yaml`` and
``to_yaml`` read and write through the port's own YAML reader and writer
(``utils/yaml_io.py``), as ``yaml.safe_load`` reads and ``yaml.dump``
writes: the machine with the card has no PyYAML.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
import typing
from typing import Any, Dict, List, Optional, Union

from .utils import yaml_io

# Registry of the supported pretrained backbones: HF identifier + output dims.
# Parity: the reference src/config.py:18-31.
MODEL_CONFIGS: Dict[str, Dict[str, Dict[str, Any]]] = {
    'vision': {
        'clip': {'name': 'openai/clip-vit-base-patch32', 'dim': 768, 'text_dim': 512},
        'dino': {'name': 'facebook/dinov2-base', 'dim': 768},
        'resnet': {'name': 'microsoft/resnet-50', 'dim': 2048},
        'convnext': {'name': 'facebook/convnext-base-224', 'dim': 1024},
    },
    'language': {
        'sentence-bert': {'name': 'sentence-transformers/all-MiniLM-L6-v2', 'dim': 384},
        'mpnet': {'name': 'sentence-transformers/all-mpnet-base-v2', 'dim': 768},
        'bert': {'name': 'bert-base-uncased', 'dim': 768},
        'roberta': {'name': 'roberta-base', 'dim': 768},
    },
}


@dataclass
class ModelConfig:
    """Architecture of the recommender (parity: reference config.py:33-70)."""
    vision_model: Optional[str] = 'resnet'
    language_model: Optional[str] = 'sentence-bert'
    embedding_dim: int = 64
    fusion_type: str = 'concatenate'
    use_contrastive: bool = True
    freeze_vision: bool = True
    freeze_language: bool = True
    contrastive_temperature: float = 0.07
    dropout_rate: float = 0.3
    num_attention_heads: int = 4
    attention_dropout: float = 0.1
    fusion_hidden_dims: List[int] = field(default_factory=lambda: [512, 256, 128])
    fusion_activation: str = 'relu'
    use_batch_norm: bool = True
    projection_hidden_dim: Optional[int] = None
    final_activation: str = 'sigmoid'
    init_method: str = 'xavier_uniform'


@dataclass
class TrainingConfig:
    """Training-loop hyperparameters (parity: reference config.py:72-115)."""
    batch_size: int = 64
    learning_rate: float = 0.001
    epochs: int = 30
    patience: int = 10
    early_stopping_metric: str = 'val_loss'
    early_stopping_direction: str = 'minimize'
    weight_decay: float = 0.01
    gradient_clip: float = 1.0
    num_workers: int = 8
    contrastive_weight: float = 0.1
    bce_weight: float = 1.0
    use_lr_scheduler: bool = True
    lr_scheduler_type: str = 'reduce_on_plateau'
    lr_scheduler_patience: int = 2
    lr_scheduler_factor: float = 0.5
    lr_scheduler_min_lr: float = 1e-6
    optimizer_type: str = 'adamw'
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    # Micro-batches per optimizer update: the gradients of k micro-batches
    # are averaged and one update applies every k-th step
    # (training/optimizers.py).
    gradient_accumulation_steps: int = 1


@dataclass
class SimpleCacheConfig:
    """Feature-cache knobs (parity: reference config.py:117-127).

    The "cache" is a device-resident feature store: item features are
    packed once into device tables and gathered by item index inside the
    train step. The disk tier stores packed .npz table shards.
    """
    enabled: bool = True
    max_memory_items: int = 1000
    cache_directory: str = 'data/cache/features'
    use_disk: bool = False


@dataclass
class TextAugmentationConfig:
    """Text augmentation during training loads (parity: config.py:129-139)."""
    enabled: bool = False
    augmentation_type: str = 'random_delete'
    delete_prob: float = 0.1
    swap_prob: float = 0.1


@dataclass
class ImageAugmentationConfig:
    """Image augmentation during training (parity: config.py:141-169)."""
    enabled: bool = False
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    random_crop: bool = True
    crop_scale: List[float] = field(default_factory=lambda: [0.8, 1.0])
    horizontal_flip: bool = True
    rotation_degrees: float = 10
    gaussian_blur: bool = True
    blur_kernel_size: List[int] = field(default_factory=lambda: [5, 9])
    gaussian_noise: bool = False
    noise_std: float = 0.01

    def __post_init__(self):
        if self.brightness < 0:
            raise ValueError("Brightness factor must be non-negative.")
        if self.contrast < 0:
            raise ValueError("Contrast factor must be non-negative.")
        if self.saturation < 0:
            raise ValueError("Saturation factor must be non-negative.")
        if not (0 <= self.hue <= 0.5):
            raise ValueError("Hue factor must be between 0 and 0.5.")
        if self.random_crop and not (0 < self.crop_scale[0] <= self.crop_scale[1] <= 1.0):
            raise ValueError(
                "Invalid crop_scale. Must be [min, max] with 0 < min <= max <= 1.0.")


@dataclass
class ImageValidationConfig:
    """Offline image validation rules (parity: config.py:171-181)."""
    check_corrupted: bool = True
    min_width: int = 64
    min_height: int = 64
    allowed_extensions: List[str] = field(default_factory=lambda: ['.jpg', '.jpeg', '.png'])


@dataclass(frozen=True)
class OfflineTextCleaningConfig:
    """Offline text cleaning rules (parity: config.py:183-192)."""
    enabled: bool = True
    remove_html: bool = True
    normalize_unicode: bool = True
    to_lowercase: bool = True


@dataclass
class DataSplittingConfig:
    """Train/val/test split strategy (parity: config.py:194-216)."""
    strategy: str = 'user'
    stratify_by: Optional[str] = None
    tag_grouping_threshold: Optional[int] = None
    random_state: int = 42
    train_final_ratio: float = 0.6
    val_final_ratio: float = 0.2
    test_final_ratio: float = 0.2
    min_interactions_per_user: int = 5
    min_interactions_per_item: int = 5
    validate_no_leakage: bool = True


@dataclass
class OfflineImageCompressionConfig:
    """Offline image compression rules (parity: config.py:218-230)."""
    enabled: bool = True
    compress_if_kb_larger_than: int = 500
    target_quality: int = 85
    resize_if_pixels_larger_than: Optional[List[int]] = field(
        default_factory=lambda: [2048, 2048])
    resize_target_longest_edge: Optional[int] = 1024


def _default_search_space() -> Dict[str, Dict[str, Any]]:
    # Parity with the reference search-space data (config.py:270-364).
    return {
        'learning_rate': {'type': 'float', 'low': 1e-5, 'high': 1e-2, 'log': True},
        'batch_size': {'type': 'categorical', 'choices': [16, 32, 64, 128]},
        'weight_decay': {'type': 'float', 'low': 1e-6, 'high': 1e-2, 'log': True},
        'patience': {'type': 'int', 'low': 2, 'high': 10},
        'gradient_clip': {'type': 'float', 'low': 0.5, 'high': 5.0},
        'embedding_dim': {'type': 'categorical', 'choices': [64, 128, 256, 512]},
        'fusion_type': {'type': 'categorical',
                        'choices': ['concatenate', 'attention', 'gated']},
        'dropout_rate': {'type': 'float', 'low': 0.1, 'high': 0.5},
        'fusion_hidden_dims': {
            'type': 'categorical',
            'choices': [[256, 128], [512, 256], [128, 64], [256, 128, 64]]},
        'contrastive_weight': {'type': 'float', 'low': 0.0, 'high': 1.0},
        'bce_weight': {'type': 'float', 'low': 0.5, 'high': 1.0},
        'optimizer_type': {'type': 'categorical', 'choices': ['adam', 'adamw', 'sgd']},
        'adam_beta1': {'type': 'float', 'low': 0.8, 'high': 0.99,
                       'condition': 'optimizer_type in ["adam", "adamw"]'},
        'adam_beta2': {'type': 'float', 'low': 0.9, 'high': 0.999,
                       'condition': 'optimizer_type in ["adam", "adamw"]'},
        'use_lr_scheduler': {'type': 'categorical', 'choices': [True, False]},
        'lr_scheduler_type': {'type': 'categorical',
                              'choices': ['reduce_on_plateau', 'cosine', 'step'],
                              'condition': 'use_lr_scheduler == True'},
        'lr_scheduler_factor': {'type': 'float', 'low': 0.1, 'high': 0.9,
                                'condition': 'use_lr_scheduler == True'},
    }


@dataclass
class HyperparameterSearchConfig:
    """HPO settings (parity: reference config.py:235-438)."""
    n_trials: int = 100
    study_name: Optional[str] = None
    storage: Optional[str] = None
    direction: str = 'minimize'
    metric: str = 'val_loss'
    enable_pruning: bool = True
    pruner_type: str = 'median'
    n_jobs: int = 1
    seed: int = 42
    output_dir: str = 'optuna_trials'
    search_space: Dict[str, Dict[str, Any]] = field(default_factory=_default_search_space)
    sampler_config: Dict[str, Any] = field(default_factory=lambda: {
        'type': 'TPESampler',
        'n_startup_trials': 10,
        'n_ei_candidates': 24,
        'multivariate': False,
        'group': False,
        'warn_independent_sampling': True,
    })
    pruner_config: Dict[str, Any] = field(default_factory=lambda: {
        'n_startup_trials': 5,
        'n_warmup_steps': 0,
        'interval_steps': 1,
        'percentile': 50.0,
        'min_resource': 1,
        'max_resource': 'auto',
        'reduction_factor': 3,
    })
    save_trial_checkpoints: bool = False
    delete_unsuccessful_trials: bool = True
    min_improvement_threshold: float = 1e-4
    resume_if_exists: bool = True
    create_visualizations: bool = True
    visualization_formats: List[str] = field(default_factory=lambda: ['html', 'png'])

    def get_parameter_config(self, param_name: str) -> Dict[str, Any]:
        return self.search_space.get(param_name, {})

    def validate(self):
        if self.direction not in ('minimize', 'maximize'):
            raise ValueError("direction must be one of ['minimize', 'maximize']")
        if self.pruner_type not in ('median', 'percentile', 'hyperband'):
            raise ValueError(
                "pruner_type must be one of ['median', 'percentile', 'hyperband']")
        for name, spec in self.search_space.items():
            kind = spec.get('type')
            if kind is None:
                raise ValueError(f"Parameter {name} must have a 'type' field")
            if kind in ('float', 'int') and not ('low' in spec and 'high' in spec):
                raise ValueError(
                    f"Parameter {name} of type {kind} must have 'low' and 'high' fields")
            if kind == 'categorical' and 'choices' not in spec:
                raise ValueError(
                    f"Parameter {name} of type categorical must have 'choices' field")


@dataclass
class DataConfig:
    """All data-related paths and knobs (parity: reference config.py:440-506)."""
    item_info_path: str = 'data/processed/item_info.csv'
    interactions_path: str = 'data/processed/interactions.csv'
    image_folder: str = 'data/raw/images'
    processed_item_info_path: str = 'data/processed/item_info.csv'
    processed_interactions_path: str = 'data/processed/interactions.csv'
    split_data_path: str = 'data/splits/split_1'
    train_data_path: str = 'data/splits/split_1/train.csv'
    val_data_path: str = 'data/splits/split_1/val.csv'
    test_data_path: str = 'data/splits/split_1/test.csv'
    image_compression_config: OfflineImageCompressionConfig = field(
        default_factory=OfflineImageCompressionConfig)
    image_validation_config: ImageValidationConfig = field(
        default_factory=ImageValidationConfig)
    text_cleaning_config: OfflineTextCleaningConfig = field(
        default_factory=OfflineTextCleaningConfig)
    cache_config: SimpleCacheConfig = field(default_factory=SimpleCacheConfig)
    scaler_path: str = 'data/processed/numerical_scaler.pkl'
    processed_image_destination_folder: Optional[str] = 'data/processed/images'
    negative_sampling_strategy: str = 'random'
    negative_sampling_ratio: float = 1.0
    numerical_normalization_method: str = 'standardization'
    numerical_features_cols: List[str] = field(default_factory=lambda: [
        'view_number', 'comment_number', 'thumbup_number',
        'share_number', 'coin_number', 'favorite_number', 'barrage_number',
    ])
    categorical_features_cols: List[str] = field(default_factory=lambda: ['tag'])
    text_augmentation: TextAugmentationConfig = field(default_factory=TextAugmentationConfig)
    image_augmentation: ImageAugmentationConfig = field(default_factory=ImageAugmentationConfig)
    offline_image_compression: OfflineImageCompressionConfig = field(
        default_factory=OfflineImageCompressionConfig)
    offline_image_validation: ImageValidationConfig = field(
        default_factory=ImageValidationConfig)
    offline_text_cleaning: OfflineTextCleaningConfig = field(
        default_factory=OfflineTextCleaningConfig)
    splitting: DataSplittingConfig = field(default_factory=DataSplittingConfig)

    def __post_init__(self):
        # Flat aliases kept for backward compatibility with the reference API
        # (reference config.py:500-506).
        self.cache_processed_images = self.cache_config.enabled
        self.cache_features = self.cache_config.enabled
        self.cache_max_items = self.cache_config.max_memory_items
        self.cache_dir = self.cache_config.cache_directory
        self.cache_to_disk = self.cache_config.use_disk


@dataclass
class RecommendationConfig:
    """Recommendation-generation knobs (parity: reference config.py:508-521)."""
    top_k: int = 50
    diversity_weight: float = 0.3
    novelty_weight: float = 0.2
    filter_seen: bool = True
    max_candidates: int = 1000


# Legacy flat cache keys accepted at the `data:` level of old YAML files
# (reference config.py:635-649).
_LEGACY_CACHE_KEYS = ('cache_features', 'cache_processed_images', 'cache_max_items',
                      'cache_dir', 'cache_to_disk')


def _unwrap_optional(tp: Any) -> Any:
    """Union[X, None] -> X; anything else unchanged."""
    if typing.get_origin(tp) is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if args:
            return args[0]
    return tp


def _build_dataclass(dc_type: Any, raw: Optional[Dict[str, Any]]) -> Any:
    """Instantiate ``dc_type`` from a (possibly partial) dict, recursing into
    nested dataclass fields and falling back to defaults for missing keys."""
    if raw is None:
        return dc_type()
    kwargs: Dict[str, Any] = {}
    # Resolve string annotations (``from __future__ import annotations``).
    hints = typing.get_type_hints(dc_type)
    for f in fields(dc_type):
        if f.name not in raw:
            continue
        value = raw[f.name]
        ftype = _unwrap_optional(hints.get(f.name, f.type))
        if is_dataclass(ftype) and isinstance(value, dict):
            kwargs[f.name] = _build_dataclass(ftype, value)
        else:
            kwargs[f.name] = value

    if dc_type is DataConfig and any(k in raw for k in _LEGACY_CACHE_KEYS):
        # Migrate old flat cache keys into the nested SimpleCacheConfig.
        enabled = raw.get('cache_features', raw.get('cache_processed_images', True))
        kwargs['cache_config'] = SimpleCacheConfig(
            enabled=enabled,
            max_memory_items=raw.get('cache_max_items', 1000),
            cache_directory=raw.get('cache_dir', 'data/cache/features'),
            use_disk=raw.get('cache_to_disk', False),
        )
    return dc_type(**kwargs)


def _to_plain(obj: Any) -> Any:
    """Recursively convert dataclasses/lists/dicts into YAML-safe builtins,
    skipping private fields."""
    if is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name))
                for f in fields(obj) if not f.name.startswith('_')}
    if isinstance(obj, list):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    return obj


@dataclass
class Config:
    """Aggregate configuration (parity: reference config.py:523-721)."""
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    data: DataConfig = field(default_factory=DataConfig)
    recommendation: RecommendationConfig = field(default_factory=RecommendationConfig)
    hyperparameter_search: HyperparameterSearchConfig = field(
        default_factory=HyperparameterSearchConfig)
    checkpoint_dir: str = 'models/checkpoints'
    results_dir: str = 'results'

    @property
    def model_specific_checkpoint_dir(self) -> str:
        """e.g. 'models/checkpoints/resnet_sentence-bert'."""
        return f"{self.checkpoint_dir}/{self.model.vision_model}_{self.model.language_model}"

    @property
    def shared_encoders_dir(self) -> str:
        """e.g. 'models/checkpoints/encoders'."""
        return f"{self.checkpoint_dir}/encoders"

    def get_model_checkpoint_path(self, filename: str) -> str:
        return f"{self.model_specific_checkpoint_dir}/{filename}"

    def get_encoder_path(self, encoder_name: str) -> str:
        return f"{self.shared_encoders_dir}/{encoder_name}"

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> 'Config':
        return cls(
            model=_build_dataclass(ModelConfig, raw.get('model')),
            training=_build_dataclass(TrainingConfig, raw.get('training')),
            data=_build_dataclass(DataConfig, raw.get('data')),
            recommendation=_build_dataclass(RecommendationConfig, raw.get('recommendation')),
            hyperparameter_search=_build_dataclass(
                HyperparameterSearchConfig, raw.get('hyperparameter_search')),
            checkpoint_dir=raw.get('checkpoint_dir', 'models/checkpoints'),
            results_dir=raw.get('results_dir', 'results'),
        )

    @classmethod
    def from_yaml(cls, path: str) -> 'Config':
        return cls.from_dict(yaml_io.load_file(path) or {})

    def to_dict(self) -> Dict[str, Any]:
        return _to_plain(self)

    def to_yaml(self, path: str):
        yaml_io.dump_file(self.to_dict(), path)

    def get_model_info(self) -> Dict[str, Any]:
        """Names and dims of the configured backbones (reference config.py:700-721)."""
        out = {}
        for modality, key in (('vision', self.model.vision_model),
                              ('language', self.model.language_model)):
            out[modality] = {
                'key_name': key,
                'pretrained_model_name': MODEL_CONFIGS[modality][key]['name'],
                'output_dimension': MODEL_CONFIGS[modality][key]['dim'],
            }
        return out
