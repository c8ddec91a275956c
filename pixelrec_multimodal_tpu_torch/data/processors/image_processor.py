# pixelrec_multimodal_tpu_torch/data/processors/image_processor.py
"""Image decode and preprocessing for the image tier, online mode.

Counterpart of ``pixelrec_multimodal_tpu/data/processors/
image_processor.py``: each vision backbone has a static
:class:`ImagePreprocessSpec` (resize, center crop and normalization
constants of the HF processors' configs); the host decodes, resizes and
center-crops to a uint8 HWC frame, and the normalization runs later as
one vectorized pass (``normalize_chw`` here, or on the device).

The resample filters are stored as PIL's integer values, so importing this
module loads no PIL. The decoder is imported when an image is loaded,
outside the per-image ``try``: without PIL, loading raises instead of
turning every frame into the zero placeholder. A file that cannot be
decoded still gives the placeholder, as in JAX. The offline mode
(validation and compression of the raw images) is not ported yet and
raises (ROADMAP item A12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np

from ...config import MODEL_CONFIGS

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# PIL.Image.Resampling values.
BILINEAR, BICUBIC = 2, 3

_NO_OFFLINE = ('the image processor\'s offline mode (validation and '
               'compression) is not ported yet (ROADMAP item A12)')


@dataclass(frozen=True)
class ImagePreprocessSpec:
    """Static preprocessing recipe for one vision backbone (the HF
    image-processor configs: resize shortest edge, center crop,
    per-channel normalization)."""
    resize_shortest: int
    crop_size: int
    resample: int  # PIL.Image.Resampling value
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]

    @property
    def output_hw(self) -> Tuple[int, int]:
        return (self.crop_size, self.crop_size)


# Per-model specs matching the published HF preprocessor configs.
PREPROCESS_SPECS = {
    'clip': ImagePreprocessSpec(224, 224, BICUBIC, _CLIP_MEAN, _CLIP_STD),
    'dino': ImagePreprocessSpec(256, 224, BICUBIC, _IMAGENET_MEAN,
                                _IMAGENET_STD),
    'resnet': ImagePreprocessSpec(224, 224, BILINEAR, _IMAGENET_MEAN,
                                  _IMAGENET_STD),
    'convnext': ImagePreprocessSpec(256, 224, BICUBIC, _IMAGENET_MEAN,
                                    _IMAGENET_STD),
}


def pil_image():
    """PIL's ``Image`` module; raises ImportError naming the missing
    decoder where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            'decoding images needs PIL, which is not installed here; the '
            'image tier has no other decoder yet (ROADMAP item A12)') from e
    return Image


def resize_and_center_crop(image, spec: ImagePreprocessSpec):
    """Resize a PIL image's shortest edge to ``spec.resize_shortest``,
    then center-crop to ``spec.crop_size``."""
    w, h = image.size
    scale = spec.resize_shortest / min(w, h)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    image = image.resize((nw, nh), spec.resample)
    left = (nw - spec.crop_size) // 2
    top = (nh - spec.crop_size) // 2
    return image.crop((left, top, left + spec.crop_size,
                       top + spec.crop_size))


def normalize_chw(frame_uint8: np.ndarray, spec: ImagePreprocessSpec
                  ) -> np.ndarray:
    """uint8 HWC frame -> normalized float32 CHW tensor."""
    x = frame_uint8.astype(np.float32) / 255.0
    x = (x - np.asarray(spec.mean, np.float32)) / np.asarray(spec.std,
                                                             np.float32)
    return np.ascontiguousarray(x.transpose(2, 0, 1))


class ImageProcessor:
    """The image processor's online mode (the dataset's decode path)."""

    def __init__(self, model_name: Optional[str] = None):
        self.model_name = model_name
        if model_name:
            if model_name not in MODEL_CONFIGS['vision']:
                raise ValueError(
                    f"Configuration for vision model '{model_name}' not found.")
            self.config = MODEL_CONFIGS['vision'][model_name]
            self.spec = PREPROCESS_SPECS[model_name]
        else:
            self.config = None
            self.spec = None

    # ------------------------------------------------------------ online mode
    def load_image_uint8(self, image_path: str) -> Optional[np.ndarray]:
        """Decode, resize and center-crop to a uint8 HWC frame; None when
        the file is missing or cannot be decoded. Raises ImportError
        without PIL."""
        if self.spec is None:
            raise RuntimeError(
                "ImageProcessor not initialized for online mode. Provide "
                "'model_name'.")
        Image = pil_image()
        try:
            with Image.open(image_path) as img:
                img = resize_and_center_crop(img.convert('RGB'), self.spec)
                return np.asarray(img, dtype=np.uint8)
        except Exception:
            return None

    def load_and_transform_image(self, image_path: str) -> np.ndarray:
        """One image as a normalized float32 CHW tensor; the zero
        placeholder for a missing or undecodable file."""
        frame = self.load_image_uint8(image_path) if self.spec else None
        if frame is None:
            return self.get_placeholder_tensor()
        return normalize_chw(frame, self.spec)

    def get_placeholder_tensor(self) -> np.ndarray:
        size = self.spec.output_hw if self.spec else (224, 224)
        return np.zeros((3, size[0], size[1]), dtype=np.float32)

    # ----------------------------------------------------------- offline mode
    def process_items_images(self, item_ids: List[str], source_folder,
                             dest_folder) -> Set[str]:
        raise NotImplementedError(_NO_OFFLINE)
