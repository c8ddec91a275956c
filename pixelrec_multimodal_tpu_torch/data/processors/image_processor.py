# pixelrec_multimodal_tpu_torch/data/processors/image_processor.py
"""Image decode and preprocessing for the image tier: the online mode
(the dataset's decode path) and the offline mode (validation and
compression of the raw images, the preprocess entry point's step 3).

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
decoded still gives the placeholder, as in JAX.

The offline mode copies JAX's ``process_items_images`` and its helpers,
quirks included: an existing destination file counts as valid;
``_should_compress_image`` tests the file's size alone, and
``_compress_and_save`` resizes (LANCZOS) when
``resize_if_pixels_larger_than`` is set and the longest edge passes
``resize_target_longest_edge``; ``.jpg``/``.jpeg`` are saved with
``quality`` and ``optimize=True``, anything else with a plain ``save``.
Its decoder is chosen once per run, before the per-file ``try``
(``data/image_codecs.image_decoder``: PIL, else nvJPEG on ``cuda``, else
``ImageCodecMissing``), and logged. The per-file ``try`` turns any failure
into an invalid file, as JAX's does, but lets ``ImageCodecMissing``
through: a PNG under nvJPEG, or a file to compress where PIL (the
encoder) is missing, raises naming ROADMAP item A12.
"""
from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Set, Tuple

import numpy as np

from ...config import (
    ImageValidationConfig,
    MODEL_CONFIGS,
    OfflineImageCompressionConfig,
)
from ..image_codecs import ImageCodecMissing, image_decoder, pil_image
from .. import preprocessing  # its image checks; imports this package

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# PIL.Image.Resampling values.
LANCZOS, BILINEAR, BICUBIC = 1, 2, 3
# Threads of the offline mode's per-item work.
OFFLINE_WORKERS = min(8, os.cpu_count() or 1)


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
    """Dual-mode image processor: the online mode (``model_name``) and the
    offline mode (``validation_config``, ``compression_config``; ``device``
    chooses nvJPEG where PIL is missing)."""

    def __init__(self, model_name: Optional[str] = None,
                 compression_config: Optional[
                     OfflineImageCompressionConfig] = None,
                 validation_config: Optional[ImageValidationConfig] = None,
                 device='cpu'):
        self.model_name = model_name
        self.compression_config = compression_config
        self.validation_config = validation_config
        self.device = device
        self.decoder = None
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
        """Validate, compress or copy each item's image; returns the ids
        that passed. Chooses the decoder first (``self.decoder``) and
        raises ``ImageCodecMissing`` where there is none. The items run on
        OFFLINE_WORKERS threads (JAX's loop runs them in turn): the work is
        file reads, copies and decodes, which release the GIL, and each
        item's outcome is its own."""
        if not self.validation_config:
            raise RuntimeError(
                "ImageProcessor not initialized for offline mode. "
                "Provide 'validation_config'.")
        self.decoder = image_decoder(self.device)
        print(f"Validating images with {self.decoder.name}")
        source_folder, dest_folder = Path(source_folder), Path(dest_folder)
        dest_folder.mkdir(parents=True, exist_ok=True)

        def passes(item_id) -> bool:
            src = self._find_image_for_item(str(item_id), source_folder)
            return bool(src) and self._process_single_image(
                src, dest_folder / src.name)
        pool = ThreadPoolExecutor(max_workers=OFFLINE_WORKERS)
        try:
            flags = list(pool.map(passes, item_ids))
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        return {item_id for item_id, ok in zip(item_ids, flags) if ok}

    def _find_image_for_item(self, item_id: str, source_folder: Path
                             ) -> Optional[Path]:
        for ext in self.validation_config.allowed_extensions:
            p = source_folder / f"{item_id}{ext}"
            if p.exists():
                return p
        return None

    def _process_single_image(self, source_path: Path, dest_path: Path
                              ) -> bool:
        if dest_path.exists():
            return True
        dest_path.parent.mkdir(parents=True, exist_ok=True)
        decoder = self.decoder or image_decoder(self.device)
        vc = self.validation_config
        try:
            if not source_path.exists():
                return False
            if vc.check_corrupted and preprocessing.is_image_corrupted(
                    str(source_path), decoder):
                return False
            if not preprocessing.check_image_dimensions(
                    str(source_path), vc.min_width, vc.min_height, decoder):
                return False
            if self._should_compress_image(source_path):
                self._compress_and_save(source_path, dest_path)
            else:
                shutil.copy2(source_path, dest_path)
            return True
        except ImageCodecMissing:
            raise
        except Exception:
            return False

    def _should_compress_image(self, image_path: Path) -> bool:
        cc = self.compression_config
        if not cc or not cc.enabled:
            return False
        return image_path.stat().st_size / 1024 > cc.compress_if_kb_larger_than

    def _compress_and_save(self, source_path: Path, dest_path: Path):
        """Re-encode with PIL (``ImageCodecMissing`` without it)."""
        cc = self.compression_config
        Image = pil_image()
        with Image.open(source_path) as img:
            img = img.convert('RGB')
            if cc.resize_if_pixels_larger_than and \
                    max(img.size) > cc.resize_target_longest_edge:
                scale = cc.resize_target_longest_edge / max(img.size)
                img = img.resize((int(img.width * scale),
                                  int(img.height * scale)), LANCZOS)
            if dest_path.suffix.lower() in ('.jpg', '.jpeg'):
                img.save(dest_path, quality=cc.target_quality, optimize=True)
            else:
                img.save(dest_path)
