# pixelrec_multimodal_tpu_torch/encoders/precompute.py
"""Batched frozen-encoder forwards -> item embedding tables.

Counterpart of ``pixelrec_multimodal_tpu/encoders/precompute.py``: the
frozen towers run once over the catalog in large batches on the device,
giving the float32 tables

    vision_emb    [n_items, dim_v]
    language_emb  [n_items, dim_l]
    clip_text_emb [n_items, 512]     (vision == 'clip')

that training and full-catalog scoring gather from. The host decodes the
images (the feature store's image tier) and stages the batches; the vision
forward normalizes the uint8 frames on the device. With a mesh
(``parallel/mesh.py``) each data rank stages and runs its share of every
batch, and the pooled rows are all-gathered in item order. The forwards run in
float32 with neither the products nor the convolutions in TF32
(``common.no_tf32``), for their scope only.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Union

import numpy as np
import torch
from torch import nn

from ..data.processors.image_processor import (
    PREPROCESS_SPECS,
    ImagePreprocessSpec,
)
from ..device import resolve_device
from ..parallel.mesh import (
    DATA_AXIS,
    all_gather,
    batch_sharding,
    pad_to_multiple,
)
from .common import no_tf32, random_init_
from .convert import load_pretrained_params
from .registry import (
    build_clip_text_encoder,
    build_language_encoder,
    build_vision_encoder,
    pooled_dim,
)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _batched_pooled(apply_fn: Callable, n_items: int, out_dim: int,
                    batch_size: int, make_batch: Callable,
                    device: torch.device, mesh=None) -> np.ndarray:
    """``apply_fn`` over the catalog in static-shape batches (the last one
    padded with item 0), into a float32 [n_items, out_dim] table.

    The next batch's host work (``make_batch``: gathering token rows or
    decoding JPEGs, then the copy to ``device``) runs on one worker thread
    while the device computes the current batch. Under a ``mesh`` the
    batch is padded to a multiple of the 'data' axis, each data rank takes
    its rows of it, and the pooled rows are all-gathered over 'data'."""
    if mesh is not None:
        batch_size = pad_to_multiple(batch_size, mesh.shape[DATA_AXIS])

    def staged(start):
        idx = np.arange(start, min(start + batch_size, n_items))
        valid = len(idx)
        if valid < batch_size:
            idx = np.concatenate(
                [idx, np.zeros(batch_size - valid, dtype=idx.dtype)])
        if mesh is not None:
            idx = idx[batch_sharding(mesh, batch_size)]
        return [_to_device(b, device) for b in make_batch(idx)], valid

    out = np.zeros((n_items, out_dim), dtype=np.float32)
    starts = list(range(0, n_items, batch_size))
    if not starts:
        return out
    with ThreadPoolExecutor(max_workers=1) as ex, torch.no_grad():
        fut = ex.submit(staged, starts[0])
        for i, start in enumerate(starts):
            batch, valid = fut.result()
            if i + 1 < len(starts):
                fut = ex.submit(staged, starts[i + 1])
            pooled = apply_fn(*batch).float()
            if mesh is not None:
                pooled = all_gather(mesh, DATA_AXIS, pooled.contiguous())
            out[start:start + valid] = pooled[:valid].cpu().numpy()
    return out


def params_or_random(modality: str, model_key: str, module: nn.Module,
                     rng_seed: int = 0) -> nn.Module:
    """``module`` with pretrained weights from a local HF cache, else
    random weights from ``torch.Generator(rng_seed)`` with a loud warning
    (no download is tried)."""
    state = load_pretrained_params(modality, model_key)
    if state is not None:
        module.load_state_dict(state, strict=True)
        print(f"Loaded pretrained weights for {modality}/{model_key}")
        return module
    print(f"WARNING: no local pretrained weights for {modality}/{model_key}; "
          "using random initialization. Embeddings will not match the "
          "reference's pretrained features.")
    return random_init_(module, rng_seed)


def vision_pooled_fn(model: nn.Module, spec: ImagePreprocessSpec,
                     device: torch.device) -> Callable:
    """The vision forward of uint8 HWC frames: scaled and normalized on
    the device, then NCHW through ``model.pooled``."""
    mean = torch.tensor(spec.mean, dtype=torch.float32,
                        device=device).reshape(1, 1, 1, 3)
    std = torch.tensor(spec.std, dtype=torch.float32,
                       device=device).reshape(1, 1, 1, 3)

    def forward(frames_u8: torch.Tensor) -> torch.Tensor:
        x = frames_u8.to(torch.float32) / 255.0
        return model.pooled(((x - mean) / std).permute(0, 3, 1, 2))
    return forward


def precompute_embedding_tables(store, config, batch_size: int = 64,
                                device: Union[str, torch.device] = 'cuda',
                                mesh=None) -> List[str]:
    """Fill a feature store's encoder-embedding tables on ``device``,
    the towers in float32, each batch split over the ``mesh``'s 'data'
    axis; returns the names of the tables added. ``store`` is a
    ``data.feature_store.ItemFeatureStore``."""
    dev = resolve_device(device)
    added: List[str] = []
    n = store.n_items
    vision_key = config.model.vision_model
    language_key = config.model.language_model

    def run(name, modality, key, model, make_batch, forward=None):
        model = params_or_random(modality, key, model).to(dev).eval()
        t0 = time.time()
        with no_tf32():
            table = _batched_pooled(forward(model) if forward else
                                    model.pooled, n,
                                    pooled_dim(modality, key), batch_size,
                                    make_batch, dev, mesh)
        store.set_embedding_table(name, table)
        added.append(name)
        print(f"{name}: {n} items in {time.time() - t0:.1f}s")

    # ------------------------------------------------------------- language
    if language_key and 'text_input_ids' in store.tables:
        ids_t = store.tables['text_input_ids']
        mask_t = store.tables['text_attention_mask']
        run('language_emb', 'language', language_key,
            build_language_encoder(language_key),
            lambda idx: (ids_t[idx], mask_t[idx]))

    # --------------------------------------------------------------- vision
    if vision_key and store.image_folder:
        spec = PREPROCESS_SPECS[vision_key]
        run('vision_emb', 'vision', vision_key,
            build_vision_encoder(vision_key),
            lambda idx: (store.image_batch_uint8(idx),),
            lambda model: vision_pooled_fn(model, spec, dev))

    # ------------------------------------------------------------ clip text
    if vision_key == 'clip' and 'clip_text_input_ids' in store.tables:
        ids_t = store.tables['clip_text_input_ids']
        mask_t = store.tables['clip_text_attention_mask']
        run('clip_text_emb', 'clip_text', 'clip',
            build_clip_text_encoder(),
            lambda idx: (ids_t[idx], mask_t[idx]))
    return added
