"""Batched image augmentation on the images' device, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/ops/augment.py``: random resized
crop, color jitter, horizontal flip, rotation, Gaussian blur and Gaussian
noise over a (B, C, H, W) float batch, in the reference's order, with
JAX's arithmetic: bilinear gathers that clip the far neighbour only
(``y_c``, ``x_c``), rotation with a validity mask and zero fill, hue as a
rotation in YIQ space, a separable blur with one sigma per batch and
zero padding. No ``F.grid_sample`` or torchvision: their conventions
differ at the borders.

Each op comes in two halves. ``*_draws(generator, ...)`` draws its random
parameters (crop boxes, factors, angles, flip bits, sigma, noise) from an
explicit ``torch.Generator`` on the images' device; the apply half takes
those parameters and is deterministic. The random op of JAX's name
(``random_resized_crop``, ...) composes the two, and ``augment_batch``
runs the pipeline, from a generator or from draws given (``augment_draws``
makes them), so a test can feed JAX's own draws to the apply halves. The
draws cannot equal JAX's for one seed (a ``torch.Generator`` is not a
JAX key). Plain PyTorch on the card: JAX computes this outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..config import ImageAugmentationConfig

Draws = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, shape, low: float,
             high: float) -> torch.Tensor:
    return low + torch.rand(shape, generator=generator,
                            device=generator.device) * (high - low)


# The same draws give the same images on the CPU and on the card: a source
# point of a rotation far from the centre moves with an ulp of its angle's
# cos or sin, and the output with it by the difference of two neighbours.
def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as the CPU (and XLA) divide; on the card
    PyTorch multiplies by the reciprocal of a Python number instead."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _trig(t: torch.Tensor):
    """cos and sin of a float32 angle, in float64 rounded once (the CPU's
    and the card's float32 versions differ by an ulp)."""
    t = t.double()
    return torch.cos(t).float(), torch.sin(t).float()


# ------------------------------------------------------------------ crop
def crop_draws(generator: torch.Generator, B: int, H: int, W: int,
               scale: Sequence[float] = (0.8, 1.0),
               ratio: Sequence[float] = (0.75, 4.0 / 3.0)) -> Draws:
    """Crop boxes: top-left ``y0``, ``x0`` and extent ``ch``, ``cw`` (B,)
    each, the area a uniform share of ``scale``, the aspect log-uniform
    in ``ratio``, each side clipped to [8, size]."""
    area = _uniform(generator, (B,), scale[0], scale[1])
    r = torch.exp(_uniform(generator, (B,), math.log(ratio[0]),
                           math.log(ratio[1])))
    ch = torch.clamp(torch.sqrt(area / r) * H, 8, H)
    cw = torch.clamp(torch.sqrt(area * r) * W, 8, W)
    x0 = _uniform(generator, (B,), 0.0, 1.0) * (W - cw)
    y0 = _uniform(generator, (B,), 0.0, 1.0) * (H - ch)
    return {'y0': y0, 'x0': x0, 'ch': ch, 'cw': cw}


def _gather_rows(images: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """images[b, :, rows[b], :] for rows (B, H)."""
    B, C, _, W = images.shape
    return images.gather(2, rows[:, None, :, None].expand(
        B, C, rows.shape[1], W))


def _gather_cols(images: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """images[b, :, :, cols[b]] for cols (B, W)."""
    B, C, H, _ = images.shape
    return images.gather(3, cols[:, None, None, :].expand(
        B, C, H, cols.shape[1]))


def _unit_steps(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: ``i`` times the float32
    reciprocal of ``n - 1`` (XLA's division by a constant), the last 1."""
    inv = _true_div(torch.ones((), device=device), n - 1)
    steps = torch.arange(n, dtype=torch.float32, device=device) * inv
    steps[-1] = 1.0
    return steps


def resized_crop(images: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 ch: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """Each image's box (``y0``, ``x0``, ``ch``, ``cw``) resampled
    bilinearly back to (H, W): source row ``y0 + i / (H - 1) * (ch - 1)``,
    the lower neighbour ``floor``, the upper one clipped to the image."""
    B, C, H, W = images.shape
    ys, xs = _unit_steps(H, images.device), _unit_steps(W, images.device)
    src_y = y0[:, None] + ys[None, :] * (ch[:, None] - 1)
    src_x = x0[:, None] + xs[None, :] * (cw[:, None] - 1)
    y_f, x_f = torch.floor(src_y), torch.floor(src_x)
    # The boxes keep y_f and x_f inside the image; the clamp is only
    # JAX's gather, which clamps any index past the edge.
    yi = y_f.long().clamp(0, H - 1)
    xi = x_f.long().clamp(0, W - 1)
    y_c = (y_f.long() + 1).clamp(0, H - 1)
    x_c = (x_f.long() + 1).clamp(0, W - 1)
    wy = (src_y - y_f)[:, None, :, None]
    wx = (src_x - x_f)[:, None, None, :]
    top_rows, bot_rows = _gather_rows(images, yi), _gather_rows(images, y_c)
    tl, tr = _gather_cols(top_rows, xi), _gather_cols(top_rows, x_c)
    bl, br = _gather_cols(bot_rows, xi), _gather_cols(bot_rows, x_c)
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop(generator: torch.Generator, images: torch.Tensor,
                        scale=(0.8, 1.0),
                        ratio=(0.75, 4.0 / 3.0)) -> torch.Tensor:
    """Batched RandomResizedCrop back to the input size (B, C, H, W)."""
    B, _, H, W = images.shape
    return resized_crop(images, **crop_draws(generator, B, H, W, scale,
                                             ratio))


# ---------------------------------------------------------------- jitter
def jitter_draws(generator: torch.Generator, B: int, brightness=0.2,
                 contrast=0.2, saturation=0.2, hue=0.1) -> Draws:
    """Factors (B, 1, 1, 1) in [1 - s, 1 + s] for each of brightness,
    contrast and saturation whose strength ``s`` is not 0, and the hue
    angle (B, 1, 1) in radians, uniform in +-2 pi ``hue``."""
    out = {}
    for name, s in (('brightness', brightness), ('contrast', contrast),
                    ('saturation', saturation)):
        if s:
            out[name] = _uniform(generator, (B, 1, 1, 1), 1 - s, 1 + s)
    if hue:
        out['hue'] = _uniform(generator, (B, 1, 1), -hue * 2 * math.pi,
                              hue * 2 * math.pi)
    return out


def jitter(images: torch.Tensor, brightness: Optional[torch.Tensor] = None,
           contrast: Optional[torch.Tensor] = None,
           saturation: Optional[torch.Tensor] = None,
           hue: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Brightness, contrast, saturation and hue by the given factors, in
    that order; a factor of None skips its step. Hue rotates the chroma
    components in YIQ space (cheap and differentiable; torchvision
    converts through HSV)."""
    out = images
    if brightness is not None:
        out = out * brightness
    if contrast is not None:
        mean = out.mean(dim=(1, 2, 3), keepdim=True)
        out = (out - mean) * contrast + mean
    if saturation is not None:
        gray = out.mean(dim=1, keepdim=True)
        out = gray + (out - gray) * saturation
    if hue is not None:
        r, g, b = out[:, 0], out[:, 1], out[:, 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        i = 0.596 * r - 0.274 * g - 0.322 * b
        q = 0.211 * r - 0.523 * g + 0.312 * b
        cos, sin = _trig(hue)
        i2 = i * cos - q * sin
        q2 = i * sin + q * cos
        out = torch.stack([
            y + 0.956 * i2 + 0.621 * q2,
            y - 0.272 * i2 - 0.647 * q2,
            y - 1.106 * i2 + 1.703 * q2,
        ], dim=1)
    return out


def color_jitter(generator: torch.Generator, images: torch.Tensor,
                 brightness=0.2, contrast=0.2, saturation=0.2,
                 hue=0.1) -> torch.Tensor:
    """Batched brightness/contrast/saturation/hue jitter on CHW images."""
    return jitter(images, **jitter_draws(generator, images.shape[0],
                                         brightness, contrast, saturation,
                                         hue))


# ------------------------------------------------------------------ flip
def flip_draws(generator: torch.Generator, B: int, p: float = 0.5) -> Draws:
    """Flip bits (B,), each true with probability ``p``."""
    return {'flip': torch.rand((B,), generator=generator,
                               device=generator.device) < p}


def horizontal_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """The images whose bit is set, mirrored left to right."""
    return torch.where(flip[:, None, None, None], images.flip(-1), images)


def random_horizontal_flip(generator: torch.Generator, images: torch.Tensor,
                           p: float = 0.5) -> torch.Tensor:
    return horizontal_flip(images, **flip_draws(generator, images.shape[0],
                                                p))


# -------------------------------------------------------------- rotation
def rotation_draws(generator: torch.Generator, B: int,
                   degrees: float) -> Draws:
    """Angles (B,) in degrees, uniform in +-``degrees``."""
    return {'degrees': _uniform(generator, (B,), -degrees, degrees)}


def rotate(images: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Each image rotated by its angle about the centre: bilinear, the
    four neighbours clipped to the image, zero where the source point
    falls outside it."""
    B, C, H, W = images.shape
    t = _true_div(degrees * math.pi, 180.0)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=images.device),
        torch.arange(W, dtype=torch.float32, device=images.device),
        indexing='ij')
    cos, sin = _trig(t)
    cos, sin = cos[:, None, None], sin[:, None, None]
    src_y = cos * (yy - cy) + sin * (xx - cx) + cy
    src_x = -sin * (yy - cy) + cos * (xx - cx) + cx
    y_f, x_f = torch.floor(src_y), torch.floor(src_x)
    wy, wx = src_y - y_f, src_x - x_f
    valid = ((src_y >= 0) & (src_y <= H - 1)
             & (src_x >= 0) & (src_x <= W - 1))
    y_f, x_f = y_f.long(), x_f.long()
    flat = images.reshape(B, C, H * W)

    def sample(yi, xi):
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, 1, -1)
        return flat.gather(2, idx.expand(B, C, H * W)).reshape(B, C, H, W)

    wy, wx = wy[:, None], wx[:, None]
    val = (sample(y_f, x_f) * (1 - wy) * (1 - wx)
           + sample(y_f, x_f + 1) * (1 - wy) * wx
           + sample(y_f + 1, x_f) * wy * (1 - wx)
           + sample(y_f + 1, x_f + 1) * wy * wx)
    return torch.where(valid[:, None], val, torch.zeros_like(val))


def random_rotation(generator: torch.Generator, images: torch.Tensor,
                    degrees: float) -> torch.Tensor:
    """Batched rotation by a uniform angle in +-degrees (bilinear, zero
    fill)."""
    return rotate(images, **rotation_draws(generator, images.shape[0],
                                           degrees))


# ------------------------------------------------------------------ blur
def blur_draws(generator: torch.Generator,
               sigma_range: Sequence[float] = (0.1, 2.0)) -> Draws:
    """One sigma for the whole batch (a 0-d tensor)."""
    return {'sigma': _uniform(generator, (), sigma_range[0],
                              sigma_range[1])}


def blur(images: torch.Tensor, sigma: torch.Tensor,
         kernel_size: int = 5) -> torch.Tensor:
    """Separable Gaussian blur, rows then columns, zero padding: each pass
    a weighted sum of shifted copies, so it is float32 on any device (a
    cuDNN convolution may run in TF32)."""
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32,
                      device=images.device)
    k1d = torch.exp((-0.5 * (xs / sigma) ** 2).double()).float()
    k1d = k1d / k1d.sum()

    def taps(x, dim):
        n = x.shape[dim]
        pad = (0, 0, half, half) if dim == 2 else (half, half)
        xp = F.pad(x, pad)
        out = k1d[0] * xp.narrow(dim, 0, n)
        for j in range(1, kernel_size):
            out = out + k1d[j] * xp.narrow(dim, j, n)
        return out
    return taps(taps(images, 2), 3)


def gaussian_blur(generator: torch.Generator, images: torch.Tensor,
                  kernel_size: int = 5,
                  sigma_range=(0.1, 2.0)) -> torch.Tensor:
    """Batched separable Gaussian blur with a per-batch random sigma."""
    return blur(images, **blur_draws(generator, sigma_range),
                kernel_size=kernel_size)


# ----------------------------------------------------------------- noise
def noise_draws(generator: torch.Generator, shape) -> Draws:
    """Standard normal noise of the images' shape."""
    return {'noise': torch.randn(shape, generator=generator,
                                 device=generator.device)}


def add_noise(images: torch.Tensor, noise: torch.Tensor,
              std: float) -> torch.Tensor:
    return images + noise * std


def gaussian_noise(generator: torch.Generator, images: torch.Tensor,
                   std: float) -> torch.Tensor:
    return add_noise(images, **noise_draws(generator, images.shape), std=std)


# -------------------------------------------------------------- pipeline
def augment_draws(generator: torch.Generator, shape,
                  config: ImageAugmentationConfig) -> Dict[str, Draws]:
    """The draws of every op ``config`` enables, by op name ('crop',
    'jitter', 'flip', 'rotation', 'blur', 'noise'), for images of
    ``shape``."""
    B, _, H, W = shape
    out = {}
    if config.random_crop:
        out['crop'] = crop_draws(generator, B, H, W, tuple(config.crop_scale))
    if any([config.brightness, config.contrast, config.saturation,
            config.hue]):
        out['jitter'] = jitter_draws(generator, B, config.brightness,
                                     config.contrast, config.saturation,
                                     config.hue)
    if config.horizontal_flip:
        out['flip'] = flip_draws(generator, B)
    if config.rotation_degrees > 0:
        out['rotation'] = rotation_draws(generator, B,
                                         config.rotation_degrees)
    if config.gaussian_blur:
        out['blur'] = blur_draws(generator)
    if config.gaussian_noise:
        out['noise'] = noise_draws(generator, shape)
    return out


def apply_augment(images: torch.Tensor, draws: Dict[str, Draws],
                  config: ImageAugmentationConfig) -> torch.Tensor:
    """The enabled ops on ``images`` with the given draws, in the
    reference's order (image_processor.py:74-96): crop, color jitter,
    flip, rotation, blur, then the config's noise."""
    out = images
    if 'crop' in draws:
        out = resized_crop(out, **draws['crop'])
    if 'jitter' in draws:
        out = jitter(out, **draws['jitter'])
    if 'flip' in draws:
        out = horizontal_flip(out, **draws['flip'])
    if 'rotation' in draws:
        out = rotate(out, **draws['rotation'])
    if 'blur' in draws:
        out = blur(out, **draws['blur'],
                   kernel_size=int(config.blur_kernel_size[0]))
    if 'noise' in draws:
        out = add_noise(out, **draws['noise'], std=config.noise_std)
    return out


def augment_batch(generator: Optional[torch.Generator], images: torch.Tensor,
                  config: Optional[ImageAugmentationConfig],
                  draws: Optional[Dict[str, Draws]] = None) -> torch.Tensor:
    """The configured augmentation pipeline on a CHW image batch: its
    draws from ``generator`` (on the images' device), or ``draws`` when
    given. A config that is None or disabled returns ``images``."""
    if config is None or not config.enabled:
        return images
    if draws is None:
        draws = augment_draws(generator, images.shape, config)
    return apply_augment(images, draws, config)
