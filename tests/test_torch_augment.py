"""The port's device-side augmentation (``ops/augment.py``) against the
JAX package's, on the CPU.

JAX's draws cannot come out of a ``torch.Generator``, so each test
recomputes them here from the same key, with the JAX module's own
arithmetic (``pixelrec_multimodal_tpu/ops/augment.py``: the same key
splits, ``jax.random`` calls and derived boxes), and feeds them to the
port's apply half. Every op, and ``augment_batch`` with every op on, then
matches JAX's output at 1e-6 of the image scale (the crop bit for bit),
rotation at 4e-6 (one ulp of cos and sin apart, ``ROTATION_TOL``). Also
the flip's exact reversal, the disabled pass-through and the port's own
draws: the same generator seed gives the same batch, another seed
another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelrec_multimodal_tpu.config import ImageAugmentationConfig as JaxCfg
from pixelrec_multimodal_tpu.ops import augment as jaug
from pixelrec_multimodal_tpu_torch.config import ImageAugmentationConfig
from pixelrec_multimodal_tpu_torch.ops import augment as taug

B, C, H, W = 4, 3, 32, 28
TOL = 1e-6
# Rotation takes the cos and sin of its angle, where XLA's float32 results
# and torch's differ by one ulp (6e-8) on about 5% of angles. A source
# point then moves by up to (H + W) / 2 ulp, 1.8e-6 pixels here, and the
# output by that times a difference of two neighbours, at most twice the
# image scale: 4e-6 of the scale bounds it (1.7e-6-2.1e-6 seen).
ROTATION_TOL = 4e-6


def images(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, C, H, W)).astype(np.float32)


def held(got: torch.Tensor, ref, x: np.ndarray, tol: float = TOL):
    """Within ``tol`` of the image scale (its largest magnitude)."""
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=tol * float(np.abs(x).max()))


def t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# JAX's draws, as its ops make them from a key.
def jax_crop_draws(key, scale=(0.8, 1.0), ratio=(0.75, 4.0 / 3.0),
                   shape=(B, C, H, W)):
    n, _, h, w = shape
    k_area, k_ratio, k_x, k_y = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (n,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(k_ratio, (n,), minval=jnp.log(ratio[0]),
                               maxval=jnp.log(ratio[1]))
    r = jnp.exp(log_r)
    ch = jnp.clip(jnp.sqrt(area / r) * h, 8, h)
    cw = jnp.clip(jnp.sqrt(area * r) * w, 8, w)
    y0 = jax.random.uniform(k_y, (n,)) * (h - ch)
    x0 = jax.random.uniform(k_x, (n,)) * (w - cw)
    return dict(y0=y0, x0=x0, ch=ch, cw=cw)


def jax_jitter_draws(key, brightness=0.2, contrast=0.2, saturation=0.2,
                     hue=0.1, n=B):
    kb, kc, ks, kh = jax.random.split(key, 4)
    out = {}
    for name, k, s in (('brightness', kb, brightness),
                       ('contrast', kc, contrast),
                       ('saturation', ks, saturation)):
        if s:
            out[name] = jax.random.uniform(k, (n, 1, 1, 1), minval=1 - s,
                                           maxval=1 + s)
    if hue:
        out['hue'] = jax.random.uniform(kh, (n, 1, 1),
                                        minval=-hue * 2 * jnp.pi,
                                        maxval=hue * 2 * jnp.pi)
    return out


def jax_flip_draws(key, p=0.5, n=B):
    return {'flip': jax.random.bernoulli(key, p, (n, 1, 1, 1)).reshape(n)}


def jax_rotation_draws(key, degrees, n=B):
    return {'degrees': jax.random.uniform(key, (n,), minval=-degrees,
                                          maxval=degrees)}


def jax_blur_draws(key, sigma_range=(0.1, 2.0)):
    return {'sigma': jax.random.uniform(key, (), minval=sigma_range[0],
                                        maxval=sigma_range[1])}


def jax_noise_draws(key, shape=(B, C, H, W)):
    return {'noise': jax.random.normal(key, shape)}


def jax_augment_draws(key, cfg, shape=(B, C, H, W)):
    """JAX's draws of ``augment_batch(key, images, cfg)`` for images of
    ``shape``, made in one jitted program, as torch tensors."""
    n = shape[0]

    def draws(key):
        keys = jax.random.split(key, 6)
        out = {}
        if cfg.random_crop:
            out['crop'] = jax_crop_draws(keys[0], tuple(cfg.crop_scale),
                                         shape=shape)
        if any([cfg.brightness, cfg.contrast, cfg.saturation, cfg.hue]):
            out['jitter'] = jax_jitter_draws(keys[1], cfg.brightness,
                                             cfg.contrast, cfg.saturation,
                                             cfg.hue, n)
        if cfg.horizontal_flip:
            out['flip'] = jax_flip_draws(keys[2], n=n)
        if cfg.rotation_degrees > 0:
            out['rotation'] = jax_rotation_draws(keys[3],
                                                 cfg.rotation_degrees, n)
        if cfg.gaussian_blur:
            out['blur'] = jax_blur_draws(keys[4])
        if cfg.gaussian_noise:
            out['noise'] = jax_noise_draws(keys[5], shape)
        return out
    return {op: t(d) for op, d in jax.jit(draws)(key).items()}


KEY = jax.random.PRNGKey(7)


@pytest.mark.parametrize('scale', [(0.8, 1.0), (0.08, 0.5)])
def test_resized_crop_matches_jax(scale):
    x = images()
    ref = jaug.random_resized_crop(KEY, jnp.asarray(x), scale=scale)
    held(taug.resized_crop(torch.from_numpy(x),
                           **t(jax_crop_draws(KEY, scale))), ref, x)


@pytest.mark.parametrize('strengths', [(0.2, 0.2, 0.2, 0.1),
                                       (0.0, 0.4, 0.0, 0.5),
                                       (0.3, 0.0, 0.5, 0.0)])
def test_color_jitter_matches_jax(strengths):
    x = images(1)
    ref = jaug.color_jitter(KEY, jnp.asarray(x), *strengths)
    draws = t(jax_jitter_draws(KEY, *strengths))
    assert sorted(draws) == sorted(taug.jitter_draws(
        torch.Generator(), B, *strengths))
    held(taug.jitter(torch.from_numpy(x), **draws), ref, x)


def test_horizontal_flip_matches_jax():
    x = images(2)
    ref = jaug.random_horizontal_flip(KEY, jnp.asarray(x))
    draws = t(jax_flip_draws(KEY))
    assert 0 < int(draws['flip'].sum()) < B
    np.testing.assert_array_equal(
        taug.horizontal_flip(torch.from_numpy(x), **draws).numpy(),
        np.asarray(ref))


@pytest.mark.parametrize('degrees', [10.0, 45.0, 180.0])
def test_rotation_matches_jax(degrees):
    x = images(3)
    ref = jaug.random_rotation(KEY, jnp.asarray(x), degrees)
    got = taug.rotate(torch.from_numpy(x),
                      **t(jax_rotation_draws(KEY, degrees)))
    held(got, ref, x, ROTATION_TOL)
    assert (got == 0).any()  # the corners fall outside the source


@pytest.mark.parametrize('kernel_size', [5, 9])
def test_blur_matches_jax(kernel_size):
    x = images(4)
    ref = jaug.gaussian_blur(KEY, jnp.asarray(x), kernel_size=kernel_size)
    held(taug.blur(torch.from_numpy(x), **t(jax_blur_draws(KEY)),
                   kernel_size=kernel_size), ref, x)


def test_noise_matches_jax():
    x = images(5)
    ref = jaug.gaussian_noise(KEY, jnp.asarray(x), 0.05)
    held(taug.add_noise(torch.from_numpy(x), **t(jax_noise_draws(KEY)),
                        std=0.05), ref, x)


@pytest.mark.parametrize('overrides', [
    dict(gaussian_noise=True),
    dict(),
    dict(random_crop=False, rotation_degrees=0, hue=0.0,
         blur_kernel_size=[9, 9]),
], ids=['all', 'default', 'some'])
def test_augment_batch_matches_jax(overrides):
    """The whole pipeline with JAX's draws, in the reference's order."""
    jcfg = JaxCfg(enabled=True, **overrides)
    tcfg = ImageAugmentationConfig(enabled=True, **overrides)
    x = images(6)
    ref = jaug.augment_batch(KEY, jnp.asarray(x), jcfg)
    draws = jax_augment_draws(KEY, jcfg)
    assert sorted(draws) == sorted(taug.augment_draws(
        torch.Generator(), x.shape, tcfg))
    tol = ROTATION_TOL if tcfg.rotation_degrees else TOL
    held(taug.augment_batch(None, torch.from_numpy(x), tcfg, draws), ref, x,
         tol)
    held(taug.apply_augment(torch.from_numpy(x), draws, tcfg), ref, x, tol)


def test_flip_is_exact_reversal():
    x = torch.from_numpy(images())
    g = torch.Generator().manual_seed(3)
    assert torch.equal(taug.random_horizontal_flip(g, x, p=1.0), x.flip(-1))
    assert torch.equal(taug.random_horizontal_flip(g, x, p=0.0), x)


def test_disabled_passthrough():
    x = torch.from_numpy(images())
    for cfg in (None, ImageAugmentationConfig(enabled=False)):
        assert taug.augment_batch(torch.Generator(), x, cfg) is x


def test_deterministic_per_generator_seed():
    """The port's own draws: one seed, one batch; another seed, another;
    shapes kept, values finite, each op's draws on the generator's
    device and in its ranges."""
    cfg = ImageAugmentationConfig(enabled=True, gaussian_noise=True)
    x = torch.from_numpy(images())

    def run(seed):
        return taug.augment_batch(torch.Generator().manual_seed(seed), x, cfg)
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert a.shape == x.shape and torch.isfinite(a).all()
    d = taug.augment_draws(torch.Generator().manual_seed(0), x.shape, cfg)
    assert sorted(d) == ['blur', 'crop', 'flip', 'jitter', 'noise',
                         'rotation']
    crop = d['crop']
    assert bool((crop['ch'] >= 8).all() and (crop['ch'] <= H).all())
    assert bool(((crop['y0'] >= 0) & (crop['y0'] + crop['ch'] <= H)).all())
    assert bool((d['rotation']['degrees'].abs() <= 10).all())
    assert 0.1 <= float(d['blur']['sigma']) <= 2.0
    assert d['noise']['noise'].shape == x.shape
    for fn in (lambda g: taug.random_resized_crop(g, x),
               lambda g: taug.color_jitter(g, x),
               lambda g: taug.random_rotation(g, x, 10.0),
               lambda g: taug.gaussian_blur(g, x),
               lambda g: taug.gaussian_noise(g, x, 0.01)):
        out = fn(torch.Generator().manual_seed(5))
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert torch.equal(out, fn(torch.Generator().manual_seed(5)))
