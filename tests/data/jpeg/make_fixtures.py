"""Write the JPEG fixtures of the image tier's decoders, with PIL.

    python tests/data/jpeg/make_fixtures.py

Small seeded images (products of sines, sides that are
not multiples of the 16-pixel MCU) saved as baseline and progressive
JPEGs at 4:2:0, 4:2:2 and 4:4:4 chroma, one grayscale, one at 16 x 16,
and a baseline and a progressive copy cut halfway through their scan
data; all of them under the 64-pixel minimum side of the repo's
configurations (``image_validation_config``). Beside them three
photo-sized ones (``photo_*``: 800 x 600 baseline 4:2:0, 480 x 640
progressive 4:2:0, 384 x 288 baseline 4:4:4; soft discs over sine
gratings, so the files stay at 9-23 KB: smoother than a photograph, at
0.3-0.7 bits a pixel). ``manifest.json`` holds PIL's verdict and size for
each file (``is_image_corrupted`` and ``img.size`` as the JAX package
computes them) and, for a photo-sized file, the corners of its crops;
``frames.npz`` holds PIL's decode of each valid file, converted to RGB,
uint8 H x W x 3, or for a photo-sized file its CROPS x CROP x CROP x 3
crops (the whole frames would not fit the fixtures' 100 KB). The decoders
on the card are held against these.
"""
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
# name -> (width, height, mode, save options)
FILES = {
    'baseline_420.jpg': (41, 35, 'RGB', dict(quality=90, subsampling=2)),
    'baseline_422.jpg': (34, 38, 'RGB', dict(quality=90, subsampling=1)),
    'baseline_444.jpg': (38, 36, 'RGB', dict(quality=90, subsampling=0)),
    'progressive_420.jpg': (43, 34, 'RGB',
                            dict(quality=85, subsampling=2,
                                 progressive=True)),
    'progressive_444.jpg': (35, 40, 'RGB',
                            dict(quality=85, subsampling=0,
                                 progressive=True)),
    'gray.jpg': (37, 39, 'L', dict(quality=90)),
    'small_16.jpg': (16, 16, 'RGB', dict(quality=90)),
}
PHOTOS = {
    'photo_baseline_420.jpg': (800, 600, dict(quality=80, subsampling=2)),
    'photo_progressive_420.jpg': (480, 640, dict(quality=80, subsampling=2,
                                                 progressive=True)),
    'photo_baseline_444.jpg': (384, 288, dict(quality=80, subsampling=0)),
}
# A photo-sized file's crops: the first and last MCU's corners and one
# off the 8-pixel grid inside.
CROP = 32
TRUNCATED = {'truncated.jpg': 'baseline_420.jpg',
             'truncated_progressive.jpg': 'progressive_420.jpg'}


def pixels(width: int, height: int, mode: str, seed: int) -> Image.Image:
    """A smooth seeded image: a product of sines per channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    chans = []
    for c in range(3 if mode == 'RGB' else 1):
        a, b, p = rng.uniform(0.02, 0.09, 3)
        chans.append(128 + 90 * np.sin(a * x + p * 6) * np.cos(b * y))
    arr = np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if mode == 'L' else arr, mode)


def photo(width: int, height: int, seed: int) -> Image.Image:
    """A seeded photo-sized image: six soft discs over three sine
    gratings per channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    discs = np.zeros((height, width))
    for _ in range(6):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(0.05, 0.3) * min(width, height)
        discs += rng.uniform(-60, 60) / (
            1 + np.exp((np.hypot(x - cx, y - cy) - r) / 2.0))
    chans = []
    for _ in range(3):
        v = 128 + discs * rng.uniform(0.6, 1.2)
        for _ in range(3):
            fx, fy = rng.uniform(0.002, 0.03, 2)
            v += 25 * np.sin(fx * x + fy * y + rng.uniform(0, 6))
        chans.append(v)
    return Image.fromarray(
        np.clip(np.stack(chans, -1), 0, 255).astype(np.uint8), 'RGB')


def crop_corners(width: int, height: int) -> list:
    """[y, x] of a photo-sized file's crops."""
    return [[0, 0], [height - CROP, width - CROP],
            [height // 3 + 5, width // 5 + 3]]


def pil_verdict(path: Path) -> dict:
    """PIL's verdict and size, as ``is_image_corrupted`` and
    ``check_image_dimensions`` of the JAX package compute them."""
    try:
        with Image.open(path) as img:
            img.verify()
        with Image.open(path) as img:
            img.load()
        corrupted = False
    except Exception:
        corrupted = True
    try:
        with Image.open(path) as img:
            size = list(img.size)
    except Exception:
        size = None
    return {'corrupted': corrupted, 'size': size,
            'bytes': path.stat().st_size}


def main():
    for seed, (name, (w, h, mode, opts)) in enumerate(FILES.items()):
        pixels(w, h, mode, seed).save(HERE / name, 'JPEG', **opts)
    for seed, (name, (w, h, opts)) in enumerate(PHOTOS.items(), 100):
        photo(w, h, seed).save(HERE / name, 'JPEG', **opts)
    for name, source in TRUNCATED.items():
        data = (HERE / source).read_bytes()
        sos = data.index(b'\xff\xda')
        (HERE / name).write_bytes(data[:(sos + len(data)) // 2])
    manifest, frames = {}, {}
    for path in sorted(HERE.glob('*.jpg')):
        manifest[path.name] = pil_verdict(path)
        if not manifest[path.name]['corrupted']:
            with Image.open(path) as img:
                frame = np.asarray(img.convert('RGB'), dtype=np.uint8)
            if path.name in PHOTOS:
                corners = crop_corners(frame.shape[1], frame.shape[0])
                manifest[path.name].update(crop=CROP, crops=corners)
                frame = np.stack([frame[y:y + CROP, x:x + CROP]
                                  for y, x in corners])
            frames[path.name] = frame
    (HERE / 'manifest.json').write_text(json.dumps(manifest, indent=1,
                                                   sort_keys=True) + '\n')
    np.savez_compressed(HERE / 'frames.npz', **frames)


if __name__ == '__main__':
    main()
