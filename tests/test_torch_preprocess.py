"""The port's preprocess entry point and the image tier's offline mode
against the JAX package, on the CPU.

One small raw workspace (40 items, 15 users; titles with HTML, a tag
missing on some items and a tail of rare tags, a NaN in a numerical
column; JPEGs made with PIL: valid ones, a grayscale one, a truncated one,
one at 32 x 32 under the 64-pixel minimum, one over the compression
threshold that is resized, a PNG, and an item with no file), copied twice.
The JAX ``scripts/preprocess_data.py`` (imported by path) runs on one copy,
the port's entry point (``--device cpu``) on the other. Both validate and
compress with the same PIL, so the processed images are held byte for
byte, and so are the CSV files (``write_csv`` writes as pandas'
``to_csv``); the scalers are held by their fitted parameters (the pickles
hold each package's own classes) and the packed tables array for array.

Then the image checks file by file against JAX's (the workspace's images
and the committed fixtures of ``tests/data/jpeg``, with the end-of-image
check nvJPEG's verdicts rest on held to PIL's), the decoder's choice with
PIL hidden, and the packing step's failure, which the port raises where
JAX carries on.
"""
import contextlib
import io
import json
import pickle
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import yaml
from PIL import Image

from pixelrec_multimodal_tpu.data import preprocessing as jpre
from pixelrec_multimodal_tpu_torch.data import image_codecs
from pixelrec_multimodal_tpu_torch.data import preprocessing as tpre
from pixelrec_multimodal_tpu_torch.data.image_codecs import (
    ImageCodecMissing,
    NvjpegDecoder,
    image_decoder,
    jpeg_complete,
)
from pixelrec_multimodal_tpu_torch.scripts import preprocess_data as tprep
from tests._torch_port import load_jax_script

N_USERS, N_ITEMS = 15, 40
FIXTURES = Path(__file__).resolve().parent / 'data' / 'jpeg'
# item -> what its image is; every other item has a valid 100 x 100 JPEG
SPECIAL = {'i1': 'truncated', 'i2': 'small', 'i3': 'large', 'i4': 'png',
           'i5': 'missing', 'i6': 'gray'}
INVALID = {'i1', 'i2', 'i5'}
COMPRESS_KB = 20


def write_images(folder: Path, rng):
    folder.mkdir(parents=True)
    for j in range(N_ITEMS):
        item, kind = f'i{j}', SPECIAL.get(f'i{j}', 'valid')
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        if kind == 'missing':
            continue
        if kind == 'png':
            Image.new('RGB', (90, 80), color).save(folder / f'{item}.png')
        elif kind == 'small':
            Image.new('RGB', (32, 32), color).save(folder / f'{item}.jpg')
        elif kind == 'gray':
            Image.new('L', (70, 90), color[0]).save(folder / f'{item}.jpg')
        elif kind == 'large':
            noise = rng.integers(0, 255, (300, 400, 3), dtype=np.uint8)
            Image.fromarray(noise).save(folder / f'{item}.jpg', quality=95)
        else:
            Image.new('RGB', (100, 100), color).save(folder / f'{item}.jpg')
        if kind == 'truncated':
            data = (folder / f'{item}.jpg').read_bytes()
            (folder / f'{item}.jpg').write_bytes(data[:len(data) * 2 // 3])


def make_raw_workspace(root: Path) -> Path:
    rng = np.random.default_rng(11)
    raw = root / 'data' / 'raw'
    tags = [None if j % 9 == 0 else
            (f'solo{j}' if j % 13 == 5 else f'tag{j % 4}')
            for j in range(N_ITEMS)]
    items = pd.DataFrame({
        'item_id': [f'i{j}' for j in range(N_ITEMS)],
        'title': [f'<b>Title {j}</b> &amp; <i>More</i>' for j in
                  range(N_ITEMS)],
        'tag': tags,
        'description': [f'Item {j}, a "quoted"   DESCRIPTION' for j in
                        range(N_ITEMS)],
        'view_number': rng.integers(0, 5000, N_ITEMS).astype(float),
        'comment_number': rng.integers(0, 100, N_ITEMS)})
    items.loc[7, 'view_number'] = np.nan
    raw.mkdir(parents=True)
    items.to_csv(raw / 'item_info.csv', index=False)
    rows = [(f'u{u}', f'i{it}', int(rng.integers(0, 10 ** 6)))
            for u in range(N_USERS)
            for it in rng.choice(N_ITEMS, size=8, replace=False)]
    pd.DataFrame(rows, columns=['user_id', 'item_id', 'timestamp']).to_csv(
        raw / 'interactions.csv', index=False)
    write_images(raw / 'images', rng)
    proc = root / 'data' / 'processed'
    cfg = {
        'model': {'vision_model': None, 'language_model': None},
        'data': {
            'item_info_path': str(raw / 'item_info.csv'),
            'interactions_path': str(raw / 'interactions.csv'),
            'image_folder': str(raw / 'images'),
            'processed_item_info_path': str(proc / 'item_info.csv'),
            'processed_interactions_path': str(proc / 'interactions.csv'),
            'processed_image_destination_folder': str(proc / 'images'),
            'scaler_path': str(proc / 'numerical_scaler.pkl'),
            'numerical_features_cols': ['view_number', 'comment_number',
                                        'absent_feature'],
            'numerical_normalization_method': 'standardization',
            'categorical_features_cols': ['tag'],
            'image_validation_config': {'check_corrupted': True,
                                        'min_width': 64, 'min_height': 64},
            'image_compression_config': {
                'enabled': True, 'compress_if_kb_larger_than': COMPRESS_KB,
                'target_quality': 80,
                'resize_if_pixels_larger_than': [256, 256],
                'resize_target_longest_edge': 256},
            'cache_config': {'enabled': True, 'use_disk': True,
                             'cache_directory': str(root / 'cache')},
            'splitting': {'min_interactions_per_user': 3,
                          'min_interactions_per_item': 1,
                          'tag_grouping_threshold': 3}}}
    path = root / 'config.yaml'
    path.write_text(yaml.dump(cfg))
    return path


def copy_workspace(seed: Path, dest: Path) -> Path:
    shutil.copytree(seed, dest)
    cfg = dest / 'config.yaml'
    cfg.write_text(cfg.read_text().replace(str(seed), str(dest)))
    return cfg


def run_quiet(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*a)
    return out.getvalue()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp('preprocess')
    make_raw_workspace(base / 'seed')
    jcfg = copy_workspace(base / 'seed', base / 'jax')
    tcfg = copy_workspace(base / 'seed', base / 'torch')
    jprep = load_jax_script('preprocess_data')
    jout = run_quiet(jprep.main, ['--config', str(jcfg)])
    tout = run_quiet(tprep.main, ['--config', str(tcfg), '--device', 'cpu'])
    return {'base': base, 'jax_out': jout, 'torch_out': tout,
            'jprep': jprep}


def processed(base: Path, name: str) -> Path:
    return base / name / 'data' / 'processed'


def test_valid_items_equal(runs):
    base = runs['base']
    sets = {}
    for name in ('jax', 'torch'):
        images = {p.stem for p in (processed(base, name) / 'images')
                  .iterdir()}
        items = set(pd.read_csv(processed(base, name) / 'item_info.csv')
                    ['item_id'].astype(str))
        assert items <= images
        sets[name] = images
    assert sets['torch'] == sets['jax'] == \
        {f'i{j}' for j in range(N_ITEMS)} - INVALID
    assert 'Validating images with PIL' in runs['torch_out']


def test_processed_images_byte_for_byte(runs):
    base = runs['base']
    jdir, tdir = (processed(base, n) / 'images' for n in ('jax', 'torch'))
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    for name in names:
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    # the large file was compressed and resized, the others copied
    raw = base / 'seed' / 'data' / 'raw' / 'images'
    with Image.open(tdir / 'i3.jpg') as img:
        assert max(img.size) == 256
    assert (raw / 'i3.jpg').stat().st_size / 1024 > COMPRESS_KB
    assert (tdir / 'i0.jpg').read_bytes() == (raw / 'i0.jpg').read_bytes()


@pytest.mark.parametrize('name', ['item_info.csv', 'interactions.csv'])
def test_processed_csv_byte_for_byte(runs, name):
    base = runs['base']
    want = (processed(base, 'jax') / name).read_bytes()
    got = (processed(base, 'torch') / name).read_bytes()
    assert got == want
    if name == 'item_info.csv':
        table = pd.read_csv(processed(base, 'torch') / name)
        assert 'rare_tag' in set(table['tag'])
        assert not table['title'].str.contains('<').any()


def test_scaler_parameters_equal(runs):
    base = runs['base']
    jax_s = pickle.loads((processed(base, 'jax') /
                          'numerical_scaler.pkl').read_bytes())
    port_s = pickle.loads((processed(base, 'torch') /
                           'numerical_scaler.pkl').read_bytes())
    assert port_s['columns'] == jax_s['columns'] == ['view_number',
                                                     'comment_number']
    for attr in ('mean_', 'var_', 'scale_', 'n_samples_seen_'):
        np.testing.assert_array_equal(getattr(port_s['scaler'], attr),
                                      getattr(jax_s['scaler'], attr))


def test_packed_tables_equal(runs):
    base = runs['base']
    path = 'cache/vision_none_lang_none/feature_tables.npz'
    with np.load(base / 'jax' / path) as j, np.load(base / 'torch' / path) \
            as t:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def image_files():
    """The workspace's raw images (made at collection, one name each) and
    the committed fixtures."""
    return ([f'ws:i{j}' for j in range(8)]
            + [f'fixture:{p.name}' for p in sorted(FIXTURES.glob('*.jpg'))])


@pytest.mark.parametrize('image', image_files())
def test_image_checks_against_jax(runs, image):
    kind, name = image.split(':')
    if kind == 'ws':
        folder = runs['base'] / 'seed' / 'data' / 'raw' / 'images'
        found = [p for p in folder.glob(f'{name}.*')]
        path = str(found[0]) if found else str(folder / f'{name}.jpg')
    else:
        path = str(FIXTURES / name)
    assert tpre.is_image_corrupted(path) == jpre.is_image_corrupted(path)
    for side in (16, 33, 64):
        assert tpre.check_image_dimensions(path, side, side) == \
            jpre.check_image_dimensions(path, side, side)
    if path.endswith('.jpg') and Path(path).exists():
        # nvJPEG's verdict adds the end-of-image check to its decode
        assert jpeg_complete(Path(path).read_bytes()) == \
            (not jpre.is_image_corrupted(path))
    if kind == 'fixture':
        manifest = json.loads((FIXTURES / 'manifest.json').read_text())
        assert manifest[name]['corrupted'] == jpre.is_image_corrupted(path)


def hide_pil(monkeypatch):
    for name in ('PIL', 'PIL.Image'):
        monkeypatch.setitem(sys.modules, name, None)


def test_no_decoder_raises_and_marks_nothing(runs, tmp_path, monkeypatch):
    """Without PIL on the CPU the image step raises naming A12 before any
    file is judged; on cuda nvJPEG is chosen only where the toolkit has
    libnvjpeg; a PNG under nvJPEG raises."""
    cfg = copy_workspace(runs['base'] / 'seed', tmp_path / 'ws')
    hide_pil(monkeypatch)
    with pytest.raises(ImageCodecMissing, match='A12'):
        run_quiet(tprep.main, ['--config', str(cfg), '--device', 'cpu'])
    dest = tmp_path / 'ws' / 'data' / 'processed'
    assert not (dest / 'images').exists() or \
        not any((dest / 'images').iterdir())
    assert not (dest / 'item_info.csv').exists()
    image = str(tmp_path / 'ws' / 'data' / 'raw' / 'images' / 'i0.jpg')
    with pytest.raises(ImageCodecMissing, match='A12'):
        tpre.is_image_corrupted(image)
    monkeypatch.setattr(image_codecs._build, 'toolkit_library',
                        lambda stem: None)
    with pytest.raises(ImageCodecMissing, match='libnvjpeg'):
        image_decoder('cuda')
    monkeypatch.setattr(image_codecs._build, 'toolkit_library',
                        lambda stem: Path(f'/toolkit/lib64/lib{stem}.so'))
    decoder = image_decoder('cuda')
    assert isinstance(decoder, NvjpegDecoder)
    png = str(tmp_path / 'ws' / 'data' / 'raw' / 'images' / 'i4.png')
    with pytest.raises(ImageCodecMissing, match='PNG'):
        tpre.is_image_corrupted(png, decoder)
    with pytest.raises(ValueError, match='cuda'):
        run_quiet(tprep.main, ['--config', str(cfg), '--device', 'tpu'])


def test_packing_failure_raises_where_jax_carries_on(runs, tmp_path,
                                                     monkeypatch):
    from pixelrec_multimodal_tpu.data import feature_store as jfs
    from pixelrec_multimodal_tpu_torch.data import feature_store as tfs

    def fail(*a, **kw):
        raise RuntimeError('packing failed')
    monkeypatch.setattr(jfs.ItemFeatureStore, 'build', fail)
    monkeypatch.setattr(tfs.ItemFeatureStore, 'build', fail)
    jcfg = copy_workspace(runs['base'] / 'seed', tmp_path / 'jax')
    tcfg = copy_workspace(runs['base'] / 'seed', tmp_path / 'torch')
    out = run_quiet(runs['jprep'].main, ['--config', str(jcfg)])
    assert 'Error during feature packing: packing failed' in out
    with pytest.raises(RuntimeError, match='packing failed'):
        run_quiet(tprep.main, ['--config', str(tcfg), '--device', 'cpu'])
