"""The port's precompute of the item embedding tables against the JAX
package's, on the CPU: ``precompute_embedding_tables`` on stores with five
JPEGs, and the ``precompute_cache`` entry point against the JAX script on
one workspace, both packages' towers holding the same weights (JAX's
random initialization from ``PRNGKey(0)``, which its precompute draws
where no local checkpoint exists, converted into the port's towers by
``utils/flax_convert``); then the refusals, and a missing PIL."""
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from pixelrec_multimodal_tpu.config import Config as JaxConfig
from pixelrec_multimodal_tpu.data.feature_store import (
    ItemFeatureStore as JaxStore,
)
from pixelrec_multimodal_tpu.encoders import precompute as jpre
from pixelrec_multimodal_tpu_torch.config import Config
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.encoders import precompute as tpre
from pixelrec_multimodal_tpu_torch.encoders.text_models import (
    TextTransformer,
)
from pixelrec_multimodal_tpu_torch.scripts import precompute_cache
from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
    load_encoder_params,
)
from tests._torch_port import load_jax_script, make_workspace, quiet

TOL = dict(rtol=2e-4, atol=2e-4)
BATCH = 8
VISION, LANGUAGE = 'resnet', 'sentence-bert'
N_ITEMS, TEXT_LEN = 7, 24


@pytest.fixture(scope='module')
def drawn():
    """JAX's draws by (modality, key), kept across this file's tests: the
    draw depends on the key and the parameters' shapes only."""
    return {}


@pytest.fixture
def same_weights(monkeypatch, drawn):
    """Both precomputes on JAX's random initialization, as its
    ``params_or_random`` draws it where no checkpoint is cached:
    ``module.init(PRNGKey(0), *example)`` (compiled, once per tower; eager
    init of a full tower takes many seconds); the port's
    ``params_or_random`` loads what JAX drew."""
    def jax_params(modality, key, module, example_args, rng_seed=0):
        if (modality, key) not in drawn:
            drawn[modality, key] = jax.tree.map(np.asarray, jax.jit(
                module.init)(jax.random.PRNGKey(rng_seed),
                             *example_args)['params'])
        return drawn[modality, key]

    def port_params(modality, key, module, rng_seed=0):
        return load_encoder_params(module, drawn[modality, key])
    monkeypatch.setattr(jpre, 'params_or_random', jax_params)
    monkeypatch.setattr(tpre, 'params_or_random', port_params)


def write_jpegs(folder, ids, seed=3):
    from PIL import Image
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for k, item in enumerate(ids):
        Image.fromarray(rng.integers(0, 256, (200 + 20 * k, 260 - 10 * k, 3),
                                     dtype=np.uint8)).save(
            folder / f'{item}.jpg')


def stores(folder):
    """A JAX and a port store of N_ITEMS items with token tables from the
    same ids, five of the items with a JPEG in ``folder``."""
    ids = np.array([f'it{j}' for j in range(N_ITEMS)])
    write_jpegs(folder, ids[:5])
    rng = np.random.default_rng(4)
    tokens = rng.integers(1000, 30000, (N_ITEMS, TEXT_LEN)).astype(np.int32)
    mask = np.ones_like(tokens)
    tokens[:, 0] = 101
    for j in range(N_ITEMS):
        tokens[j, 8 + 2 * j:] = 0
        mask[j, 8 + 2 * j:] = 0
    out = []
    for cls in (JaxStore, ItemFeatureStore):
        s = cls(N_ITEMS, ids, VISION, LANGUAGE, image_folder=str(folder))
        s.tables.update(text_input_ids=tokens, text_attention_mask=mask)
        out.append(s)
    return out


def configs():
    j, t = JaxConfig(), Config()
    for c in (j, t):
        c.model.vision_model, c.model.language_model = VISION, LANGUAGE
    return j, t


def test_tables_match_jax(tmp_path, same_weights):
    jstore, tstore = stores(tmp_path / 'images')
    jcfg, tcfg = configs()
    jadded = quiet(jpre.precompute_embedding_tables, jstore, jcfg,
                   batch_size=BATCH)  # JAX first: it draws the weights
    tadded = quiet(tpre.precompute_embedding_tables, tstore, tcfg,
                   batch_size=BATCH, device='cpu')
    assert tadded == jadded == ['language_emb', 'vision_emb']
    for name, dim in (('language_emb', 384), ('vision_emb', 2048)):
        got, ref = tstore.tables[name], np.asarray(jstore.tables[name])
        assert got.shape == ref.shape == (N_ITEMS, dim)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
    # the two items without a JPEG ran as zero frames, as in JAX
    np.testing.assert_array_equal(tstore.tables['vision_emb'][5],
                                  tstore.tables['vision_emb'][6])


def workspace(root):
    """The recommend tests' workspace with the flagship pair, eight items
    given JPEGs in the processed image folder."""
    cfg_path = make_workspace(root)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg['model'].update(vision_model=VISION, language_model=LANGUAGE)
    cfg['data']['processed_image_destination_folder'] = str(root / 'images')
    cfg_path.write_text(yaml.dump(cfg))
    write_jpegs(root / 'images', [f'i{j}' for j in range(8)])
    return cfg_path


def test_entry_point_matches_jax_script(tmp_path, monkeypatch,
                                        same_weights):
    """Both scripts on one workspace (copied once for each): the same
    ``feature_tables.npz`` keys, shapes and dtypes, the input tables equal
    and the embedding tables within TOL. Both forwards in batches of
    BATCH (the scripts' default 64 would pad the 8 items to 64)."""
    jax_script = load_jax_script('precompute_cache')
    for module, fn in ((jpre, jpre.precompute_embedding_tables),
                       (precompute_cache,
                        precompute_cache.precompute_embedding_tables)):
        monkeypatch.setattr(module, 'precompute_embedding_tables',
                            lambda *a, _fn=fn, **kw: _fn(
                                *a, batch_size=BATCH, **kw))
    tables = []
    for name, main, device in (('jax', jax_script.main, 'cpu'),
                               ('port', precompute_cache.main, 'cpu')):
        root = tmp_path / name
        cfg = workspace(root)
        quiet(main, ['--config', str(cfg), '--max_items', '8',
                     '--device', device])
        npz = root / 'cache' / f'vision_{VISION}_lang_{LANGUAGE}' / \
            'feature_tables.npz'
        with np.load(npz, allow_pickle=False) as z:
            tables.append({k: z[k] for k in z.files})
    ref, got = tables
    assert sorted(got) == sorted(ref)
    assert {'item_ids', 'tag_idx', 'numerical', 'text_input_ids',
            'text_attention_mask', 'vision_emb', 'language_emb'} <= set(got)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        if k in ('vision_emb', 'language_emb'):
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got['vision_emb'].shape == (8, 2048)
    assert got['text_input_ids'].shape == (8, 512)


def test_entry_point_refusals(tmp_path, monkeypatch):
    """Another device, a mesh past the one process (JAX's message) and
    a failed forward raise; without a card the default device raises;
    nothing is written."""
    cfg = make_workspace(tmp_path)
    base = ['--config', str(cfg), '--max_items', '4']
    with pytest.raises(ValueError, match='cuda'):
        quiet(precompute_cache.main, base + ['--device', 'tpu'])
    for flag in ('--data_parallel', '--model_parallel'):
        with pytest.raises(ValueError,
                           match=r'mesh but only 1 device\(s\) visible'):
            quiet(precompute_cache.main, base + [flag, '2', '--device',
                                                 'cpu'])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        quiet(precompute_cache.main, base)

    text = yaml.safe_load(cfg.read_text())
    text['model']['language_model'] = LANGUAGE
    cfg.write_text(yaml.dump(text))

    def fault(self, *a, **kw):
        raise RuntimeError('device fault')
    monkeypatch.setattr(TextTransformer, 'pooled', fault)
    monkeypatch.setattr(tpre, 'params_or_random',
                        lambda m, k, module, rng_seed=0: module)
    with pytest.raises(RuntimeError, match='device fault'):
        quiet(precompute_cache.main, base + ['--device', 'cpu'])
    assert not (tmp_path / 'cache').exists()


def test_missing_pil_raises(tmp_path, monkeypatch):
    """With PIL unimportable, decoding raises, in the image tier and in
    the vision precompute: no frame turns silently into zeros."""
    _, tstore = stores(tmp_path / 'images')
    for name in ('PIL', 'PIL.Image'):
        monkeypatch.setitem(sys.modules, name, None)
    for call in (lambda: tstore.image_batch_uint8(np.arange(3)),
                 lambda: tstore.get_image(0),
                 lambda: tstore.image_batch([0, 1])):
        with pytest.raises(ImportError, match='PIL'):
            call()
    cfg = Config()
    cfg.model.vision_model, cfg.model.language_model = VISION, None
    monkeypatch.setattr(tpre, 'params_or_random',
                        lambda m, k, module, rng_seed=0: module)
    with pytest.raises(ImportError, match='PIL'):
        quiet(tpre.precompute_embedding_tables, tstore, cfg,
              batch_size=BATCH, device='cpu')
    assert 'vision_emb' not in tstore.tables


def test_params_or_random_is_seeded_and_prefers_checkpoints(monkeypatch,
                                                             capsys):
    """Without a checkpoint: JAX's warning and the same weights for the
    same seed; with one, its state dict."""
    from pixelrec_multimodal_tpu_torch.encoders.text_models import (
        TextEncoderConfig,
    )
    cfg = TextEncoderConfig(vocab_size=50, hidden_size=16, num_layers=1,
                            num_heads=2, intermediate_size=32)
    monkeypatch.setattr(tpre, 'load_pretrained_params', lambda *a: None)
    a = tpre.params_or_random('language', 'bert', TextTransformer(cfg), 7)
    b = tpre.params_or_random('language', 'bert', TextTransformer(cfg), 7)
    assert 'WARNING: no local pretrained weights for language/bert' in \
        capsys.readouterr().out
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    state = {k: torch.full_like(v, 0.5) for k, v in a.state_dict().items()}
    monkeypatch.setattr(tpre, 'load_pretrained_params', lambda *a: state)
    c = tpre.params_or_random('language', 'bert', TextTransformer(cfg))
    assert all((v == 0.5).all() for v in c.state_dict().values())
    assert 'Loaded pretrained weights' in capsys.readouterr().out
