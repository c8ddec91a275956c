"""The port stands alone: it imports neither JAX, Flax nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""
import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pixelrec_multimodal_tpu_torch as port
from pixelrec_multimodal_tpu_torch import resolve_device
from pixelrec_multimodal_tpu_torch.data.feature_store import ItemFeatureStore
from pixelrec_multimodal_tpu_torch.inference.scorer import CatalogScorer
from pixelrec_multimodal_tpu_torch.models.multimodal import (
    MultimodalRecommender,
)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'orbax',
             'pixelrec_multimodal_tpu'}


def port_modules():
    return [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + '.')]


def port_sources():
    """The package and everything that runs on the machine with the card,
    which has no JAX."""
    return sorted(Path(port.__path__[0]).rglob('*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'tests' / 'test_torch_cuda.py',
        *sorted((ROOT / 'scripts').glob('torch_*.py'))]


def test_import_leaves_jax_out():
    """A fresh interpreter imports every port module (and chip_smoke's
    helpers) without loading JAX, Flax or the JAX package."""
    code = (
        'import importlib, json, sys\n'
        f'for m in {port_modules()!r}: importlib.import_module(m)\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    assert 'pixelrec_multimodal_tpu_torch.inference.scorer' in loaded


@pytest.mark.parametrize('path', port_sources(), ids=lambda p: p.name)
def test_sources_import_nothing_forbidden(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or '']
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, (path, name)


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """Without a CUDA device, the default device='cuda' raises; only an
    explicit device='cpu' runs on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device()
    kw = dict(n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
              embedding_dim=8, fusion_hidden_dims=(16,),
              use_contrastive=False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MultimodalRecommender(**kw)
    model = MultimodalRecommender(**kw, device='cpu')
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = torch.zeros(8, dtype=torch.int32).numpy()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        CatalogScorer(model, store)
    scorer = CatalogScorer(model, store, device='cpu')
    assert scorer.device.type == 'cpu'
    with pytest.raises(ValueError):
        resolve_device('meta')


def test_unported_options_raise():
    kw = dict(n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
              embedding_dim=8, fusion_hidden_dims=(16,),
              use_contrastive=False, device='cpu')
    for fusion, item in (('gated', 'A8'), ('attention', 'A9')):
        with pytest.raises(NotImplementedError, match=item):
            MultimodalRecommender(**kw, fusion_type=fusion)
    model = MultimodalRecommender(**kw)
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = torch.zeros(8, dtype=torch.int32).numpy()
    with pytest.raises(NotImplementedError, match='A10'):
        CatalogScorer(model, store, device='cpu', precision='int8')
    with pytest.raises(NotImplementedError, match='A11'):
        CatalogScorer(model, store, device='cpu', mesh=object())
    model.train()
    idx = torch.zeros(1, dtype=torch.long)
    with pytest.raises(NotImplementedError, match='A6'):
        model(idx, idx, idx)
