"""The port stands alone: it imports neither JAX, Flax nor the JAX
package, and its entry points refuse to fall back to the CPU silently."""
import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    which has no JAX, or as the port's gloo ranks on the CPU."""
    return sorted(Path(port.__path__[0]).rglob('*.py')) + [
        ROOT / 'chip_smoke.py', ROOT / 'tests' / 'test_torch_cuda.py',
        ROOT / 'tests' / '_torch_smem.py', ROOT / 'tests' / '_torch_mesh.py',
        *sorted((ROOT / 'scripts').glob('torch_*.py'))]


def test_import_leaves_jax_out():
    """A fresh interpreter imports every port module (and chip_smoke's
    helpers) without loading JAX, Flax or the JAX package, and without
    starting a process group."""
    code = (
        'import importlib, json, sys\n'
        f'for m in {port_modules()!r}: importlib.import_module(m)\n'
        'import torch.distributed as dist\n'
        'assert not dist.is_initialized()\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split('.')[0] in FORBIDDEN]
    assert not bad, bad
    assert 'pixelrec_multimodal_tpu_torch.inference.scorer' in loaded
    assert 'pixelrec_multimodal_tpu_torch.parallel.mesh' in loaded
    # the Hopper probes P1-P3 stand alone too
    assert {'pixelrec_multimodal_tpu_torch.probes.int8_mxu',
            'pixelrec_multimodal_tpu_torch.probes.vpu_roofline'} <= set(loaded)
    # and so does the training core; its config needs no PyYAML to import
    assert {'pixelrec_multimodal_tpu_torch.config',
            'pixelrec_multimodal_tpu_torch.models.losses',
            'pixelrec_multimodal_tpu_torch.training.optimizers',
            'pixelrec_multimodal_tpu_torch.training.steps'} <= set(loaded)
    assert 'yaml' not in loaded


# What the machine with the card lacks; the port's data path and Trainer
# must not load them.
CARD_ABSENT = {'pandas', 'sklearn', 'PIL', 'yaml', 'transformers'}


def test_data_path_stands_alone(tmp_path):
    """A fresh interpreter imports every port module, builds a small
    MultimodalDataset from dicts of numpy columns (numerical scaling,
    tags, tokenized descriptions, negatives) and its device tables, and
    loads none of JAX, the JAX package, pandas, scikit-learn, PIL, PyYAML
    or transformers."""
    code = (
        'import importlib, json, sys\n'
        'import numpy as np\n'
        f'for m in {port_modules()!r}: importlib.import_module(m)\n'
        'from pixelrec_multimodal_tpu_torch.data.dataset import '
        'MultimodalDataset\n'
        'from pixelrec_multimodal_tpu_torch.data.processors.'
        'numerical_processor import StandardScaler\n'
        'items = {"item_id": np.array(["a", "b", "c", "d"]),\n'
        '         "tag": np.array(["x", None, "y", "x"], dtype=object),\n'
        '         "price": np.array([1.0, np.nan, 3.0, 4.0]),\n'
        '         "description": np.array(["red", "blue", None, "hat"],\n'
        '                                 dtype=object)}\n'
        'inter = {"user_id": np.array(["u1", "u2", "u1", "u3"]),\n'
        '         "item_id": np.array(["a", "b", "c", "zz"])}\n'
        'ds = MultimodalDataset(inter, items, "/nonexistent",\n'
        '    vision_model_name=None, language_model_name="sentence-bert",\n'
        '    numerical_feat_cols=["price"], categorical_feat_cols=["tag"],\n'
        '    numerical_normalization_method="standardization",\n'
        '    numerical_scaler=StandardScaler(), max_text_length=8)\n'
        'tables = ds.feature_store.device_tables(device="cpu", pack=True)\n'
        'assert len(ds) == 6 and ds.n_items == 4 and ds.n_users == 2\n'
        'assert ds.feature_store.tables["text_input_ids"].shape == (4, 8)\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    env = dict(os.environ, HF_HOME=str(tmp_path), HF_HUB_CACHE='',
               TRANSFORMERS_CACHE='')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
    assert not bad, bad
    assert {'pixelrec_multimodal_tpu_torch.training.trainer',
            'pixelrec_multimodal_tpu_torch.utils.checkpointing',
            'pixelrec_multimodal_tpu_torch.data.loader'} <= set(loaded)


def test_probe_sources_are_checked():
    """The probes' modules and entry scripts, the training core's modules
    and the data path's are among the sources held to importing nothing
    forbidden."""
    names = {p.name for p in port_sources()}
    assert {'int8_mxu.py', 'vpu_roofline.py', 'torch_profile_int8_mxu.py',
            'torch_profile_vpu_roofline.py', 'config.py', 'losses.py',
            'optimizers.py', 'steps.py', 'trainer.py', 'dataset.py',
            'feature_store.py', 'loader.py', 'negative_sampling.py',
            'tokenization.py', 'label_encoder.py', 'columns.py',
            'numerical_processor.py', 'checkpointing.py',
            'logging.py', 'yaml_io.py', 'splitting.py', 'preprocessing.py',
            'text_processor.py', 'data_filter.py', 'simple_cache.py',
            'create_splits.py', 'train.py', 'recommender.py',
            'evaluate.py', 'generate_recommendations.py',
            'checkpoint_manager.py', 'inspect_checkpoint.py',
            'extract_encoders.py', 'tasks.py', 'metrics.py', 'novelty.py',
            'advanced_metrics.py', 'baseline_recommenders.py',
            'search.py', 'visualization.py', 'timestamps.py',
            'create_training_subsets.py', 'hyperparameter_search.py',
            'common.py', 'text_models.py', 'resnet.py', 'clip.py',
            'dinov2.py', 'convnext.py', 'registry.py', 'convert.py',
            'precompute.py', 'image_processor.py', 'flax_convert.py',
            'precompute_cache.py', 'mesh.py', 'topk.py',
            '_torch_mesh.py', 'tensor_parallel.py', 'dryrun.py'} <= names


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
    from pixelrec_multimodal_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dryrun_multichip(4)


def test_gated_fusion_builds_on_cpu_and_defaults_to_cuda(monkeypatch):
    """Gated fusion is ported: a gated model and its scorer build on the
    CPU when asked, and raise without a card by default."""
    kw = dict(n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
              embedding_dim=8, fusion_hidden_dims=(16,),
              use_contrastive=False, fusion_type='gated')
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = torch.zeros(8, dtype=torch.int32).numpy()
    model = MultimodalRecommender(**kw, device='cpu')
    scorer = CatalogScorer(model, store, device='cpu')
    assert scorer.gated_variant == 'exact'
    assert scorer.top_k([0, 1], 3)[1].shape == (2, 3)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MultimodalRecommender(**kw)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        CatalogScorer(model, store)


@pytest.mark.parametrize('variant', ['stream', 'gram'])
def test_attention_fusion_builds_on_cpu_and_defaults_to_cuda(monkeypatch,
                                                             variant):
    """Attention fusion is ported: an attention model and its scorer build
    on the CPU when asked, the cascade runs there, and both raise without
    a card by default."""
    kw = dict(n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
              embedding_dim=16, fusion_hidden_dims=(16,),
              use_contrastive=False, fusion_type='attention',
              num_attention_heads=2)
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = torch.zeros(8, dtype=torch.int32).numpy()
    model = MultimodalRecommender(**kw, device='cpu')
    scorer = CatalogScorer(model, store, attention_variant=variant,
                           device='cpu')
    assert scorer.attention_variant == variant
    assert scorer.top_k([0, 1], 3)[1].shape == (2, 3)
    for screen in ('additive', 'token0', 'funnel'):
        v, i = scorer.top_k_cascade([0, 1], 3, screen=screen)
        assert v.shape == i.shape == (2, 3) and (i >= 0).all()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MultimodalRecommender(**kw)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        CatalogScorer(model, store)


def test_unported_options_raise():
    kw = dict(n_users=4, n_items=8, n_tags=2, num_numerical_features=0,
              embedding_dim=8, fusion_hidden_dims=(16,),
              use_contrastive=False, device='cpu')
    assert MultimodalRecommender(**kw, fusion_type='attention').fusion_type \
        == 'attention'
    with pytest.raises(ValueError, match='fusion type'):
        MultimodalRecommender(**kw, fusion_type='bilinear')
    assert MultimodalRecommender(**kw, fusion_type='gated').fusion_type \
        == 'gated'
    model = MultimodalRecommender(**kw)
    store = ItemFeatureStore(8, [str(i) for i in range(8)])
    store.tables['tag_idx'] = torch.zeros(8, dtype=torch.int32).numpy()
    # int8 is ported: this head has no hidden layer to quantize, so 'int8'
    # falls below the flip point and serves bf16, and 'int8!' raises
    assert CatalogScorer(model, store, device='cpu',
                         precision='int8').precision == 'bf16'
    with pytest.raises(ValueError, match='qlayers'):
        CatalogScorer(model, store, device='cpu', precision='int8!')
    with pytest.raises(ValueError, match='precision'):
        CatalogScorer(model, store, device='cpu', precision='int4')
    # a mesh is ported: one process is a 1x1 mesh, served as without one
    from pixelrec_multimodal_tpu_torch.parallel import make_mesh
    meshed = CatalogScorer(model, store, device='cpu', mesh=make_mesh())
    for a, b in zip(meshed.top_k([0, 1, 2], 4),
                    CatalogScorer(model, store, device='cpu').top_k(
                        [0, 1, 2], 4)):
        np.testing.assert_array_equal(a, b)


def test_cli_path_stands_alone(tmp_path):
    """A fresh interpreter imports the split and train entry points, reads
    a config through the port's YAML reader and CSV files through its CSV
    reader, splits, trains one epoch on the CPU and writes every file, and
    loads none of JAX, the JAX package, pandas, scikit-learn, PIL, PyYAML
    or transformers."""
    proc = tmp_path / 'processed'
    proc.mkdir()
    (proc / 'item_info.csv').write_text(
        'item_id,tag,price,description\n' + ''.join(
            f'i{j},t{j % 3},{j * 1.5},"item {j}, red"\n' for j in range(12)))
    (proc / 'interactions.csv').write_text(
        'user_id,item_id,timestamp\n' + ''.join(
            f'{u:03d},i{(u * 5 + k) % 12},{k}\n'
            for u in range(6) for k in range(5)))
    split = tmp_path / 'split'
    (tmp_path / 'config.yaml').write_text(f"""\
model:
  vision_model: null
  language_model: null
  embedding_dim: 8
  fusion_hidden_dims: [16]
  use_contrastive: false
training: {{batch_size: 16, epochs: 1}}
data:
  processed_item_info_path: {proc / 'item_info.csv'}
  processed_interactions_path: {proc / 'interactions.csv'}
  scaler_path: {proc / 'scaler.pkl'}
  split_data_path: {split}
  train_data_path: {split / 'train.csv'}
  val_data_path: {split / 'val.csv'}
  numerical_features_cols: [price]
  splitting:
    strategy: leave_one_out
    min_interactions_per_user: 3
    min_interactions_per_item: 1
checkpoint_dir: {tmp_path / 'ckpt'}
results_dir: {tmp_path / 'results'}
""")
    code = (
        'import contextlib, io, json, sys\n'
        'from pixelrec_multimodal_tpu_torch.scripts import create_splits, '
        'train\n'
        f'cfg = {str(tmp_path / "config.yaml")!r}\n'
        'with contextlib.redirect_stdout(io.StringIO()):\n'
        '    out = create_splits.main(cfg)\n'
        '    res = train.main(["--config", cfg, "--device", "cpu"])\n'
        'assert out["rows"] == {"train": 18, "val": 6, "test": 6}, out\n'
        'assert res["epochs_completed"] == 1\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
    assert not bad, bad
    assert {'pixelrec_multimodal_tpu_torch.utils.yaml_io',
            'pixelrec_multimodal_tpu_torch.data.splitting',
            'pixelrec_multimodal_tpu_torch.training.trainer'} <= set(loaded)
    assert (tmp_path / 'results' / 'training_metadata.json').exists()


def test_recommend_path_stands_alone(tmp_path):
    """A fresh interpreter splits and trains on the CPU, then runs the
    recommend entry point (top-K and MMR), the checkpoint manager, the
    inspector and extract_encoders, and loads none of JAX, the JAX
    package, pandas, scikit-learn, scipy, PIL, PyYAML or transformers."""
    proc = tmp_path / 'processed'
    proc.mkdir()
    (proc / 'item_info.csv').write_text(
        'item_id,tag,price\n' + ''.join(
            f'i{j},t{j % 3},{j * 1.5}\n' for j in range(12)))
    (proc / 'interactions.csv').write_text(
        'user_id,item_id,timestamp\n' + ''.join(
            f'{u:03d},i{(u * 5 + k) % 12},{k}\n'
            for u in range(6) for k in range(5)))
    split, ckpt = tmp_path / 'split', tmp_path / 'ckpt'
    (tmp_path / 'config.yaml').write_text(f"""\
model:
  vision_model: null
  language_model: null
  embedding_dim: 8
  fusion_hidden_dims: [16]
  use_contrastive: false
training: {{batch_size: 16, epochs: 1}}
recommendation: {{top_k: 3}}
data:
  processed_item_info_path: {proc / 'item_info.csv'}
  processed_interactions_path: {proc / 'interactions.csv'}
  scaler_path: {proc / 'scaler.pkl'}
  split_data_path: {split}
  train_data_path: {split / 'train.csv'}
  val_data_path: {split / 'val.csv'}
  numerical_features_cols: [price]
  splitting:
    strategy: leave_one_out
    min_interactions_per_user: 3
    min_interactions_per_item: 1
checkpoint_dir: {ckpt}
results_dir: {tmp_path / 'results'}
""")
    code = (
        'import contextlib, io, json, sys\n'
        'from pixelrec_multimodal_tpu_torch.scripts import (\n'
        '    checkpoint_manager, create_splits, extract_encoders,\n'
        '    generate_recommendations, inspect_checkpoint, train)\n'
        f'cfg = {str(tmp_path / "config.yaml")!r}\n'
        f'ckpt = {str(ckpt)!r}\n'
        'with contextlib.redirect_stdout(io.StringIO()):\n'
        '    create_splits.main(cfg)\n'
        '    train.main(["--config", cfg, "--device", "cpu"])\n'
        '    out = generate_recommendations.main(\n'
        '        ["--config", cfg, "--device", "cpu"])\n'
        '    mmr = generate_recommendations.main(\n'
        '        ["--config", cfg, "--device", "cpu", "--use_diversity",\n'
        '         "--output", "mmr.json"])\n'
        '    checkpoint_manager.main(["list", "--checkpoint_dir", ckpt])\n'
        '    checkpoint_manager.main(["info", "--checkpoint_dir", ckpt])\n'
        '    code = inspect_checkpoint.main(\n'
        '        [ckpt + "/None_None/best_model"])\n'
        '    extract_encoders.main(["--config", cfg])\n'
        'assert code == 0\n'
        'for report in (out, mmr):\n'
        '    recs = report["recommendations"]\n'
        '    assert len(recs) == 5 and all(len(v) == 3 for v in '
        'recs.values())\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split('.')[0] in FORBIDDEN | CARD_ABSENT | {'scipy'}]
    assert not bad, bad
    assert {'pixelrec_multimodal_tpu_torch.inference.recommender',
            'pixelrec_multimodal_tpu_torch.scripts.evaluate'} <= set(loaded)
    assert (ckpt / 'checkpoint_info.json').exists()
    assert (tmp_path / 'results' / 'mmr.json').exists()


def test_evaluate_path_stands_alone(tmp_path):
    """A fresh interpreter imports the evaluate entry point, the
    evaluation modules and the baselines without loading scipy, then
    splits, trains and evaluates on the CPU (the learned model, sampled
    and over the full catalog, and ItemKNN, which loads scipy), and loads
    none of JAX, the JAX package, pandas, scikit-learn, PIL, PyYAML or
    transformers."""
    proc, split = tmp_path / 'processed', tmp_path / 'split'
    proc.mkdir()
    (proc / 'item_info.csv').write_text(
        'item_id,tag,price\n' + ''.join(
            f'i{j},t{j % 3},{j * 1.5}\n' for j in range(12)))
    (proc / 'interactions.csv').write_text(
        'user_id,item_id,timestamp\n' + ''.join(
            f'{u:03d},i{(u * 5 + k) % 12},{k}\n'
            for u in range(6) for k in range(5)))
    (tmp_path / 'config.yaml').write_text(f"""\
model:
  vision_model: null
  language_model: null
  embedding_dim: 8
  fusion_hidden_dims: [16]
  use_contrastive: false
training: {{batch_size: 16, epochs: 1}}
recommendation: {{top_k: 3}}
data:
  processed_item_info_path: {proc / 'item_info.csv'}
  processed_interactions_path: {proc / 'interactions.csv'}
  scaler_path: {proc / 'scaler.pkl'}
  split_data_path: {split}
  train_data_path: {split / 'train.csv'}
  val_data_path: {split / 'val.csv'}
  numerical_features_cols: [price]
  splitting:
    strategy: leave_one_out
    min_interactions_per_user: 3
    min_interactions_per_item: 1
checkpoint_dir: {tmp_path / 'ckpt'}
results_dir: {tmp_path / 'results'}
""")
    code = (
        'import contextlib, io, json, sys\n'
        'import pixelrec_multimodal_tpu_torch.evaluation\n'
        'import pixelrec_multimodal_tpu_torch.inference.baseline_recommenders\n'
        'from pixelrec_multimodal_tpu_torch.scripts import (\n'
        '    create_splits, evaluate, train)\n'
        'scipy_on_import = "scipy" in sys.modules\n'
        f'cfg = {str(tmp_path / "config.yaml")!r}\n'
        f'test = {str(split / "val.csv")!r}\n'
        'ev = ["--config", cfg, "--device", "cpu", "--test_data", test]\n'
        'with contextlib.redirect_stdout(io.StringIO()):\n'
        '    create_splits.main(cfg)\n'
        '    train.main(["--config", cfg, "--device", "cpu"])\n'
        '    runs = [evaluate.main(ev),\n'
        '            evaluate.main(ev + ["--full_catalog", "--output",\n'
        '                                "full.json"]),\n'
        '            evaluate.main(ev + ["--recommender_type", "item_knn",\n'
        '                                "--output", "knn.json"])]\n'
        'assert not scipy_on_import\n'
        'assert [r["num_users_evaluated"] for r in runs] == [6, 6, 6], runs\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
    assert not bad, bad
    assert 'scipy.sparse' in loaded
    assert {'pixelrec_multimodal_tpu_torch.evaluation.tasks',
            'pixelrec_multimodal_tpu_torch.evaluation.novelty'} <= set(loaded)
    for name in ('evaluation_results.json', 'full.json', 'knn.json'):
        assert (tmp_path / 'results' / name).exists()


def test_hpo_path_stands_alone(tmp_path):
    """A fresh interpreter imports the search engine, its plots and both
    entry points, then writes the training subsets, and loads none of
    JAX, the JAX package, pandas, scikit-learn, PyYAML, optuna,
    matplotlib or scipy (matplotlib only inside the plotting
    functions)."""
    split = tmp_path / 'split'
    split.mkdir()
    (split / 'train.csv').write_text('user_id,item_id,timestamp\n' + ''.join(
        f'u{k % 7},i{k % 11},2023-{1 + k % 6:02d}-0{1 + k % 9} 10:00:00\n'
        for k in range(80)))
    (tmp_path / 'config.yaml').write_text(
        f'data:\n  train_data_path: {split / "train.csv"}\n')
    code = (
        'import contextlib, io, json, sys\n'
        'import pixelrec_multimodal_tpu_torch.hpo\n'
        'from pixelrec_multimodal_tpu_torch.scripts import (\n'
        '    create_training_subsets, hyperparameter_search)\n'
        'with contextlib.redirect_stdout(io.StringIO()):\n'
        f'    out = create_training_subsets.main(["--config", '
        f'{str(tmp_path / "config.yaml")!r}])\n'
        'assert out["rows"] == {"full": 80, "50": 40, "20": 16, "05": 4}\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split('.')[0] in
           FORBIDDEN | CARD_ABSENT | {'optuna', 'matplotlib', 'scipy'}]
    assert not bad, bad
    assert {'pixelrec_multimodal_tpu_torch.hpo.search',
            'pixelrec_multimodal_tpu_torch.hpo.visualization',
            'pixelrec_multimodal_tpu_torch.data.timestamps'} <= set(loaded)
    for frac in ('50', '20', '05'):
        assert (split / f'train_{frac}_percent.csv').exists()


def test_precompute_path_stands_alone(tmp_path):
    """A fresh interpreter imports every port module, the encoder towers
    and the image tier among them, and loads neither PIL nor transformers
    (they are imported only inside the calls that decode or load a
    checkpoint); then packs a catalog's input tables through the
    precompute entry point (``--skip_encoders``), and still loads none of
    JAX, the JAX package, pandas, scikit-learn, PIL, PyYAML or
    transformers."""
    proc = tmp_path / 'processed'
    proc.mkdir()
    (proc / 'item_info.csv').write_text(
        'item_id,tag,price,description\n' + ''.join(
            f'i{j},t{j % 3},{j * 1.5},item {j} red\n' for j in range(12)))
    (tmp_path / 'config.yaml').write_text(f"""\
model:
  vision_model: resnet
  language_model: sentence-bert
data:
  processed_item_info_path: {proc / 'item_info.csv'}
  scaler_path: {proc / 'scaler.pkl'}
  processed_image_destination_folder: {tmp_path / 'images'}
  numerical_features_cols: [price]
  categorical_features_cols: [tag]
  cache_config: {{cache_directory: {tmp_path / 'cache'}}}
""")
    code = (
        'import contextlib, importlib, io, json, sys\n'
        f'for m in {port_modules()!r}: importlib.import_module(m)\n'
        'on_import = sorted(sys.modules)\n'
        'from pixelrec_multimodal_tpu_torch.scripts import precompute_cache\n'
        'with contextlib.redirect_stdout(io.StringIO()):\n'
        '    store = precompute_cache.main(["--config", '
        f'{str(tmp_path / "config.yaml")!r}, "--device", "cpu", '
        '"--skip_encoders"])\n'
        'assert store.tables["text_input_ids"].shape == (12, 512)\n'
        'print(json.dumps([on_import, sorted(sys.modules)]))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    on_import, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {'pixelrec_multimodal_tpu_torch.encoders.precompute',
            'pixelrec_multimodal_tpu_torch.encoders.convert',
            'pixelrec_multimodal_tpu_torch.data.processors.image_processor',
            'pixelrec_multimodal_tpu_torch.scripts.precompute_cache'} <= set(
        on_import)
    for modules in (on_import, loaded):
        bad = [m for m in modules
               if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
        assert not bad, bad
    assert (tmp_path / 'cache' / 'vision_resnet_lang_sentence-bert' /
            'feature_tables.npz').exists()


def test_e2e_path_stands_alone(tmp_path):
    """A fresh interpreter imports every port module, then builds a small
    end-to-end model (a 2-stage ResNet, a 1-layer text tower, remat on),
    takes one augmented SGD step and one eval step under the profiling
    utilities and a trace, and loads none of JAX, the JAX package,
    pandas, scikit-learn, PIL, PyYAML or transformers."""
    code = (
        'import importlib, json, sys\n'
        'import numpy as np, torch\n'
        f'for m in {port_modules()!r}: importlib.import_module(m)\n'
        'from pixelrec_multimodal_tpu_torch.config import (\n'
        '    ImageAugmentationConfig)\n'
        'from pixelrec_multimodal_tpu_torch.encoders.resnet import (\n'
        '    ResNetConfig, ResNetTower)\n'
        'from pixelrec_multimodal_tpu_torch.encoders.text_models import (\n'
        '    TextEncoderConfig, TextTransformer)\n'
        'from pixelrec_multimodal_tpu_torch.models.end_to_end import (\n'
        '    EndToEndRecommender, trainable_mask)\n'
        'from pixelrec_multimodal_tpu_torch.models.multimodal import (\n'
        '    MultimodalRecommender)\n'
        'from pixelrec_multimodal_tpu_torch.training import e2e_steps\n'
        'from pixelrec_multimodal_tpu_torch.training.optimizers import (\n'
        '    build_optimizer, with_frozen)\n'
        'from pixelrec_multimodal_tpu_torch.utils import profiling\n'
        'scorer = MultimodalRecommender(6, 10, 3, 0, embedding_dim=8,\n'
        '    vision_feature_dim=32, language_feature_dim=16,\n'
        '    use_contrastive=False, fusion_hidden_dims=(16,),\n'
        '    device="cpu")\n'
        'model = EndToEndRecommender(scorer,\n'
        '    vision_encoder=ResNetTower(ResNetConfig(8, (16, 32), (2, 2))),\n'
        '    language_encoder=TextTransformer(TextEncoderConfig(\n'
        '        50, 16, 1, 2, 32, 16)), remat_encoders=True)\n'
        'tx = with_frozen(build_optimizer("sgd", 1e-2),\n'
        '    trainable_mask(model, freeze_vision=False))\n'
        'state = e2e_steps.init_e2e_train_state(model, tx)\n'
        'train, evaluate = e2e_steps.make_e2e_step_fns(model, {},\n'
        '    augmentation_config=ImageAugmentationConfig(enabled=True))\n'
        'rng = np.random.default_rng(0)\n'
        'batch = dict(user_idx=np.arange(4) % 6, item_idx=np.arange(4),\n'
        '    tag_idx=np.arange(4) % 3, label=np.array([0., 1., 1., 0.]),\n'
        '    image=rng.standard_normal((4, 3, 32, 32)).astype("float32"),\n'
        '    text_input_ids=rng.integers(1, 50, (4, 8)),\n'
        '    text_attention_mask=np.ones((4, 8), "int64"))\n'
        'meter, timer = profiling.ThroughputMeter(), profiling.StepTimer()\n'
        f'with profiling.trace({str(tmp_path)!r}), meter.measure(4), \\\n'
        '        timer.phase("step"), profiling.step_annotation("e2e"):\n'
        '    state, m = train(state, batch,\n'
        '                     torch.Generator().manual_seed(1))\n'
        'assert int(state.step) == 1 and np.isfinite(float(m["total_loss"]))\n'
        'assert np.isfinite(float(evaluate(state, batch)["total_loss"]))\n'
        'assert meter.calls == 1 and "step" in timer.phases\n'
        'assert profiling.device_memory_stats() == {}\n'
        'print(json.dumps(sorted(sys.modules)))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {'pixelrec_multimodal_tpu_torch.ops.augment',
            'pixelrec_multimodal_tpu_torch.models.end_to_end',
            'pixelrec_multimodal_tpu_torch.training.e2e_steps',
            'pixelrec_multimodal_tpu_torch.utils.profiling'} <= set(loaded)
    bad = [m for m in loaded if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
    assert not bad, bad
    assert (tmp_path / 'trace.json').exists()


def test_preprocess_path_stands_alone(tmp_path):
    """A fresh interpreter imports the preprocess entry point, the image
    processor and the image decoders, and loads none of JAX, the JAX
    package, pandas, scikit-learn, PIL, PyYAML or transformers; with PIL
    blocked and ``--device cpu`` the entry point then raises at the image
    step naming A12, and still loads none of them."""
    raw = tmp_path / 'raw'
    (raw / 'images').mkdir(parents=True)
    (raw / 'item_info.csv').write_text(
        'item_id,tag,title\n' + ''.join(f'i{j},t{j % 2},<b>T{j}</b>\n'
                                        for j in range(4)))
    (raw / 'interactions.csv').write_text(
        'user_id,item_id,timestamp\n' + ''.join(
            f'u{u},i{j},{u + j}\n' for u in range(3) for j in range(4)))
    (tmp_path / 'config.yaml').write_text(f"""\
data:
  item_info_path: {raw / 'item_info.csv'}
  interactions_path: {raw / 'interactions.csv'}
  image_folder: {raw / 'images'}
  processed_image_destination_folder: {tmp_path / 'processed' / 'images'}
""")
    code = (
        'import contextlib, io, json, sys\n'
        'from pixelrec_multimodal_tpu_torch.scripts import preprocess_data\n'
        'from pixelrec_multimodal_tpu_torch.data.processors import '
        'image_processor\n'
        'from pixelrec_multimodal_tpu_torch.data import image_codecs\n'
        'on_import = sorted(sys.modules)\n'
        'sys.modules["PIL"] = None\n'
        'try:\n'
        '    with contextlib.redirect_stdout(io.StringIO()):\n'
        '        preprocess_data.main(["--config", '
        f'{str(tmp_path / "config.yaml")!r}, "--device", "cpu"])\n'
        'except image_codecs.ImageCodecMissing as e:\n'
        '    assert "A12" in str(e), e\n'
        'else:\n'
        '    raise AssertionError("no decoder, and no raise")\n'
        'print(json.dumps([on_import, sorted(\n'
        '    k for k, v in sys.modules.items() if v is not None)]))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    on_import, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {'pixelrec_multimodal_tpu_torch.scripts.preprocess_data',
            'pixelrec_multimodal_tpu_torch.data.image_codecs'} <= set(
        on_import)
    for modules in (on_import, loaded):
        bad = [m for m in modules
               if m.split('.')[0] in FORBIDDEN | CARD_ABSENT]
        assert not bad, bad
