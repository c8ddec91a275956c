# pixelrec_multimodal_tpu_torch/parallel/dryrun.py
"""The multi-rank dry run: the whole training and serving matrix on a mesh.

Counterpart of ``dryrun_multichip`` and ``_dryrun_impl`` of the repo's
``__graft_entry__.py``. ``dryrun_multichip(n)`` starts ``n`` rank
processes of one process group (``python -m
pixelrec_multimodal_tpu_torch.parallel.dryrun JOB RANK N DEVICE``, a file
store under a temporary job directory; NCCL where the ranks run on the
card and there are ``n`` cards, one a rank, else gloo) and runs, on a
(data, model) mesh with a model axis of 2 where ``n`` is even:

  1. a frozen train and eval step with InfoNCE active: the batch over
     'data', the parameters tensor-parallel (``param_shardings``) and the
     packed item table split over 'model';
  2. the catalog-sharded top-K of ``CatalogScorer`` on the trained model;
  3. the three cascades of an attention model (gram variant) on the mesh,
     equal to one process's, then ``auto_cascade``'s plan and the
     routed ``top_k`` equal to the exact scan;
  4. the unfrozen step with remat: tiny CLIP vision and text towers and a
     text transformer in the step, data-parallel and tensor-parallel;
  5. a checkpoint round trip of the sharded train state on the mesh (the
     single-process file), then one more step on the restored state;

then the frozen step and the scorer again on an (n, 1) and a (2, n/2)
mesh. Rank 0 prints ``dryrun_multichip ok: ranks=... backend=...
primary_mesh=... stages=[...]`` with JAX's stage names; any rank's
failure raises. The weights are the port's own random ones, so the
losses are not JAX's. The ranks run on ``device``: the card by default
(rank r on card r modulo the visible cards: with fewer cards than ranks,
ranks share a card and gloo carries their CUDA tensors), ``'cpu'`` when
asked.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..device import resolve_device

RANK_TIMEOUT_S = 900


def dryrun_multichip(n_ranks: int,
                     device: Union[str, torch.device] = 'cuda') -> str:
    """Run the dry run on ``n_ranks`` rank processes; returns and prints
    rank 0's ok line. Raises with the ranks' logs if any rank fails."""
    dev = resolve_device(device)
    repo = Path(__file__).resolve().parents[2]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS='1')
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp)
        procs = []
        try:
            for r in range(n_ranks):
                with open(job / f'log{r}.txt', 'w') as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, '-m', __name__, str(job), str(r),
                         str(n_ranks), dev.type], cwd=repo, env=env,
                        stdout=log, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            logs = '\n'.join(f'--- rank {r} exited {p.returncode}\n'
                             + (job / f'log{r}.txt').read_text()[-4000:]
                             for r, p in enumerate(procs))
            raise RuntimeError(f'dryrun_multichip failed:\n{logs}')
        line = (job / 'ok.txt').read_text()
    print(line, flush=True)
    return line


# ------------------------------------------------------------- rank side
VISION, LANGUAGE, NUMERICAL, CLIP_TEXT = 128, 64, 4, 64
N_USERS, N_TAGS = 64, 8


def _flagship(n_items, dev, use_contrastive=False, fusion='concatenate',
              seed=0):
    """JAX's ``_flagship``: the flagship's layout at the dry run's widths."""
    from ..models.multimodal import MultimodalRecommender
    return MultimodalRecommender(
        n_users=N_USERS, n_items=n_items, n_tags=N_TAGS,
        num_numerical_features=NUMERICAL, embedding_dim=32,
        vision_feature_dim=VISION, language_feature_dim=LANGUAGE,
        clip_text_feature_dim=CLIP_TEXT, use_contrastive=use_contrastive,
        fusion_hidden_dims=(64, 32), fusion_type=fusion, use_batch_norm=True,
        dropout_rate=0.1, generator=torch.Generator().manual_seed(seed),
        device=dev)


def _make_tables(mesh, n_items, dev):
    """The packed item table (vision, language, numerical, CLIP text),
    this rank's rows of the item axis split over 'model'."""
    from .mesh import item_table_sharding
    rng = np.random.default_rng(7)
    parts = [('vision_emb', rng.standard_normal((n_items, VISION))),
             ('language_emb', rng.standard_normal((n_items, LANGUAGE))),
             ('numerical', rng.standard_normal((n_items, NUMERICAL))),
             ('clip_text_emb', rng.standard_normal((n_items, CLIP_TEXT)))]
    key = 'packed::' + '+'.join(f'{n}={a.shape[1]}' for n, a in parts)
    table = np.concatenate([a for _, a in parts], axis=1).astype(np.float32)
    rows = item_table_sharding(mesh, n_items)
    return {key: torch.from_numpy(table[rows].copy()).to(dev)}


def _make_batch(B, n_items, seed=0):
    rng = np.random.default_rng(seed)
    return {
        'user_idx': rng.integers(0, N_USERS, B).astype(np.int32),
        'item_idx': rng.integers(0, n_items, B).astype(np.int32),
        'tag_idx': rng.integers(0, N_TAGS, B).astype(np.int32),
        'label': rng.integers(0, 2, B).astype(np.float32),
        'weight': np.ones(B, np.float32),
    }


def _local(batch, mesh, dev):
    from .mesh import shard_batch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in shard_batch(batch, mesh).items()}


def _frozen_contrastive_stage(mesh, n_items, dev):
    """Frozen train and eval step with InfoNCE: the batch over 'data',
    tensor-parallel parameters, the packed table over 'model'."""
    from ..training.optimizers import build_optimizer
    from ..training.steps import init_train_state, make_step_fns
    from .tensor_parallel import shard_module
    model = _flagship(n_items, dev, use_contrastive=True)
    shard_module(model, mesh)
    state = init_train_state(model, build_optimizer('adamw', 1e-3, 0.01,
                                                    gradient_clip=1.0))
    tables = _make_tables(mesh, n_items, dev)
    train_step, eval_step = make_step_fns(model, tables, mesh=mesh)
    batch = _local(_make_batch(8 * mesh.size, n_items), mesh, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    state, metrics = train_step(state, batch, gen)
    loss = float(metrics['total_loss'])
    closs = float(metrics['contrastive_loss'])
    assert np.isfinite(loss), f'non-finite loss in the dry run: {loss}'
    assert closs > 0.0, 'contrastive loss inactive in the dry run'
    em = eval_step(state, batch)
    assert np.isfinite(float(em['total_loss']))
    return loss, closs, state, model


def _whole_model(mesh, state, n_items, dev):
    """A single-process model holding the trained sharded state's whole
    parameters and BatchNorm statistics (gathered by name)."""
    from ..training.trainer import train_state_tensors
    from ..utils.checkpointing import gather_state, load_model_state
    whole = gather_state(train_state_tensors(state), mesh,
                         state.model.tp_shardings)
    model = _flagship(n_items, dev, use_contrastive=True)
    load_model_state(model, whole)
    return model


def _store(n_items, seed):
    from ..data.feature_store import ItemFeatureStore
    rng = np.random.default_rng(seed)
    store = ItemFeatureStore(n_items, np.arange(n_items).astype(str))
    store.tables['tag_idx'] = (np.arange(n_items) % N_TAGS).astype(np.int32)
    store.tables['vision_emb'] = rng.standard_normal(
        (n_items, VISION)).astype(np.float32)
    store.tables['language_emb'] = rng.standard_normal(
        (n_items, LANGUAGE)).astype(np.float32)
    store.tables['numerical'] = rng.standard_normal(
        (n_items, NUMERICAL)).astype(np.float32)
    return store


def _scorer_stage(mesh, state, n_items, dev):
    """The catalog-sharded top-K of the trained model: item tables over
    'model', user rows over 'data'."""
    from ..inference.scorer import CatalogScorer
    n = mesh.size
    scorer = CatalogScorer(_whole_model(mesh, state, n_items, dev),
                           _store(n_items, 1), item_chunk=128,
                           user_chunk=2 * n, mesh=mesh, device=dev)
    values, items = scorer.top_k(np.arange(3 * n) % N_USERS, k=5)
    assert items.shape == (3 * n, 5) and (items >= 0).all()
    assert np.isfinite(values).all()
    return items.shape


def _cascade_stage(mesh, n_items, dev):
    """The attention model's cascades (gram variant) on the mesh, equal
    to one process's; ``auto_cascade``'s routed top-K equal to the exact
    scan."""
    from ..inference.scorer import CatalogScorer
    n = mesh.size
    model = _flagship(n_items, dev, fusion='attention', seed=2)
    store = _store(n_items, 11)
    kw = dict(item_chunk=32, user_chunk=2 * n, attention_variant='gram',
              device=dev)
    single = CatalogScorer(model, store, **kw)
    meshed = CatalogScorer(model, store, mesh=mesh, **kw)
    users = np.arange(3 * n, dtype=np.int32) % N_USERS
    for screen in ('additive', 'token0', 'funnel'):
        vs, is_ = single.top_k_cascade(users, 5, n_candidates=16,
                                       screen=screen, funnel_c1=24,
                                       _calibrated=True)
        vm, im = meshed.top_k_cascade(users, 5, n_candidates=16,
                                      screen=screen, funnel_c1=24,
                                      _calibrated=True)
        assert all(set(a) == set(b) for a, b in zip(im, is_)), \
            f'sharded {screen} cascade diverged'
        np.testing.assert_allclose(vm, vs, rtol=1e-4, atol=1e-5)
    ve, ie = meshed.top_k(users, 5, _exact=True)
    plan = meshed.auto_cascade(users, 5, max_candidate_frac=1.0,
                               min_speedup=0.0)
    assert plan is not None and meshed._cascade_plan is not None
    va, ia = meshed.top_k(users, 5)  # routed through the cascade
    assert all(set(a) == set(b) for a, b in zip(ia, ie)), \
        'auto-cascade routed top_k diverged'
    return plan['screen'], int(plan['n_candidates'])


def e2e_model(n_items: int, dev) -> 'torch.nn.Module':
    """The dry run's end-to-end model: tiny CLIP vision (32 px) and text
    towers and a text transformer (16 tokens) under remat, each from
    ``random_init_(seed 0)``, before a contrastive scorer with BatchNorm
    and dropout 0.1 (seed 0)."""
    from ..encoders.clip import (
        CLIPTextConfig,
        CLIPTextTower,
        CLIPVisionConfig,
        CLIPVisionTower,
    )
    from ..encoders.common import random_init_
    from ..encoders.text_models import TextEncoderConfig, TextTransformer
    from ..models.end_to_end import EndToEndRecommender
    from ..models.multimodal import MultimodalRecommender
    towers = {
        'vision_encoder': CLIPVisionTower(CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
            image_size=32, patch_size=16)),
        'language_encoder': TextTransformer(TextEncoderConfig(
            vocab_size=64, hidden_size=24, num_layers=2, num_heads=2,
            intermediate_size=48, max_position_embeddings=16)),
        'clip_text_encoder': CLIPTextTower(CLIPTextConfig(
            vocab_size=64, hidden_size=16, intermediate_size=32,
            num_layers=2, num_heads=2, max_position_embeddings=16))}
    for tower in towers.values():
        random_init_(tower, 0)
    scorer = MultimodalRecommender(
        n_users=N_USERS, n_items=n_items, n_tags=N_TAGS,
        num_numerical_features=NUMERICAL, embedding_dim=16,
        vision_feature_dim=32, language_feature_dim=24,
        clip_text_feature_dim=16, use_contrastive=True,
        fusion_hidden_dims=(32,), fusion_type='concatenate',
        use_batch_norm=True, dropout_rate=0.1, vision_model_name='clip',
        language_model_name='sentence-bert',
        generator=torch.Generator().manual_seed(0), device=dev)
    return EndToEndRecommender(scorer, remat_encoders=True, **towers)


def e2e_batch(B: int, n_items: int, seed: int = 3) -> dict:
    """A global batch of the end-to-end model's inputs (numpy)."""
    rng = np.random.default_rng(seed)
    batch = _make_batch(B, n_items, seed=seed)
    batch['image'] = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    batch['text_input_ids'] = rng.integers(1, 64, (B, 16)).astype(np.int32)
    batch['text_attention_mask'] = np.ones((B, 16), np.int32)
    batch['clip_text_input_ids'] = rng.integers(1, 64, (B, 16)).astype(
        np.int32)
    batch['clip_text_attention_mask'] = np.ones((B, 16), np.int32)
    return batch


def _e2e_remat_stage(mesh, n_items, dev):
    """The unfrozen step under the mesh: ``e2e_model`` with InfoNCE
    active, the batch over 'data', tensor-parallel parameters."""
    from ..training.e2e_steps import init_e2e_train_state, make_e2e_step_fns
    from ..training.optimizers import build_optimizer
    from .tensor_parallel import shard_module
    model = e2e_model(n_items, dev)
    shard_module(model, mesh)
    state = init_e2e_train_state(model, build_optimizer(
        'adamw', 1e-3, 0.01, gradient_clip=1.0))
    num = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n_items, NUMERICAL)).astype(np.float32)).to(dev)
    train_step, _ = make_e2e_step_fns(model, {'numerical': num}, mesh=mesh)
    batch = e2e_batch(4 * mesh.size, n_items)
    before = [p.detach().clone()
              for p in model.vision_encoder.parameters()]
    state, metrics = train_step(state, _local(batch, mesh, dev),
                                torch.Generator(device=dev).manual_seed(4))
    loss = float(metrics['total_loss'])
    assert np.isfinite(loss), f'non-finite e2e loss: {loss}'
    assert float(metrics['contrastive_loss']) > 0.0
    moved = sum(float((a - b).abs().sum()) for a, b in zip(
        before, model.vision_encoder.parameters()))
    assert moved > 0.0, 'the unfrozen encoder did not update on the mesh'
    return loss


def _checkpoint_stage(mesh, state, n_items, dev, directory):
    """The sharded train state written on the mesh (the single-process
    file), read back onto the mesh bit for bit, then one more step on the
    restored state."""
    from ..training.steps import make_step_fns
    from ..training.trainer import restore_optimizer, train_state_tensors
    from ..utils.checkpointing import (
        load_checkpoint,
        load_model_state,
        save_checkpoint,
    )
    shardings = state.model.tp_shardings
    payload = train_state_tensors(state)
    save_checkpoint(directory, 'best_model', payload, {'epoch': 1},
                    mesh=mesh, shardings=shardings)
    restored = load_checkpoint(directory, 'best_model', device=dev,
                               mesh=mesh, shardings=shardings)
    assert restored is not None
    r = restored['state']
    for group in ('params', 'batch_stats'):
        for name, t in payload[group].items():
            assert torch.equal(t.detach(), r[group][name]), name
    for field, t in payload['opt_state'].items():
        if field != 'names':
            assert torch.equal(t, r['opt_state'][field]), field
    load_model_state(state.model, r)
    restore_optimizer(state, r)
    train_step, _ = make_step_fns(state.model, _make_tables(mesh, n_items,
                                                            dev),
                                  mesh=mesh)
    batch = _local(_make_batch(8 * mesh.size, n_items, seed=5), mesh, dev)
    _, metrics = train_step(state, batch,
                            torch.Generator(device=dev).manual_seed(6))
    loss = float(metrics['total_loss'])
    assert np.isfinite(loss), f'non-finite loss after restore: {loss}'
    return loss


def _dryrun_impl(job: Path, n_ranks: int, dev: torch.device) -> str:
    """Every stage on this rank (module docstring); the ok line."""
    import torch.distributed as dist

    from .mesh import make_mesh
    model_parallel = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    mesh = make_mesh(model_parallel=model_parallel)
    n_items = 8 * max(model_parallel, n_ranks // 2, 1) * 4

    stages = []
    loss, closs, state, _ = _frozen_contrastive_stage(mesh, n_items, dev)
    stages.append(f'frozen+contrastive(loss={loss:.4f},infonce={closs:.4f})')
    shape = _scorer_stage(mesh, state, n_items, dev)
    stages.append(f'sharded_topk(shape={shape})')
    ctier, cc = _cascade_stage(mesh, n_items, dev)
    stages.append(f'sharded_cascade(auto={ctier}@C{cc})')
    e2e_loss = _e2e_remat_stage(mesh, n_items, dev)
    stages.append(f'e2e_unfrozen+remat(loss={e2e_loss:.4f})')
    ck_loss = _checkpoint_stage(mesh, state, n_items, dev, job / 'ckpt')
    stages.append(f'sharded_ckpt_roundtrip(loss={ck_loss:.4f})')

    topos = [(n_ranks, 1)]
    if n_ranks >= 4 and n_ranks % 2 == 0:
        topos.append((2, n_ranks // 2))
    for dp, mp in topos:
        if (dp, mp) == tuple(mesh.devices.shape):
            continue
        m2 = make_mesh(data_parallel=dp, model_parallel=mp)
        l2, _, st2, _ = _frozen_contrastive_stage(m2, n_items, dev)
        _scorer_stage(m2, st2, n_items, dev)
        stages.append(f'mesh{dp}x{mp}(loss={l2:.4f})')
    return (f'dryrun_multichip ok: ranks={n_ranks} backend='
            f'{dist.get_backend()} primary_mesh={mesh.shape} '
            'stages=[' + '; '.join(stages) + ']')


def rank_main(job: Path, rank: int, n_ranks: int, device: str) -> int:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev, backend = torch.device('cpu'), 'gloo'
    if device == 'cuda':
        cards = torch.cuda.device_count()
        dev = torch.device('cuda', rank % cards)
        torch.cuda.set_device(dev)
        if cards >= n_ranks:  # NCCL takes one rank a card
            backend = 'nccl'
    dist.init_process_group(backend, init_method=f'file://{job}/store',
                            rank=rank, world_size=n_ranks)
    line = _dryrun_impl(job, n_ranks, dev)
    dist.barrier()
    if rank == 0:
        (job / 'ok.txt').write_text(line)
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    try:
        sys.exit(rank_main(Path(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
