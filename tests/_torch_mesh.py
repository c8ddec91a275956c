"""Gloo ranks on the CPU for the port's meshed tests.

A test module starts its ranks once (``Ranks``): ``world`` processes of
``python -m tests._torch_mesh JOB_DIR RANK WORLD``, which import the port
only (never JAX), take one thread each, and join one gloo group through a
file store under the job's directory (no TCP port, so test files can run
side by side). While they start, the test process prepares the job (the
models' Flax variables as numpy trees, the item tables and a list of
calls) and hands it over (``Ranks.submit``); each rank runs every call in
order, on meshes and scorers it builds once, and pickles the results;
the training calls (``TRAIN_CALLS``) build their models afresh and run
with gradients on. Each rank's output and errors go to files in the job's
directory.
"""
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
JOB_WAIT_S = 300


class Ranks:
    """``world`` gloo rank processes waiting for a job under ``job_dir``."""

    def __init__(self, job_dir: Path, world: int):
        self.dir, self.world = Path(job_dir), world
        self.dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
        self.procs = []
        for r in range(world):
            log = open(self.dir / f'log_{r}.txt', 'w')
            self.procs.append(subprocess.Popen(
                [sys.executable, '-m', 'tests._torch_mesh', str(self.dir),
                 str(r), str(world)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
            log.close()
        self._results = None

    def submit(self, job: dict):
        """Hand the job to the ranks (written whole, then renamed)."""
        tmp = self.dir / 'job.tmp'
        tmp.write_bytes(pickle.dumps(job))
        tmp.rename(self.dir / 'job.pkl')

    def results(self, timeout: float = JOB_WAIT_S) -> list:
        """Every rank's {call id: result}, after all ranks exited 0; on a
        failure or past ``timeout`` the ranks are killed and their logs
        raised."""
        if self._results is not None:
            return self._results
        deadline = time.time() + timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError('ranks timed out:\n' + self.logs())
        if any(p.returncode for p in self.procs):
            self.kill()
            raise AssertionError('a rank failed:\n' + self.logs())
        self._results = [pickle.loads((self.dir / f'out_{r}.pkl')
                                      .read_bytes())
                         for r in range(self.world)]
        return self._results

    def logs(self) -> str:
        return '\n'.join(f'--- rank {r}\n' + (self.dir / f'log_{r}.txt')
                         .read_text()[-6000:] for r in range(self.world))

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class Torchrun:
    """One entry point of the port under ``torchrun`` on the CPU:
    ``python -m torch.distributed.run --standalone --nproc_per_node N -m
    pixelrec_multimodal_tpu_torch.scripts.<entry> ARGS`` from ``cwd`` (the
    rendezvous on a free localhost port), ``threads`` threads a rank, its
    output in ``cwd/torchrun_<entry>.txt``. ``wait`` raises with that output
    unless it exited 0."""

    def __init__(self, entry: str, args, cwd: Path, nproc: int = 2,
                 threads: int = 1):
        self.log = Path(cwd) / f'torchrun_{entry}.txt'
        env = dict(os.environ, OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=str(REPO))
        with open(self.log, 'w') as log:
            self.proc = subprocess.Popen(
                [sys.executable, '-m', 'torch.distributed.run',
                 '--standalone', '--nproc_per_node', str(nproc), '-m',
                 f'pixelrec_multimodal_tpu_torch.scripts.{entry}',
                 *map(str, args)], cwd=cwd, env=env, stdout=log,
                stderr=subprocess.STDOUT)

    def wait(self, timeout: float = JOB_WAIT_S) -> str:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        out = self.log.read_text()
        if self.proc.returncode:
            raise AssertionError(f'torchrun exited {self.proc.returncode}:'
                                 f'\n{out[-8000:]}')
        return out


# ------------------------------------------------------------- rank side
class StubDataset:
    """What the Recommender reads of a dataset: encoders, the feature
    store, the catalog size and the users' histories (CSR)."""

    def __init__(self, store, user_ids, item_ids, history):
        from pixelrec_multimodal_tpu_torch.data.label_encoder import (
            LabelEncoder,
        )
        self.feature_store = store
        self.user_encoder = LabelEncoder().fit(list(user_ids))
        self.item_encoder = LabelEncoder().fit(list(item_ids))
        self.n_items = len(item_ids)
        self._history = history

    def user_history_matrix(self):
        return self._history

    def get_user_history(self, user_id):
        uidx = int(self.user_encoder.transform([user_id])[0])
        indptr, items = self._history
        return set(self.item_encoder.inverse_transform(
            items[indptr[uidx]:indptr[uidx + 1]]))


class Context:
    """The meshes, models, stores, scorers and recommenders of a job,
    each built once, in the order the calls first need them (the same on
    every rank, as the process groups require)."""

    def __init__(self, job: dict):
        self.job = job
        self.cache = {}

    def once(self, key, build):
        if key not in self.cache:
            self.cache[key] = build()
        return self.cache[key]

    def mesh(self, shape):
        from pixelrec_multimodal_tpu_torch.parallel import make_mesh
        dp, mp = shape
        return self.once(('mesh', dp, mp), lambda: make_mesh(
            data_parallel=dp, model_parallel=mp))

    def model(self, name):
        def build():
            from pixelrec_multimodal_tpu_torch.models.multimodal import (
                MultimodalRecommender,
            )
            from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
                load_flax_variables,
            )
            spec = self.job['models'][name]
            model = MultimodalRecommender(**spec['kw'], device='cpu')
            load_flax_variables(model, spec['variables'])
            return model
        return self.once(('model', name), build)

    def store(self, name):
        def build():
            from pixelrec_multimodal_tpu_torch.data.feature_store import (
                ItemFeatureStore,
            )
            tables = self.job['stores'][name]
            n = len(tables['tag_idx'])
            store = ItemFeatureStore(n, np.asarray(
                self.job.get('item_ids', {}).get(name,
                                                 np.arange(n).astype(str))))
            store.tables.update(tables)
            return store
        return self.once(('store', name), build)

    def scorer(self, call):
        from pixelrec_multimodal_tpu_torch.inference.scorer import (
            CatalogScorer,
        )
        mesh = self.mesh(call['mesh']) if call.get('mesh') else None
        kw = call.get('scorer', {})
        key = ('scorer', call['model'], call.get('mesh'),
               tuple(sorted(kw.items())))
        return self.once(key, lambda: CatalogScorer(
            self.model(call['model']), self.store(call['store']),
            mesh=mesh, device='cpu', **kw)), mesh

    def recommender(self, call):
        from pixelrec_multimodal_tpu_torch.inference import Recommender
        mesh = self.mesh(call['mesh']) if call.get('mesh') else None
        kw = call.get('scorer', {})
        key = ('recommender', call['model'], call.get('mesh'),
               tuple(sorted(kw.items())))

        def build():
            d = self.job['datasets'][call['dataset']]
            data = StubDataset(self.store(call['store']), d['user_ids'],
                               d['item_ids'], d['history'])
            return Recommender(self.model(call['model']), data, mesh=mesh,
                               device='cpu', **kw)
        return self.once(key, build), mesh

    def run(self, call):
        kind = call['kind']
        if kind in TRAIN_CALLS:
            import torch
            with torch.enable_grad():
                return TRAIN_CALLS[kind](self, call)
        if kind == 'mesh_info':
            return mesh_info(call['requests'])
        if kind == 'init_distributed':
            import torch.distributed as dist
            from pixelrec_multimodal_tpu_torch.parallel import (
                init_distributed,
            )
            return str(init_distributed('cpu')), dist.get_world_size()
        if kind == 'sharded_topk':
            return sharded_topk_call(self.mesh(call['mesh']), **call['args'])
        if kind == 'device_tables':
            store = self.store(call['store'])
            out = store.device_tables(device='cpu',
                                      mesh=self.mesh(call['mesh']),
                                      shard_items=call['shard_items'])
            return {k: v.numpy() for k, v in out.items()}
        if kind == 'recommender':
            rec, mesh = self.recommender(call)
            return getattr(rec, call['method'])(*call.get('args', ()),
                                                **call.get('kwargs', {}))
        scorer, mesh = self.scorer(call)
        before = dict(mesh.traffic) if mesh is not None else {}
        if call['method'] == 'auto_cascade_routed':
            plan = scorer.auto_cascade(*call['args'], **call['kwargs'])
            routed = scorer.top_k(*call['routed_args'])
            scorer.disable_cascade()
            return plan, routed
        out = getattr(scorer, call['method'])(*call.get('args', ()),
                                              **call.get('kwargs', {}))
        if call.get('traffic'):
            return out, {k: v - before.get(k, 0)
                         for k, v in mesh.traffic.items()}
        return out


def fresh_model(ctx, call):
    """A new port model of the job's ``call['model']`` spec on the CPU
    (``kw`` updated by ``call['kw']``), its Flax variables loaded; cut to
    this rank's shards when ``call['tp']``. Returns (model, mesh)."""
    from pixelrec_multimodal_tpu_torch.models.multimodal import (
        MultimodalRecommender,
    )
    from pixelrec_multimodal_tpu_torch.parallel.tensor_parallel import (
        shard_module,
    )
    from pixelrec_multimodal_tpu_torch.utils.flax_convert import (
        load_flax_variables,
    )
    spec = ctx.job['models'][call['model']]
    model = MultimodalRecommender(**dict(spec['kw'], **call.get('kw', {})),
                                  device='cpu')
    load_flax_variables(model, spec['variables'])
    mesh = ctx.mesh(call['mesh'])
    if call.get('tp'):
        shard_module(model, mesh)
    return model, mesh


def local_tables(ctx, call, mesh):
    """The job's tables, whole or (``call['tables_sharded']``) this rank's
    rows of the item axis over 'model'."""
    import torch
    from pixelrec_multimodal_tpu_torch.parallel import item_table_sharding
    out = {}
    for k, v in ctx.job['tables'][call['tables']].items():
        if call.get('tables_sharded'):
            v = v[item_table_sharding(mesh, len(v))]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def local_batch(batch, mesh):
    import torch
    from pixelrec_multimodal_tpu_torch.parallel import shard_batch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch(batch, mesh).items()}


def whole_state(state, mesh):
    """The train state with its shards gathered by name, as numpy."""
    from pixelrec_multimodal_tpu_torch.training.trainer import (
        train_state_tensors,
    )
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        gather_state,
    )
    st = gather_state(train_state_tensors(state), mesh,
                      getattr(state.model, 'tp_shardings', {}))
    return {'params': {k: v.detach().numpy().copy()
                       for k, v in st['params'].items()},
            'batch_stats': {k: v.numpy().copy()
                            for k, v in st['batch_stats'].items()},
            'opt_state': {k: (v if k == 'names' else v.numpy().copy())
                          for k, v in st['opt_state'].items()}}


def train_steps_call(ctx, call):
    """``call['batches']`` (global, [steps, B]) through the port's meshed
    train step; the metrics of each step, the whole trained state and the
    traffic. With ``call['checkpoint']`` the state is then written there
    on the mesh."""
    import torch
    from pixelrec_multimodal_tpu_torch.training.optimizers import (
        build_optimizer,
    )
    from pixelrec_multimodal_tpu_torch.training.steps import (
        init_train_state,
        make_step_fns,
    )
    from pixelrec_multimodal_tpu_torch.training.trainer import (
        train_state_tensors,
    )
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        save_checkpoint,
    )
    model, mesh = fresh_model(ctx, call)
    state = init_train_state(model, build_optimizer(**call['optimizer']))
    step, _ = make_step_fns(model, local_tables(ctx, call, mesh), mesh=mesh)
    gen = torch.Generator().manual_seed(call.get('seed', 0))
    bs = call['batches']
    before = dict(mesh.traffic)
    metrics = []
    for i in range(len(bs['item_idx'])):
        state, m = step(state, local_batch({k: v[i] for k, v in bs.items()},
                                           mesh), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    traffic = {k: v - before.get(k, 0) for k, v in mesh.traffic.items()}
    if call.get('checkpoint'):
        save_checkpoint(call['checkpoint'], 'best_model',
                        train_state_tensors(state), {'epoch': 1}, mesh=mesh,
                        shardings=model.tp_shardings)
    return {'metrics': metrics, 'state': whole_state(state, mesh),
            'traffic': traffic, 'step': int(state.step),
            'shapes': {k: tuple(p.shape)
                       for k, p in model.named_parameters()}}


def load_checkpoint_call(ctx, call):
    """A single-process checkpoint loaded onto the mesh with the tensor-
    parallel model's shardings: this rank's parameters and optimizer
    fields, as numpy."""
    from pixelrec_multimodal_tpu_torch.utils.checkpointing import (
        load_checkpoint,
    )
    model, mesh = fresh_model(ctx, call)
    st = load_checkpoint(call['checkpoint'], 'best_model', mesh=mesh,
                         shardings=model.tp_shardings)['state']
    return {'params': {k: v.numpy() for k, v in st['params'].items()},
            'opt_state': {k: (v if k == 'names' else v.numpy())
                          for k, v in st['opt_state'].items()},
            'coords': mesh.coords}


def gather_call(ctx, call):
    """The feature kwargs of a batch gathered from the tables split over
    'model' and from the whole tables, both under the mesh (the gather
    tells them apart by their row count)."""
    import torch
    from pixelrec_multimodal_tpu_torch.training.steps import (
        gather_feature_kwargs,
    )
    model, mesh = fresh_model(ctx, call)
    batch = {'item_idx': torch.from_numpy(call['item_idx'])}
    sharded = gather_feature_kwargs(model, local_tables(
        ctx, dict(call, tables_sharded=True), mesh), batch, mesh)
    whole = gather_feature_kwargs(model, local_tables(ctx, call, mesh), batch,
                                  mesh)
    return ({k: v.numpy() for k, v in sharded.items()},
            {k: v.numpy() for k, v in whole.items()})


def e2e_steps_call(ctx, call):
    """The meshed unfrozen step (``e2e`` spec of the job: a tiny CLIP
    vision tower, a text tower and a CLIP text tower under remat, a
    contrastive scorer with dropout, augmentation on) for each global
    batch of ``call['batches']``; the metrics and the whole state."""
    import torch
    from pixelrec_multimodal_tpu_torch.parallel.tensor_parallel import (
        shard_module,
    )
    from pixelrec_multimodal_tpu_torch.training.e2e_steps import (
        init_e2e_train_state,
        make_e2e_step_fns,
    )
    from pixelrec_multimodal_tpu_torch.training.optimizers import (
        build_optimizer,
    )
    from pixelrec_multimodal_tpu_torch.config import ImageAugmentationConfig
    from pixelrec_multimodal_tpu_torch.parallel.dryrun import e2e_model
    model = e2e_model(call['n_items'], 'cpu')
    mesh = ctx.mesh(call['mesh'])
    if call.get('tp'):
        shard_module(model, mesh)
    state = init_e2e_train_state(model, build_optimizer(**call['optimizer']))
    num = torch.from_numpy(ctx.job['e2e_numerical'])
    step, _ = make_e2e_step_fns(model, {'numerical': num}, mesh=mesh,
                                augmentation_config=ImageAugmentationConfig(
                                    **call['augmentation']))
    gen = torch.Generator().manual_seed(call.get('seed', 0))
    bs = call['batches']
    metrics = []
    for i in range(len(bs['item_idx'])):
        state, m = step(state, local_batch({k: v[i] for k, v in bs.items()},
                                           mesh), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    return {'metrics': metrics, 'state': whole_state(state, mesh)}


def trainer_call(ctx, call):
    """The port's ``Trainer`` on the mesh over the job's datasets; the
    loss history, the LR after each epoch, the trained state dict and
    the checkpoint directory's files."""
    from pixelrec_multimodal_tpu_torch.training import Trainer
    model, mesh = fresh_model(ctx, call)
    train, val = ctx.job['datasets'][call['datasets']]
    trainer = Trainer(model, config=ctx.job['configs'][call['config']],
                      checkpoint_dir=call['checkpoint_dir'], mesh=mesh,
                      compiled_epochs=call.get('compiled', True))
    lrs = []
    trainer._print_epoch_summary = lambda *a: lrs.append(
        trainer.get_learning_rate())
    losses = trainer.train(train, val, **call['train'])
    return {'losses': losses, 'lrs': lrs,
            'history': trainer.training_history,
            'state': {k: v.numpy().copy()
                      for k, v in model.state_dict().items()}}


TRAIN_CALLS = {'train_steps': train_steps_call,
               'load_checkpoint': load_checkpoint_call,
               'gather': gather_call, 'e2e_steps': e2e_steps_call,
               'trainer': trainer_call}


def mesh_info(requests):
    """For each request (function name, kwargs): the mesh's shape, grid and
    this rank's coordinates, None, or the ValueError's message."""
    from pixelrec_multimodal_tpu_torch.parallel import (
        make_mesh,
        mesh_from_flags,
    )
    fns = {'make_mesh': make_mesh, 'mesh_from_flags': mesh_from_flags}
    out = []
    for name, kw in requests:
        try:
            m = fns[name](**kw)
        except ValueError as e:
            out.append(('error', str(e)))
            continue
        out.append(None if m is None else (
            'mesh', m.shape, m.devices.tolist(), m.coords,
            {a: m.groups[a] is not None for a in m.axis_names}))
    return out


def sharded_topk_call(mesh, scores, k):
    """``ops/topk.py:sharded_topk`` on this rank's columns of ``scores``."""
    import torch
    from pixelrec_multimodal_tpu_torch.ops.topk import sharded_topk
    from pixelrec_multimodal_tpu_torch.parallel import (
        MODEL_AXIS,
        item_table_sharding,
    )
    cols = item_table_sharding(mesh, scores.shape[1])
    v, i = sharded_topk(torch.from_numpy(np.ascontiguousarray(
        scores[:, cols])), k, mesh, MODEL_AXIS)
    return v.numpy(), i.numpy()


def rank_main(job_dir: Path, rank: int, world: int) -> int:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{job_dir}/store',
                            rank=rank, world_size=world)
    deadline = time.time() + JOB_WAIT_S
    while not (job_dir / 'job.pkl').exists():
        if time.time() > deadline:
            raise TimeoutError('no job was submitted')
        time.sleep(0.05)
    job = pickle.loads((job_dir / 'job.pkl').read_bytes())
    ctx = Context(job)
    out = {}
    with torch.no_grad():
        for call in job['calls']:
            out[call['id']] = ctx.run(call)
    tmp = job_dir / f'out_{rank}.tmp'
    tmp.write_bytes(pickle.dumps(out))
    tmp.rename(job_dir / f'out_{rank}.pkl')
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    try:
        sys.exit(rank_main(Path(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3])))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
