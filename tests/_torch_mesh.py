"""Gloo ranks on the CPU for the port's meshed tests.

A test module starts its ranks once (``Ranks``): ``world`` processes of
``python -m tests._torch_mesh JOB_DIR RANK WORLD``, which import the port
only (never JAX), take one thread each, and join one gloo group through a
file store under the job's directory (no TCP port, so test files can run
side by side). While they start, the test process prepares the job (the
models' Flax variables as numpy trees, the item tables and a list of
calls) and hands it over (``Ranks.submit``); each rank runs every call in
order, on meshes and scorers it builds once, and pickles the results.
Each rank's output and errors go to files in the job's directory.
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
