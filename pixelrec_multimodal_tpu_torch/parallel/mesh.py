# pixelrec_multimodal_tpu_torch/parallel/mesh.py
"""The (data, model) device mesh over ``torch.distributed`` ranks.

Counterpart of ``pixelrec_multimodal_tpu/parallel/mesh.py``: one rank
drives one card, and the ranks lie on a 2D grid, row-major as JAX's
``reshape(data_parallel, model_parallel)`` of its devices:

  * ``data``  - user rows of a scoring call (each data coordinate scores
    its share of a user block), the batches of the encoder forwards and
    the rows of a training batch;
  * ``model`` - the catalog axis: each model coordinate builds and holds
    only its rows of the item tables, and the scorer merges the per-shard
    top-k candidates over this axis; in a tensor-parallel step, the
    vocabulary rows of the embeddings and the output features of the 2-D
    Dense kernels (``param_shardings``, ``parallel/tensor_parallel.py``).

Each axis has one process group per line of the grid (made collectively
on every rank), and the collectives below run over the calling rank's
line, their pieces concatenated in axis order. JAX emits these
collectives from sharding annotations; here they are explicit calls.

A meshed train step computes the function of the global batch, as GSPMD
does, under one convention for its gradients:

  * over 'data' each rank holds its own part of the loss, and the parts
    sum to the global loss; a collective's backward is its adjoint
    (``gather_data``: the gradients summed over 'data', this rank's rows
    kept; ``sum_data``: the gradients summed over 'data'), and the flat
    gradient is summed over 'data' once a step;
  * over 'model' every rank holds the whole loss; ``gather_model``'s
    backward keeps this rank's slice, ``sum_model``'s is the identity,
    and ``copy_to_model`` (the input of a sharded Dense) sums its
    gradient over 'model'.

An axis of size 1 makes every such collective the identity, so a step on
a 1x1 mesh runs the single-process arithmetic.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import io
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (and >= m)."""
    return max(m, ((n + m - 1) // m) * m)


def world_size() -> int:
    """Ranks of the initialized default process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A (data, model) grid of ranks and this rank's place on it.

    ``devices`` is the grid of global ranks ([data, model]), ``shape``
    ``{'data': dp, 'model': mp}``, ``coords`` this rank's (data, model)
    coordinates. ``groups[axis]`` is the process group of this rank's line
    along ``axis`` (None in a process without a process group, where the
    grid is one rank and every collective is the identity); ``axis_ranks``
    holds that line's global ranks in axis order. ``traffic`` counts the
    bytes this rank handed to each kind of collective."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, grid: np.ndarray, rank: int,
                 groups: Dict[str, Optional[object]]):
        self.devices = grid
        self.rank = rank
        where = np.argwhere(grid == rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self.groups = groups
        self.axis_ranks = {}
        if self.coords is not None:
            d, m = self.coords
            self.axis_ranks = {DATA_AXIS: grid[:, m].tolist(),
                               MODEL_AXIS: grid[d, :].tolist()}
        self.traffic: Dict[str, int] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]


def make_mesh(ranks: Optional[Sequence[int]] = None,
              data_parallel: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """Build a 2D (data, model) mesh over ``ranks`` (default: every rank
    of the initialized group, or the one process without a group).

    By default all ranks go on the data axis; ``model_parallel`` splits
    off the catalog axis (the ranks must factor evenly). With a process
    group, every rank of it must call this, in the same order as its other
    group calls: each line of the grid gets its process group here
    (``dist.new_group`` is collective over the default group)."""
    ranks = list(ranks if ranks is not None else range(world_size()))
    n = len(ranks)
    if data_parallel is None:
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by "
                             f"model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"data_parallel({data_parallel}) * "
                         f"model_parallel({model_parallel}) "
                         f"!= device count ({n})")
    grid = np.asarray(ranks, dtype=np.int64).reshape(data_parallel,
                                                    model_parallel)
    me = _rank()
    groups: Dict[str, Optional[object]] = {a: None for a in Mesh.axis_names}
    if dist.is_initialized():
        lines = {DATA_AXIS: [grid[:, m] for m in range(model_parallel)],
                 MODEL_AXIS: [grid[d, :] for d in range(data_parallel)]}
        for axis in Mesh.axis_names:
            for line in lines[axis]:
                group = dist.new_group(ranks=line.tolist())
                if me in line:
                    groups[axis] = group
    return Mesh(grid, me, groups)


def mesh_from_flags(data_parallel: Optional[int] = None,
                    model_parallel: int = 1) -> Optional[Mesh]:
    """Build the entry points' mesh from their flags; None when trivial.

    As the JAX scripts' policy (``--data_parallel``/``--model_parallel``):
    every rank on the data axis unless an explicit factorization is given,
    and None for a 1x1 mesh, so single-device runs keep the unsharded
    paths. Where JAX counts its visible devices, the port counts the
    ranks of the initialized process group (1 without one). A mesh smaller
    than the world raises too: every rank runs the entry point, and a rank
    outside the mesh would have no share of the work."""
    n_ranks = world_size()
    model_parallel = max(int(model_parallel or 1), 1)
    if data_parallel is None:
        data_parallel = max(n_ranks // model_parallel, 1)
    data_parallel = max(int(data_parallel), 1)
    if data_parallel * model_parallel == 1:
        if n_ranks > 1:
            raise ValueError(f"requested a 1x1 mesh but {n_ranks} ranks "
                             "were started: one rank a device")
        return None
    n = data_parallel * model_parallel
    if n > n_ranks:
        raise ValueError(
            f"requested {data_parallel}x{model_parallel} mesh but only "
            f"{n_ranks} device(s) visible")
    if n < n_ranks:
        raise ValueError(
            f"requested {data_parallel}x{model_parallel} mesh but "
            f"{n_ranks} ranks were started: every rank takes a place in the "
            "mesh")
    return make_mesh(data_parallel=data_parallel,
                     model_parallel=model_parallel)


def _axis_slice(mesh: Mesh, axis: str, n_rows: int) -> slice:
    size = mesh.shape[axis]
    if n_rows % size:
        raise ValueError(f'{n_rows} rows do not divide over the {axis!r} '
                         f'axis of size {size}')
    per = n_rows // size
    start = mesh.index(axis) * per
    return slice(start, start + per)


def item_table_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of an item-major table of ``n_rows`` rows: the
    item axis split over 'model'."""
    return _axis_slice(mesh, MODEL_AXIS, n_rows)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a per-example block of ``n_rows`` rows (users,
    a batch): the leading axis split over 'data'."""
    return _axis_slice(mesh, DATA_AXIS, n_rows)


def replicated(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a replicated block: all of them."""
    return slice(0, n_rows)


def score_matrix_sharding(mesh: Mesh, n_users: int,
                          n_items: int) -> tuple:
    """This rank's block of a [users, items] score matrix: the rows over
    'data', the columns over 'model'."""
    return (_axis_slice(mesh, DATA_AXIS, n_users),
            _axis_slice(mesh, MODEL_AXIS, n_items))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batch dict (numpy arrays or tensors), the
    leading axis over 'data'; every length must divide by the data-axis
    size (pads are the caller's)."""
    return {k: v[batch_sharding(mesh, len(v))] for k, v in batch.items()}


def param_shardings(model: torch.nn.Module, mesh: Mesh
                    ) -> Dict[str, Optional[int]]:
    """Tensor-parallel shardings of ``model``'s parameters over 'model':
    state-dict name -> the torch dimension split over 'model', or None
    (replicated).

    JAX's rule on the Flax tree, read through the Flax names and shapes
    of ``utils/flax_convert.flax_leaves`` (a Flax kernel is [in, out], a
    torch Linear weight [out, in]): a 2-D ``embedding`` has its rows
    sharded (torch dim 0), a 2-D ``kernel`` its output features (torch
    dim 0), each only where that dimension divides by the model-axis size
    and, for a kernel, is at least that size. Everything else stays
    replicated: biases, norms, scalars, the fusion attention's 3-D
    DenseGeneral kernels, convolutions' 4-D ones."""
    from ..utils.flax_convert import flax_leaves
    size = mesh.shape[MODEL_AXIS]
    out = {}
    for name, leaf, shape in flax_leaves(model):
        dim = None
        if size > 1 and len(shape) == 2:
            if leaf == 'embedding' and shape[0] % size == 0:
                dim = 0
            elif leaf == 'kernel' and shape[1] % size == 0 \
                    and shape[1] >= size:
                dim = 0
        out[name] = dim
    return out


def param_shard(mesh: Mesh, t: torch.Tensor, dim: Optional[int]
                ) -> torch.Tensor:
    """This rank's shard of a whole parameter ``t`` split on ``dim`` over
    'model' (``t`` itself where ``dim`` is None)."""
    if dim is None:
        return t
    sl = _axis_slice(mesh, MODEL_AXIS, t.shape[dim])
    return t.narrow(dim, sl.start, sl.stop - sl.start)


def _count(mesh: Mesh, op: str, t: torch.Tensor):
    mesh.traffic[op] = mesh.traffic.get(op, 0) + t.numel() * t.element_size()


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along this rank's ``axis`` line, concatenated
    along ``dim`` in axis order (equal shapes on every rank)."""
    group = mesh.groups.get(axis)
    _count(mesh, 'all_gather', t)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    order = dist.get_process_group_ranks(group)
    parts = [parts[order.index(r)] for r in mesh.axis_ranks[axis]]
    return torch.cat(parts, dim=dim)


def all_reduce(mesh: Mesh, axis: str, t: torch.Tensor,
               op: str = 'max') -> torch.Tensor:
    """The elementwise ``op`` ('max' or 'sum') of every rank's ``t`` along
    this rank's ``axis`` line (equal shapes on every rank); ``t`` itself
    holds the result."""
    group = mesh.groups.get(axis)
    _count(mesh, f'all_reduce_{op}', t)
    if group is None:
        return t
    reduce_op = {'max': dist.ReduceOp.MAX, 'sum': dist.ReduceOp.SUM}[op]
    dist.all_reduce(t, op=reduce_op, group=group)
    return t


# ------------------------------------------------ autograd collectives
def _active(mesh: Optional[Mesh], axis: str) -> bool:
    return mesh is not None and mesh.shape[axis] > 1


def data_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where its 'data' axis splits the batch, else None."""
    return mesh if _active(mesh, DATA_AXIS) else None


def _own_slice(mesh: Mesh, axis: str, t: torch.Tensor,
               dim: int) -> torch.Tensor:
    n = t.shape[dim] // mesh.shape[axis]
    return t.narrow(dim, mesh.index(axis) * n, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``; backward: the gradient
    summed over the axis first where ``reduce`` (a loss held in parts),
    then this rank's slice."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, reduce):
        ctx.mesh, ctx.axis, ctx.dim, ctx.reduce = mesh, axis, dim, reduce
        return all_gather(mesh, axis, t, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.reduce:
            g = all_reduce(ctx.mesh, ctx.axis, g.clone(), op='sum')
        return (_own_slice(ctx.mesh, ctx.axis, g, ctx.dim).contiguous(),
                None, None, None, None)


class _Sum(torch.autograd.Function):
    """Sum all-reduce over ``axis``; backward: summed again where
    ``reduce`` (a loss held in parts), else the identity (a whole loss on
    every rank)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, reduce):
        ctx.mesh, ctx.axis, ctx.reduce = mesh, axis, reduce
        return all_reduce(mesh, axis, t.detach().clone().contiguous(),
                          op='sum')

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = all_reduce(ctx.mesh, ctx.axis, g.detach().clone()
                           .contiguous(), op='sum')
        return g, None, None, None


class _CopyToModel(torch.autograd.Function):
    """The identity; backward: the gradient summed over 'model'."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, MODEL_AXIS, g.detach().clone()
                          .contiguous(), op='sum'), None


def gather_data(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``t`` concatenated (the global batch's),
    differentiable under the 'data' convention (module docstring)."""
    if not _active(mesh, DATA_AXIS):
        return t
    return _Gather.apply(t, mesh, DATA_AXIS, 0, True)


def sum_data(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over 'data', differentiable (the gradients summed
    over 'data' too)."""
    if not _active(mesh, DATA_AXIS):
        return t
    return _Sum.apply(t, mesh, DATA_AXIS, True)


def gather_model(mesh: Optional[Mesh], t: torch.Tensor,
                 dim: int = -1) -> torch.Tensor:
    """Every model rank's slice of ``t`` concatenated along ``dim``; the
    backward keeps this rank's slice of the gradient."""
    if not _active(mesh, MODEL_AXIS):
        return t
    return _Gather.apply(t, mesh, MODEL_AXIS, dim % t.dim(), False)


def sum_model(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over 'model'; the backward is the identity."""
    if not _active(mesh, MODEL_AXIS):
        return t
    return _Sum.apply(t, mesh, MODEL_AXIS, False)


def copy_to_model(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` itself; its gradient summed over 'model' (the input of a
    Dense whose output features are sharded)."""
    if not _active(mesh, MODEL_AXIS):
        return t
    return _CopyToModel.apply(t, mesh)


def owned_rows(mesh: Mesh, table: torch.Tensor, ids: torch.Tensor,
               start: int, differentiable: bool = False) -> torch.Tensor:
    """Rows ``ids`` (global positions, any shape) of a table split over
    'model', of which this rank holds rows ``start`` .. ``start +
    len(table)``: the owner gives each row and the others zeros, summed
    over 'model' (exact: x + 0 = x). ``differentiable``: through
    ``sum_model``, so the gradient reaches the owned rows; else one sum
    all-reduce in place."""
    n = table.shape[0]
    local = ids.long() - start
    own = (local >= 0) & (local < n)
    rows = torch.nn.functional.embedding(
        local.clamp(0, n - 1), table.reshape(n, -1)).view(
            *ids.shape, *table.shape[1:])
    rows = rows.masked_fill(
        ~own.view(*own.shape, *(1,) * (table.dim() - 1)), 0)
    if differentiable:
        return sum_model(mesh, rows)
    return all_reduce(mesh, MODEL_AXIS, rows, op='sum')


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This rank's rows ``rows`` of a global batch of ``total`` rows
    split over the mesh's 'data' axis."""
    mesh: Mesh
    rows: slice
    total: int


_DATA_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    'pixelrec_data_shard', default=None)


def data_shard() -> Optional[DataShard]:
    """The data shard of the step running (``data_parallel``), or None."""
    return _DATA_SHARD.get()


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh], local_rows: int):
    """Run a forward on this rank's ``local_rows`` rows of a global batch
    split over 'data': BatchNorm's training statistics sum over 'data'
    and dropout draws its masks for the global batch and keeps this
    rank's rows. Without a mesh, or on a data axis of size 1, nothing
    changes."""
    if not _active(mesh, DATA_AXIS):
        yield None
        return
    start = mesh.index(DATA_AXIS) * local_rows
    token = _DATA_SHARD.set(DataShard(mesh, slice(start, start + local_rows),
                                      local_rows * mesh.shape[DATA_AXIS]))
    try:
        yield _DATA_SHARD.get()
    finally:
        _DATA_SHARD.reset(token)


def _world_group(mesh: Mesh):
    """The group of every rank of the mesh (the default group where the
    mesh spans the world), None without a process group."""
    if not dist.is_initialized():
        return None
    if mesh.size == dist.get_world_size():
        return dist.group.WORLD
    raise ValueError('a mesh over part of the world has no group over all '
                     'of its ranks')


def agree_max(mesh: Mesh, value: float, device: torch.device) -> float:
    """The largest of every mesh rank's ``value``: a decision that ranks
    must take alike (a measured time) is taken on this one number."""
    group = _world_group(mesh)
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank of the mesh (nothing without a process group)."""
    if mesh is not None and _world_group(mesh) is not None:
        dist.barrier()


def is_main_rank() -> bool:
    """True on rank 0 of the process group, and without one."""
    return _rank() == 0


def main_rank_stdout():
    """A context in which only rank 0 (or the one process) prints to
    stdout; the other ranks' prints are dropped."""
    return (contextlib.nullcontext() if is_main_rank()
            else contextlib.redirect_stdout(io.StringIO()))


def init_distributed(device: Union[str, torch.device] = 'cuda'
                     ) -> torch.device:
    """The device this rank runs on, with its process group started.

    A process group the caller has already initialized is used as it is,
    with the CUDA device the caller has set. Under ``torchrun``
    (``WORLD_SIZE`` above 1, no group yet) the group starts from
    ``env://``: NCCL for ``cuda``, gloo for ``cpu``; rank r then runs on
    ``cuda:LOCAL_RANK``, and a local rank past the visible cards raises:
    ranks never share a card here. Without either, one process runs on
    ``device``. ``'cuda'`` without a card raises, whatever the world."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dev
    if int(os.environ.get('WORLD_SIZE', '1')) <= 1:
        return dev
    if dev.type == 'cuda':
        local = int(os.environ.get('LOCAL_RANK', '0'))
        count = torch.cuda.device_count()
        if local >= count:
            raise RuntimeError(
                f'local rank {local} has no card of its own: '
                f'{count} CUDA device(s) visible; start at most {count} '
                'ranks a machine (one card a rank)')
        dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
    dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                            init_method='env://')
    return dev
