"""Data and tensor parallelism and ZeRO-1 over ``torch.distributed`` — port
of ``hvt/parallel.py``'s ``data`` and ``model`` axes and its ``zero`` flag.

hvt shards the global batch over its mesh's ``data`` axis under GSPMD (the
batch rank-major over the processes, ``make_array_from_process_local_data``),
runs every Pallas kernel per data shard inside ``shard_map`` and lets XLA
sum the parameter cotangents; its BatchNorm reductions psum their
per-channel sums over the axis (global-batch statistics). The port runs one
process per card, started by ``torchrun``, in one process group: NCCL on
the card, gloo on the CPU. Each rank holds its share of every microbatch of
hvt's global batch (:func:`microbatch_rows`); the step sums the ranks'
gradients after the last microbatch; the BatchNorm reductions all-reduce
their sums; random draws are made over the global microbatch from one
generator that stays equal on every rank, and each rank keeps its rows
(:func:`rand_rows`); MixUp's and CutMix's roll of the batch by one crosses
the rank boundary through one exchange (:func:`roll_rows`).

The grid (hvt's ``make_mesh`` lays devices out as ``reshape(data, spatial,
model, pipe)``, ``model`` the faster axis): rank r of a world W with
``mesh.model`` m has data index r // m and model index r % m, data = W / m.
The data group holds the ranks of one model index, the model group the m
adjacent ranks of one data index (one node under torchrun). Everything
above sums over the data group; model peers load the same rows, draw the
same numbers and run the same step.

Tensor parallelism is hvt's ``TP_RULES`` (``hvt/parallel.py:310-328``), the
Megatron split of the transformer MLP, in torch's layout (:data:`TP_RULES`):
``mlp.fc1.weight`` (hidden, C) and ``mlp.fc1.bias`` shard dim 0 over the
model group, ``mlp.fc2.weight`` (C, hidden) dim 1; expert parallelism, the
MoE layers' ``moe.w1``, ``b1``, ``w2`` and ``b2`` (E, ...) dim 0, so that
each rank holds E / model experts (:mod:`hvt_torch.ops.moe` runs them); every
other parameter, the MoE router included, is replicated. :func:`shard_model_`
cuts a built model's matching parameters to the rank's shard; the MLP then
runs its hidden slice and one all-reduce
(:func:`copy_to_model`, :func:`reduce_from_model`), or, where a fused MLP
kernel runs, gathers the full weights for it (:func:`gather_from_model`),
as hvt's kernels re-gather them. Optimizer moments and the EMA copy mirror
their parameter's shard. ZeRO-1 (``mesh.zero``, hvt's ``tp_shardings(...,
zero=True)`` and ``zero_update_shardings``) is in
:class:`hvt_torch.train.optim.Optimizer`, with the layout of
:func:`zero_split`.

The Trainer declares the grid with :func:`set_data_group` before any step
runs, as hvt's declares ``set_kernel_mesh``: model code asks
:func:`data_group` and :func:`model_size` and stays grid-agnostic. Without
a declared group every helper here is the one-process identity, and routes
that read the group take it by its declaration, not its size: a world of one
through NCCL runs the data-parallel route, bit-equal to the one-process one.
Every collective is synchronous (``async_op=False``) on the caller's current
stream order. The collective helpers choose by the group's backend: NCCL
takes CUDA tensors; gloo takes them in ``all_reduce`` and ``broadcast``, and
its ``all_gather`` of a CUDA tensor goes through host copies (two ranks on
one card share no NCCL communicator). Each call is counted in
:data:`COUNTS`.

Of hvt's mesh ``spatial`` and ``pipe`` above 1 still raise
(:func:`check_mesh`), naming ROADMAP.md queue 1, item 11, which also lists
communication overlap as later speed work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ITEM_11 = "ROADMAP.md queue 1, item 11"
BUCKET_BYTES = 64 << 20  # gradient all-reduce bucket: at most this much flat copy at once
# collectives issued, by kind; "model_all_reduce" counts the all-reduces
# over the model group again, apart from the data group's
COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "model_all_reduce": 0}


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process: its
    environment names a world."""
    return "WORLD_SIZE" in os.environ


def launch_device(device):
    """The device a launched rank runs on: ``cuda:LOCAL_RANK`` for a default
    or CUDA device (which becomes the current device), else ``device``. A
    process no launcher started keeps ``device`` as given (one that joined
    a group of its own making names its card itself)."""
    if not launched() or (device is not None and torch.device(device).type != "cuda"):
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: hvt_torch runs on the GPU by default; pass "
                           "--device cpu to run the ranks on the CPU over gloo")
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def init_process_group(device) -> None:
    """Join the launcher's process group from its environment (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; it raises
    on one missing): NCCL for ranks on the card, gloo on the CPU. No-op
    when this process already belongs to one."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if torch.device(device).type == "cuda" else "gloo")


def process_world() -> tuple[int, int]:
    """(rank, world) of the initialized default group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def one_process_entry(config, what: str) -> None:
    """The guard of an entry point that has no data-parallel form yet (the
    downstream ones: hvt spreads them over the devices of one process,
    ``divisor_mesh``, which the port does not have): it refuses a world
    above 1, from a group or a launcher's environment (it does not run rank
    0 alone), and a ``mesh`` off what one process runs (``model`` or
    ``zero`` included: they need a world)."""
    world = max(process_world()[1], int(os.environ.get("WORLD_SIZE", 1)))
    if world > 1:
        raise NotImplementedError(
            f"{what} runs in one process: spreading it over the devices of a world of "
            f"{world} is {ITEM_11}")
    mesh = getattr(config, "mesh", None)
    if mesh is not None and (int(getattr(mesh, "model", 1)) > 1
                             or bool(getattr(mesh, "zero", False))):
        raise NotImplementedError(
            f"{what} runs in one process: mesh model={getattr(mesh, 'model', 1)}, "
            f"zero={getattr(mesh, 'zero', False)} over a world is {ITEM_11}")
    check_mesh(mesh, 1)


# ---------------------------------------------------------------------------
# hvt's mesh config
# ---------------------------------------------------------------------------


def check_mesh(mesh_cfg, world: int) -> int:
    """``config.mesh`` against the world, as hvt's ``make_mesh`` reads it:
    ``model`` must divide the world, ``data: -1`` means world / model, any
    other ``data`` must equal it; ``zero`` is free (it acts where data > 1).
    ``spatial`` or ``pipe`` above 1 raise ``NotImplementedError``. Returns
    the data size."""
    if mesh_cfg is None:
        return world
    off = [f"{k}={getattr(mesh_cfg, k)}" for k in ("spatial", "pipe")
           if int(getattr(mesh_cfg, k, 1)) > 1]
    if off:
        raise NotImplementedError(
            f"mesh {', '.join(off)}: the port has data and tensor parallelism and ZeRO-1; "
            f"spatial and pipeline parallelism are {ITEM_11}")
    model = int(getattr(mesh_cfg, "model", 1))
    if model < 1 or world % model:
        raise ValueError(f"mesh model={model} does not divide the world of {world} processes "
                         f"(one card each; {ITEM_11})")
    data = int(getattr(mesh_cfg, "data", -1))
    if data == -1:
        return world // model
    if data * model != world:
        raise ValueError(
            f"mesh data={data} x model={model} does not match the world of {world} processes "
            f"(one card each; data: -1 takes world / model; {ITEM_11})")
    return data


# ---------------------------------------------------------------------------
# The declared grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Declared:
    group: object  # the data axis's ProcessGroup
    rank: int  # data index
    world: int  # data size
    device: torch.device  # where the group's collectives take their tensors
    host: object  # a gloo group over every rank of the grid, for host values
    root: int  # global rank of data index 0 in this rank's data group
    model_group: object  # the model axis's ProcessGroup (None at model 1)
    model_rank: int
    model: int


_DATA: Optional[_Declared] = None
_LOCAL = False  # inside no_data_group()
_HOST_GROUPS: dict = {}  # group → its gloo twin (made once: new_group is collective)
_GRIDS: dict = {}  # (group, model) → (data groups, model groups), made once


def _grid_groups(group, ranks: list, model: int) -> tuple[list, list]:
    """Every data group and every model group of ``group``'s ranks at
    ``model``, made on every rank in one order (``new_group`` is collective)."""
    key = (group, model)
    if key not in _GRIDS:
        backend = dist.get_backend(group)
        data = len(ranks) // model
        models = [dist.new_group([ranks[d * model + j] for j in range(model)], backend=backend)
                  for d in range(data)]
        datas = [dist.new_group([ranks[d * model + j] for d in range(data)], backend=backend)
                 for j in range(model)]
        _GRIDS[key] = (datas, models)
    return _GRIDS[key]


def set_data_group(group=None, device=None, model: int = 1) -> None:
    """Declare the process group the run spans (``group=None`` clears it), as
    a grid of data × ``model`` ranks (see the module's docstring; at model 1
    the data group is ``group`` itself). ``dist.group.WORLD`` is the usual
    group; ``device`` is where its collectives take tensors (the card for
    NCCL). Host values (flags, counts, the wandb descriptor) travel over a
    gloo group of all its ranks, so reading them never waits for the card;
    every rank must make the first declaration of a grid together."""
    global _DATA
    if group is None:
        _DATA = None
        return
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    ranks = dist.get_process_group_ranks(group)
    if model < 1 or len(ranks) % model:
        raise ValueError(f"model={model} does not divide the group's {len(ranks)} ranks")
    host = group
    if backend != "gloo":
        host = _HOST_GROUPS.get(group)
        if host is None:
            host = _HOST_GROUPS[group] = dist.new_group(ranks=ranks, backend="gloo")
    me = ranks.index(dist.get_rank())
    data_group, model_group = group, None
    if model > 1:
        datas, models = _grid_groups(group, ranks, model)
        data_group, model_group = datas[me % model], models[me // model]
    _DATA = _Declared(data_group, me // model, len(ranks) // model, torch.device(device), host,
                      ranks[me % model], model_group, me % model, model)


def destroy() -> None:
    """Clear the declaration and leave the default process group."""
    set_data_group(None)
    _HOST_GROUPS.clear()
    _GRIDS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _active() -> Optional[_Declared]:
    return None if _LOCAL else _DATA


def data_group():
    """The declared data group, or None (also inside :func:`no_data_group`)."""
    d = _active()
    return None if d is None else d.group


def rank() -> int:
    """This process's data index (0 without a group)."""
    d = _active()
    return 0 if d is None else d.rank


def world() -> int:
    """The data size (1 without a group)."""
    d = _active()
    return 1 if d is None else d.world


def model_size() -> int:
    """The model axis's size: 1 without a grid; inside :func:`no_data_group`
    still the grid's, since the parameters stay sharded there."""
    return 1 if _DATA is None else _DATA.model


def model_rank() -> int:
    """This process's model index (0 without a grid)."""
    return 0 if _DATA is None else _DATA.model_rank


def model_group():
    """The declared model group, or None (model 1, no grid, or inside
    :func:`no_data_group`)."""
    d = _active()
    return None if d is None else d.model_group


@contextlib.contextmanager
def no_data_group():
    """Run a block as one process, with no collective (the memory probe of
    ``grad_accum: auto``, which must not enter a collective that another
    rank may skip): the data axis reads as one rank, the model group's
    sums are identities and :func:`gather_from_model` repeats the rank's
    own shard, so the block keeps the grid's shapes and memory."""
    global _LOCAL
    saved, _LOCAL = _LOCAL, True
    try:
        yield
    finally:
        _LOCAL = saved


# ---------------------------------------------------------------------------
# Collectives (identities without a declared group)
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(size of ``group``, *t.shape): every rank's ``t`` by its index in the
    group. NCCL gathers into one tensor on the card; gloo gathers host
    tensors, so a CUDA ``t`` goes through host copies there and back."""
    COUNTS["all_gather"] += 1
    n = dist.get_world_size(group)
    t = t.contiguous()
    if dist.get_backend(group) != "gloo":
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    src = t.cpu() if t.is_cuda else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def all_reduce_(t: torch.Tensor, op=None) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over the data group, in place; returns it."""
    d = _active()
    if d is not None:
        _all_reduce(t, d.group, op)
    return t


def model_all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the model group, in place; returns it."""
    group = model_group()
    if group is not None:
        COUNTS["model_all_reduce"] += 1
        _all_reduce(t, group)
    return t


def all_reduce_tensors_(tensors: Sequence[torch.Tensor]) -> int:
    """Sum each tensor over the data group in place, through flat buckets of
    up to ``BUCKET_BYTES`` of one dtype and device, one all-reduce a
    bucket, one at a time. Returns the number of all-reduces made."""
    if _active() is None or not tensors:
        return 0
    calls = 0
    for bucket in _buckets(tensors):
        if len(bucket) == 1:
            all_reduce_(bucket[0])
        else:
            flat = all_reduce_(torch.cat([t.reshape(-1) for t in bucket]))
            offset = 0
            for t in bucket:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n
        calls += 1
    return calls


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of ``tensors`` of one dtype and device, each of at most
    ``BUCKET_BYTES`` (or one larger tensor)."""
    bucket: list[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_gather_slices_(slices: Sequence[tuple[torch.Tensor, torch.Tensor, int]]) -> int:
    """ZeRO-1's parameter gather: for each (full, mine, dim), ``full``
    becomes the data group's slices along ``dim`` in data order, ``mine``
    being this rank's; one all-gather of a flat bucket of slices at a time.
    Returns the number of all-gathers made."""
    d = _active()
    if d is None or not slices:
        return 0
    calls = 0
    by_mine = {id(m): (f, m, dim) for f, m, dim in slices}
    for bucket in _buckets([m for _, m, _ in slices]):
        every = all_gather(torch.cat([m.reshape(-1) for m in bucket]), d.group)
        offset = 0
        for m in bucket:
            full, _, dim = by_mine[id(m)]
            n = m.numel()
            pieces = every[:, offset:offset + n].reshape(d.world, *m.shape)
            full.copy_(pieces.movedim(0, dim).reshape(full.shape))
            offset += n
        calls += 1
    return calls


class _AllReduceSum(torch.autograd.Function):
    """y = Σ_ranks x; its cotangent is again the sum over the ranks of each
    rank's cotangent of y (every rank's y feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The data group's sum of ``x``, differentiable (a new tensor; ``x``
    itself without a group)."""
    if _active() is None:
        return x
    return _AllReduceSum.apply(x)


def host_max(values: Sequence[int]) -> list[int]:
    """The largest of each host integer over every rank of the grid (the
    host group: no wait for the card)."""
    d = _active()
    if d is None:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=d.host)
    return t.tolist()


def check_same(values: Sequence[int], what: str) -> None:
    """Raise unless every rank holds the same host integers."""
    if _active() is None:
        return
    hi = host_max(values)
    lo = [-v for v in host_max([-int(v) for v in values])]
    if hi != lo:
        raise RuntimeError(f"the ranks disagree on {what}: from {lo} to {hi}")


def barrier() -> None:
    """Every rank of the grid reaches this point (the host group)."""
    d = _active()
    if d is not None:
        dist.barrier(group=d.host)


def broadcast_small_json(obj, max_bytes: int = 65536):
    """Rank 0's JSON-able ``obj`` on every rank (hvt's
    ``broadcast_small_json``, parallel.py:468: the wandb run's descriptor);
    the object itself without a group."""
    d = _active()
    if d is None:
        return obj
    buf = torch.zeros(max_bytes + 8, dtype=torch.uint8)
    if dist.get_rank() == 0:
        payload = json.dumps(obj).encode()
        if len(payload) > max_bytes:
            raise ValueError(f"object too large to broadcast ({len(payload)} bytes)")
        buf[:8] = torch.from_numpy(np.frombuffer(np.int64(len(payload)).tobytes(), np.uint8).copy())
        buf[8:8 + len(payload)] = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    dist.broadcast(buf, src=0, group=d.host)
    out = buf.numpy()
    n = int(np.frombuffer(out[:8].tobytes(), np.int64)[0])
    return json.loads(out[8:8 + n].tobytes().decode())


def broadcast_tensors_(tensors: Sequence[torch.Tensor]) -> None:
    """Data index 0's values of ``tensors`` on every rank of its data group,
    in place (model peers hold different shards: each data group takes its
    own root's)."""
    d = _active()
    if d is None:
        return
    for t in tensors:
        COUNTS["broadcast"] += 1
        dist.broadcast(t.data, src=d.root, group=d.group)


# ---------------------------------------------------------------------------
# Tensor parallelism: the rules, the shards and the model group's Functions
# ---------------------------------------------------------------------------

# hvt's TP_RULES for the transformer MLP (hvt/parallel.py:324-327) in torch's
# layout: (name pattern, the dim split over the model group). flax's
# fc1/kernel P(None, model) is (in, out) split on out: nn.Linear's (out, in)
# weight on dim 0; fc2/kernel P(model, None) is split on in: dim 1 here.
TP_RULES: tuple[tuple[str, int], ...] = (
    (r"mlp\.fc1\.weight$", 0),
    (r"mlp\.fc1\.bias$", 0),
    (r"mlp\.fc2\.weight$", 1),
    # expert parallelism (hvt/parallel.py:320-324): the stacked experts' dim;
    # the router stays replicated
    (r"(^|\.)moe\.(w1|w2|b1|b2)$", 0),
)


def tp_rule(name: str) -> Optional[int]:
    """The dim hvt's rules split parameter ``name`` on, or None (replicated)."""
    for pattern, dim in TP_RULES:
        if re.search(pattern, name):
            return dim
    return None


def tp_dim(name: str) -> Optional[int]:
    """The dim parameter ``name`` is sharded on under the declared grid, or
    None (model 1, or no rule)."""
    return tp_rule(name) if model_size() > 1 else None


def zero_split(name: str, shape: Sequence[int], data: int) -> Optional[int]:
    """The dim of a parameter's optimizer state that ZeRO-1 splits over
    ``data`` ranks (hvt's ``tp_shardings(..., zero=True)``): None for a
    leaf the TP rules match (at any model size: hvt's rule spec wins over
    zero) or with no dim that ``data`` divides, else the first that it
    does."""
    if data <= 1 or tp_rule(name) is not None:
        return None
    for d, n in enumerate(shape):
        if n >= data and n % data == 0:
            return d
    return None


def shard(t, dim: int, index: int, parts: int):
    """Slice ``index`` of ``parts`` along ``dim`` of a tensor or array."""
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {parts}")
    k = n // parts
    if isinstance(t, torch.Tensor):
        return t.narrow(dim, index * k, k)
    return np.take(t, np.arange(index * k, (index + 1) * k), axis=dim)


def local_shards(named: Mapping[str, torch.Tensor]) -> dict:
    """Full tensors by parameter name → this rank's shards under the grid."""
    out = {}
    for name, t in named.items():
        dim = tp_dim(name)
        out[name] = t if dim is None else shard(t, dim, model_rank(), model_size())
    return out


def full_tensors(named: Mapping[str, torch.Tensor]) -> dict:
    """This rank's shards by parameter name → full tensors, gathered over the
    model group (every rank of the grid must call it, in one order)."""
    out = {}
    for name, t in named.items():
        dim = tp_dim(name)
        out[name] = t if dim is None else gather_full(t.detach(), dim)
    return out


def gather_full(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's shards of ``t`` along ``dim``, concatenated."""
    group = model_group()
    if group is None:
        if model_size() > 1:  # inside no_data_group: the shapes, not the values
            return torch.cat([t] * model_size(), dim)
        return t
    every = all_gather(t, group)
    return every.movedim(0, dim).reshape(*t.shape[:dim], -1, *t.shape[dim + 1:])


def shard_model_(model: torch.nn.Module) -> int:
    """Cut ``model``'s parameters that the TP rules match to this rank's
    shard (new Parameters, each marked with its dim), and mark each layer
    that owns them ``tp``: its forward then runs the model group's form.
    The layer is the MLP above ``fc1``/``fc2``, or an MoE layer, which owns
    its expert weights itself. Every rank must hold the same full weights
    before (one seed). Returns the number of parameters cut; 0 at model 1."""
    m = model_size()
    if m == 1:
        return 0
    modules = dict(model.named_modules())
    cut = 0
    for name, p in list(model.named_parameters()):
        dim = tp_rule(name)
        if dim is None:
            continue
        owner, _, attr = name.rpartition(".")
        mlp = modules[owner]
        if not hasattr(mlp, "tp"):
            mlp = modules[owner.rpartition(".")[0]]
        if not hasattr(mlp, "tp"):
            raise NotImplementedError(
                f"{name} matches the TP rules but {type(mlp).__name__} has no tensor-parallel "
                "forward")
        piece = torch.nn.Parameter(shard(p.detach(), dim, model_rank(), m).clone(),
                                   requires_grad=p.requires_grad)
        piece.tp_dim = dim
        setattr(modules[owner], attr, piece)
        mlp.tp = True
        cut += 1
    return cut


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity, whose cotangent
    is the model group's sum (each rank's hidden slice sends back its
    part)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return model_all_reduce_(g.clone())


class _ReduceFromModel(torch.autograd.Function):
    """The output of a row-parallel layer: the model group's sum of the
    partial products; its cotangent passes to every rank as it is."""

    @staticmethod
    def forward(ctx, x):
        return model_all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherFromModel(torch.autograd.Function):
    """A sharded weight fed whole to a fused kernel: the model group's
    shards concatenated along ``dim``; the cotangent of the full weight is
    the same on every model peer (they run the same rows), so each keeps
    its slice, no sum."""

    @staticmethod
    def forward(ctx, w, dim):
        ctx.dim = dim
        return gather_full(w, dim)

    @staticmethod
    def backward(ctx, g):
        return shard(g, ctx.dim, model_rank(), model_size()).contiguous(), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, model-group all-reduce backward (``x`` at model 1)."""
    return x if model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Model-group all-reduce forward, identity backward (``x`` at model 1)."""
    return x if model_size() == 1 else _ReduceFromModel.apply(x)


def gather_from_model(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The full weight of the shard ``w`` (split on ``dim``), gathered over
    the model group, its gradient sliced back (``w`` at model 1)."""
    return w if model_size() == 1 else _GatherFromModel.apply(w, dim)


# ---------------------------------------------------------------------------
# The global microbatch: rows, draws and the roll
# ---------------------------------------------------------------------------


def microbatch_rows(global_batch: int, accum: int, world_size: int, rank_index: int) -> np.ndarray:
    """The rows of hvt's global batch that rank ``rank_index`` holds, in the
    order of its local batch: for each microbatch i of ``accum`` (global rows
    [i·mb, (i+1)·mb), mb = global_batch / accum, as hvt's reshape of the
    global batch makes them), its share [i·mb + r·mb/W, i·mb + (r+1)·mb/W).
    At accum 1 that is the rank's own chunk [r·B/W, (r+1)·B/W)."""
    if global_batch % accum:
        raise ValueError(f"global batch {global_batch} not divisible by grad_accum {accum}")
    mb = global_batch // accum
    if mb % world_size:
        raise ValueError(f"microbatch {mb} (global batch {global_batch} / grad_accum {accum}) "
                         f"not divisible by the world of {world_size}")
    share = mb // world_size
    return np.concatenate([i * mb + rank_index * share + np.arange(share) for i in range(accum)])


def global_rows(local: int) -> tuple[int, int]:
    """(rows of the global microbatch, the offset of this rank's) for a
    local microbatch of ``local`` rows."""
    d = _active()
    if d is None:
        return local, 0
    return local * d.world, local * d.rank


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator] = None,
              device=None) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows of a draw over the global
    microbatch: the draw takes (W·shape[0], ...) numbers from ``generator``
    on every rank, so the generators stay equal, and the rank keeps its
    rows."""
    local = int(shape[0])
    total, offset = global_rows(local)
    draw = torch.rand((total, *shape[1:]), generator=generator, device=device)
    return draw[offset:offset + local] if total != local else draw


def roll_rows(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``torch.roll(t, 1, dims=0)`` of each tensor over the global batch:
    this rank's first row becomes the previous rank's last (rank 0's, the
    last rank's). One ``all_gather`` of every tensor's last row, packed in
    f32 (exact for bf16 and f32), for all the tensors together."""
    rolled = [torch.roll(t, 1, dims=0) for t in tensors]
    d = _active()
    if d is None:
        return rolled
    rows = torch.cat([t[-1].reshape(-1).float() for t in tensors])
    prev = all_gather(rows, d.group)[(d.rank - 1) % d.world]
    offset = 0
    for t, r in zip(tensors, rolled):
        n = t[-1].numel()
        r[0] = prev[offset:offset + n].view(t.shape[1:]).to(t.dtype)
        offset += n
    return rolled
