"""Data parallelism over ``torch.distributed`` — port of the data axis of
``hvt/parallel.py``.

hvt shards the global batch over its mesh's ``data`` axis under GSPMD (the
batch rank-major over the processes, ``make_array_from_process_local_data``),
runs every Pallas kernel per data shard inside ``shard_map`` and lets XLA
sum the parameter cotangents; its BatchNorm reductions psum their
per-channel sums over the axis (global-batch statistics). The port runs one
process per card, started by ``torchrun``, in one process group: NCCL on
the card, gloo on the CPU. Each rank holds the model whole and its share of
every microbatch of hvt's global batch (:func:`microbatch_rows`); the step
sums the ranks' gradients after the last microbatch; the BatchNorm
reductions all-reduce their sums; random draws are made over the global
microbatch from one generator that stays equal on every rank, and each rank
keeps its rows (:func:`rand_rows`); MixUp's and CutMix's roll of the batch by
one crosses the rank boundary through one exchange (:func:`roll_rows`).

The Trainer declares the group with :func:`set_data_group` before any step
runs, as hvt's declares ``set_kernel_mesh``: model code asks
:func:`data_group` and stays group-agnostic. Without a declared group every
helper here is the one-process identity, and routes that read the group
take it by its declaration, not its size: a world of one through NCCL runs
the data-parallel route, bit-equal to the one-process one. Every collective
is synchronous (``async_op=False``) on the caller's current stream order.

Of hvt's mesh only ``data`` is ported: ``model``, ``spatial``, ``pipe`` above
1 and ``zero: true`` raise (:func:`check_mesh`), naming ROADMAP.md queue 1,
item 11, which also lists communication overlap as later speed work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

ITEM_11 = "ROADMAP.md queue 1, item 11"
BUCKET_BYTES = 64 << 20  # gradient all-reduce bucket: at most this much flat copy at once


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process: its
    environment names a world."""
    return "WORLD_SIZE" in os.environ


def launch_device(device):
    """The device a launched rank runs on: ``cuda:LOCAL_RANK`` for a default
    or CUDA device (which becomes the current device), else ``device``."""
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
    0 alone), and, as the Trainer does, a ``mesh`` off what one process
    runs."""
    world = max(process_world()[1], int(os.environ.get("WORLD_SIZE", 1)))
    if world > 1:
        raise NotImplementedError(
            f"{what} runs in one process: spreading it over the devices of a world of "
            f"{world} is {ITEM_11}")
    check_mesh(getattr(config, "mesh", None), 1)


# ---------------------------------------------------------------------------
# hvt's mesh config
# ---------------------------------------------------------------------------


def check_mesh(mesh_cfg, world: int) -> int:
    """``config.mesh`` against the world, as hvt's ``make_mesh`` reads it:
    ``data: -1`` means the world, any other ``data`` must equal it. The
    axes that are not ported (``model``, ``spatial``, ``pipe`` above 1,
    ``zero: true``) raise ``NotImplementedError``. Returns the data size."""
    if mesh_cfg is None:
        return world
    off = [f"{k}={getattr(mesh_cfg, k)}" for k in ("model", "spatial", "pipe")
           if int(getattr(mesh_cfg, k, 1)) > 1]
    if bool(getattr(mesh_cfg, "zero", False)):
        off.append("zero=true")
    if off:
        raise NotImplementedError(
            f"mesh {', '.join(off)}: the port has data parallelism only; ZeRO-1, tensor, "
            f"spatial and pipeline parallelism are {ITEM_11}")
    data = int(getattr(mesh_cfg, "data", -1))
    if data == -1:
        return world
    if data != world:
        raise ValueError(
            f"mesh data={data} does not match the world of {world} processes (one card "
            f"each; data: -1 takes the world; {ITEM_11})")
    return data


# ---------------------------------------------------------------------------
# The declared data group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Declared:
    group: object  # a ProcessGroup
    rank: int
    world: int
    device: torch.device  # where the group's collectives take their tensors
    host: object  # a gloo group over the same ranks, for host values


_DATA: Optional[_Declared] = None
_HOST_GROUPS: dict = {}  # group → its gloo twin (made once: new_group is collective)


def set_data_group(group=None, device=None) -> None:
    """Declare the process group the batch is sharded over (``group=None``
    clears it). ``dist.group.WORLD`` is the usual group; ``device`` is where
    its collectives take tensors (the card for NCCL). Host values (flags,
    counts, the wandb descriptor) travel over a gloo group of the same
    ranks, so reading them never waits for the card; every rank must make
    the first declaration of a group together."""
    global _DATA
    if group is None:
        _DATA = None
        return
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    host = group
    if backend != "gloo":
        host = _HOST_GROUPS.get(group)
        if host is None:
            host = _HOST_GROUPS[group] = dist.new_group(
                ranks=dist.get_process_group_ranks(group), backend="gloo")
    _DATA = _Declared(group, dist.get_rank(group), dist.get_world_size(group),
                      torch.device(device), host)


def destroy() -> None:
    """Clear the declaration and leave the default process group."""
    set_data_group(None)
    _HOST_GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def data_group():
    """The declared group, or None."""
    return None if _DATA is None else _DATA.group


def rank() -> int:
    """This process's rank in the declared group (0 without one)."""
    return 0 if _DATA is None else _DATA.rank


def world() -> int:
    """Ranks of the declared group (1 without one)."""
    return 1 if _DATA is None else _DATA.world


@contextlib.contextmanager
def no_data_group():
    """Run a block as one process (the memory probe of ``grad_accum:
    auto``, which must not enter a collective that another rank may skip)."""
    global _DATA
    saved, _DATA = _DATA, None
    try:
        yield
    finally:
        _DATA = saved


# ---------------------------------------------------------------------------
# Collectives (identities without a declared group)
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, op=None) -> torch.Tensor:
    """Sum (or ``op``) ``t`` over the declared group, in place; returns it."""
    if _DATA is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=_DATA.group)
    return t


def all_reduce_tensors_(tensors: Sequence[torch.Tensor]) -> int:
    """Sum each tensor over the group in place, through flat buckets of up to
    ``BUCKET_BYTES`` of one dtype and device, one all-reduce a bucket, one at
    a time. Returns the number of all-reduces made."""
    if _DATA is None or not tensors:
        return 0
    calls = 0
    bucket: list[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size, calls
        if not bucket:
            return
        if len(bucket) == 1:
            all_reduce_(bucket[0])
        else:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce_(flat)
            offset = 0
            for t in bucket:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n
        calls += 1
        bucket, size = [], 0

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            flush()
        bucket.append(t)
        size += nbytes
    flush()
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
    """The group's sum of ``x``, differentiable (a new tensor; ``x`` itself
    without a group)."""
    if _DATA is None:
        return x
    return _AllReduceSum.apply(x)


def host_max(values: Sequence[int]) -> list[int]:
    """The largest of each host integer over the group (the host group: no
    wait for the card)."""
    if _DATA is None:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_DATA.host)
    return t.tolist()


def check_same(values: Sequence[int], what: str) -> None:
    """Raise unless every rank holds the same host integers."""
    if _DATA is None:
        return
    hi = host_max(values)
    lo = [-v for v in host_max([-int(v) for v in values])]
    if hi != lo:
        raise RuntimeError(f"the ranks disagree on {what}: from {lo} to {hi}")


def barrier() -> None:
    """Every rank of the declared group reaches this point (the host group)."""
    if _DATA is not None:
        dist.barrier(group=_DATA.host)


def broadcast_small_json(obj, max_bytes: int = 65536):
    """Rank 0's JSON-able ``obj`` on every rank (hvt's
    ``broadcast_small_json``, parallel.py:468: the wandb run's descriptor);
    the object itself without a group."""
    if _DATA is None:
        return obj
    buf = torch.zeros(max_bytes + 8, dtype=torch.uint8)
    if _DATA.rank == 0:
        payload = json.dumps(obj).encode()
        if len(payload) > max_bytes:
            raise ValueError(f"object too large to broadcast ({len(payload)} bytes)")
        buf[:8] = torch.from_numpy(np.frombuffer(np.int64(len(payload)).tobytes(), np.uint8).copy())
        buf[8:8 + len(payload)] = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    dist.broadcast(buf, src=0, group=_DATA.host)
    out = buf.numpy()
    n = int(np.frombuffer(out[:8].tobytes(), np.int64)[0])
    return json.loads(out[8:8 + n].tobytes().decode())


def broadcast_tensors_(tensors: Sequence[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place."""
    if _DATA is None:
        return
    for t in tensors:
        dist.broadcast(t.data, src=0, group=_DATA.group)


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
    if _DATA is None:
        return local, 0
    return local * _DATA.world, local * _DATA.rank


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
    if _DATA is None:
        return rolled
    rows = torch.cat([t[-1].reshape(-1).float() for t in tensors])
    every = [torch.empty_like(rows) for _ in range(_DATA.world)]
    dist.all_gather(every, rows, group=_DATA.group)
    prev = every[(_DATA.rank - 1) % _DATA.world]
    offset = 0
    for t, r in zip(tensors, rolled):
        n = t[-1].numel()
        r[0] = prev[offset:offset + n].view(t.shape[1:]).to(t.dtype)
        offset += n
    return rolled
