"""Kernels 7 and 8: training-mode BatchNorm on the card, four calls.

Port of ``_sums_pallas`` (hvt/ops/bn_stats_pallas.py:94) and
``_bwd_reduce_pallas`` (:181), each a launch over the rows and a second
launch that finishes its sums into hvt's per-channel formulas, and of the
elementwise rest of ``_bn_train_fwd``/``_bn_train_bwd``
(:273-301) as two passes, all in ``csrc/bn_stats.cu``. They take the
(rows, C) view of an NHWC activation, contiguous and 16-byte aligned, with C
a multiple of 8, in bf16 or f32, and (C,) f32 per-channel vectors, and
compute in f32:

* :func:`bn_moments` (``bn_channel_sums``) → mean, var, rstd;
  :func:`channel_sums` → (Σx, Σx²) from the same call;
* :func:`bn_normalize` (``bn_normalize``) → y = ((x − mean)·rstd)·γ + β;
* :func:`bn_bwd_terms` (``bn_bwd_reduce``) → the (5, C) rows Σg, Σg·x̂,
  γ·rstd, Σg/n, Σg·x̂/n; :func:`bn_bwd_reduce` → (Σg, Σg·x̂) from the same
  call;
* :func:`bn_dx` (``bn_dx``) → dx = γ·rstd·((g − Σg/n) − x̂·Σg·x̂/n);
* :func:`channel_partials` and :func:`bwd_partials` → the reductions' rows
  launch alone, its (chunks, 2, C) f32 partials in a tensor of their own;
  :func:`bn_finish` (``bn_finish``) → the finish alone, on such partials:
  the data-parallel route of :mod:`hvt_torch.ops.bn_stats` all-reduces each
  rank's partials and finishes them on the global row count, two launches
  a reduction as the one-process calls make.

Each counts its calls in its ``_build.Kernel``'s ``launches``. They take
CUDA tensors only and raise on anything the kernels do not take:
never a silent copy, never a plain version. The device dispatch and the
plain versions are in :mod:`hvt_torch.ops.bn_stats`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hvt_torch.ops import _build
from hvt_torch.ops._build import F, I, L, P

SUMS_KERNEL = _build.Kernel("bn_stats", "hvt_bn_channel_sums", [P, L, I, I, I, F, P, P, I, P])
NORMALIZE_KERNEL = _build.Kernel("bn_stats", "hvt_bn_normalize",
                                 [P, P, P, P, P, P, L, I, I, I, I, I, P])
BWD_KERNEL = _build.Kernel("bn_stats", "hvt_bn_bwd_reduce",
                           [P, P, P, P, P, L, I, I, I, P, P, I, P])
DX_KERNEL = _build.Kernel("bn_stats", "hvt_bn_dx", [P, P, P, P, P, P, P, P, L, I, I, I, I, P])
FINISH_KERNEL = _build.Kernel("bn_stats", "hvt_bn_finish", [P, I, L, I, F, P, P, P, I, P])
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
THREADS = 256  # threads of a block (csrc kBnThreads)
TARGET_BLOCKS = 396  # blocks a launch: one wave of three an SM on the H100's 132
MIN_ROWS_PER_THREAD = 4
MAX_TX = 32  # threads across channels: 256 channels a tile, 512 bytes of a bf16 row


class Plan(NamedTuple):
    """A launch over (rows, C): ``tx`` threads of a block across channels (8
    each), ``tiles`` channel tiles (the grid's x), ``chunks`` row chunks (its
    y) of ``rows_per_chunk`` rows, and the reductions' ``scratch``: one
    (2, C) f32 partial a chunk."""

    tx: int
    tiles: int
    chunks: int
    rows_per_chunk: int
    scratch: int


def unsupported(c: int) -> str | None:
    """Why the kernels cannot take C channels, or None."""
    if c < 8 or c % 8:
        return f"{c} channels: the BatchNorm kernels take a multiple of 8"
    return None


@functools.lru_cache(maxsize=4096)
def launch_plan(m: int, c: int) -> Plan:
    """The one plan of all four calls over (m, c): up to MAX_TX threads
    across channels, the rest of the block's 256 down the rows; chunks for
    about TARGET_BLOCKS blocks, each thread at least MIN_ROWS_PER_THREAD
    rows. The finish reads a chunk's partial a thread, at most
    ceil(396 / 256) = 2."""
    tx = min(c // 8, MAX_TX)
    ty = THREADS // tx
    tiles = -(-c // (8 * tx))
    chunks = max(1, min(-(-TARGET_BLOCKS // tiles), m // (ty * MIN_ROWS_PER_THREAD)))
    return Plan(tx, tiles, chunks, -(-m // chunks), chunks * 2 * c)


# (device index, stream) → the reductions' scratch for their partials. The
# two launches of a call, and the calls on one stream, run in order, so
# they share one; another stream gets its own.
_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}


def _workspace(device: torch.device, stream: int, plan: Plan) -> int:
    key = (device.index, stream)
    scratch = _WORKSPACES.get(key)
    if scratch is None or scratch.numel() < plan.scratch:
        scratch = torch.empty(plan.scratch, dtype=torch.float32, device=device)
        _WORKSPACES[key] = scratch
    return scratch.data_ptr()


def _why(t: torch.Tensor, first: torch.Tensor) -> str | None:
    if t.dim() != 2 or t.shape != first.shape:
        return f"shape {tuple(t.shape)}: (rows, C) of one shape wanted"
    if t.dtype not in _DTYPES or t.dtype != first.dtype:
        return f"{t.dtype}: bf16 or f32, one dtype wanted"
    if not t.is_contiguous():
        return (f"strides {t.stride()}: the (rows, C) view must be contiguous (an NHWC "
                "activation); the wrapper makes no copy")
    if t.data_ptr() % 16:
        return "not 16-byte aligned"
    return unsupported(t.shape[1])


def _check(name: str, *tensors: torch.Tensor) -> None:
    """Raises on what the kernels do not take; the devices are asked last,
    so each other refusal shows on CPU tensors too."""
    first = tensors[0]
    shape, dtype, device = first.shape, first.dtype, first.device
    if (device.type == "cuda" and dtype in _DTYPES and len(shape) == 2 and shape[1] >= 8
            and shape[1] % 8 == 0
            and all(t.shape == shape and t.dtype == dtype and t.device == device
                    and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)):
        return  # the common case, asked in one pass
    whys = [_why(t, first) for t in tensors]
    whys += [f"on {t.device}, not the CUDA device of the first operand" for t in tensors
             if t.device.type != "cuda" or t.device != first.device]
    why = next((w for w in whys if w), None)
    if why:
        raise ValueError(f"{name}: {why}")


def _check_vectors(name: str, c: int, like: torch.Tensor, *vectors: torch.Tensor) -> None:
    device = like.device
    for t in vectors:
        if (t.dtype != torch.float32 or t.shape != (c,) or t.stride() != (1,) or t.data_ptr() % 16
                or t.device != device):
            raise ValueError(f"{name}: per-channel operand {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: ({c},) f32 on {like.device}, contiguous and 16-byte "
                             "aligned wanted")


def _launch_args(x2d: torch.Tensor) -> tuple[int, int, Plan, int]:
    """(rows, C, plan, the device's current stream as a raw handle)."""
    m, c = x2d.shape
    return m, c, launch_plan(m, c), torch._C._cuda_getCurrentRawStream(x2d.device.index)


def channel_stats(x2d: torch.Tensor, eps: float) -> torch.Tensor:
    """(5, C) f32 = (Σx, Σx², mean, var, rstd) through one launch."""
    _check("bn_channel_sums", x2d)
    m, c, plan, stream = _launch_args(x2d)
    scratch = _workspace(x2d.device, stream, plan)
    out = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    SUMS_KERNEL(x2d.data_ptr(), m, c, plan.tx, plan.chunks, eps, scratch, out.data_ptr(),
                _DTYPES[x2d.dtype], stream)
    return out


def channel_sums(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the rows of a CUDA (rows, C) tensor, through the kernel."""
    out = channel_stats(x2d, 0.0)
    return out[0], out[1]


def bn_moments(x2d: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var, rstd) of each channel of a CUDA (rows, C) tensor, hvt's
    ``_bn_train_fwd`` formulas formed by the sums' finish launch."""
    out = channel_stats(x2d, eps)
    return out[2], out[3], out[4]


def bn_normalize(x2d: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """y = ((x − mean)·rstd)·scale + bias in f32, rounded once to
    ``out_dtype`` (bf16 or f32), through the kernel."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"bn_normalize: out_dtype {out_dtype}: bf16 or f32 wanted")
    _check("bn_normalize", x2d)
    m, c, plan, stream = _launch_args(x2d)
    _check_vectors("bn_normalize", c, x2d, mean, rstd, scale, bias)
    y = torch.empty((m, c), dtype=out_dtype, device=x2d.device)
    NORMALIZE_KERNEL(x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
                     bias.data_ptr(), y.data_ptr(), m, c, plan.tx, plan.chunks,
                     _DTYPES[x2d.dtype], _DTYPES[out_dtype], stream)
    return y


def _bwd_terms(g2d, x2d, mean, rstd, scale) -> torch.Tensor:
    _check("bn_bwd_reduce", g2d, x2d)
    m, c, plan, stream = _launch_args(x2d)
    _check_vectors("bn_bwd_reduce", c, x2d, mean, rstd, *(() if scale is None else (scale,)))
    scratch = _workspace(x2d.device, stream, plan)
    out = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    BWD_KERNEL(g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
               None if scale is None else scale.data_ptr(), m, c, plan.tx, plan.chunks, scratch,
               out.data_ptr(), _DTYPES[x2d.dtype], stream)
    return out


def bn_bwd_reduce(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·(x − mean)·rstd) over the rows of CUDA (rows, C) tensors g and
    x of one dtype, with (C,) f32 mean and rstd, through the kernel."""
    out = _bwd_terms(g2d, x2d, mean, rstd, None)
    return out[0], out[1]


def bn_bwd_terms(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """The (5, C) f32 rows Σg, Σg·x̂, scale·rstd, Σg/n, Σg·x̂/n formed by the
    reduce's finish launch: dbias, dscale and dx's factors. One tensor, so
    that bn_dx reads its rows by offset and the call makes no views."""
    return _bwd_terms(g2d, x2d, mean, rstd, scale)


def bn_dx(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
          terms: torch.Tensor) -> torch.Tensor:
    """dx = k·((g − m1) − ((x − mean)·rstd)·m2) in f32, rounded once to x's
    dtype, through the kernel; k, m1, m2 are rows 2-4 of bn_bwd_terms' (5, C)
    ``terms``."""
    _check("bn_dx", g2d, x2d)
    m, c, plan, stream = _launch_args(x2d)
    _check_vectors("bn_dx", c, x2d, mean, rstd)
    if (terms.shape != (5, c) or terms.dtype != torch.float32 or not terms.is_contiguous()
            or terms.data_ptr() % 16 or terms.device != x2d.device):
        raise ValueError(f"bn_dx: terms {tuple(terms.shape)} {terms.dtype} on {terms.device}: "
                         f"bn_bwd_terms' contiguous (5, {c}) f32 on {x2d.device} wanted")
    dx = torch.empty_like(x2d)
    k = terms.data_ptr() + 2 * c * 4  # rows 2, 3, 4 of the f32 (5, C)
    DX_KERNEL(g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(), k, k + c * 4,
              k + 2 * c * 4, dx.data_ptr(), m, c, plan.tx, plan.chunks, _DTYPES[x2d.dtype],
              stream)
    return dx


def channel_partials(x2d: torch.Tensor) -> torch.Tensor:
    """The sums' rows launch alone: (chunks, 2, C) f32 chunk partials of
    (Σx, Σx²), in a tensor of their own (a collective may take it)."""
    _check("bn_channel_sums", x2d)
    m, c, plan, stream = _launch_args(x2d)
    part = torch.empty((plan.chunks, 2, c), dtype=torch.float32, device=x2d.device)
    SUMS_KERNEL(x2d.data_ptr(), m, c, plan.tx, plan.chunks, 0.0, part.data_ptr(), None,
                _DTYPES[x2d.dtype], stream)
    return part


def bwd_partials(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                 rstd: torch.Tensor) -> torch.Tensor:
    """The backward reduce's rows launch alone: (chunks, 2, C) f32 chunk
    partials of (Σg, Σg·x̂), in a tensor of their own."""
    _check("bn_bwd_reduce", g2d, x2d)
    m, c, plan, stream = _launch_args(x2d)
    _check_vectors("bn_bwd_reduce", c, x2d, mean, rstd)
    part = torch.empty((plan.chunks, 2, c), dtype=torch.float32, device=x2d.device)
    BWD_KERNEL(g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(), None, m, c,
               plan.tx, plan.chunks, part.data_ptr(), None, _DTYPES[x2d.dtype], stream)
    return part


def bn_finish(part: torch.Tensor, n: int, eps: float, kind: int, rstd: torch.Tensor | None = None,
              scale: torch.Tensor | None = None) -> torch.Tensor:
    """A reduction's finish on the (parts, 2, C) f32 partials ``part`` over
    ``n`` rows, one launch: kind 0 takes (Σx, Σx²) and gives (5, C) = (Σx,
    Σx², mean, var, rstd); kind 1 takes (Σg, Σg·x̂) with ``rstd`` (and
    ``scale``, or γ = 1) and gives (Σg, Σg·x̂, γ·rstd, Σg/n, Σg·x̂/n). The
    kernel is the fused calls' finish, so the partials of one rank's rows
    launch give those calls' bits."""
    if (part.dim() != 3 or part.shape[1] != 2 or part.dtype != torch.float32
            or not part.is_contiguous() or part.data_ptr() % 16 or part.device.type != "cuda"):
        raise ValueError(f"bn_finish: partials {tuple(part.shape)} {part.dtype} on {part.device}: "
                         "contiguous (parts, 2, C) f32 on the card, 16-byte aligned, wanted")
    parts, c = part.shape[0], part.shape[2]
    why = unsupported(c)
    if why:
        raise ValueError(f"bn_finish: {why}")
    if kind == 1:
        if rstd is None:
            raise ValueError("bn_finish: the backward's finish needs rstd")
        _check_vectors("bn_finish", c, part, rstd, *(() if scale is None else (scale,)))
    out = torch.empty((5, c), dtype=torch.float32, device=part.device)
    stream = torch._C._cuda_getCurrentRawStream(part.device.index)
    FINISH_KERNEL(part.data_ptr(), parts, int(n), c, eps,
                  None if rstd is None else rstd.data_ptr(),
                  None if scale is None else scale.data_ptr(), out.data_ptr(), int(kind), stream)
    return out
