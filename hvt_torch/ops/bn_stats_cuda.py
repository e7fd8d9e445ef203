"""Kernels 7 and 8: the per-channel reductions of training-mode BatchNorm.

Port of ``_sums_pallas`` (hvt/ops/bn_stats_pallas.py:94) and
``_bwd_reduce_pallas`` (:181) as ``csrc/bn_stats.cu``. Both take the (rows, C)
view of an NHWC activation, contiguous and 16-byte aligned, with C a
multiple of 8, in bf16 or f32, and accumulate in f32:

* :func:`channel_sums` → (Σx, Σx²), each (C,) f32;
* :func:`bn_bwd_reduce` → (Σg, Σg·(x − mean)·rstd), each (C,) f32.

They take CUDA tensors only and raise on anything the kernel does not take:
never a silent copy, never a plain reduction. The device dispatch and the
plain versions are in :mod:`hvt_torch.ops.bn_stats`.
"""

from __future__ import annotations

import torch

from hvt_torch.ops import _build

SUMS_KERNEL = _build.Kernel(
    "bn_stats", "hvt_bn_channel_sums",
    [_build.P, _build.L, _build.I, _build.I, _build.I, _build.P, _build.P, _build.I, _build.P],
)
BWD_KERNEL = _build.Kernel(
    "bn_stats", "hvt_bn_bwd_reduce",
    [_build.P, _build.P, _build.P, _build.P, _build.L, _build.I, _build.I, _build.I, _build.P,
     _build.P, _build.I, _build.P],
)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
THREADS = 256  # threads of a block (csrc kBnThreads)
TARGET_BLOCKS = 1056  # blocks per launch to aim for: 8 per SM of the H100
MIN_ROWS_PER_THREAD = 4


def unsupported(c: int) -> str | None:
    """Why the kernels cannot take C channels, or None."""
    if c < 8 or c % 8:
        return f"{c} channels: the BatchNorm kernels take a multiple of 8"
    return None


def launch_shape(m: int, c: int) -> tuple[int, int]:
    """(threads across channels, row chunks) of a launch over (m, c): 8
    channels a thread, up to 32 threads across, the rest of the block's 256
    down the rows; chunks for about TARGET_BLOCKS blocks, each thread at least
    MIN_ROWS_PER_THREAD rows."""
    tx = min(c // 8, 32)
    ty = THREADS // tx
    tiles = -(-c // (8 * tx))
    chunks = min(-(-TARGET_BLOCKS // tiles), m // (ty * MIN_ROWS_PER_THREAD))
    return tx, max(1, chunks)


def _check(name: str, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    for t in tensors:
        why = None
        if t.device.type != "cuda":
            why = f"on {t.device}, not a CUDA device"
        elif t.dim() != 2 or t.shape != first.shape:
            why = f"shape {tuple(t.shape)}: (rows, C) of one shape wanted"
        elif t.dtype not in _DTYPES or t.dtype != first.dtype:
            why = f"{t.dtype}: bf16 or f32, one dtype wanted"
        elif not t.is_contiguous():
            why = (f"strides {t.stride()}: the (rows, C) view must be contiguous (an NHWC "
                   "activation); the wrapper makes no copy")
        elif t.data_ptr() % 16:
            why = "not 16-byte aligned"
        else:
            why = unsupported(t.shape[1])
        if why:
            raise ValueError(f"{name}: {why}")


def _vector(t: torch.Tensor, c: int, like: torch.Tensor) -> torch.Tensor:
    if t.shape != (c,) or t.dtype != torch.float32 or t.device != like.device:
        raise ValueError(f"per-channel operand {tuple(t.shape)} {t.dtype} on {t.device}: "
                         f"({c},) f32 on {like.device} wanted")
    return t.contiguous()


def channel_sums(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) over the rows of a CUDA (rows, C) tensor, through the kernel."""
    _check("channel_sums", x2d)
    m, c = x2d.shape
    tx, chunks = launch_shape(m, c)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x2d.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    SUMS_KERNEL(x2d.data_ptr(), m, c, tx, chunks, part.data_ptr(), out.data_ptr(),
                _DTYPES[x2d.dtype], torch.cuda.current_stream(x2d.device).cuda_stream)
    return out[0], out[1]


def bn_bwd_reduce(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·(x − mean)·rstd) over the rows of CUDA (rows, C) tensors g and
    x of one dtype, with (C,) f32 mean and rstd, through the kernel."""
    _check("bn_bwd_reduce", g2d, x2d)
    m, c = x2d.shape
    mean, rstd = _vector(mean, c, x2d), _vector(rstd, c, x2d)
    tx, chunks = launch_shape(m, c)
    part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x2d.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    BWD_KERNEL(g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), rstd.data_ptr(), m, c, tx, chunks,
               part.data_ptr(), out.data_ptr(), _DTYPES[x2d.dtype],
               torch.cuda.current_stream(x2d.device).cuda_stream)
    return out[0], out[1]
