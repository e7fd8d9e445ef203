"""Flash attention over a whole sequence: ViT's and DINOv2's ``use_flash`` route.

Port of ``_attend_flash`` (hvt/models/vit.py:50), which calls jax's TPU
flash-attention op (three ``pallas_call``\\ s: the forward at
jax/experimental/pallas/ops/tpu/flash_attention.py:758, dK/dV at :1121, dQ
at :1456). Here one ``torch.autograd.Function`` runs ``csrc/flash_attention.cu``
on a CUDA tensor: the forward kernel, then in the backward the dQ kernel,
which also forms D = rowsum(dO∘O) in f32 (jax computes it outside its
kernels, flash_attention.py:274) and writes it for the dK/dV kernel, which
runs next: two launches, no torch pass between them. All three are Hopper
kernels (TMA into the 128-byte swizzle, ``wgmma``, a whole (image, head) a
block where its keys or queries fit, :func:`flash_plan`). A CPU tensor
takes the plain versions below; nothing else selects between them. The
contract:

    o = softmax(sm_scale · q·kᵀ) · v      per (image, head), over the N real keys

with q·kᵀ from the inputs' values summed in f32 and the softmax in f32; the
kernel rounds the unnormalised p to v's dtype before p·v and P, dS·sm_scale to
bf16 before the backward's products, as jax's kernels do, and the plain
versions keep them in f32. The row log-sum-exp (natural log, f32) is saved
for the backward. hvt pads N to 128 and masks with segment ids; the kernel
masks the last key tile instead, so nothing is padded.

The kernels take head dim :data:`HEAD_DIM` only (every ViT and DINOv2 variant
hvt defines beyond the test-only micro ones); another head dim on a CUDA
tensor raises before anything launches (:func:`unsupported`).

On the model's path (:func:`flash_attention_qkv`) the kernels read q, k and v
straight from the packed (B, N, 3·D) qkv projection and write o into a
(B, N, D) tensor and dq, dk, dv into one (B, N, 3·D) gradient, through
TMA tensor maps: no head split or merge is copied. An f32 input reaches
the kernels' products as one bf16 copy of qkv and of dO (the values the
tensor cores would take), their outputs come out in f32, and D sums the
f32 values of O and dO.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from hvt_torch.ops import _build

HEAD_DIM = 64
_F = ctypes.c_float
_SHAPE = [_build.I] * 4 + [_F, _build.I, _build.P]  # B, H, N, d; sm_scale, dtype, stream
FWD_KERNEL = _build.Kernel("flash_attention", "hvt_flash_attention_fwd",
                           [_build.P] * 3 + _SHAPE)
BWD_DQ_KERNEL = _build.Kernel("flash_attention", "hvt_flash_attention_bwd_dq",
                              [_build.P] * 7 + _SHAPE)
BWD_DKV_KERNEL = _build.Kernel("flash_attention", "hvt_flash_attention_bwd_dkv",
                               [_build.P] * 5 + _SHAPE)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
COVERAGE_ITEM = "ROADMAP.md queue 2, 'Kernel coverage' (flash attention at other head dims)"


# The Hopper kernels' plan (csrc/flash_attention.cu `fwd_plan`, `dkv_plan`, `dq_plan`).
ROWS = 64              # an outer tile: wgmma's M (queries forward and in dQ, keys in dK/dV)
MIN_INNER = 64         # the narrowest inner tile
FWD_RESIDENT = 256     # the forward keeps one key tile of up to this many keys
FWD_STREAM = 160       # its widest key tile where it takes several (two blocks an SM)
DKV_CHUNK = 128        # dK/dV's widest query chunk (its registers)
DQ_TILE = 128          # dQ's widest key tile (its registers)
STAGING, BARS = 16384, 64  # the output staging tile (64 x 64 f32), the mbarriers
SMEM_PER_BLOCK = 232448    # the most dynamic shared memory an H100 block takes (227 KB)
BOX_MOST = 256             # the longest side of a TMA box


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One kernel's walk over an (image, head) of N rows: ``outer`` tiles of
    :data:`ROWS` rows (queries, with dQ's dO, O and lse, in the forward and
    dQ; keys and values in dK/dV), each against ``tiles`` inner tiles of
    ``inner`` rows (keys and values; dK/dV's queries, dO, lse and D), rows
    at or past N zero-filled or masked. ``blocks_per_head`` blocks take an
    (image, head): one, looping
    over every outer tile with the inner tiles resident, where there are at
    most two inner tiles, else one for each outer tile, the inner tiles
    streamed through two stages. ``smem`` is a block's dynamic shared memory, bytes;
    ``boxes`` the rows of each TMA box (128 bytes of one head's columns)."""

    kernel: str
    n: int
    inner: int
    tiles: int
    outer: int
    blocks_per_head: int
    smem: int
    boxes: dict

    @property
    def resident(self) -> bool:
        return self.tiles <= 2

    def blocks(self, batch: int, heads: int) -> list[tuple[int, int, range]]:
        """(image, head, outer tiles) of each block in linear block order:
        the blocks of one (image, head) consecutive."""
        per = self.blocks_per_head
        return [(bh // heads, bh % heads,
                 range(self.outer) if per == 1 else range(sub, sub + 1))
                for bh in range(batch * heads) for sub in range(per)]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _inner_tiles(n: int, most: int) -> tuple[int, int]:
    """The fewest inner tiles of at most ``most`` rows covering n, all of
    one width, a multiple of 16 and at least MIN_INNER: (tiles, width)."""
    tiles = _ceil(n, most)
    return tiles, max(MIN_INNER, 16 * _ceil(_ceil(n, tiles), 16))


def flash_plan(n: int) -> tuple[KernelPlan, KernelPlan, KernelPlan]:
    """The forward's, dK/dV's and dQ's plan at sequence length n, as the
    kernels' host code computes it (``hvt_flash_plan`` returns the same
    numbers)."""
    outer = _ceil(n, ROWS)
    tiles, inner = _inner_tiles(n, FWD_RESIDENT if n <= FWD_RESIDENT else FWD_STREAM)
    stages = min(tiles, 2)
    fwd = KernelPlan("forward", n, inner, tiles, outer, 1 if tiles <= 2 else outer,
                     1024 + stages * 2 * inner * 128 + ROWS * 128 + STAGING + BARS,
                     {"q": ROWS, "k": inner, "v": inner, "o": ROWS})
    tiles, inner = _inner_tiles(n, DKV_CHUNK)
    stages = min(tiles, 2)
    dkv = KernelPlan("dkv", n, inner, tiles, outer, 1 if tiles <= 2 else outer,
                     1024 + stages * 2 * inner * 128 + 2 * ROWS * 128 + STAGING
                     + stages * inner * 8 + BARS,
                     {"k": ROWS, "v": ROWS, "q": inner, "do": inner, "dk": ROWS, "dv": ROWS})
    tiles, inner = _inner_tiles(n, DQ_TILE)
    stages = min(tiles, 2)
    dq = KernelPlan("dq", n, inner, tiles, outer, 1 if tiles <= 2 else outer,
                    1024 + stages * 2 * inner * 128 + 3 * ROWS * 128 + STAGING + ROWS * 4 + BARS,
                    {"q": ROWS, "do": ROWS, "o": ROWS, "k": inner, "v": inner, "dq": ROWS})
    return fwd, dkv, dq


def unsupported(head_dim: int) -> str | None:
    """Why the kernels cannot take heads of ``head_dim``, or None."""
    if head_dim != HEAD_DIM:
        return (f"the flash-attention kernel takes head dim {HEAD_DIM}, not {head_dim}: "
                f"{COVERAGE_ITEM}")
    return None


def _split(qkv: torch.Tensor, heads: int):
    """(B, N, 3·D) → q, k, v (B, H, N, hd) views."""
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4).unbind(0)


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def forward_plain(qkv: torch.Tensor, heads: int, sm_scale: float):
    """Plain version of the forward kernel: (o (B, N, D) in qkv's dtype, lse
    (B, H, N) f32 (f64 on f64)), the dense softmax in f32."""
    b, n, c3 = qkv.shape
    q, k, v = (t.to(_acc(qkv)) for t in _split(qkv, heads))
    s = (q @ k.transpose(-1, -2)) * sm_scale
    lse = torch.logsumexp(s, -1)
    o = torch.exp(s - lse[..., None]) @ v
    return o.transpose(1, 2).reshape(b, n, c3 // 3).to(qkv.dtype), lse


def delta_rows(out: torch.Tensor, dout: torch.Tensor, heads: int) -> torch.Tensor:
    """D = rowsum(dO∘O) per (image, head, row), (B, H, N) f32 (f64 on f64)."""
    b, n, c = out.shape
    prod = out.to(_acc(out)) * dout.to(_acc(out))
    return prod.view(b, n, heads, c // heads).sum(-1).transpose(1, 2).contiguous()


def _p_ds(qkv, dout, lse, delta, heads: int, sm_scale: float):
    """q, k, dO (B, H, N, hd), P = exp(s − lse) and dS = P∘(dO·vᵀ − D)·sm_scale
    in f32 (f64 on f64)."""
    b, n, c3 = qkv.shape
    ad = _acc(qkv)
    q, k, v = (t.to(ad) for t in _split(qkv, heads))
    go = dout.to(ad).view(b, n, heads, c3 // 3 // heads).transpose(1, 2)
    p = torch.exp((q @ k.transpose(-1, -2)) * sm_scale - lse[..., None].to(ad))
    ds = p * (go @ v.transpose(-1, -2) - delta[..., None].to(ad)) * sm_scale
    return q, k, go, p, ds


def _merge(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, hd) → (B, N, H·hd) in dtype."""
    b, h, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, h * hd).to(dtype)


def backward_dq_plain(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                      heads: int, sm_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dQ kernel: (dq (B, N, D) in qkv's dtype, D =
    rowsum(dO∘O) (B, H, N) f32, f64 on f64), D by :func:`delta_rows`, dq =
    dS·k in f32."""
    delta = delta_rows(out, dout, heads)
    _, k, _, _, ds = _p_ds(qkv, dout, lse, delta, heads, sm_scale)
    return _merge(ds @ k, qkv.dtype), delta


def backward_plain(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   heads: int, sm_scale: float) -> torch.Tensor:
    """Plain version of the backward (the dQ kernel with its D, then dK/dV):
    dqkv (B, N, 3·D) in qkv's dtype from P = exp(s − lse) and
    dS = P∘(dO·vᵀ − D)·sm_scale, in f32."""
    dq, delta = backward_dq_plain(qkv, out, dout, lse, heads, sm_scale)
    q, _, go, p, ds = _p_ds(qkv, dout, lse, delta, heads, sm_scale)
    dk, dv = ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ go
    return torch.cat([dq, _merge(dk, qkv.dtype), _merge(dv, qkv.dtype)], -1)


def _check(qkv: torch.Tensor, heads: int) -> None:
    b, n, c3 = qkv.shape
    why = "3·D columns in whole heads wanted" if c3 % (3 * heads) else unsupported(c3 // 3 // heads)
    if qkv.dtype not in _DTYPES or why:
        raise ValueError(f"flash_attention: qkv {tuple(qkv.shape)} {qkv.dtype} with {heads} "
                         f"heads: {why or 'bf16 or f32 wanted'}")


def _packed(t: torch.Tensor) -> torch.Tensor:
    """t (B, N, C) with rows on 16-byte boundaries, contiguous (a copy only
    where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def forward(qkv: torch.Tensor, heads: int, sm_scale: float):
    """(o, lse) of the forward: the kernel for a CUDA tensor, ``forward_plain``
    for a CPU one."""
    if qkv.device.type == "cpu":
        return forward_plain(qkv, heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {qkv.device}")
    _check(qkv, heads)
    qkv = _packed(qkv)
    b, n, c3 = qkv.shape
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    src = _bf16(qkv)
    FWD_KERNEL(src.data_ptr(), out.data_ptr(), lse.data_ptr(), *_tail(qkv, heads, sm_scale))
    return out, lse


def backward(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
             heads: int, sm_scale: float) -> torch.Tensor:
    """dqkv of the forward: the dQ kernel (which writes D), then the dK/dV
    kernel (which reads it) for a CUDA tensor, ``backward_plain`` for a CPU
    one."""
    if qkv.device.type == "cpu":
        return backward_plain(qkv, out, lse, dout, heads, sm_scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention backward: unsupported device {qkv.device}")
    _check(qkv, heads)
    qkv = _packed(qkv)
    out = _packed(out.to(qkv.dtype))
    dout = _packed(dout.to(qkv.dtype))
    copies = (_bf16(qkv), _bf16(dout))
    b, n, _ = qkv.shape
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    backward_dq(qkv, out, dout, lse, delta, dqkv, heads, sm_scale, copies)
    backward_dkv(qkv, dout, lse, delta, dqkv, heads, sm_scale, copies)
    return dqkv


def _tail(qkv, heads, sm_scale):
    """The kernels' trailing arguments: B, H, N, head dim, sm_scale, the
    dtype flag (1 = f32: the kernels' outputs, and the o and dO that dQ's D
    reads) and the stream."""
    b, n, c3 = qkv.shape
    return (b, heads, n, c3 // 3 // heads, sm_scale, _DTYPES[qkv.dtype],
            torch.cuda.current_stream(qkv.device).cuda_stream)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t as the TMA kernels read it: bf16 (an f32 tensor rounded once, as
    the tensor cores would round it), on a 16-byte boundary."""
    return t if t.dtype == torch.bfloat16 else _packed(t.to(torch.bfloat16))


def backward_dkv(qkv, dout, lse, delta, dqkv, heads: int, sm_scale: float,
                 copies=None) -> None:
    """The dK/dV kernel into dqkv's k and v columns, reading D from ``delta``
    (``backward``'s launch: contiguous CUDA qkv, dout and dqkv on 16-byte
    boundaries; ``copies`` the caller's ``_bf16`` of qkv and dout, else made
    here)."""
    src, grad = copies or (_bf16(qkv), _bf16(dout))
    BWD_DKV_KERNEL(src.data_ptr(), grad.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dqkv.data_ptr(), *_tail(qkv, heads, sm_scale))


def backward_dq(qkv, out, dout, lse, delta, dqkv, heads: int, sm_scale: float,
                copies=None) -> None:
    """The dQ kernel into dqkv's q columns; it also writes D = rowsum(dO∘O)
    of ``out`` and ``dout`` (f32, from their own values) into ``delta``
    (B, H, N) f32, which ``backward_dkv`` reads (as ``backward_dkv``; out
    and dout in qkv's dtype)."""
    src, grad = copies or (_bf16(qkv), _bf16(dout))
    BWD_DQ_KERNEL(src.data_ptr(), grad.data_ptr(), out.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                  *_tail(qkv, heads, sm_scale))


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of jax's flash attention: the forward kernel saves the
    row log-sum-exp; the backward recomputes P from it."""

    @staticmethod
    def forward(ctx, qkv, heads, sm_scale):
        out, lse = forward(qkv, heads, sm_scale)
        ctx.heads, ctx.sm_scale = heads, sm_scale
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return backward(qkv, out, lse, dout, ctx.heads, ctx.sm_scale), None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, sm_scale: float) -> torch.Tensor:
    """The packed qkv projection (B, N, 3·D) → the attention output (B, N, D)
    with its heads merged, in qkv's dtype, differentiable in qkv. A CUDA
    tensor (bf16 or f32, head dim 64) takes the kernels, a CPU one the plain
    versions; a shape the kernels refuse raises before anything launches."""
    return _FlashAttention.apply(qkv, num_heads, float(sm_scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """hvt's ``_attend_flash`` signature: q, k, v (B, H, N, hd) → (B, H, N, hd)
    in q's dtype, through :func:`flash_attention_qkv` on their packing."""
    b, h, n, hd = q.shape
    qkv = torch.stack([q, k.to(q.dtype), v.to(q.dtype)], 2).permute(0, 3, 2, 1, 4)
    out = flash_attention_qkv(qkv.reshape(b, n, 3 * h * hd), h, sm_scale)
    return out.view(b, n, h, hd).transpose(1, 2)
