"""Cosine window attention kernels, forward and backward, in two layouts.

Port of ``window_attention_packed`` (hvt/ops/window_attention_pallas.py:613)
and its custom VJP (``_packed_bwd``, :593) on the packed (nWB, N, 3C) qkv
projection, and of ``window_attention_kernel`` (:323) and its custom VJP
(``_bwd``, :285) on split q, k, v, each (nWB, H, N, D).
``window_attention_packed`` and ``window_attention_split`` are
``torch.autograd.Function``s: their forwards launch
``csrc/window_attention.cu`` for a CUDA tensor and run ``packed_heads_forward``
/ ``split_heads_forward`` for a CPU tensor; their backwards launch
``csrc/window_attention_bwd.cu`` for a CUDA tensor and run
``packed_heads_backward`` / ``split_heads_backward`` for a CPU tensor.
Nothing else selects between them. All compute, per head,

    out = softmax(exp(min(ls, log 100)) · q̂k̂ᵀ + z) · v,   q̂ = q·rsqrt(Σq² + 1e-24)

in f32 (f64 for f64 inputs on the CPU), with z = bias (H, N, N) [+ mask
(nW, N, N)] and window id = row mod nW. The split layout's contract rounds P
to v's dtype before P·v (``attn.astype(v.dtype)``); the packed one keeps P
in f32. The gradient of the logit scale is zero above the clamp, and the
mask gets none.
"""

from __future__ import annotations

import math

import torch

from hvt_torch.ops import _build

KERNEL = _build.Kernel(
    "window_attention",
    "hvt_window_attention_packed_fwd",
    [_build.P, _build.P, _build.P, _build.I, _build.P] + [_build.I] * 7 + [_build.P],
)
BWD_KERNEL = _build.Kernel(
    "window_attention_bwd",
    "hvt_window_attention_packed_bwd",
    [_build.P, _build.P, _build.P, _build.P, _build.I, _build.P, _build.P, _build.P, _build.P,
     _build.P, _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.P],
)
SPLIT_KERNEL = _build.Kernel(
    "window_attention", "hvt_window_attention_fwd",
    [_build.P] * 5 + [_build.I, _build.P] + [_build.I] * 7 + [_build.P],
)
SPLIT_BWD_KERNEL = _build.Kernel(
    "window_attention_bwd", "hvt_window_attention_bwd",
    [_build.P] * 6 + [_build.I] + [_build.P] * 7 + [_build.I] * 7 + [_build.P],
)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
SMEM_BYTES = 227 * 1024  # the H100's dynamic shared memory per block
# The tensor-core forward and backward (csrc/attention_fwd_tc.cuh,
# attention_bwd_tc.cuh): head dim and padded window they are built for, and
# blocks per launch to aim for: one wave on the H100's 132 SMs, of 3 resident
# blocks an SM for the backward (its register cap), and for the forward as
# many as its shared memory admits: 5 in bf16 (43.5 KB a block), 2 in f32
# (92.7 KB).
TC_HEAD_DIM = 32
TC_ROWS = 64
TC_BWD_BLOCKS = 396
TC_FWD_BLOCKS = {torch.bfloat16: 660, torch.float32: 264}
LOG_MAX_SCALE = math.log(100.0)


def unsupported(n: int, c: int, heads: int, backward: bool = False) -> str | None:
    """Why the forward (or the ``backward``) kernel cannot take windows of
    ``n`` tokens at width ``c`` with ``heads`` heads, or None. The forward
    runs on tensor cores at head dim TC_HEAD_DIM with the window padded to
    TC_ROWS tokens, and any other shape on CUDA cores with the head's q, k,
    v and the N x N logits in f32 shared memory (csrc/window_attention.cu
    chooses by shape), so it takes what fits there; the backward runs on
    tensor cores only."""
    if c % heads:
        return f"width {c} does not split into {heads} heads"
    d = c // heads
    if backward:
        if d != TC_HEAD_DIM or n > TC_ROWS:
            return (f"the backward kernel takes head dim {TC_HEAD_DIM} and windows of at most "
                    f"{TC_ROWS} tokens, not head dim {d} and {n} tokens")
        return None
    smem = 4 * (3 * n * (d + 1) + n * (n + 1))
    if smem > SMEM_BYTES:
        return (f"windows of {n} tokens at head dim {d} need {smem} B of shared memory "
                f"(the card has {SMEM_BYTES})")
    return None


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 arithmetic, or f64 for f64 inputs (the CPU gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def attention_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """(heads, 1, 1) logit scale → (heads,) exp(min(ls, log 100)) in f32."""
    ls = logit_scale.to(_acc_dtype(logit_scale))
    return torch.exp(torch.clamp(ls, max=LOG_MAX_SCALE)).reshape(-1)


def merge_bias_mask(bias: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """(H, N, N) bias [+ (nW, N, N) mask] → (nWZ, H, N, N) f32, nWZ ∈ {1, nW}."""
    bias = bias.to(_acc_dtype(bias))
    if mask is None:
        return bias[None].contiguous()
    return (bias[None] + mask.to(bias.dtype)[:, None]).contiguous()


def _split(qkv: torch.Tensor, heads: int):
    """(g, N, 3C) → q, k, v each (g, H, N, D) in the arithmetic dtype."""
    g, n, c3 = qkv.shape
    c = c3 // 3
    return qkv.to(_acc_dtype(qkv)).reshape(g, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)


def _normalize(x: torch.Tensor):
    inv = torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-24)
    return x * inv, inv


def _add_z(logits: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    g, heads, n, _ = logits.shape
    nwz = z.shape[0]
    return (logits.reshape(g // nwz, nwz, heads, n, n) + z[None]).reshape(g, heads, n, n)


def packed_heads_forward(qkv: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """The attention core on packed qkv (g, N, 3C) → (g, N, C): the plain
    version of what kernels 1 and 3 compute per (window, head). z is
    (nWZ, H, N, N) with window id = row mod nWZ."""
    g, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)
    qn, _ = _normalize(q)
    kn, _ = _normalize(k)
    logits = _add_z((qn @ kn.transpose(-1, -2)) * scale.reshape(1, heads, 1, 1), z)
    out = torch.softmax(logits, dim=-1) @ v  # (g, H, N, d)
    return out.transpose(1, 2).reshape(g, n, c3 // 3)


def _heads_backward(q, k, v, go, z: torch.Tensor, scale: torch.Tensor):
    """The core's backward on (g, H, N, D) q, k, v and dO in the arithmetic
    dtype, recomputing the forward with P in f32 (both TPU backwards do):
    (dq, dk, dv, dz (nWZ, H, N, N) summed over the windows of each window
    id, dscale (H,))."""
    g, heads, n, _ = q.shape
    nwz = z.shape[0]
    sc = scale.to(q.dtype).reshape(1, heads, 1, 1)
    qn, inv_q = _normalize(q)
    kn, inv_k = _normalize(k)
    cos = qn @ kn.transpose(-1, -2)
    attn = torch.softmax(_add_z(cos * sc, z), dim=-1)
    dv = attn.transpose(-1, -2) @ go
    dp = go @ v.transpose(-1, -2)
    ds = attn * (dp - (dp * attn).sum(-1, keepdim=True))
    dz = ds.reshape(g // nwz, nwz, heads, n, n).sum(0)
    dscale = (ds * cos).sum((0, 2, 3))
    dqn = (ds * sc) @ kn
    dkn = (ds * sc).transpose(-1, -2) @ qn
    dq = (dqn - qn * (dqn * qn).sum(-1, keepdim=True)) * inv_q
    dk = (dkn - kn * (dkn * kn).sum(-1, keepdim=True)) * inv_k
    return dq, dk, dv, dz, dscale


def packed_heads_backward(qkv: torch.Tensor, dout: torch.Tensor, z: torch.Tensor,
                          scale: torch.Tensor, heads: int):
    """Plain version of the backward kernel (hvt's ``packed_heads_backward``,
    window_attention_pallas.py:377): recomputes the forward from qkv and
    returns (dqkv (g, N, 3C) in qkv's dtype, dz (nWZ, H, N, N), dscale (H,)),
    dz summed over the windows of each window id, both f32 (f64 on f64)."""
    g, n, c3 = qkv.shape
    q, k, v = _split(qkv, heads)
    go = dout.to(q.dtype).reshape(g, n, heads, c3 // 3 // heads).transpose(1, 2)
    dq, dk, dv, dz, dscale = _heads_backward(q, k, v, go, z, scale)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(g, n, c3)
    return dqkv.to(qkv.dtype), dz, dscale


def _check(name: str, qkv: torch.Tensor, z: torch.Tensor, num_heads: int,
           backward: bool = False) -> None:
    nwb, n, c3 = qkv.shape
    why = "3C columns wanted" if c3 % 3 else unsupported(n, c3 // 3, num_heads, backward)
    if qkv.dtype not in _DTYPES or why:
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} {qkv.dtype} with {num_heads} heads: "
                         f"{why or 'bf16 or f32 wanted'}")
    if z.shape[1:] != (num_heads, n, n) or nwb % z.shape[0]:
        raise ValueError(f"{name}: z {tuple(z.shape)} vs qkv {tuple(qkv.shape)}")


def packed_forward(qkv: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """The forward on a merged z and scale: the kernel for a CUDA tensor,
    ``packed_heads_forward`` for a CPU one. Output in qkv's dtype."""
    if qkv.device.type == "cpu":
        return packed_heads_forward(qkv, z, scale, num_heads).to(qkv.dtype)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_packed: unsupported device {qkv.device}")
    z = z.to(qkv.device, torch.float32).contiguous()
    _check("window_attention_packed", qkv, z, num_heads)
    nwb, n, c3 = qkv.shape
    qkv = _aligned(qkv.contiguous())
    scale = scale.to(qkv.device, torch.float32).contiguous()
    per_block, chunks = tc_forward_chunks(nwb, z.shape[0], num_heads, qkv.dtype)
    out = torch.empty((nwb, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    KERNEL(qkv.data_ptr(), scale.data_ptr(), z.data_ptr(), z.shape[0], out.data_ptr(), nwb, n,
           c3 // 3, num_heads, per_block, chunks, _DTYPES[qkv.dtype],
           torch.cuda.current_stream(qkv.device).cuda_stream)
    return out


def tc_forward_chunks(nwb: int, nwz: int, heads: int, dtype: torch.dtype) -> tuple[int, int]:
    """(images per block, chunks) of the tensor-core forward kernel: one block
    per (chunk of images, window id, head), image b holding windows b·nwz..
    (the last one partial where nwz does not divide nwb); as many chunks as
    keep the blocks within TC_FWD_BLOCKS[dtype], one wave, so that every
    block starts at once and does the same work (at least one chunk). On
    the card half a wave ran slower and two waves no faster."""
    nb = -(-nwb // nwz)
    per_block = -(-nb // max(1, TC_FWD_BLOCKS[dtype] // (nwz * heads)))
    return per_block, -(-nb // per_block)


def tc_backward_chunks(nwb: int, nwz: int, heads: int,
                       blocks: int = TC_BWD_BLOCKS) -> tuple[int, int]:
    """(images per block, chunks) of a tensor-core backward kernel: one
    block per (chunk of images, window id, head), the chunks as few and
    long as give about ``blocks`` blocks in all (TC_BWD_BLOCKS for the
    window-attention backward's)."""
    nb = nwb // nwz
    per_block = -(-nb // max(1, round(blocks / (nwz * heads))))
    return per_block, -(-nb // per_block)


def _refuse_backward(name: str, n: int, c: int, heads: int, *inputs) -> None:
    """Raise before the forward runs where autograd would later call a
    backward kernel that cannot take the shape: CUDA inputs, grad enabled
    and one of ``inputs`` requiring it."""
    if not (inputs[0].is_cuda and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in inputs)):
        return
    why = unsupported(n, c, heads, backward=True)
    if why:
        raise ValueError(f"{name}: {why}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself where its data starts on a 16-byte boundary (the kernel's
    16-byte loads), else a copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def packed_backward(qkv: torch.Tensor, dout: torch.Tensor, z: torch.Tensor,
                    scale: torch.Tensor, num_heads: int):
    """(dqkv, dz, dscale) of the forward above: the kernel for a CUDA
    tensor, ``packed_heads_backward`` for a CPU one."""
    if qkv.device.type == "cpu":
        return packed_heads_backward(qkv, dout, z, scale, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention_packed backward: unsupported device {qkv.device}")
    z = z.to(qkv.device, torch.float32).contiguous()
    _check("window_attention_packed backward", qkv, z, num_heads, backward=True)
    nwb, n, c3 = qkv.shape
    if dout.shape != (nwb, n, c3 // 3):
        raise ValueError(f"window_attention_packed backward: dO {tuple(dout.shape)} "
                         f"vs qkv {tuple(qkv.shape)}")
    nwz = z.shape[0]
    qkv = _aligned(qkv.contiguous())
    dout = _aligned(dout.to(qkv.dtype).contiguous())
    scale = scale.to(qkv.device, torch.float32).contiguous()
    per_block, chunks = tc_backward_chunks(nwb, nwz, num_heads)
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    dz = torch.empty((nwz, num_heads, n, n), dtype=torch.float32, device=dev)
    dscale = torch.empty((num_heads,), dtype=torch.float32, device=dev)
    dz_part = torch.empty((chunks, nwz, num_heads, n, n), dtype=torch.float32, device=dev)
    ds_part = torch.empty((chunks, nwz, num_heads), dtype=torch.float32, device=dev)
    BWD_KERNEL(qkv.data_ptr(), dout.data_ptr(), scale.data_ptr(), z.data_ptr(), nwz,
               dqkv.data_ptr(), dz.data_ptr(), dscale.data_ptr(), dz_part.data_ptr(),
               ds_part.data_ptr(), nwb, n, c3 // 3, num_heads, per_block, chunks,
               _DTYPES[qkv.dtype], torch.cuda.current_stream(dev).cuda_stream)
    return dqkv, dz, dscale


class _PackedAttention(torch.autograd.Function):
    """The custom VJP of hvt's ``_packed_attention``: the forward kernel, and
    a backward that recomputes from qkv (nothing of the forward is saved
    but its inputs)."""

    @staticmethod
    def forward(ctx, qkv, logit_scale, bias, mask, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, logit_scale, bias, mask)
        return packed_forward(qkv, merge_bias_mask(bias, mask), attention_scale(logit_scale),
                              num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, logit_scale, bias, mask = ctx.saved_tensors
        scale = attention_scale(logit_scale)
        dqkv, dz, dscale = packed_backward(qkv, dout, merge_bias_mask(bias, mask), scale,
                                           ctx.num_heads)
        ls = logit_scale.to(scale.dtype).reshape(-1)
        dls = (dscale * scale * (ls < LOG_MAX_SCALE)).reshape(logit_scale.shape)
        return dqkv, dls.to(logit_scale.dtype), dz.sum(0).to(bias.dtype), None, None


def window_attention_packed(qkv, logit_scale, bias, mask=None, *, num_heads):
    """qkv (nWB, N, 3C) → (nWB, N, C), same dtype, differentiable in qkv,
    logit_scale and bias. A CPU tensor takes the plain versions; a CUDA
    tensor (bf16 or f32) takes the kernels; where it needs a gradient, a
    shape the backward kernel cannot take raises before the forward runs."""
    nwb, n, c3 = qkv.shape
    _refuse_backward("window_attention_packed", n, c3 // 3, num_heads, qkv, logit_scale, bias)
    return _PackedAttention.apply(qkv, logit_scale, bias, mask, num_heads)


def window_attention_packed_plain(qkv, logit_scale, bias, mask=None, *, num_heads):
    """Plain PyTorch version of the forward (any device); its gradient is
    torch autograd's."""
    z = merge_bias_mask(bias, mask)
    out = packed_heads_forward(qkv, z, attention_scale(logit_scale), num_heads)
    return out.to(qkv.dtype)


# ---------------------------------------------------------------------------
# Split q, k, v (hvt's ``window_attention_kernel``)
# ---------------------------------------------------------------------------


def split_heads_forward(q, k, v, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the split forward kernel (hvt's ``_attention_kernel``,
    window_attention_pallas.py:45) on q, k, v (nWB, H, N, D): P rounded to
    v's dtype before P·v, the output in q's dtype. z is (nWZ, H, N, N) with
    window id = row mod nWZ."""
    nwb, heads, n, _ = q.shape
    ad = _acc_dtype(q)
    qn, _ = _normalize(q.to(ad))
    kn, _ = _normalize(k.to(ad))
    zw = z.to(ad)[torch.arange(nwb, device=z.device) % z.shape[0]]
    p = torch.softmax((qn @ kn.transpose(-1, -2)) * scale.to(ad).reshape(1, heads, 1, 1) + zw, -1)
    return (p.to(v.dtype).to(ad) @ v.to(ad)).to(q.dtype)


def split_heads_backward(q, k, v, dout, z: torch.Tensor, scale: torch.Tensor):
    """Plain version of the split backward kernel (hvt's
    ``_attention_bwd_kernel``, :126, all in f32 with P unrounded) and of
    ``_bwd``'s roundings: (dq, dk, dv (nWB, H, N, D), each rounded to q's
    dtype and then to its own, as hvt's ``_backward`` outputs in q's dtype;
    dz (nWZ, H, N, N) and dscale (H,) in f32, f64 on f64)."""
    ad = _acc_dtype(q)
    dq, dk, dv, dz, dscale = _heads_backward(q.to(ad), k.to(ad), v.to(ad), dout.to(ad), z.to(ad),
                                             scale)
    return (dq.to(q.dtype), dk.to(q.dtype).to(k.dtype), dv.to(q.dtype).to(v.dtype), dz, dscale)


def _check_split(name: str, q, k, v, z: torch.Tensor, backward: bool = False) -> None:
    nwb, heads, n, d = q.shape
    why = unsupported(n, heads * d, heads, backward)
    if k.shape != q.shape or v.shape != q.shape:
        why = f"k {tuple(k.shape)} and v {tuple(v.shape)} differ from q"
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype or why:
        raise ValueError(f"{name}: q {tuple(q.shape)} {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"{why or 'one dtype, bf16 or f32, wanted'}")
    if z.shape[1:] != (heads, n, n):
        raise ValueError(f"{name}: z {tuple(z.shape)} vs q {tuple(q.shape)}")
    if backward and nwb % z.shape[0]:
        raise ValueError(f"{name}: {nwb} windows are not a whole number of images of "
                         f"{z.shape[0]} windows (q {tuple(q.shape)}, z {tuple(z.shape)})")


def split_forward(q, k, v, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The split forward on a merged z and scale: the kernel for a CUDA
    tensor, ``split_heads_forward`` for a CPU one. Output in q's dtype."""
    if q.device.type == "cpu":
        return split_heads_forward(q, k, v, z, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    z = z.to(q.device, torch.float32).contiguous()
    _check_split("window_attention", q, k, v, z)
    nwb, heads, n, d = q.shape
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    scale = scale.to(q.device, torch.float32).contiguous()
    per_block, chunks = tc_forward_chunks(nwb, z.shape[0], heads, q.dtype)
    out = torch.empty_like(q)
    SPLIT_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(), z.data_ptr(),
                 z.shape[0], out.data_ptr(), nwb, n, d, heads, per_block, chunks,
                 _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    return out


def split_backward(q, k, v, dout, z: torch.Tensor, scale: torch.Tensor):
    """(dq, dk, dv, dz, dscale) of the forward above: the kernel for a CUDA
    tensor, ``split_heads_backward`` for a CPU one. On the card a batch of
    windows that is not a whole number of images (nWB not a multiple of nWZ)
    raises: hvt falls back to its reference's VJP there, and the port has no
    such fallback on the card."""
    if q.device.type == "cpu":
        return split_heads_backward(q, k, v, dout, z, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention backward: unsupported device {q.device}")
    z = z.to(q.device, torch.float32).contiguous()
    _check_split("window_attention backward", q, k, v, z, backward=True)
    if dout.shape != q.shape:
        raise ValueError(f"window_attention backward: dO {tuple(dout.shape)} vs q "
                         f"{tuple(q.shape)}")
    nwb, heads, n, d = q.shape
    nwz = z.shape[0]
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    g = _aligned(dout.to(q.dtype).contiguous())
    scale = scale.to(q.device, torch.float32).contiguous()
    per_block, chunks = tc_backward_chunks(nwb, nwz, heads)
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dz = torch.empty((nwz, heads, n, n), dtype=torch.float32, device=dev)
    dscale = torch.empty((heads,), dtype=torch.float32, device=dev)
    dz_part = torch.empty((chunks, nwz, heads, n, n), dtype=torch.float32, device=dev)
    ds_part = torch.empty((chunks, nwz, heads), dtype=torch.float32, device=dev)
    SPLIT_BWD_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), scale.data_ptr(),
                     z.data_ptr(), nwz, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dz.data_ptr(),
                     dscale.data_ptr(), dz_part.data_ptr(), ds_part.data_ptr(), nwb, n, d, heads,
                     per_block, chunks, _DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    return dq, dk, dv, dz, dscale


class _SplitAttention(torch.autograd.Function):
    """The custom VJP of hvt's ``_window_attention``: the forward kernel,
    and a backward that recomputes from q, k, v, with ``_bwd``'s tail."""

    @staticmethod
    def forward(ctx, q, k, v, logit_scale, bias, mask):
        ctx.save_for_backward(q, k, v, logit_scale, bias, mask)
        return split_forward(q, k, v, merge_bias_mask(bias, mask), attention_scale(logit_scale))

    @staticmethod
    def backward(ctx, dout):
        q, k, v, logit_scale, bias, mask = ctx.saved_tensors
        scale = attention_scale(logit_scale)
        dq, dk, dv, dz, dscale = split_backward(q, k, v, dout, merge_bias_mask(bias, mask), scale)
        ls = logit_scale.to(scale.dtype).reshape(-1)
        dls = (dscale.to(scale.dtype) * scale * (ls < LOG_MAX_SCALE)).reshape(logit_scale.shape)
        return dq, dk, dv, dls.to(logit_scale.dtype), dz.sum(0).to(bias.dtype), None


def window_attention_split(q, k, v, logit_scale, bias, mask=None):
    """q, k, v (nWB, H, N, D) → (nWB, H, N, D) in q's dtype, differentiable
    in q, k, v, logit_scale and bias. A CPU tensor takes the plain versions
    (any dtypes, as hvt's contract); CUDA tensors, all bf16 or all f32, take
    the kernels; where they need a gradient, a shape the backward kernel
    cannot take raises before the forward runs."""
    nwb, heads, n, d = q.shape
    _refuse_backward("window_attention", n, heads * d, heads, q, k, v, logit_scale, bias)
    return _SplitAttention.apply(q, k, v, logit_scale, bias, mask)
