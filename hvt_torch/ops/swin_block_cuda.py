"""The retired mega-fused SwinV2 block halves, forward only, at f32 accuracy.

Port of ``fused_attention_branch`` (hvt/ops/swin_block_pallas.py:160) and
``fused_mlp_branch`` (:244) as ``csrc/swin_block.cu``. hvt's fused block
routes through ``fused_halves_pallas`` and no longer reaches them, nor does
the port's (``hvt_torch/ops/fused_halves_cuda.py``): they are public
functions of the op layer, with their own contract, which is not the fused
halves' one:

* attention: LN(proj(cosine window attention(x·Wqkvᵀ + bqkv)) + bproj) with
  x, every weight, qkv, the core and proj all in f32: q̂ = q·rsqrt(Σq² +
  1e-24), softmax(scale·q̂k̂ᵀ + z)·v;
* MLP: LN(fc2(gelu(x·W1ᵀ + b1))) with fc1 in f32, exact GELU by the A&S erf
  polynomial, its output rounded to W2's dtype and fc2 in f32 on those
  values (a product of two bf16 values is exact in f32);
* LayerNorm in f32 (eps 1e-5), the output in x's dtype;
* no residual, no drop-path scale, no shift: the caller rolls the map and
  adds the branch;
* no gradient: hvt gives neither a VJP.

Layouts are hvt's: x (B, H, W, C) with H and W multiples of ``window``;
``scale`` the (heads, 1, 1) f32 logit scale, already exp'd and clamped
(``window_attention_cuda.attention_scale``); ``z`` the combined bias + mask
(nWin or 1, heads, N, N) (``merge_bias_mask``), indexed by the window within
the image in row-major order and broadcast when its first dim is 1; ``bqkv``
(3C,) with zeros for k. Weights are in nn.Linear's (out, in) layout: wqkv
(3C, C), wproj (C, C), w1 (hidden, C), w2 (C, hidden).

A CUDA x launches the kernel, which takes x in bf16 or f32, the weights all
bf16 or all f32, C a multiple of 32 that splits into heads whose head dim the
attention core takes (``window_attention_cuda.unsupported``) and a hidden
width that is a multiple of 32, and raises on anything else. It raises too
where grad is enabled and an input requires it. A CPU x runs the plain
version; nothing else selects between them.

On the card every product runs on bf16 tensor cores with f32 accumulation:
an f32 operand as three bf16 pieces, the piece products of order at most 2
summed (``csrc/swin_block.cu``); the attention core on tensor cores at head
dim 32 and N <= 64 (``csrc/attention_fwd_tc.cuh``). The wrapper allocates
the chain's scratch: the pieces of f32 operands, qkv and the core's output
(attention), h (MLP) and the f32 pre-LN sums.
"""

from __future__ import annotations

import torch

from hvt_torch.ops import _build
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac

P, I = _build.P, _build.I
ATTN_KERNEL = _build.Kernel(
    "swin_block", "hvt_swin_block_attention_fwd", [P] * 5 + [I] + [P] * 9 + [I] * 10 + [P]
)
MLP_KERNEL = _build.Kernel("swin_block", "hvt_swin_block_mlp_fwd", [P] * 12 + [I] * 5 + [P])
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def fused_attention_branch_plain(x, wqkv, bqkv, scale, z, wproj, bproj, lns, lnb, *,
                                 window: int, num_heads: int) -> torch.Tensor:
    """The attention branch in plain PyTorch: the TPU kernel's f32 math on
    the windows of the map in window-major order."""
    h, w = x.shape[1:3]
    xw = wa.window_partition(x.float(), window)
    qkv = xw @ wqkv.float().t() + bqkv.float()
    core = wac.packed_heads_forward(qkv, z.float(), scale.float(), num_heads)
    y = fh.layer_norm(core @ wproj.float().t() + bproj.float(), lns.float(), lnb.float())
    return wa.window_reverse(y, window, h, w).to(x.dtype)


def fused_mlp_branch_plain(x, w1, b1, w2, b2, lns, lnb) -> torch.Tensor:
    """The MLP branch in plain PyTorch. fc2 multiplies in f32 the values of
    the GELU output rounded to w2's dtype and of w2 (a torch bf16 matmul on
    the CPU would round its output)."""
    hidden = fh.gelu_as(x.float() @ w1.float().t() + b1.float())
    y = hidden.to(w2.dtype).float() @ w2.float().t() + b2.float()
    return fh.layer_norm(y, lns.float(), lnb.float()).to(x.dtype)


def _on_card(name: str, x: torch.Tensor, *inputs) -> bool:
    """As ``fused_halves_cuda._on_card`` (False for a CPU x, True for a CUDA
    one, raises for any other device), and raises where an input asks for a
    gradient the kernel cannot give."""
    if not fh._on_card(name, x):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *inputs)):
        raise RuntimeError(f"{name}: the kernel is forward only, as hvt's, and an input "
                           "requires grad; call it under torch.no_grad()")
    return True


def _check(name: str, x: torch.Tensor, weights: dict, vectors: dict) -> None:
    """Raise unless the kernel takes x, the weights {name: (tensor, shape)}
    and the f32-able vectors {name: (tensor, length)}."""
    why = None
    wdtypes = {t.dtype for t, _ in weights.values()}
    if x.dim() != 4 or x.dtype not in _DTYPES:
        why = f"x {tuple(x.shape)} {x.dtype}: (B, H, W, C) in bf16 or f32 wanted"
    elif x.shape[-1] % 32:
        why = f"width {x.shape[-1]}: a multiple of 32 wanted"
    elif len(wdtypes) != 1 or not wdtypes <= set(_DTYPES):
        why = f"weights in {sorted(map(str, wdtypes))}: all bf16 or all f32 wanted"
    for key, (t, shape) in weights.items():
        if why is None and (tuple(t.shape) != shape or t.device != x.device):
            why = f"{key} {tuple(t.shape)} on {t.device}: {shape} on {x.device} wanted"
    for key, (t, length) in vectors.items():
        if why is None and (t.numel() != length or t.device != x.device):
            why = f"{key} of {t.numel()} on {t.device}: {length} on {x.device} wanted"
    if why:
        raise ValueError(f"{name}: {why}")


def _pieces(t: torch.Tensor, numel: int) -> torch.Tensor:
    """Scratch for the three bf16 pieces of an f32 operand t of ``numel``
    values, or a placeholder the kernel does not read where t is bf16."""
    n = 3 * numel if t.dtype == torch.float32 else 1
    return torch.empty(n, dtype=torch.bfloat16, device=t.device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A per-channel operand as the kernel reads it. The caller binds the
    result to a name until the launch: a temporary would be freed before the
    kernel runs, and its memory handed to the next allocation."""
    return t.reshape(-1).to(torch.float32).contiguous()


def fused_attention_branch(x, wqkv, bqkv, scale, z, wproj, bproj, lns, lnb, *, window: int,
                           num_heads: int) -> torch.Tensor:
    """branch = LN(proj(window attention(qkv(x)))) of the (B, H, W, C) map,
    in x's dtype: ``hvt_swin_block_attention_fwd`` for a CUDA x, the plain
    version for a CPU one."""
    args = (x, wqkv, bqkv, scale, z, wproj, bproj, lns, lnb)
    if not _on_card("fused_attention_branch", *args):
        return fused_attention_branch_plain(*args, window=window, num_heads=num_heads)
    c = x.shape[-1]
    _check("fused_attention_branch", x, {"wqkv": (wqkv, (3 * c, c)), "wproj": (wproj, (c, c))},
           {"bqkv": (bqkv, 3 * c), "scale": (scale, num_heads), "bproj": (bproj, c),
            "lns": (lns, c), "lnb": (lnb, c)})
    b, h, w, _ = x.shape
    n = window * window
    n_win = (h // window) * (w // window)
    why = wac.unsupported(n, c, num_heads)
    if h % window or w % window:
        why = f"the window {window} does not tile the {h}x{w} map"
    elif (z.dim() != 4 or z.shape[0] not in (1, n_win) or tuple(z.shape[1:]) != (num_heads, n, n)
          or z.device != x.device):
        why = f"z {tuple(z.shape)} on {z.device}: (1 or {n_win}, {num_heads}, {n}, {n}) wanted"
    if why:
        raise ValueError(f"fused_attention_branch: {why}")
    x, wqkv, wproj = (wac._aligned(t.contiguous()) for t in (x, wqkv, wproj))
    z = z.to(torch.float32).contiguous()
    t = b * h * w
    qkv = torch.empty((t, 3 * c), dtype=torch.float32, device=x.device)
    attn = torch.empty((t, c), dtype=torch.float32, device=x.device)
    pieces = torch.empty((3, t, c), dtype=torch.bfloat16, device=x.device)  # x's, then attn's
    w_pieces = _pieces(wqkv, 4 * c * c)
    per_block, chunks = wac.tc_forward_chunks(t // n, z.shape[0], num_heads, torch.float32)
    bq, sc, bp, ls, lb = (_f32(v) for v in (bqkv, scale, bproj, lns, lnb))
    out = torch.empty_like(x)
    ATTN_KERNEL(x.data_ptr(), wqkv.data_ptr(), bq.data_ptr(), sc.data_ptr(), z.data_ptr(),
                z.shape[0], wproj.data_ptr(), bp.data_ptr(), ls.data_ptr(), lb.data_ptr(),
                qkv.data_ptr(), attn.data_ptr(), pieces.data_ptr(), w_pieces.data_ptr(),
                out.data_ptr(), b, h, w, c, num_heads, window, per_block, chunks,
                _DTYPES[x.dtype], _DTYPES[wqkv.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    return out


def fused_mlp_branch(x, w1, b1, w2, b2, lns, lnb) -> torch.Tensor:
    """branch = LN(fc2(gelu(fc1(x)))) of the (B, H, W, C) map, in x's dtype:
    ``hvt_swin_block_mlp_fwd`` for a CUDA x, the plain version for a CPU one."""
    args = (x, w1, b1, w2, b2, lns, lnb)
    if not _on_card("fused_mlp_branch", *args):
        return fused_mlp_branch_plain(*args)
    c = x.shape[-1]
    hid = w1.shape[0]
    _check("fused_mlp_branch", x, {"w1": (w1, (hid, c)), "w2": (w2, (c, hid))},
           {"b1": (b1, hid), "b2": (b2, c), "lns": (lns, c), "lnb": (lnb, c)})
    if hid % 32:
        raise ValueError(f"fused_mlp_branch: hidden width {hid}: a multiple of 32 wanted")
    x, w1, w2 = (wac._aligned(t.contiguous()) for t in (x, w1, w2))
    t = x.numel() // c
    x_pieces = _pieces(x, t * c)
    w_pieces = _pieces(w1, 2 * hid * c)
    # h in w2's dtype: bf16, or the three bf16 pieces of f32 h
    hidden = torch.empty((3 if w2.dtype == torch.float32 else 1, t, hid), dtype=torch.bfloat16,
                         device=x.device)
    pre = torch.empty((t, c), dtype=torch.float32, device=x.device)
    v1, v2, ls, lb = (_f32(v) for v in (b1, b2, lns, lnb))
    out = torch.empty_like(x)
    MLP_KERNEL(x.data_ptr(), w1.data_ptr(), v1.data_ptr(), w2.data_ptr(), v2.data_ptr(),
               ls.data_ptr(), lb.data_ptr(), x_pieces.data_ptr(), w_pieces.data_ptr(),
               hidden.data_ptr(), pre.data_ptr(), out.data_ptr(), t, c, hid, _DTYPES[x.dtype],
               _DTYPES[w2.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    return out
