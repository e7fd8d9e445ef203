"""Kernels 2-5, the chunked MLP and the windowed attention half: the fused
SwinV2 block halves, forward and backward, and hvt's routing between them.

Port of ``mlp_half`` (hvt/ops/fused_halves_pallas.py:397),
``mlp_half_chunked`` (:645), ``attention_half_nhwc`` (:1491) and
``attention_half`` (:1564) with their custom VJPs (``_mlp_half_bwd`` :415,
``_mlp_chunked_bwd`` :659, ``_attn_half_nhwc_bwd`` :1444, ``_attn_half_bwd``
:1599). Each is a ``torch.autograd.Function``: the halves save only their
inputs, the chunked MLP its inputs and the pre-LN sum, as hvt's
``_mlp_chunked_fwd``. The wrappers launch, for a CUDA tensor, the MLP
half's forward and backward at both sites ``csrc/mlp.cu`` (one library, C
at run time), the attention half's forward ``csrc/fused_halves.cu``
(``fused_halves_base.cu`` at SwinV2-B's widths) and backward
``csrc/fused_halves_bwd.cu`` (``fused_halves_bwd_base.cu``), and the
windowed attention half both ways ``csrc/attention_half.cu``
(``attention_half_base.cu``), and run their plain versions for a CPU
tensor; nothing else selects between them.

The arithmetic contract is the TPU kernels': every product rounds its
operands to bf16 and accumulates in f32 (``_dot``/``_dot_t``, the weight
gradients included), exact GELU and its derivative by the A&S erf
polynomial, LayerNorm and its backward in f32 (eps 1e-5), the attention core
of kernel 1 in f32, and the optional fused residual ``x + s·branch`` with one
scale per image. The backward runs the branch on s·g (rounded to g's dtype
first in the attention half, kept in f32 in the MLP half, as hvt) and adds
the pass-through g to dx. On f64 CPU tensors the plain versions skip the
bf16 rounding, so ``torch.autograd.gradcheck`` can hold them to finite
differences.

Layouts follow hvt's public functions: x is (T, C) flat tokens for the MLP,
the NHWC map (B, H, W, C) for ``attention_half_nhwc`` and window tokens
(nWB, N, C), window id = row mod nW, for ``attention_half``, whose kernels
are the NHWC ones on another token layout (hvt's two entries share their
bodies too). hvt pads a window's N to a multiple of 8 for the TPU's tiles;
the port takes N as it is. Weights are in
nn.Linear's (out, in) layout (hvt_torch/models/convert.py maps the flax
ones), and ``dp`` is the per-image scale as a (B,) vector (hvt broadcasts it
to (B, 8, 128) for the TPU's tiling); it gets no gradient, nor does the
mask. ``attention_half_nhwc`` also takes ``shift``: shift = 0 reads x as hvt
does (already rolled); shift > 0 reads the un-rolled map, rolls by -shift on
the way in and by +shift on the way out, which the kernels fold into their
gather index, in both directions.
"""

from __future__ import annotations

import torch

from hvt_torch.ops import _build
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops.window_attention_cuda import (
    LOG_MAX_SCALE,
    _aligned,
    attention_scale,
    merge_bias_mask,
    packed_heads_backward,
    packed_heads_forward,
    tc_backward_chunks,
)

P, I = _build.P, _build.I
#: SwinV2-T's stage widths (SwinV2-S's too) and SwinV2-B's: the attention
#: half's kernels are built for these, each set from its own sources, so
#: that the two builds run side by side
TINY_WIDTHS = (96, 192, 384, 768)
BASE_WIDTHS = (128, 256, 512, 1024)
WIDTHS = TINY_WIDTHS + BASE_WIDTHS
#: The MLP kernels (``csrc/mlp.cu``, both sites, both directions) take C at
#: run time: a multiple of 32 up to MLP_MAX_WIDTH, hidden 4C. Their
#: LayerNorm passes hold a row in one warp's registers, 32 columns a
#: register, in buckets of 4, 8, 16 and 32 registers: 1024 columns at most.
MLP_MAX_WIDTH = 1024
#: the unchunked MLP backward's widest C: hvt trains C = 1024 through the
#: chunked MLP (``mlp_route``), and the card's checks hold the unchunked
#: backward at SwinV2-T's and SwinV2-B's other widths (MLP_BWD_WIDTHS)
MLP_BWD_MAX_WIDTH = 768
MLP_BWD_WIDTHS = TINY_WIDTHS + (128, 256, 512)


def _by_width(source: str, widths=WIDTHS) -> dict[int, str]:
    return {c: source if c in TINY_WIDTHS else f"{source}_base" for c in widths}


MLP_KERNEL = _build.Kernel("mlp", "hvt_mlp_half_fwd", [P] * 8 + [I] + [P] * 3 + [I] * 3 + [P])
ATTN_KERNEL = _build.Kernel(
    _by_width("fused_halves"), "hvt_attention_half_nhwc_fwd", [P] * 5 + [I] + [P] * 8 + [I] * 9 + [P]
)
MLP_BWD_KERNEL = _build.Kernel("mlp", "hvt_mlp_half_bwd", [P] * 7 + [I] + [P] * 11 + [I] * 5 + [P])
ATTN_BWD_KERNEL = _build.Kernel(
    _by_width("fused_halves_bwd"),
    "hvt_attention_half_nhwc_bwd",
    [P] * 5 + [I] + [P] * 19 + [I] * 12 + [P],
)
ATTN_WIN_KERNEL = _build.Kernel(
    _by_width("attention_half"), "hvt_attention_half_fwd", [P] * 5 + [I] + [P] * 7 + [I] * 6 + [P]
)
ATTN_WIN_BWD_KERNEL = _build.Kernel(
    _by_width("attention_half"), "hvt_attention_half_bwd", [P] * 5 + [I] + [P] * 18 + [I] * 9 + [P]
)
MLP_CHUNKED_KERNEL = _build.Kernel("mlp", "hvt_mlp_half_chunked_fwd", [P] * 11 + [I] * 3 + [P])
MLP_CHUNKED_BWD_KERNEL = _build.Kernel(
    "mlp", "hvt_mlp_half_chunked_bwd", [P] * 17 + [I] * 5 + [P]
)
#: the weight-gradient product both halves' backwards launch inside their C
#: entries, bound on its own for the tests: out = aᵀ·b over token slices
GRAD_TN_KERNEL = _build.Kernel("mlp", "hvt_grad_tn", [P] * 4 + [I] * 5 + [P])
HEAD_DIM = 32
#: rows of a block of the MLP backwards' LayerNorm kernel, and of the tiled
#: kernels' (and grad_tn's) output tiles
LN_ROWS, TILE_ROWS = 64, 128
#: CUDA's limit on gridDim.y, which holds the row tiles of the MLP's products
#: (both directions, both sites) and of the attention half's forward proj:
#: 8,388,480 token rows, a SwinV2 stage-1 map of 2,674 images at 224 px
MAX_ROW_TILES = 65535
#: the MLP forward's output tile widths: fc1's (its columns, 4C, are always a
#: multiple), and those fc2 takes (``fc2_cols``)
FC1_COLS = 128
FC2_COLS = (64, 96, 128)
#: blocks of a weight-gradient product to aim for: 8 per SM of the H100
GRAD_BLOCKS = 1056
#: blocks of the attention half's backward proj/LayerNorm kernel to aim for
#: (8 per SM), each taking a run of whole 32-row tiles
PROJ_BLOCKS = 1056
#: blocks of the attention half's two tensor-core backward kernels (attention
#: output, core) to aim for: one wave at their 2 resident blocks an SM (81 KB
#: and 115 KB of shared memory)
TC_HALF_BLOCKS = 264
#: blocks of the forward's attention-output kernel to aim for: four waves.
#: The forward sums no per-block partials, so shorter chunks cost only z's
#: reload, and they fill the card where one wave would leave it part-used
#: (the shifted stages' 192 or 288 blocks at TC_HALF_BLOCKS); chosen by
#: timing the forward at SwinV2-T's block shapes on the H100 at 264 to 4,224
TC_HALF_FWD_BLOCKS = 1056
_LN_EPS = 1e-5
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def unsupported(c: int, heads: int, n: int) -> str | None:
    """Why the attention half's kernels (forward and backward, on the NHWC
    map or on window tokens) cannot run a fused block of width ``c`` with
    ``heads`` heads and windows of ``n`` tokens, or None."""
    if c not in WIDTHS:
        return f"width {c} is not one the kernels are built for {WIDTHS}"
    if c != heads * HEAD_DIM:
        return f"head dim {c // heads} is not {HEAD_DIM}"
    if n > 64:
        return f"windows of {n} tokens are more than 64"
    return None


def mlp_width_unsupported(c: int, hidden: int) -> str | None:
    """Why the MLP kernels (both sites, forward and backward) cannot take
    width ``c`` with ``hidden`` units, or None."""
    if hidden != 4 * c:
        return f"hidden {hidden} is not 4C ({4 * c})"
    if c <= 0 or c % 32 or c > MLP_MAX_WIDTH:
        return (f"width {c}: the MLP kernels' LayerNorm passes hold a row in one warp's "
                f"registers, in buckets of at most {MLP_MAX_WIDTH // 32} registers of 32 "
                f"columns: C a multiple of 32 up to {MLP_MAX_WIDTH}")
    return None


def mlp_unsupported(c: int, hidden: int, nchunks: int, training: bool) -> str | None:
    """Why the kernels cannot run an MLP half of width ``c`` routed to
    ``nchunks`` (1: ``mlp_half``, K > 1: ``mlp_half_chunked``, 0: plain
    PyTorch, no kernel), forward or, when ``training``, forward and
    backward; or None."""
    if nchunks == 0:
        return None
    if nchunks > 1:
        return chunked_unsupported(c, hidden, nchunks)
    why = mlp_width_unsupported(c, hidden)
    if why is None and training and c > MLP_BWD_MAX_WIDTH:
        why = (f"width {c}: the unchunked MLP backward takes C up to {MLP_BWD_MAX_WIDTH} "
               "(hvt trains wider MLP halves through the chunked MLP)")
    return why


def chunked_unsupported(c: int, hidden: int, nchunks: int) -> str | None:
    """Why the chunked MLP's kernels (forward and backward) cannot run width
    ``c`` with ``hidden`` in ``nchunks`` chunks, or None."""
    why = mlp_width_unsupported(c, hidden)
    if why is None and (nchunks < 1 or hidden % nchunks or (hidden // nchunks) % 32):
        why = f"{nchunks} chunks of the hidden dim {hidden} are not multiples of 32"
    return why


# ---------------------------------------------------------------------------
# hvt's routing: which kernel takes a block's half
# ---------------------------------------------------------------------------

#: hvt's fused budget at its default, ``_fused_attn_budget_bytes``
#: (fused_halves_pallas.py:1133): it sizes the fused-residual MLP's row blocks
BUDGET_BYTES = 32 * 2**20
#: the routing threshold at hvt's defaults: ``fits_vmem`` (fused_halves_pallas.py
#: :1669) compares with max(12 MiB, budget + 8 MiB). hvt reads both from
#: environment variables for TPU experiments; the port reads none, and tests
#: patch these constants.
FITS_THRESHOLD_BYTES = max(12 * 2**20, BUDGET_BYTES + 8 * 2**20)


def fits_vmem(c: int, heads: int, n: int, mlp_hidden: int | None = None,
              train: bool = True) -> bool:
    """hvt's ``fits_vmem``: whether a fused half's resident set (weights,
    f32 weight-gradient accumulators when ``train``, live blocks) is under
    the routing threshold. It decides which kernel takes a block exactly as
    hvt decides; its bytes are the TPU kernels' VMEM, not this card's shared
    memory."""
    if mlp_hidden is not None:
        r = max(64, (512 * 96) // c)
        weights = 2 * c * mlp_hidden * 2
        grads = 2 * c * mlp_hidden * 4 if train else 0
        live = (6 if train else 3) * r * max(mlp_hidden, c) * 4
    else:
        weights = 4 * c * c * 2
        grads = 4 * c * c * 4 if train else 0
        n_rows = -(-n // 8) * 8
        n_pad = n_rows * (-(-n // 128) * 128)
        live = 8 * n_pad * 48 + 6 * 8 * n_rows * 4 * c
    return weights + grads + live < FITS_THRESHOLD_BYTES


def mlp_chunks(c: int, hidden: int, train: bool = True, cap: int = 4) -> int:
    """hvt's ``mlp_chunks``: the smallest power-of-two K ≤ ``cap`` dividing
    ``hidden`` whose chunk fits :func:`fits_vmem`; 0 if none does."""
    k = 1
    while k <= cap:
        if hidden % k == 0 and fits_vmem(c, 0, 0, mlp_hidden=hidden // k, train=train):
            return k
        k *= 2
    return 0


def mlp_route(c: int, hidden: int, train: bool, chunked: bool = True) -> int:
    """hvt's choice for a fused block's MLP half (``_mlp_half_fused``,
    hvt/models/swinv2.py:416): 1 where the unchunked half fits, else the K > 1
    of :func:`mlp_chunks` when ``chunked`` (``fuse_mlp_chunked``), else 0, the
    plain LayerNorm(MLP) (hvt's XLA fallback)."""
    if fits_vmem(c, 0, 0, mlp_hidden=hidden, train=train):
        return 1
    return mlp_chunks(c, hidden, train) if chunked else 0


def _mlp_target_rows(c: int, hidden: int) -> int:
    """hvt's ``_mlp_target_rows`` (fused_halves_pallas.py:275): the row-block
    target of the MLP kernels from the budget."""
    per_row = 4 * c + 12 * hidden + 4 * c
    weights = 2 * c * hidden * (2 + 4)
    rows = (BUDGET_BYTES - weights) // per_row
    return int(max(64, (512 * 96) // c, min(rows, 8192)))


def mlp_resid_images_per_block(t: int, tpi: int, c: int, hidden: int) -> int:
    """hvt's ``mlp_resid_images_per_block`` (fused_halves_pallas.py:288):
    images per row block of the fused-residual MLP, whole images of ``tpi``
    rows each, 8-aligned, under the row target; 0 where there is none. hvt
    fuses a block's MLP residual only where this is positive (its row blocks
    must hold whole images); elsewhere the residual and drop path run outside
    the kernel, as they do here, though this card's kernel needs no such
    blocks. At 224 px that is SwinV2's stages 3 and 4 (196 and 49 tokens)."""
    if tpi <= 0 or tpi % 8 or t % tpi:
        return 0
    b_loc = t // tpi
    target = _mlp_target_rows(c, hidden)
    if tpi > target:
        return 0
    for m in range(min(b_loc, target // tpi), 0, -1):
        if b_loc % m == 0:
            return m
    return 0


def _acc(t: torch.Tensor) -> torch.dtype:
    """f32 arithmetic, or f64 for f64 inputs (the CPU gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """An operand of hvt's ``_dot``: rounded to bf16, carried in f32; an f64
    tensor passes unrounded."""
    return t if t.dtype == torch.float64 else t.to(torch.bfloat16).float()


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz–Stegun 7.1.26 (|err| ≤ 1.5e-7), as hvt's ``_erf``."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + erf_as(x * _INV_SQRT2))


def gelu_and_grad(x: torch.Tensor):
    """(gelu(x), gelu'(x)) as hvt's ``_gelu_and_grad``: Φ(x) + x·φ(x) with the
    erf polynomial's exp(-x²/2) shared."""
    erf = erf_as(x * _INV_SQRT2)
    e = torch.exp(-0.5 * x * x)
    return 0.5 * x * (1.0 + erf), 0.5 * (1.0 + erf) + x * _INV_SQRT_2PI * e


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm over the last dim, two-pass, as hvt's ``_ln_fwd``."""
    normed, _ = _ln_stats(x)
    return normed * scale.to(x.dtype) + bias.to(x.dtype)


def _ln_stats(x: torch.Tensor):
    xc = x - x.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _LN_EPS)
    return xc * inv, inv


def _ln_bwd(g, normed, inv, scale):
    """dx of y = normed·scale + bias given g, as hvt's ``_ln_bwd``."""
    gn = g * scale.to(g.dtype)
    return (gn - gn.mean(-1, keepdim=True) - normed * (gn * normed).mean(-1, keepdim=True)) * inv


def bf16_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., K) · w (N, K)ᵀ + b with operands rounded to bf16 and f32
    accumulation — the TPU kernels' ``_dot``."""
    out = _bf16(x.to(_acc(x))) @ _bf16(w.to(_acc(x))).t()
    return out + b.to(out.dtype)


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _splits(m: int, n: int, t: int) -> int:
    """Token slices of the (m, n) weight-gradient product over t tokens:
    about GRAD_BLOCKS blocks of 128 x 64 (half as many where the kernel
    takes 128 x 128 tiles, each slice's partial then summed once), at least
    256 tokens a slice."""
    tiles = -(-m // TILE_ROWS) * -(-n // 64)
    return max(1, min(-(-GRAD_BLOCKS // tiles), t // 256))


def tc_half_fwd_chunks(nwb: int, nwz: int, heads: int) -> tuple[int, int]:
    """(per_block, chunks) of the forward's attention-output kernel for
    ``nwb`` windows of ``nwz`` window ids and ``heads`` heads: block
    (k·nwz + wz, h) takes windows u·nwz + wz, u in [k·per_block,
    min((k + 1)·per_block, nwb / nwz)), about TC_HALF_FWD_BLOCKS blocks in
    all (the backward's kernels: TC_HALF_BLOCKS, the same rule)."""
    return tc_backward_chunks(nwb, nwz, heads, TC_HALF_FWD_BLOCKS)


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs), and raises for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def weight_grad_plain(a: torch.Tensor, b: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """Plain version of ``grad_tn`` (any device): aᵀ·b in f32 for a (T, M)
    and b (T, N), (M, N), or its transpose where ``trans``."""
    out = a.float().t() @ b.float()
    return out.t() if trans else out


def weight_grad(a: torch.Tensor, b: torch.Tensor, splits: int = 1, trans: bool = False):
    """``grad_tn`` (``hvt_grad_tn``) for CUDA tensors, its plain version for
    CPU ones: aᵀ·b (M, N) in f32 for bf16 a (T, M) and b (T, N), over
    ``splits`` token slices summed in a fixed order, or its transpose (N, M)
    where ``trans``. Both halves' backwards launch the same kernel inside
    their C entries; this binding serves the tests."""
    if not _on_card("weight_grad", a):
        return weight_grad_plain(a, b, trans)
    (t, m), n = a.shape, b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.shape[0] != t or m % 8 or n % 8:
        raise ValueError(f"weight_grad: a {tuple(a.shape)} {a.dtype}, b {tuple(b.shape)} "
                         f"{b.dtype}; bf16 (T, M) and (T, N) with M and N multiples of 8 wanted")
    a, b = _aligned(a.contiguous()), _aligned(b.contiguous())
    out = torch.empty((n, m) if trans else (m, n), dtype=torch.float32, device=a.device)
    part = torch.empty(splits * m * n if splits > 1 else 1, dtype=torch.float32, device=a.device)
    GRAD_TN_KERNEL(a.data_ptr(), b.data_ptr(), out.data_ptr(), part.data_ptr(), splits, t, m, n,
                   int(trans), _stream(a))
    return out


# ---------------------------------------------------------------------------
# MLP half
# ---------------------------------------------------------------------------


def mlp_half_plain(x, w1, b1, w2, b2, lns, lnb, tpi: int = 0, dp=None):
    """Plain PyTorch version of kernel 2 (any device)."""
    hidden = gelu_as(bf16_linear(x, w1, b1))
    branch = layer_norm(bf16_linear(hidden, w2, b2), lns, lnb)
    if dp is None:
        return branch.to(x.dtype)
    s = dp.to(branch.dtype).repeat_interleave(tpi)[:, None]
    return (x.to(branch.dtype) + s * branch).to(x.dtype)


def mlp_half_backward_plain(x, w1, b1, w2, b2, lns, g, tpi: int = 0, dp=None):
    """Plain PyTorch version of kernel 4 (any device): the gradients of
    ``mlp_half_plain`` given g, recomputing the forward as ``_mlp_bwd_kernel``
    does. Returns (dx in x's dtype, dw1 (4C, C), db1, dw2 (C, 4C), db2, dlns,
    dlnb) in f32 (f64 on f64)."""
    ad = _acc(x)
    gf = g.to(ad)
    gs = gf if dp is None else dp.to(ad).repeat_interleave(tpi)[:, None] * gf
    hidden, dgelu = gelu_and_grad(bf16_linear(x, w1, b1))
    normed, inv = _ln_stats(bf16_linear(hidden, w2, b2))
    dout = _ln_bwd(gs, normed, inv, lns)
    dpre = (_bf16(dout) @ _bf16(w2.to(ad))) * dgelu
    dx = _bf16(dpre) @ _bf16(w1.to(ad))
    if dp is not None:
        dx = gf + dx
    return (dx.to(x.dtype), _bf16(dpre).t() @ _bf16(x.to(ad)), dpre.sum(0),
            _bf16(dout).t() @ _bf16(hidden), dout.sum(0), (gs * normed).sum(0), gs.sum(0))


def rows_unsupported(t: int) -> str | None:
    """Why the kernels that put TILE_ROWS-row tiles on gridDim.y cannot take
    ``t`` token rows, or None."""
    tiles = -(-t // TILE_ROWS)
    if tiles > MAX_ROW_TILES:
        return (f"{t} token rows make {tiles} row tiles of {TILE_ROWS}, past CUDA's gridDim.y "
                f"limit of {MAX_ROW_TILES}: split the batch")
    return None


def _check_rows(name: str, t: int) -> None:
    why = rows_unsupported(t)
    if why:
        raise ValueError(f"{name}: {why}")


def _check_mlp(name, x, w1, tpi, dp, training: bool = False):
    t, c = x.shape
    _check_rows(name, t)
    why = mlp_unsupported(c, w1.shape[0], 1, training)
    if x.dtype != torch.bfloat16 or w1.shape[1] != c or why:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)}: "
                         f"{why or 'bf16 x and w1 (4C, C) wanted'}")
    if dp is not None and (tpi <= 0 or t != tpi * dp.numel()):
        raise ValueError(f"{name}: {t} rows are not {dp.numel()} images of {tpi} tokens")


def _mlp_args(x, w1, b1, w2, b2, lns, dp):
    f32 = lambda v: v.to(device=x.device, dtype=torch.float32).contiguous()  # noqa: E731
    bf = lambda v: v.to(device=x.device, dtype=torch.bfloat16).contiguous()  # noqa: E731
    s = None if dp is None else f32(dp.reshape(-1))
    return [bf(w1), f32(b1), bf(w2), f32(b2), f32(lns)], f32, s


def fc2_cols(c: int) -> int:
    """fc2's output tile width for C columns, which both directions pass to
    their C entries: 128 where C is a multiple of it, else 96 where C is one
    of 96, else 64 (the last tile masked where C is not a multiple of 64)."""
    return 128 if c % 128 == 0 else 96 if c % 96 == 0 else 64


def mlp_fwd_plan(t: int, c: int) -> dict:
    """The MLP forward chain's tiles and scratch for x (T, C), as both
    forward wrappers launch it: per product, (rows, columns) of an output
    tile and the grid (column tiles, row tiles) that the C entry launches
    (fc1: h (T, 4C); fc2: the pre-LN sum (T, C), its tile width passed to
    the C entry); and the scratch (shape, dtype) of h and pre."""
    rows = -(-t // TILE_ROWS)
    bn = fc2_cols(c)
    return {"fc1": ((TILE_ROWS, FC1_COLS), (4 * c // FC1_COLS, rows)),
            "fc2": ((TILE_ROWS, bn), (-(-c // bn), rows)),
            "scratch": {"hid": ((t, 4 * c), torch.bfloat16), "pre": ((t, c), torch.float32)}}


def _mlp_fwd_scratch(x, plan: dict):
    return [torch.empty(shape, dtype=dtype, device=x.device)
            for shape, dtype in plan["scratch"].values()]


def mlp_half_forward(x, w1, b1, w2, b2, lns, lnb, tpi: int = 0, dp=None):
    """Kernel 2 (``hvt_mlp_half_fwd``: fc1, fc2, LayerNorm and residual) for
    a CUDA tensor, its plain version for a CPU one."""
    if not _on_card("mlp_half", x):
        return mlp_half_plain(x, w1, b1, w2, b2, lns, lnb, tpi, dp)
    _check_mlp("mlp_half", x, w1, tpi, dp)
    t, c = x.shape
    x = _aligned(x.contiguous())
    args, f32, s = _mlp_args(x, w1, b1, w2, b2, lns, dp)
    plan = mlp_fwd_plan(t, c)
    hid, pre = _mlp_fwd_scratch(x, plan)
    out = torch.empty_like(x)
    MLP_KERNEL(x.data_ptr(), *(a.data_ptr() for a in args), f32(lnb).data_ptr(),
               None if s is None else s.data_ptr(), max(tpi, 1), out.data_ptr(), hid.data_ptr(),
               pre.data_ptr(), plan["fc2"][0][1], t, c, _stream(x))
    return out


def mlp_half_backward(x, w1, b1, w2, b2, lns, g, tpi: int = 0, dp=None):
    """Kernel 4 (``hvt_mlp_half_bwd``) for a CUDA tensor, its plain version
    for a CPU one: (dx, dw1, db1, dw2, db2, dlns, dlnb)."""
    if not _on_card("mlp_half backward", x):
        return mlp_half_backward_plain(x, w1, b1, w2, b2, lns, g, tpi, dp)
    _check_mlp("mlp_half backward", x, w1, tpi, dp, training=True)
    t, c = x.shape
    x = _aligned(x.contiguous())
    g = _aligned(g.to(torch.bfloat16).contiguous())
    args, _, s = _mlp_args(x, w1, b1, w2, b2, lns, dp)
    out, scratch, splits = _mlp_bwd_buffers(x)
    # the f32 pre-LN sum lives in dpre's buffer (scratch[1]) until dpre is written
    MLP_BWD_KERNEL(x.data_ptr(), *(a.data_ptr() for a in args), None if s is None else s.data_ptr(),
                   max(tpi, 1), g.data_ptr(), *(b.data_ptr() for b in out + scratch), *splits,
                   fc2_cols(c), t, c, _stream(x))
    return _mlp_bwd_result(out, c)


def _mlp_bwd_buffers(x):
    """Both MLP backward launchers' outputs (dx, dw1, dw2, dsmall) and scratch
    (hid, dpre, dout, part_ln, part_h, wpart) for x (T, C), and the token
    slices of dW1 and dW2, in the C entries' order."""
    t, c = x.shape
    splits = _splits(4 * c, c, t), _splits(4 * c, c, t)  # dW2 is formed as (hᵀ·dout)ᵀ

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    out = (torch.empty_like(x), empty(4 * c, c), empty(c, 4 * c), empty(7 * c))
    scratch = (empty(t, 4 * c, dtype=x.dtype), empty(t, 4 * c, dtype=x.dtype),
               empty(t, c, dtype=x.dtype), empty(-(-t // LN_ROWS), 3 * c),
               empty(-(-t // TILE_ROWS), 4 * c),
               empty(max(splits) * 4 * c * c if max(splits) > 1 else 1))
    return out, scratch, splits


def _mlp_bwd_result(out, c: int):
    """(dx, dw1, db1, dw2, db2, dlns, dlnb) from the launchers' outputs."""
    dx, dw1, dw2, dsmall = out
    return (dx, dw1, dsmall[:4 * c], dw2, dsmall[4 * c:5 * c], dsmall[5 * c:6 * c],
            dsmall[6 * c:])


class _MlpHalf(torch.autograd.Function):
    """The custom VJP of hvt's ``mlp_half``: kernel 2 forward, kernel 4
    backward, recomputing from the saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, lns, lnb, tpi, dp):
        ctx.tpi = tpi
        ctx.save_for_backward(x, w1, b1, w2, b2, lns, dp)
        return mlp_half_forward(x, w1, b1, w2, b2, lns, lnb, tpi, dp)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, lns, dp = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dlns, dlnb = mlp_half_backward(x, w1, b1, w2, b2, lns, g,
                                                               ctx.tpi, dp)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
                dlns.to(lns.dtype), dlnb.to(lns.dtype), None, None)


def mlp_half(x, w1, b1, w2, b2, lns, lnb, tpi: int = 0, dp=None):
    """x (T, C) → LN(fc2(GELU(fc1 x))), or x + dp·branch when ``dp`` (B,)
    gives a scale per image of ``tpi`` consecutive rows. w1 (4C, C) and
    w2 (C, 4C) in nn.Linear layout. Differentiable in x and the parameters."""
    return _MlpHalf.apply(x, w1, b1, w2, b2, lns, lnb, tpi, dp)


# ---------------------------------------------------------------------------
# MLP half with the hidden dim in chunks
# ---------------------------------------------------------------------------


def _chunks(hidden: int, nchunks: int) -> int:
    if nchunks < 1 or hidden % nchunks:
        raise ValueError(f"{nchunks} chunks do not divide the hidden dim {hidden}")
    return hidden // nchunks


def mlp_half_chunked_plain(x, w1, b1, w2, b2, lns, lnb, nchunks: int):
    """Plain PyTorch version of the chunked forward (any device), as hvt's
    ``_mlp_chunk_fwd_kernel``: (branch, pre) in x's dtype, pre the pre-LN
    sum Σₖ gelu(x·W1ₖᵀ + b1ₖ)·W2ₖᵀ + b2 (f32 over the chunks) rounded to x's
    dtype; the branch is the LayerNorm of the unrounded sum."""
    hk = _chunks(w1.shape[0], nchunks)
    out = 0.0
    for k in range(nchunks):
        hid = slice(k * hk, (k + 1) * hk)
        hidden = gelu_as(bf16_linear(x, w1[hid], b1[hid]))
        out = out + _bf16(hidden) @ _bf16(w2[:, hid].to(hidden.dtype)).t()
    out = out + b2.to(out.dtype)
    return layer_norm(out, lns, lnb).to(x.dtype), out.to(x.dtype)


def mlp_half_chunked_backward_plain(x, w1, b1, w2, lns, pre, g, nchunks: int):
    """Plain PyTorch version of the chunked backward (any device), as hvt's
    ``_mlp_chunked_bwd`` and its K calls of ``_mlp_chunk_bwd_kernel``: the
    LayerNorm statistics from the saved ``pre``; per chunk, dpre and its dx
    partial rounded to x's dtype; the partials summed in f32 and rounded.
    Returns (dx in x's dtype, dw1 (4C, C), db1, dw2 (C, 4C), db2, dlns, dlnb)
    in f32 (f64 on f64)."""
    ad = _acc(x)
    hk = _chunks(w1.shape[0], nchunks)
    gf = g.to(ad)
    normed, inv = _ln_stats(pre.to(ad))
    dout = _ln_bwd(gf, normed, inv, lns)
    dx = 0.0
    dw1, db1, dw2 = [], [], []
    for k in range(nchunks):
        hid = slice(k * hk, (k + 1) * hk)
        hidden, dgelu = gelu_and_grad(bf16_linear(x, w1[hid], b1[hid]))
        dpre = (_bf16(dout) @ _bf16(w2[:, hid].to(ad))) * dgelu
        dx = dx + (_bf16(dpre) @ _bf16(w1[hid].to(ad))).to(x.dtype).to(ad)
        dw1.append(_bf16(dpre).t() @ _bf16(x.to(ad)))
        db1.append(dpre.sum(0))
        dw2.append(_bf16(dout).t() @ _bf16(hidden))
    return (dx.to(x.dtype), torch.cat(dw1), torch.cat(db1), torch.cat(dw2, 1), dout.sum(0),
            (gf * normed).sum(0), gf.sum(0))


def _check_chunked(name, x, w1, nchunks):
    t, c = x.shape
    _check_rows(name, t)
    why = chunked_unsupported(c, w1.shape[0], nchunks)
    if x.dtype != torch.bfloat16 or w1.shape[1] != c or why:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)}, "
                         f"{nchunks} chunks: {why or 'bf16 x and w1 (4C, C) wanted'}")


def mlp_half_chunked_forward(x, w1, b1, w2, b2, lns, lnb, nchunks: int):
    """The chunked forward (``hvt_mlp_half_chunked_fwd``: the unchunked
    site's chain over the whole 4C, the pre-LN sum also stored) for a CUDA
    tensor, its plain version for a CPU one: (branch, pre). ``nchunks`` is
    checked and reaches nothing else: fc2 adds the chunks' products in f32
    as hvt's VMEM scratch does, so the result does not depend on it."""
    if not _on_card("mlp_half_chunked", x):
        return mlp_half_chunked_plain(x, w1, b1, w2, b2, lns, lnb, nchunks)
    _check_chunked("mlp_half_chunked", x, w1, nchunks)
    t, c = x.shape
    x = _aligned(x.contiguous())
    args, f32, _ = _mlp_args(x, w1, b1, w2, b2, lns, None)
    plan = mlp_fwd_plan(t, c)
    hid, pre_f32 = _mlp_fwd_scratch(x, plan)
    out, pre = torch.empty_like(x), torch.empty_like(x)
    MLP_CHUNKED_KERNEL(x.data_ptr(), *(a.data_ptr() for a in args), f32(lnb).data_ptr(),
                       out.data_ptr(), pre.data_ptr(), hid.data_ptr(), pre_f32.data_ptr(),
                       plan["fc2"][0][1], t, c, _stream(x))
    return out, pre


def mlp_half_chunked_backward(x, w1, b1, w2, lns, pre, g, nchunks: int):
    """The chunked backward kernel (``hvt_mlp_half_chunked_bwd``, one launch
    for all K chunks) for a CUDA tensor, its plain version for a CPU one:
    (dx, dw1, db1, dw2, db2, dlns, dlnb)."""
    if not _on_card("mlp_half_chunked backward", x):
        return mlp_half_chunked_backward_plain(x, w1, b1, w2, lns, pre, g, nchunks)
    _check_chunked("mlp_half_chunked backward", x, w1, nchunks)
    t, c = x.shape
    x = _aligned(x.contiguous())
    pre = _aligned(pre.to(torch.bfloat16).contiguous())
    g = _aligned(g.to(torch.bfloat16).contiguous())
    w1b, w2b = (w.to(device=x.device, dtype=torch.bfloat16).contiguous() for w in (w1, w2))
    b1f, lnsf = (v.to(device=x.device, dtype=torch.float32).contiguous() for v in (b1, lns))
    out, scratch, splits = _mlp_bwd_buffers(x)
    MLP_CHUNKED_BWD_KERNEL(
        x.data_ptr(), w1b.data_ptr(), b1f.data_ptr(), w2b.data_ptr(), lnsf.data_ptr(),
        pre.data_ptr(), g.data_ptr(), *(b.data_ptr() for b in out + scratch), *splits,
        4 * c // nchunks, t, c, _stream(x))
    return _mlp_bwd_result(out, c)


class _MlpHalfChunked(torch.autograd.Function):
    """The custom VJP of hvt's ``mlp_half_chunked``: the chunked forward
    saves (x, the weights, pre), the backward derives every gradient from
    them."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, lns, lnb, nchunks):
        ctx.nchunks = nchunks
        out, pre = mlp_half_chunked_forward(x, w1, b1, w2, b2, lns, lnb, nchunks)
        ctx.save_for_backward(x, w1, b1, w2, b2, lns, pre)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, lns, pre = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dlns, dlnb = mlp_half_chunked_backward(x, w1, b1, w2, lns, pre, g,
                                                                       ctx.nchunks)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
                dlns.to(lns.dtype), dlnb.to(lns.dtype), None)


def mlp_half_chunked(x, w1, b1, w2, b2, lns, lnb, nchunks: int):
    """x (T, C) → LN(fc2(GELU(fc1 x))) with the hidden dim in ``nchunks``
    chunks, no residual (hvt routes a block here where the unchunked MLP does
    not fit: :func:`mlp_route`). w1 (4C, C) and w2 (C, 4C) in nn.Linear
    layout. Differentiable in x and the parameters."""
    return _MlpHalfChunked.apply(x, w1, b1, w2, b2, lns, lnb, nchunks)


# ---------------------------------------------------------------------------
# Attention half on the NHWC map
# ---------------------------------------------------------------------------


def _rolled(t: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(t, (shift, shift), (1, 2)) if shift else t


def _attn_branch(xw, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb, heads: int):
    """The attention half's branch on window tokens xw (g, N, C), in the
    arithmetic dtype (f32, f64 on f64): hvt's ``_attn_half_fwd_body``."""
    qkv = bf16_linear(xw.to(_acc(xw)), wqkv, bqkv)
    z = merge_bias_mask(bias, mask).to(xw.device)
    attn = packed_heads_forward(qkv, z, attention_scale(logit_scale).to(xw.device), heads)
    return layer_norm(bf16_linear(attn, wproj, bproj), lns, lnb)


def _attn_branch_backward(xw, gw, wqkv, bqkv, scale, z, wproj, bproj, lns, heads: int):
    """The gradients of ``_attn_branch`` given gw (g, N, C), recomputing the
    forward: hvt's ``_attn_half_bwd_body``. Returns (dxw, dwqkv (3C, C),
    dbqkv, dscale (H,), dz (nWZ, H, N, N), dwproj (C, C), dbproj, dlns,
    dlnb), all in the arithmetic dtype."""
    ad = _acc(xw)
    xw = xw.to(ad)
    qkv = bf16_linear(xw, wqkv, bqkv)
    attn = packed_heads_forward(qkv, z, scale, heads)
    normed, inv = _ln_stats(bf16_linear(attn, wproj, bproj))
    dproj = _ln_bwd(gw, normed, inv, lns)
    dqkv, dz, dscale = packed_heads_backward(qkv, _bf16(dproj) @ _bf16(wproj.to(ad)), z, scale,
                                             heads)
    return (_bf16(dqkv) @ _bf16(wqkv.to(ad)), _bf16(_flat(dqkv)).t() @ _bf16(_flat(xw)),
            _flat(dqkv).sum(0), dscale, dz, _bf16(_flat(dproj)).t() @ _bf16(_flat(attn)),
            _flat(dproj).sum(0), _flat(gw * normed).sum(0), _flat(gw).sum(0))


def attention_half_nhwc_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                              window: int, heads: int, dp=None, shift: int = 0):
    """Plain PyTorch version of kernel 3 (any device)."""
    b, h, w, c = x.shape
    xs = _rolled(x, -shift)
    branch = _attn_branch(wa.window_partition(xs, window), wqkv, bqkv, logit_scale, bias, mask,
                          wproj, bproj, lns, lnb, heads)
    out = wa.window_reverse(branch, window, h, w)
    if dp is not None:
        out = xs.to(out.dtype) + dp.to(out.dtype).reshape(b, 1, 1, 1) * out
    return _rolled(out.to(x.dtype), shift)


def attention_half_nhwc_backward_plain(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g,
                                       window: int, heads: int, dp=None, shift: int = 0):
    """Plain PyTorch version of kernel 5 (any device): the gradients of
    ``attention_half_nhwc_plain`` given g, on the merged z (nWZ, H, N, N) and
    the clamped scale (H,), recomputing the forward as ``_attn_bwd_kernel_nhwc``
    does. Returns (dx in x's dtype, dwqkv (3C, C), dbqkv, dscale (H,),
    dz (nWZ, H, N, N), dwproj (C, C), dbproj, dlns, dlnb) in f32 (f64 on f64)."""
    b, h, w, c = x.shape
    ad = _acc(x)
    gr = _rolled(g, -shift).to(ad)
    # hvt rounds s·g to the activation dtype before the branch backward
    gs = gr if dp is None else (dp.to(ad).reshape(b, 1, 1, 1) * gr).to(g.dtype).to(ad)
    dxw, *grads = _attn_branch_backward(
        wa.window_partition(_rolled(x, -shift), window), wa.window_partition(gs, window), wqkv,
        bqkv, scale, z, wproj, bproj, lns, heads)
    dx = wa.window_reverse(dxw, window, h, w)
    if dp is not None:
        dx = gr + dx
    return (_rolled(dx, shift).to(x.dtype), *grads)


def _check_attn(name, x, heads, window, dp, shift):
    b, h, w, c = x.shape
    why = unsupported(c, heads, window * window)
    if h % window or w % window:
        why = "the window does not tile the map"
    if x.dtype != torch.bfloat16 or why:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, {heads} heads, window "
                         f"{window}: {why or 'bf16 wanted'}")
    if not 0 <= shift < window:
        raise ValueError(f"{name}: shift {shift} outside [0, {window})")
    if dp is not None and dp.numel() != b:
        raise ValueError(f"{name}: dp has {dp.numel()} scales for {b} images")


def _attn_args(x, wqkv, bqkv, wproj, bproj, lns, dp):
    f32 = lambda v: v.to(device=x.device, dtype=torch.float32).contiguous()  # noqa: E731
    bf = lambda v: v.to(device=x.device, dtype=torch.bfloat16).contiguous()  # noqa: E731
    s = None if dp is None else f32(dp.reshape(-1))
    return bf(wqkv), f32(bqkv), bf(wproj), f32(bproj), f32(lns), f32, s


def attention_half_nhwc_forward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                                window: int, heads: int, dp=None, shift: int = 0):
    """Kernel 3 (``hvt_attention_half_nhwc_fwd``: the attention output, proj,
    LayerNorm and residual) for a CUDA tensor, its plain version for a CPU
    one."""
    if not _on_card("attention_half_nhwc", x):
        return attention_half_nhwc_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj,
                                         lns, lnb, window, heads, dp, shift)
    name = "attention_half_nhwc"
    _check_attn(name, x, heads, window, dp, shift)
    b, h, w, c = x.shape
    _check_rows(name, b * h * w)
    nw = (h // window) * (w // window)
    z = _merged_z(name, merge_bias_mask(bias, mask), x, heads, window * window, (1, nw))
    x = _aligned(x.contiguous())
    wq, bq, wp, bp, ls, f32, s = _attn_args(x, wqkv, bqkv, wproj, bproj, lns, dp)
    out, ao, pre = _attn_fwd_buffers(x, c)
    ATTN_KERNEL(x.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                f32(attention_scale(logit_scale)).data_ptr(), z.data_ptr(), z.shape[0],
                wp.data_ptr(), bp.data_ptr(), ls.data_ptr(), f32(lnb).data_ptr(),
                None if s is None else s.data_ptr(), out.data_ptr(), ao.data_ptr(), pre.data_ptr(),
                *tc_half_fwd_chunks(b * nw, z.shape[0], heads), b, h, w, c, heads, window,
                shift, _stream(x), width=c)
    return out


def _merged_z(name, z, x, heads: int, n: int, nwz_ok) -> torch.Tensor:
    """z (nWZ, heads, N, N) as the kernels read it: f32, contiguous, on x's
    device, nWZ one of ``nwz_ok``."""
    z = z.to(x.device, torch.float32).contiguous()
    if z.shape[1:] != (heads, n, n) or z.shape[0] not in nwz_ok:
        raise ValueError(f"{name}: z {tuple(z.shape)} for windows of {n} tokens and {heads} heads "
                         f"(nWZ in {tuple(nwz_ok)})")
    return z


def _attn_fwd_buffers(x, c: int):
    """The forward launchers' output (x's shape and dtype) and scratch: the
    attention output ao (T, C) in x's dtype and the pre-LN sum (T, C) in f32,
    T = x.numel() / C, at the tokens' own rows."""
    t = x.numel() // c
    return (torch.empty_like(x), torch.empty((t, c), dtype=x.dtype, device=x.device),
            torch.empty((t, c), dtype=torch.float32, device=x.device))


def attention_half_nhwc_backward(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, window: int,
                                 heads: int, dp=None, shift: int = 0):
    """Kernel 5 (``hvt_attention_half_nhwc_bwd``) for a CUDA tensor, its plain
    version for a CPU one: (dx, dwqkv, dbqkv, dscale, dz, dwproj, dbproj,
    dlns, dlnb) on the merged z and the clamped scale."""
    if not _on_card("attention_half_nhwc backward", x):
        return attention_half_nhwc_backward_plain(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g,
                                                  window, heads, dp, shift)
    name = "attention_half_nhwc backward"
    _check_attn(name, x, heads, window, dp, shift)
    b, h, w, c = x.shape
    n, nw = window * window, (h // window) * (w // window)
    z = _merged_z(name, z, x, heads, n, (1, nw))
    nwz = z.shape[0]
    x = _aligned(x.contiguous())
    g = _aligned(g.to(torch.bfloat16).contiguous())
    wq, bq, wp, bp, ls, f32, s = _attn_args(x, wqkv, bqkv, wproj, bproj, lns, dp)
    scale = f32(scale)
    dx, out, scratch, sizes = _attn_bwd_buffers(x, b * nw, nwz, n, c, heads)
    ATTN_BWD_KERNEL(
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), scale.data_ptr(), z.data_ptr(), nwz,
        wp.data_ptr(), bp.data_ptr(), ls.data_ptr(), None if s is None else s.data_ptr(),
        g.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in out + scratch), *sizes, b, h, w,
        c, heads, window, shift, _stream(x), width=c)
    return _attn_bwd_result(dx, out, c)


def _attn_bwd_buffers(x, nwb: int, nwz: int, n: int, c: int, heads: int):
    """The backward launchers' outputs and scratch for ``nwb`` windows of
    ``n`` tokens of x: (dx, outputs (dwqkv, dwproj, dsmall, dscale, dz),
    scratch (ao, dproj, dqkv, part_a, part_b, dz_part, ds_part, wpart),
    sizes (per_block, chunks, proj_rows, splits of dWqkv and dWproj)), in
    the C entries' order."""
    t = nwb * n
    per_block, chunks = tc_backward_chunks(nwb, nwz, heads, TC_HALF_BLOCKS)
    tiles = -(-t // 32)
    proj_rows = 32 * -(-tiles // PROJ_BLOCKS)
    sq, sp = _splits(3 * c, c, t), _splits(c, c, t)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    out = (empty(3 * c, c), empty(c, c), empty(6 * c), empty(heads), empty(nwz, heads, n, n))
    scratch = (empty(t, c, dtype=x.dtype), empty(t, c, dtype=x.dtype),
               empty(t, 3 * c, dtype=x.dtype), empty(-(-t // proj_rows), 3 * c),
               empty(chunks * nwz, 3 * c), empty(chunks, nwz, heads, n, n),
               empty(chunks, nwz, heads), empty(max(sq, sp) * 3 * c * c if max(sq, sp) > 1 else 1))
    return torch.empty_like(x), out, scratch, (per_block, chunks, proj_rows, sq, sp)


def _attn_bwd_result(dx, out, c: int):
    """(dx, dwqkv, dbqkv, dscale, dz, dwproj, dbproj, dlns, dlnb) from the
    launchers' outputs."""
    dwqkv, dwproj, dsmall, dscale, dz = out
    return (dx, dwqkv, dsmall[:3 * c], dscale, dz, dwproj, dsmall[3 * c:4 * c],
            dsmall[4 * c:5 * c], dsmall[5 * c:])


class _AttnHalfNhwc(torch.autograd.Function):
    """The custom VJP of hvt's ``_attention_half_nhwc_core``: kernel 3
    forward, kernel 5 backward, recomputing from the saved inputs, with
    ``_attn_half_nhwc_bwd``'s tail: dbias = Σ dz over window ids, the logit
    scale's gradient zero above the log 100 clamp."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb, window,
                heads, dp, shift):
        ctx.window, ctx.heads, ctx.shift = window, heads, shift
        ctx.save_for_backward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, dp)
        return attention_half_nhwc_forward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj,
                                           lns, lnb, window, heads, dp, shift)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, dp = ctx.saved_tensors
        scale = attention_scale(logit_scale)
        z = merge_bias_mask(bias, mask).to(x.device)
        dx, dwqkv, dbqkv, dscale, dz, dwproj, dbproj, dlns, dlnb = attention_half_nhwc_backward(
            x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, ctx.window, ctx.heads, dp, ctx.shift)
        ls = logit_scale.to(scale.dtype).reshape(-1)
        dls = (dscale.to(scale.dtype) * scale * (ls < LOG_MAX_SCALE)).reshape(logit_scale.shape)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dls.to(logit_scale.dtype),
                dz.sum(0).to(bias.dtype), None, dwproj.to(wproj.dtype), dbproj.to(bproj.dtype),
                dlns.to(lns.dtype), dlnb.to(lns.dtype), None, None, None, None)


def attention_half_nhwc(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                        window: int, heads: int, dp=None, shift: int = 0):
    """x (B, H, W, C) → LN(proj(window attention(qkv(x)))) at every token, or
    x + dp·branch with ``dp`` (B,). wqkv (3C, C), bqkv (3C,) = [q_b, 0, v_b],
    wproj (C, C); bias (heads, N, N), mask (nW, N, N) or None.
    Differentiable in x, the weights, logit_scale and bias."""
    return _AttnHalfNhwc.apply(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                               window, heads, dp, shift)


# ---------------------------------------------------------------------------
# Attention half on window tokens
# ---------------------------------------------------------------------------


def attention_half_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                         heads: int):
    """Plain PyTorch version of the windowed forward kernel (any device): the
    branch of window tokens x (nWB, N, C), in x's dtype."""
    return _attn_branch(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                        heads).to(x.dtype)


def attention_half_backward_plain(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, heads: int):
    """Plain PyTorch version of the windowed backward kernel (any device): the
    gradients of ``attention_half_plain`` given g, on the merged z and the
    clamped scale, recomputing the forward as ``_attn_bwd_kernel`` does.
    Returns (dx in x's dtype, dwqkv (3C, C), dbqkv, dscale (H,),
    dz (nWZ, H, N, N), dwproj (C, C), dbproj, dlns, dlnb) in f32 (f64 on f64)."""
    dx, *grads = _attn_branch_backward(x, g.to(_acc(x)), wqkv, bqkv, scale, z, wproj, bproj, lns,
                                       heads)
    return (dx.to(x.dtype), *grads)


def _check_windows(name, x, heads, nwz, wqkv, wproj):
    nwb, n, c = x.shape
    why = unsupported(c, heads, n)
    if nwb % nwz:
        why = f"{nwb} windows are not a whole number of images of {nwz} windows"
    if tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c):
        why = f"wqkv {tuple(wqkv.shape)}, wproj {tuple(wproj.shape)} for width {c}"
    if x.dtype != torch.bfloat16 or why:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}, {heads} heads: "
                         f"{why or 'bf16 wanted'}")


def attention_half_forward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb,
                           heads: int):
    """The windowed forward kernels (``hvt_attention_half_fwd``, the NHWC
    half's three on window tokens) for a CUDA tensor, its plain version for a
    CPU one."""
    if not _on_card("attention_half", x):
        return attention_half_plain(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns,
                                    lnb, heads)
    name = "attention_half"
    z = merge_bias_mask(bias, mask)
    _check_windows(name, x, heads, z.shape[0], wqkv, wproj)
    nwb, n, c = x.shape
    _check_rows(name, nwb * n)
    z = _merged_z(name, z, x, heads, n, (z.shape[0],))
    x = _aligned(x.contiguous())
    wq, bq, wp, bp, ls, f32, _ = _attn_args(x, wqkv, bqkv, wproj, bproj, lns, None)
    out, ao, pre = _attn_fwd_buffers(x, c)
    ATTN_WIN_KERNEL(x.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                    f32(attention_scale(logit_scale)).data_ptr(), z.data_ptr(), z.shape[0],
                    wp.data_ptr(), bp.data_ptr(), ls.data_ptr(), f32(lnb).data_ptr(),
                    out.data_ptr(), ao.data_ptr(), pre.data_ptr(),
                    *tc_half_fwd_chunks(nwb, z.shape[0], heads), nwb, n, c, heads, _stream(x),
                    width=c)
    return out


def attention_half_backward(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, heads: int):
    """The windowed backward kernel (``hvt_attention_half_bwd``) for a CUDA
    tensor, its plain version for a CPU one: (dx, dwqkv, dbqkv, dscale, dz,
    dwproj, dbproj, dlns, dlnb) on the merged z and the clamped scale."""
    if not _on_card("attention_half backward", x):
        return attention_half_backward_plain(x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, heads)
    name = "attention_half backward"
    _check_windows(name, x, heads, z.shape[0], wqkv, wproj)
    nwb, n, c = x.shape
    z = _merged_z(name, z, x, heads, n, (z.shape[0],))
    nwz = z.shape[0]
    if g.shape != x.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)} for windows {tuple(x.shape)}")
    x = _aligned(x.contiguous())
    g = _aligned(g.to(torch.bfloat16).contiguous())
    wq, bq, wp, bp, ls, f32, _ = _attn_args(x, wqkv, bqkv, wproj, bproj, lns, None)
    scale = f32(scale)
    dx, out, scratch, sizes = _attn_bwd_buffers(x, nwb, nwz, n, c, heads)
    ATTN_WIN_BWD_KERNEL(
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), scale.data_ptr(), z.data_ptr(), nwz,
        wp.data_ptr(), bp.data_ptr(), ls.data_ptr(), g.data_ptr(), dx.data_ptr(),
        *(t.data_ptr() for t in out + scratch), *sizes, nwb, n, c, heads, _stream(x), width=c)
    return _attn_bwd_result(dx, out, c)


class _AttnHalf(torch.autograd.Function):
    """The custom VJP of hvt's ``_attention_half_core``: the windowed forward
    kernel, the windowed backward kernel recomputing from the saved inputs,
    with ``_attn_half_bwd``'s tail: dbias = Σ dz over window ids, the logit
    scale's gradient zero above the log 100 clamp, no gradient for the mask."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb, heads):
        ctx.heads = heads
        ctx.save_for_backward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns)
        return attention_half_forward(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns,
                                      lnb, heads)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns = ctx.saved_tensors
        scale = attention_scale(logit_scale)
        z = merge_bias_mask(bias, mask).to(x.device)
        dx, dwqkv, dbqkv, dscale, dz, dwproj, dbproj, dlns, dlnb = attention_half_backward(
            x, wqkv, bqkv, scale, z, wproj, bproj, lns, g, ctx.heads)
        ls = logit_scale.to(scale.dtype).reshape(-1)
        dls = (dscale.to(scale.dtype) * scale * (ls < LOG_MAX_SCALE)).reshape(logit_scale.shape)
        return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dls.to(logit_scale.dtype),
                dz.sum(0).to(bias.dtype), None, dwproj.to(wproj.dtype), dbproj.to(bproj.dtype),
                dlns.to(lns.dtype), dlnb.to(lns.dtype), None)


def attention_half(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb, heads: int):
    """Window tokens x (nWB, N, C), batch-major (window id = row mod nW) →
    the branch LN(proj(window attention(qkv(x)))) (nWB, N, C) in x's dtype,
    no residual. wqkv (3C, C), bqkv (3C,) = [q_b, 0, v_b], wproj (C, C);
    bias (heads, N, N), mask (nW, N, N) or None. Differentiable in x, the
    weights, logit_scale and bias."""
    return _AttnHalf.apply(x, wqkv, bqkv, logit_scale, bias, mask, wproj, bproj, lns, lnb, heads)
