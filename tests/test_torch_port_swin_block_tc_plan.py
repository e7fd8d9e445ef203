"""The retired fused halves' tensor-core piece plan, on the CPU.

On the card, the retired halves (``swin_block_cuda.fused_attention_branch``
and ``fused_mlp_branch``, ``csrc/swin_block.cu``) run every product on bf16
tensor cores with f32 accumulation and keep f32 accuracy by these means: a
bf16 operand enters as it is (a product of two bf16 values is exact in
f32); an f32 operand enters as three bf16 pieces p0 + p1 + p2, and a
product sums the piece products of order at most 2 into one f32
accumulator, smallest first ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0);
(2, 0), (1, 0), (0, 0) where only A is f32; ``piece_terms``). qkv's rows are
gathered from the NHWC map in window-major order by the product's loader
(``Rows::src``), the attention core runs ``attention_fwd_tc.cuh``'s f32 path
on the f32 qkv (emulated by ``_plan_forward`` of
tests/test_torch_port_attention_fwd_precision.py), its f32 output enters
proj as three pieces, and the LayerNorm stores each row back to its place
in the map; fc1's GELU output is stored in W2's dtype (bf16, or three
pieces of f32). The emulation below does exactly that in plain torch: each
piece rounded to bf16, each piece product an f32 matmul of bf16-exact
values, the terms summed in the kernel's order in f32, and the rows
gathered and scattered by a copy of ``Rows::src``'s index arithmetic. The
card cannot be asked here, so this shows the plan before the card runs it.

At SwinV2-T's four stage widths (C = 96, 192, 384, 768 with 3, 6, 12, 24
heads; window 7; stages 1-3 on the map rolled by -3 with z per window, bias
+ shift mask) at batch 1, for each pair of x's and the weights' dtypes
(f32 or bf16 each), from numpy-seeded inputs, the emulation is held against
hvt's ``fused_attention_branch`` and ``fused_mlp_branch`` (the Pallas
kernels in interpret mode) within the tolerances ``chip_smoke.py`` holds
the kernels to: 1e-4·max|ref| with f32 x (f32 out, summation order only)
and 2e-2 with bf16 x (the output rounded to bf16 on both sides). The MLP
with f32 x and bf16 weights rounds its f32 GELU output h to bf16 on both
sides, by contract: where the two sides' f32 sums of fc1 straddle a
rounding boundary (73-161 of 0.15-1.2 M values here), h differs by one
bf16 ulp, which moves its row's pre-LN sum by |w2|·ulp(h). Any f32 fc1 in
another order does the same (the port's plain version lands 1.7e-4 from
hvt's at stage 4), so that pair's MLP is held to 2e-3, below the 3e-3 that
one flip can reach (|w2| ≤ 0.23, ulp(h) ≤ 2^-7·|h| at C = 96). A control
shows that the test can fail: at stage 1, every f32 operand in two pieces
(the piece products of order at most 1) misses 1e-4, because the logit
scale (up to 100) multiplies q's and k's error.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_attention_fwd_precision as fwd_plan

from hvt.ops import swin_block_pallas as sbp
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH, WINDOW = 1, 7
N = WINDOW * WINDOW
STAGES = ((56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24))  # (grid, C, heads)
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
DT_IDS = [f"x{'f32' if a == torch.float32 else 'bf16'}-w{'f32' if b == torch.float32 else 'bf16'}"
          for a, b in DTYPES]
# piece products of order at most 2, smallest first, as csrc/swin_block.cu's piece_terms
ORDER = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _inputs(stage: int, xdt: torch.dtype, wdt: torch.dtype) -> dict:
    """One stage's block inputs in the port's layouts, each tensor holding
    the values of its dtype (x in xdt, the four weights in wdt) as f32."""
    grid, c, heads = STAGES[stage]
    shift = 3 if grid > WINDOW else 0
    rng = np.random.default_rng(200 + stage)
    ls = np.log(10.0) + rng.normal(size=heads) * 0.3
    ls[0] = 5.0  # above the log 100 clamp: the scale at its largest
    bias = torch.as_tensor(16.0 / (1.0 + np.exp(-rng.normal(size=(heads, N, N)))),
                           dtype=torch.float32)
    mask = torch.as_tensor(wa.shift_attn_mask((grid, grid), WINDOW, shift)) if shift else None

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dt).float()

    return {
        "x": t(np.roll(rng.normal(size=(BATCH, grid, grid, c)), (-shift, -shift), (1, 2)), xdt),
        "wqkv": t(rng.normal(size=(3 * c, c)) / math.sqrt(c), wdt),
        "bqkv": t(np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c),
                                  rng.normal(size=c) * 0.1])),
        "scale": torch.exp(torch.clamp(t(ls), max=math.log(100.0))).reshape(heads, 1, 1),
        "z": wac.merge_bias_mask(bias, mask),
        "wproj": t(rng.normal(size=(c, c)) / math.sqrt(c), wdt),
        "bproj": t(rng.normal(size=c) * 0.1),
        "w1": t(rng.normal(size=(4 * c, c)) / math.sqrt(c), wdt),
        "b1": t(rng.normal(size=4 * c) * 0.1),
        "w2": t(rng.normal(size=(c, 4 * c)) / math.sqrt(4 * c), wdt),
        "b2": t(rng.normal(size=c) * 0.1),
        "lns": t(1.0 + rng.normal(size=c) * 0.1),
        "lnb": t(rng.normal(size=c) * 0.1),
        "heads": heads,
    }


def _rows_src(b: int, h: int, w: int, window: int) -> torch.Tensor:
    """Rows::src of csrc/swin_block.cu for every row r of the window-major
    token order of _group_windows over b images of h x w: the NHWC row it
    reads (the qkv product's loader) and stores (the LayerNorm)."""
    r = torch.arange(b * h * w)
    n, nw = window * window, w // window
    wins = (h // window) * nw
    win, t = r // n, r % n
    img, j = win // wins, win % wins
    row = (j // nw) * window + t // window
    col = (j % nw) * window + t % window
    return (img * h + row) * w + col


def _linear(a: torch.Tensor, pa: int, w: torch.Tensor, pw: int, bias: torch.Tensor,
            terms=ORDER) -> torch.Tensor:
    """a·wᵀ + bias as the kernel's product runs it: a in pa bf16 pieces, w
    (out, in) in pw, the piece products of ``terms`` that both operands
    have, in that order, into one f32 sum."""
    A, W = fwd_plan._pieces(a, pa), fwd_plan._pieces(w, pw)
    acc = torch.zeros(a.shape[0], w.shape[0])
    for i, j in terms:
        if i < pa and j < pw:
            acc = acc + fwd_plan._mm([A[i]], [W[j].t()], ((0, 0),))
    return acc + bias


def _pieces_of(dtype: torch.dtype) -> int:
    return 3 if dtype == torch.float32 else 1


def plan_attention_branch(p: dict, xdt, wdt, terms=ORDER) -> torch.Tensor:
    """The attention branch under the plan: (B, H, W, C) in xdt; qkv and
    proj sum the piece products ``terms``."""
    x, heads = p["x"], p["heads"]
    b, h, w, c = x.shape
    src = _rows_src(b, h, w, WINDOW)
    xs = x.reshape(-1, c)[src]  # the loader's gather, window-major
    pw = _pieces_of(wdt)
    qkv = _linear(xs, _pieces_of(xdt), p["wqkv"], pw, p["bqkv"], terms).reshape(-1, N, 3 * c)
    q, k, v = (u.contiguous() for u in wa.split_heads(qkv, heads))
    core = fwd_plan._plan_forward(q, k, v, p["z"], p["scale"].reshape(-1), f32_inputs=True)
    core = core.transpose(1, 2).reshape(-1, c)  # f32 out, then three pieces into proj
    pre = _linear(core, 3, p["wproj"], pw, p["bproj"], terms)
    out = torch.empty_like(pre)
    out[src] = fh.layer_norm(pre, p["lns"], p["lnb"])  # the LayerNorm's scatter
    return out.reshape(b, h, w, c).to(xdt)


def plan_mlp_branch(p: dict, xdt, wdt) -> torch.Tensor:
    """The MLP branch under the plan: h stored in W2's dtype (bf16, or three
    pieces of f32) between the two products."""
    x = p["x"]
    c = x.shape[-1]
    pw = _pieces_of(wdt)
    hidden = fh.gelu_as(_linear(x.reshape(-1, c), _pieces_of(xdt), p["w1"], pw, p["b1"]))
    hidden = hidden.to(wdt).float()
    pre = _linear(hidden, pw, p["w2"], pw, p["b2"])
    return fh.layer_norm(pre, p["lns"], p["lnb"]).reshape(x.shape).to(xdt)


def _jnp(t: torch.Tensor, dtype: torch.dtype, transpose: bool = False):
    a = t.t() if transpose else t
    return jnp.asarray(a.contiguous().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _hvt_attention(p: dict, xdt, wdt) -> torch.Tensor:
    """hvt's fused_attention_branch (interpret mode): weights in flax's (in,
    out) layout, in their dtype; vectors f32."""
    out = sbp.fused_attention_branch(
        _jnp(p["x"], xdt), _jnp(p["wqkv"], wdt, True), _jnp(p["bqkv"], torch.float32),
        _jnp(p["scale"], torch.float32), _jnp(p["z"], torch.float32),
        _jnp(p["wproj"], wdt, True), _jnp(p["bproj"], torch.float32),
        _jnp(p["lns"], torch.float32), _jnp(p["lnb"], torch.float32),
        window=WINDOW, num_heads=p["heads"], interpret=True)
    return torch.as_tensor(np.array(out.astype(jnp.float32)))


def _hvt_mlp(p: dict, xdt, wdt) -> torch.Tensor:
    out = sbp.fused_mlp_branch(
        _jnp(p["x"], xdt), _jnp(p["w1"], wdt, True), _jnp(p["b1"], torch.float32),
        _jnp(p["w2"], wdt, True), _jnp(p["b2"], torch.float32),
        _jnp(p["lns"], torch.float32), _jnp(p["lnb"], torch.float32), interpret=True)
    return torch.as_tensor(np.array(out.astype(jnp.float32)))


def _tol(xdt, wdt=None) -> float:
    """The bound on max|Δ|/max|ref|; ``wdt`` for the MLP, whose f32 x with
    bf16 weights rounds h to bf16 (the module docstring)."""
    if (xdt, wdt) == (torch.float32, torch.bfloat16):
        return 2e-3
    return 1e-4 if xdt == torch.float32 else 2e-2


def test_rows_src_is_group_windows():
    """The index arithmetic of Rows::src is _group_windows' order: the port's
    window_partition of a map of row ids."""
    b, h, w = 2, 14, 21
    ids = torch.arange(b * h * w, dtype=torch.float64).reshape(b, h, w, 1)
    want = wa.window_partition(ids, WINDOW).reshape(-1).long()
    assert torch.equal(_rows_src(b, h, w, WINDOW), want)


@pytest.mark.parametrize("xdt,wdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("stage", range(4), ids=[f"stage{s + 1}" for s in range(4)])
def test_attention_plan_matches_hvt(stage, xdt, wdt):
    p = _inputs(stage, xdt, wdt)
    got = plan_attention_branch(p, xdt, wdt)
    assert got.dtype == xdt
    err = fwd_plan._rel_err(got.float(), _hvt_attention(p, xdt, wdt))
    assert err <= _tol(xdt), f"stage {stage + 1}: max|Δ| = {err:.3g}·max|ref|"


@pytest.mark.parametrize("xdt,wdt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("stage", range(4), ids=[f"stage{s + 1}" for s in range(4)])
def test_mlp_plan_matches_hvt(stage, xdt, wdt):
    p = _inputs(stage, xdt, wdt)
    got = plan_mlp_branch(p, xdt, wdt)
    assert got.dtype == xdt
    err = fwd_plan._rel_err(got.float(), _hvt_mlp(p, xdt, wdt))
    assert err <= _tol(xdt, wdt), f"stage {stage + 1}: max|Δ| = {err:.3g}·max|ref|"


@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16], ids=["wf32", "wbf16"])
def test_one_piece_fewer_misses_the_f32_tolerance(monkeypatch, wdt):
    """The control, at stage 1 with f32 x (f32 out): every f32 operand in two
    bf16 pieces, not three (qkv's, the core's q, k and v, proj's), the piece
    products of order at most 1, misses 1e-4·max|ref| (about 1.3e-4, where
    three pieces land about 7e-6 from hvt's: the LayerNorm at the end
    dilutes the core's error, which the logit scale multiplies)."""
    p = _inputs(0, torch.float32, wdt)
    ref = _hvt_attention(p, torch.float32, wdt)
    three = fwd_plan._rel_err(plan_attention_branch(p, torch.float32, wdt), ref)
    assert three <= 1e-4
    pieces = fwd_plan._pieces
    monkeypatch.setattr(fwd_plan, "_pieces", lambda x, count: pieces(x, min(count, 2)))
    monkeypatch.setattr(fwd_plan, "SIX", ORDER[3:])  # the core's q·kᵀ
    err = fwd_plan._rel_err(plan_attention_branch(p, torch.float32, wdt, ORDER[3:]), ref)
    assert err > 1e-4 and err > 10 * three, f"two pieces: max|Δ| = {err:.3g}·max|ref|"
