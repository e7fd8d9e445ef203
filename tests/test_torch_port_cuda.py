"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test asks its fixture for a CUDA device and skips
where there is none (the CPU test run). On a machine with the card and the
CUDA toolkit:

    python -m pytest -q --noconftest -m gpu tests/test_torch_port_cuda.py

This file imports neither jax nor hvt, so it runs where only the port is
installed (``--noconftest`` skips tests/conftest.py, which sets up jax).
Inputs are bf16 (and f32 for the attention cores) at SwinV2-T and SwinV2-B
widths (C = 96 to 1024, head dim 32, window 7; the attention backwards
also at window 8), on every layout: packed and
split q/k/v attention, the NHWC and the windowed attention half (forward
and backward: reruns, chunk plans and x off a 16-byte boundary); kernel and
plain version share the arithmetic contract (bf16
operands, f32 accumulation, f32 softmax and LayerNorm), so they differ by
accumulation order and the odd bf16 rounding flip: max|Δ| ≤ 1e-2·max|plain|
for the attention core (1e-4 in f32), 2e-2 for the fused halves. The
BatchNorm reductions run at ResNet-50 widths (C = 64 to 2048) against f64
sums of the same inputs. The retired fused halves (``swin_block_cuda``)
compute at f32 accuracy on both sides: 1e-4·max|plain| with f32 x, 2e-2
with bf16 x (the output rounding), at every SwinV2-T and SwinV2-B block
shape and each pair of x's and the weights' dtypes. The downstream layer:
the linear probe's grid search in f32 on the card against f64 on the CPU,
the centroids (f64) against the CPU's, and ``extract_features`` on ResNet-50
and SwinV2-T fused against the plain path. Tensor parallelism's pieces run
on two gloo ranks sharing the card (``tests/torch_ddp_worker.py``): the
model group's three autograd Functions, gloo's host-staged all-gather of
CUDA tensors, and the fused MLP's kernels on weights gathered from each
rank's shards. Each test states its tolerance.
"""

import math

import numpy as np
import pytest
import torch

from hvt_torch.ops import bn_stats as bs
from hvt_torch.ops import bn_stats_cuda as bsc
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import swin_block_cuda as sb
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _params(c, heads, n, device, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "wqkv": t(rng.normal(size=(3 * c, c)) / math.sqrt(c)),
        "bqkv": t(np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1])),
        "ls": t(np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3),
        "bias": t(16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))),
        "wproj": t(rng.normal(size=(c, c)) / math.sqrt(c)),
        "bproj": t(rng.normal(size=c) * 0.1),
        "w1": t(rng.normal(size=(4 * c, c)) / math.sqrt(c)),
        "b1": t(rng.normal(size=4 * c) * 0.1),
        "w2": t(rng.normal(size=(c, 4 * c)) / math.sqrt(4 * c)),
        "b2": t(rng.normal(size=c) * 0.1),
        "lns": t(1.0 + rng.normal(size=c) * 0.1),
        "lnb": t(rng.normal(size=c) * 0.1),
        "x": t(rng.normal(size=(2, 14, 14, c))).bfloat16(),
    }


def _close(got, ref, tol, what, floor=0.0):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all(), what
    err, scale = float((got - ref).abs().max()), max(float(ref.abs().max()), floor)
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


@pytest.mark.parametrize("c,shift,dtype,tol,window", [
    (96, 3, torch.bfloat16, 1e-2, 7), (768, 0, torch.bfloat16, 1e-2, 7),
    (96, 3, torch.float32, 1e-4, 7),  # f32 in and out: summation order only
    (96, 4, torch.bfloat16, 1e-2, 8), (384, 0, torch.float32, 1e-4, 8),  # N = 64
    (192, 6, torch.bfloat16, 1e-2, 12), (192, 6, torch.float32, 1e-4, 12),  # N = 144
])
def test_window_attention_packed_kernel(cuda, c, shift, dtype, tol, window):
    """The packed forward at batch 2 against its plain version. Head dim 32
    and N <= 64 (windows 7 and 8) run the tensor-core kernel, N = 144
    (window 12) the CUDA-core one: the same tolerances."""
    heads = c // 32
    if window == 7:
        p = _params(c, heads, 49, cuda, seed=c + shift)
        mask = (torch.as_tensor(wa.shift_attn_mask((14, 14), window, shift), device=cuda)
                if shift else None)
        xw = wa.window_partition(p["x"], window)
        qkv = fh.bf16_linear(xw, p["wqkv"], p["bqkv"]).to(dtype).contiguous()
    else:
        p, mask, qkv = _window_inputs(c, window, shift, dtype, cuda, seed=c + shift)
    before = wac.KERNEL.launches
    got = wac.window_attention_packed(qkv, p["ls"], p["bias"], mask, num_heads=heads)
    torch.cuda.synchronize()
    assert wac.KERNEL.launches == before + 1 and got.dtype == dtype
    ref = wac.window_attention_packed_plain(qkv, p["ls"], p["bias"], mask, num_heads=heads)
    _close(got, ref, tol, f"packed attention C={c} window={window} {dtype}")


@pytest.mark.parametrize("split", [False, True], ids=["packed", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_window_attention_forward_kernels_are_deterministic(cuda, split, dtype):
    """Two runs of a forward kernel on the same inputs give bit-identical
    outputs, and so do inputs whose data start one element (2 bytes in bf16,
    4 in f32) past a 16-byte boundary (the wrapper copies them for the
    kernel's 16-byte loads). On split q, k, v, which may hold a batch of
    windows that is not whole images (6 windows with a 4-window mask: the
    last image partial; the packed layout refuses one), those windows get
    the bits they get in the whole batch. Stage 1's width with the shift
    mask."""
    c, heads = 96, 3
    p, mask, qkv = _window_inputs(c, 7, 3, dtype, cuda, seed=37)
    z, scale = wac.merge_bias_mask(p["bias"], mask), wac.attention_scale(p["ls"])

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    if split:
        q, k, v = (t.contiguous() for t in wa.split_heads(qkv, heads))
        runs = [lambda: wac.split_forward(q, k, v, z, scale)] * 2
        runs.append(lambda: wac.split_forward(off(q), off(k), off(v), z, scale))
        runs.append(lambda: wac.split_forward(q[:6], k[:6], v[:6], z, scale))
    else:
        runs = [lambda: wac.packed_forward(qkv, z, scale, heads)] * 2
        runs.append(lambda: wac.packed_forward(off(qkv), z, scale, heads))
    first, *others = (run() for run in runs)
    torch.cuda.synchronize()
    assert qkv.shape[0] == 8 and z.shape[0] == 4
    for other in others:
        assert torch.equal(first[:other.shape[0]], other)


@pytest.mark.parametrize("c", [96, 768, 128, 1024])
def test_mlp_half_kernel(cuda, c):
    p = _params(c, c // 32, 49, cuda, seed=c)
    x = p["x"].reshape(-1, c)
    args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    dp = torch.tensor([0.0, 1.25], device=cuda)
    before = fh.MLP_KERNEL.launches
    got, got_resid = fh.mlp_half(x, *args), fh.mlp_half(x, *args, tpi=196, dp=dp)
    torch.cuda.synchronize()
    assert fh.MLP_KERNEL.launches == before + 2
    _close(got, fh.mlp_half_plain(x, *args), 2e-2, f"mlp_half C={c}")
    _close(got_resid, fh.mlp_half_plain(x, *args, tpi=196, dp=dp), 2e-2, f"mlp_half resid C={c}")


def _mlp_inputs(c, cuda, seed, images=3):
    """Seeded MLP parameters and bf16 x of ``images`` images of 196 tokens."""
    p = _params(c, c // 32, 49, cuda, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(images * 196, c)).astype(np.float32), device=cuda)
    return x.bfloat16(), (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])


def _off(t):
    """A copy of t starting 2 bytes past a 16-byte boundary."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("c", [64, 160])
@pytest.mark.parametrize("resid", [True, False])
def test_mlp_forwards_at_run_time_widths(cuda, c, resid):
    """Both MLP forwards take C at run time: at widths no kernel was built
    for before (64; 160, not a multiple of fc2's 64- and 128-column tiles),
    588 tokens (not a multiple of the 128-row tiles), the unchunked forward
    with and without the fused residual, and the chunked one (K = 2), within
    2e-2·max|plain| (the fused halves' tolerance: bf16 operands and stores
    on both sides, another summation order); the chunked backward on its
    output too. A rerun and x 2 bytes off a 16-byte boundary give
    bit-identical outputs."""
    x, args = _mlp_inputs(c, cuda, seed=17 * c)
    extra = dict(tpi=196, dp=torch.tensor([0.0, 1.25, 1.0], device=cuda)) if resid else {}
    before = fh.MLP_KERNEL.launches, fh.MLP_CHUNKED_KERNEL.launches
    runs = [fh.mlp_half(x, *args, **extra), fh.mlp_half(x, *args, **extra),
            fh.mlp_half(_off(x), *args, **extra)]
    chunked = [fh.mlp_half_chunked_forward(x, *args, 2), fh.mlp_half_chunked_forward(_off(x), *args, 2)]
    torch.cuda.synchronize()
    assert (fh.MLP_KERNEL.launches, fh.MLP_CHUNKED_KERNEL.launches) == (before[0] + 3, before[1] + 2)
    for other in runs[1:]:
        assert torch.equal(runs[0], other)
    for a, b in zip(*chunked):
        assert torch.equal(a, b)
    _close(runs[0], fh.mlp_half_plain(x, *args, **extra), 2e-2, f"mlp_half C={c} resid={resid}")
    out, pre = chunked[0]
    ref_out, ref_pre = fh.mlp_half_chunked_plain(x, *args, 2)
    _close(out, ref_out, 2e-2, f"chunked C={c} branch")
    _close(pre, ref_pre, 2e-2, f"chunked C={c} pre")
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(c)).bfloat16()
    w1, b1, w2, _, lns, _ = args
    grads = fh.mlp_half_chunked_backward(x, w1, b1, w2, lns, pre, g, 2)
    ref = fh.mlp_half_chunked_backward_plain(x, w1, b1, w2, lns, pre, g, 2)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dlns", "dlnb"), grads, ref):
        _close(a, b, 2e-2, f"chunked C={c} {name}")


def _bf16_order(t):
    """bf16 values as integers in the order of the values they encode, so
    that neighbouring values differ by 1 (±0 both 0)."""
    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


@pytest.mark.parametrize("c", [96, 1024])
@pytest.mark.parametrize("nchunks", [2, 4])
def test_mlp_chunked_forward_is_the_unchunked_chain(cuda, monkeypatch, c, nchunks):
    """The chunked forward runs the unchunked forward's chain over the whole
    4C, its sums in f32 whatever K: its branch equals the unchunked forward's
    without residual bit for bit. Its pre is the f32 pre-LN sum (the
    kernel's own scratch) rounded once to bf16, bit for bit; that f32 sum is
    within 1e-5·max|ref| of h·W2ᵀ + b2 taken in f64 on the kernel's own bf16
    h (the same bf16 products summed in another order), so against that
    reference rounded to bf16 every element of pre whose magnitude is at
    least 1e-2·max|ref| (where the sum's error is below half a bf16 ulp) is
    within one bf16 ulp; and h within 2e-2·max|plain| of the plain GELU(fc1
    x)."""
    x, args = _mlp_inputs(c, cuda, seed=c + nchunks, images=2)
    scratch = []
    allocate = fh._mlp_fwd_scratch
    monkeypatch.setattr(fh, "_mlp_fwd_scratch", lambda *a: scratch.append(allocate(*a)) or scratch[-1])
    out, pre = fh.mlp_half_chunked_forward(x, *args, nchunks)
    hid, pre32 = scratch[-1]
    unchunked = fh.mlp_half(x, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, unchunked)
    assert torch.equal(pre, pre32.bfloat16())
    w1, b1, w2, b2 = args[:4]
    pre64 = hid.double() @ w2.bfloat16().double().t() + b2.double()
    _close(pre32, pre64, 1e-5, f"f32 pre C={c} K={nchunks}")
    big = pre64.abs() >= 1e-2 * pre64.abs().max()
    steps = (_bf16_order(pre) - _bf16_order(pre64.bfloat16())).abs()[big]
    assert int(steps.max()) <= 1, f"pre C={c} K={nchunks}: {int(steps.max())} bf16 steps apart"
    _close(hid, fh.gelu_as(fh.bf16_linear(x, w1, b1)), 2e-2, f"h C={c}")


@pytest.mark.parametrize("c,shift", [(96, 3), (96, 0), (768, 0), (128, 3), (1024, 0), (1024, 3)])
def test_attention_half_nhwc_kernel(cuda, c, shift):
    heads, window = c // 32, 7
    p = _params(c, heads, 49, cuda, seed=2 * c + shift)
    mask = torch.as_tensor(wa.shift_attn_mask((14, 14), window, shift), device=cuda) if shift else None
    args = (p["wqkv"], p["bqkv"], p["ls"], p["bias"], mask, p["wproj"], p["bproj"], p["lns"],
            p["lnb"], window, heads)
    dp = torch.tensor([0.0, 1.25], device=cuda)
    before = fh.ATTN_KERNEL.launches
    got = fh.attention_half_nhwc(p["x"], *args, shift=shift)
    got_resid = fh.attention_half_nhwc(p["x"], *args, dp=dp, shift=shift)
    torch.cuda.synchronize()
    assert fh.ATTN_KERNEL.launches == before + 2
    _close(got, fh.attention_half_nhwc_plain(p["x"], *args, shift=shift), 2e-2,
           f"attention half C={c}")
    _close(got_resid, fh.attention_half_nhwc_plain(p["x"], *args, dp=dp, shift=shift), 2e-2,
           f"attention half resid C={c}")


def _window_inputs(c, window, shift, dtype, device, seed):
    """_params for windows of window² tokens on a 2 x 2-window map per image
    (batch 2), the shift mask, and qkv projected from the partitioned map."""
    heads, n = c // 32, window * window
    p = _params(c, heads, n, device, seed)
    if window != 7:
        rng = np.random.default_rng(seed + 1)
        p["x"] = torch.as_tensor(rng.normal(size=(2, 2 * window, 2 * window, c)).astype(np.float32),
                                 device=device).bfloat16()
    p["ls"][0] = 5.0  # above the log 100 clamp
    side = 2 * window if window != 7 else 14
    mask = (torch.as_tensor(wa.shift_attn_mask((side, side), window, shift), device=device)
            if shift else None)
    qkv = fh.bf16_linear(wa.window_partition(p["x"], window), p["wqkv"], p["bqkv"]).to(dtype)
    return p, mask, qkv.contiguous()


# Stage 1 (C = 96, unshifted and shifted), stages 2-3 (C = 192, 384) and
# stage 4 (C = 768) widths at window 7, and window 8 (N = 64, the padded
# tile's full height), in bf16 and f32.
BACKWARD_CASES = [
    (96, 0, torch.bfloat16, 7), (96, 3, torch.bfloat16, 7), (768, 0, torch.bfloat16, 7),
    (96, 3, torch.float32, 7), (192, 3, torch.bfloat16, 7), (384, 0, torch.bfloat16, 7),
    (192, 3, torch.float32, 7), (384, 0, torch.float32, 7), (96, 4, torch.bfloat16, 8),
    (96, 4, torch.float32, 8), (384, 0, torch.bfloat16, 8), (384, 0, torch.float32, 8),
]


@pytest.mark.parametrize("c,shift,dtype,window", BACKWARD_CASES)
def test_window_attention_packed_backward_kernel(cuda, c, shift, dtype, window):
    """The packed backward kernel at batch 2 through the autograd Function.
    dqkv is rounded to qkv's dtype at the store: max|Δ| ≤ 1e-2·max|plain| in
    bf16, 1e-4 in f32; dbias and dlogit_scale are f32 sums over windows in
    another order: 1e-3."""
    heads, n = c // 32, window * window
    p, mask, qkv = _window_inputs(c, window, shift, dtype, cuda, seed=3 * c + shift)
    gen = torch.Generator(cuda).manual_seed(c)
    dout = torch.randn(qkv.shape[0], n, c, device=cuda, generator=gen).to(dtype)

    def grads(fn):
        leaves = [qkv.clone().requires_grad_(), p["ls"].clone().requires_grad_(),
                  p["bias"].clone().requires_grad_()]
        fn(*leaves, mask, num_heads=heads).backward(dout)
        return [t.grad for t in leaves]

    before = wac.BWD_KERNEL.launches
    dq, dls, db = grads(wac.window_attention_packed)
    torch.cuda.synchronize()
    assert wac.BWD_KERNEL.launches == before + 1
    rq, rls, rb = grads(wac.window_attention_packed_plain)  # torch autograd of the plain forward
    assert wac.BWD_KERNEL.launches == before + 1
    assert dq.dtype == dtype and dls[0].item() == 0.0
    what = f"C={c} shift={shift} window={window} {dtype}"
    _close(dq, rq, 1e-2 if dtype == torch.bfloat16 else 1e-4, f"dqkv {what}")
    _close(db, rb, 1e-3, f"dbias {what}")
    _close(dls, rls, 1e-3, f"dlogit_scale {what}")


@pytest.mark.parametrize("split", [False, True])
def test_window_attention_backward_kernels_are_deterministic(cuda, split):
    """Two runs of a backward kernel on the same inputs give bit-identical
    dz and dscale (per-chunk partials summed in a fixed order, no atomics),
    and dq, dk, dv too; so do inputs whose data start 2 bytes past a 16-byte
    boundary (the wrapper copies them for the kernel's 16-byte loads).
    Stage 1's width with the shift mask, bf16."""
    c, heads = 96, 3
    p, mask, qkv = _window_inputs(c, 7, 3, torch.bfloat16, cuda, seed=31)
    z, scale = wac.merge_bias_mask(p["bias"], mask), wac.attention_scale(p["ls"])
    gen = torch.Generator(cuda).manual_seed(5)
    dout = torch.randn(qkv.shape[0], 49, c, device=cuda, generator=gen).bfloat16()

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    if split:
        q, k, v = (t.contiguous() for t in wa.split_heads(qkv, heads))
        g = dout.reshape(q.shape[0], 49, heads, 32).transpose(1, 2).contiguous()
        runs = [lambda: wac.split_backward(q, k, v, g, z, scale)] * 2
        runs.append(lambda: wac.split_backward(off(q), off(k), off(v), off(g), z, scale))
    else:
        runs = [lambda: wac.packed_backward(qkv, dout, z, scale, heads)] * 2
        runs.append(lambda: wac.packed_backward(off(qkv), off(dout), z, scale, heads))
    first, *others = (run() for run in runs)
    torch.cuda.synchronize()
    for other in others:
        for a, b in zip(first, other):
            assert torch.equal(a, b)


def test_window_attention_backward_refuses_what_its_kernel_does_not_take(cuda):
    """The tensor-core backward takes head dim 32 and windows of at most 64
    tokens, raise naming the limits, and nothing is launched: the wrappers,
    and the public ops before their forward where a gradient is wanted. The
    forward still runs head dim 64 where none is (no_grad, or no input
    requiring one)."""
    before = wac.BWD_KERNEL.launches, wac.SPLIT_BWD_KERNEL.launches
    fwd_before = wac.KERNEL.launches, wac.SPLIT_KERNEL.launches
    limits = "head dim 32 and windows of at most 64 tokens"
    for n, c, heads in ((49, 128, 2), (81, 96, 3)):
        qkv = torch.zeros(4, n, 3 * c, device=cuda, dtype=torch.bfloat16)
        z = torch.zeros(1, heads, n, n, device=cuda)
        scale = torch.ones(heads, device=cuda)
        with pytest.raises(ValueError, match=limits):
            wac.packed_backward(qkv, qkv[..., :c], z, scale, heads)
        q = torch.zeros(4, heads, n, c // heads, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=limits):
            wac.split_backward(q, q, q, q, z, scale)
        ls = torch.zeros(heads, 1, 1, device=cuda, requires_grad=True)
        bias = torch.zeros(heads, n, n, device=cuda)
        with pytest.raises(ValueError, match=limits):
            wac.window_attention_packed(qkv, ls, bias, num_heads=heads)
        with pytest.raises(ValueError, match=limits):
            wac.window_attention_split(q, q, q.clone().requires_grad_(), ls.detach(), bias)
    assert (wac.KERNEL.launches, wac.SPLIT_KERNEL.launches) == fwd_before
    qkv = torch.zeros(4, 49, 384, device=cuda, dtype=torch.bfloat16)
    ls = torch.zeros(2, 1, 1, device=cuda, requires_grad=True)
    bias = torch.zeros(2, 49, 49, device=cuda)
    wac.packed_forward(qkv, torch.zeros(1, 2, 49, 49, device=cuda), torch.ones(2, device=cuda), 2)
    with torch.no_grad():
        wac.window_attention_packed(qkv, ls, bias, num_heads=2)
    wac.window_attention_packed(qkv, ls.detach(), bias, num_heads=2)
    assert wac.KERNEL.launches == fwd_before[0] + 3
    assert (wac.BWD_KERNEL.launches, wac.SPLIT_BWD_KERNEL.launches) == before


@pytest.mark.parametrize("c,resid", [(c, resid) for c in fh.MLP_BWD_WIDTHS + (64, 160)
                                     for resid in (True, False)])
def test_mlp_half_backward_kernel(cuda, c, resid):
    """The unchunked MLP backward at SwinV2-T's and SwinV2-B's widths, and at
    two widths of no model (it takes C at run time: 160 is not a multiple of
    its 64- and 128-column tiles), at batch 3 (588 tokens: not a multiple of the 128-row tiles, and dW1, dW2
    over 2 token slices), with and without the fused residual, one image
    dropped (s = 0) and two kept at 1/keep. Kernel and plain version share
    the contract (bf16 operands, f32 accumulation) and differ in summation
    order and the odd bf16 flip of an operand: every gradient within
    2e-2·max|plain|, the forward halves' tolerance. Two runs give
    bit-identical outputs (fixed-order sums, no atomics), and so do x and g
    starting 2 bytes past a 16-byte boundary (the wrapper copies them for
    the kernels' 16-byte loads)."""
    p = _params(c, c // 32, 49, cuda, seed=5 * c)
    rng = np.random.default_rng(c)
    x = torch.as_tensor(rng.normal(size=(3 * 196, c)).astype(np.float32), device=cuda).bfloat16()
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(c)).bfloat16()
    args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"])
    extra = dict(tpi=196, dp=torch.tensor([0.0, 1.25, 1.25], device=cuda)) if resid else {}

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    before = fh.MLP_BWD_KERNEL.launches
    got = fh.mlp_half_backward(x, *args, g, **extra)
    second = fh.mlp_half_backward(x, *args, g, **extra)
    shifted = fh.mlp_half_backward(off(x), *args, off(g), **extra)
    torch.cuda.synchronize()
    assert fh.MLP_BWD_KERNEL.launches == before + 3 and got[0].dtype == torch.bfloat16
    for a, b, d in zip(got, second, shifted):
        assert torch.equal(a, b) and torch.equal(a, d)
    ref = fh.mlp_half_backward_plain(x, *args, g, **extra)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dlns", "dlnb"), got, ref):
        _close(a, b, 2e-2, f"mlp_half C={c} resid={resid} {name}")
    if resid:  # image 0's branch is dropped: dx is the pass-through g there
        assert torch.equal(got[0][:196], g[:196])


@pytest.mark.parametrize("t,m,n,splits,trans", [
    (1000, 200, 72, 1, False), (1000, 200, 72, 3, True), (37, 8, 16, 1, False),
    (4099, 384, 96, 7, False), (4099, 96, 1536, 2, True), (777, 200, 256, 2, False),
])
def test_grad_tn_kernel(cuda, t, m, n, splits, trans):
    """The weight-gradient product both fused halves' backwards launch,
    aᵀ·b over token slices, at M, N and T that are not multiples of its
    128 x 64 and 128 x 128 tiles and 32-token steps, in one slice and in several, and
    transposed: within 1e-5·max|ref| of ``a.float().T @ b.float()`` taken in
    f64 (the kernel sums the same bf16 products in f32), bit-identical over
    two runs."""
    gen = torch.Generator(cuda).manual_seed(t + m + n)
    a = torch.randn(t, m, device=cuda, generator=gen).bfloat16()
    b = torch.randn(t, n, device=cuda, generator=gen).bfloat16()
    before = fh.GRAD_TN_KERNEL.launches
    got, again = fh.weight_grad(a, b, splits, trans), fh.weight_grad(a, b, splits, trans)
    torch.cuda.synchronize()
    assert fh.GRAD_TN_KERNEL.launches == before + 2
    ref = a.double().t() @ b.double()
    assert got.shape == (ref.t() if trans else ref).shape and torch.equal(got, again)
    _close(got, ref.t() if trans else ref, 1e-5, f"grad_tn t={t} m={m} n={n} splits={splits}")


# Every SwinV2-T and SwinV2-B width at window 7 (shifted by 3 with the mask
# or not), and window 8 (N = 64, the tensor-core tile's full height, no
# padding) shifted by 4 and not.
HALF_BACKWARD_CASES = [
    (96, 0, 7), (96, 3, 7), (192, 3, 7), (384, 0, 7), (768, 0, 7), (128, 3, 7), (256, 0, 7),
    (512, 3, 7), (1024, 0, 7), (96, 4, 8), (384, 0, 8),
]


def _half_inputs(c, window, shift, device, seed):
    """_params with x on a 2 x 2-window map per image (batch 2), head 0's
    logit scale above the log 100 clamp, the shift mask, and the drop-path
    scales 0 (image 0 dropped) and 1/keep."""
    p, mask, _ = _window_inputs(c, window, shift, torch.bfloat16, device, seed)
    return p, mask, torch.tensor([0.0, 1.25], device=device)


@pytest.mark.parametrize("c,shift,window", HALF_BACKWARD_CASES)
def test_attention_half_nhwc_backward_kernel(cuda, monkeypatch, c, shift, window):
    """Through the autograd Function at batch 2: every gradient within
    2e-2·max|plain| (as the MLP half), and head 0's logit scale, above the
    log 100 clamp, gets exactly 0."""
    heads = c // 32
    p, mask, dp = _half_inputs(c, window, shift, cuda, seed=7 * c + shift)
    g = torch.randn(p["x"].shape, device=cuda, generator=torch.Generator(cuda).manual_seed(c)).bfloat16()
    names = ("x", "wqkv", "bqkv", "ls", "bias", "wproj", "bproj", "lns", "lnb")

    def grads():
        leaves = [p[k].clone().requires_grad_() for k in names]
        x, wq, bq, ls, bias, wp, bp, lns, lnb = leaves
        out = fh.attention_half_nhwc(x, wq, bq, ls, bias, mask, wp, bp, lns, lnb, window, heads,
                                     dp=dp, shift=shift)
        out.backward(g)
        return [t.grad for t in leaves]

    before = fh.ATTN_BWD_KERNEL.launches
    got = grads()
    torch.cuda.synchronize()
    assert fh.ATTN_BWD_KERNEL.launches == before + 1 and got[0].dtype == torch.bfloat16
    assert got[3][0].item() == 0.0
    monkeypatch.setattr(fh, "attention_half_nhwc_backward", fh.attention_half_nhwc_backward_plain)
    ref = grads()
    assert fh.ATTN_BWD_KERNEL.launches == before + 1
    for name, a, b in zip(names, got, ref):
        _close(a, b, 2e-2, f"attention half C={c} shift={shift} window={window} d{name}")


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("blocks", [None, 2])
def test_attention_half_backward_kernels_chunks_and_reruns(cuda, monkeypatch, windowed, blocks):
    """Both attention-half backward wrappers at stage 1's width (C = 96, 3
    heads, shifted by 3) at batch 4: with the default grid (chunks of one
    window here) and with ``TC_HALF_BLOCKS`` = 2 (one chunk of the 4
    windows of each window id a block). Two runs give bit-identical outputs
    (per-block partials summed in a fixed order, no atomics), and so do x
    and g starting 2 bytes past a 16-byte boundary (the wrapper copies them
    for the kernels' 16-byte loads); every output within 2e-2·max|plain|."""
    c, heads, window, shift = 96, 3, 7, 3
    if blocks is not None:
        monkeypatch.setattr(fh, "TC_HALF_BLOCKS", blocks)
    p, mask, _ = _half_inputs(c, window, shift, cuda, seed=41)
    rng = np.random.default_rng(43)
    x = torch.as_tensor(rng.normal(size=(4, 14, 14, c)).astype(np.float32), device=cuda).bfloat16()
    dp = torch.tensor([0.0, 1.25, 1.25, 1.0], device=cuda)
    z, scale = wac.merge_bias_mask(p["bias"], mask), wac.attention_scale(p["ls"])
    weights = (p["wqkv"], p["bqkv"], scale, z, p["wproj"], p["bproj"], p["lns"])
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3)).bfloat16()
    if windowed:
        x, g = (wa.window_partition(torch.roll(t, (-shift, -shift), (1, 2)), window).contiguous()
                for t in (x, g))

    def run(xi, gi, fn=None):
        if windowed:
            return (fn or fh.attention_half_backward)(xi, *weights, gi, heads)
        return (fn or fh.attention_half_nhwc_backward)(xi, *weights, gi, window, heads, dp=dp,
                                                       shift=shift)

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    kernel = fh.ATTN_WIN_BWD_KERNEL if windowed else fh.ATTN_BWD_KERNEL
    before = kernel.launches
    first, second, shifted = run(x, g), run(x, g), run(off(x), off(g))
    torch.cuda.synchronize()
    assert kernel.launches == before + 3
    for a, b, d in zip(first, second, shifted):
        assert torch.equal(a, b) and torch.equal(a, d)
    ref = run(x, g, fh.attention_half_backward_plain if windowed
              else fh.attention_half_nhwc_backward_plain)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dscale", "dz", "dwproj", "dbproj", "dlns",
                           "dlnb"), first, ref):
        _close(a, b, 2e-2, f"{'windowed' if windowed else 'NHWC'} half blocks={blocks} {name}")


@pytest.mark.parametrize("windowed", [False, True])
def test_attention_half_forward_kernels_chunks_reruns_and_alignment(cuda, monkeypatch, windowed):
    """Both attention-half forward wrappers at stage 1's width (C = 96, 3
    heads, shifted by 3) at batch 4, the NHWC one with drop-path scales:
    two runs, x starting 2 bytes past a 16-byte boundary (the wrapper copies
    it for the kernels' 16-byte loads) and another chunk plan
    (``TC_HALF_FWD_BLOCKS`` = 2: one chunk of the 4 windows of each window id
    a block, against chunks of one window) all give bit-identical outputs (the
    attention output's arithmetic does not depend on the chunks); the output
    within 2e-2·max|plain|."""
    c, heads, window, shift = 96, 3, 7, 3
    p, mask, _ = _half_inputs(c, window, shift, cuda, seed=45)
    rng = np.random.default_rng(47)
    x = torch.as_tensor(rng.normal(size=(4, 14, 14, c)).astype(np.float32), device=cuda).bfloat16()
    dp = torch.tensor([0.0, 1.25, 1.25, 1.0], device=cuda)
    args = (p["wqkv"], p["bqkv"], p["ls"], p["bias"], mask, p["wproj"], p["bproj"], p["lns"],
            p["lnb"])
    if windowed:
        x = wa.window_partition(torch.roll(x, (-shift, -shift), (1, 2)), window).contiguous()

    def run(xi, fn=None):
        if windowed:
            return (fn or fh.attention_half_forward)(xi, *args, heads)
        return (fn or fh.attention_half_nhwc_forward)(xi, *args, window, heads, dp=dp, shift=shift)

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:].view(t.shape).copy_(t)

    kernel = fh.ATTN_WIN_KERNEL if windowed else fh.ATTN_KERNEL
    before = kernel.launches
    default_plan = fh.tc_half_fwd_chunks(16, 4, heads)
    first, second, shifted = run(x), run(x), run(off(x))
    monkeypatch.setattr(fh, "TC_HALF_FWD_BLOCKS", 2)
    assert fh.tc_half_fwd_chunks(16, 4, heads) != default_plan
    other_plan = run(x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 4
    for out in (second, shifted, other_plan):
        assert torch.equal(first, out)
    _close(first, run(x, fh.attention_half_plain if windowed else fh.attention_half_nhwc_plain),
           2e-2, f"{'windowed' if windowed else 'NHWC'} forward")


@pytest.mark.parametrize("nchunks", [2, 4])
def test_mlp_half_chunked_kernels(cuda, nchunks):
    """SwinV2-B's stage-4 width (C = 1024) at batch 2 (196 tokens an image):
    the chunked forward's branch and pre-LN sum and every gradient of its
    backward against the plain versions, 2e-2·max|plain| (the fused halves'
    tolerance: bf16 operands and stores on both sides, another summation
    order). One launch each, for all K chunks."""
    c = 1024
    p = _params(c, c // 32, 49, cuda, seed=11 * nchunks)
    x = p["x"].reshape(-1, c)
    g = torch.randn(x.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(9)).bfloat16()
    args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    before = fh.MLP_CHUNKED_KERNEL.launches, fh.MLP_CHUNKED_BWD_KERNEL.launches
    out, pre = fh.mlp_half_chunked_forward(x, *args, nchunks)
    grads = fh.mlp_half_chunked_backward(x, p["w1"], p["b1"], p["w2"], p["lns"], pre, g, nchunks)
    torch.cuda.synchronize()
    assert (fh.MLP_CHUNKED_KERNEL.launches, fh.MLP_CHUNKED_BWD_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    ref_out, ref_pre = fh.mlp_half_chunked_plain(x, *args, nchunks)
    _close(out, ref_out, 2e-2, f"chunked K={nchunks} branch")
    _close(pre, ref_pre, 2e-2, f"chunked K={nchunks} pre")
    ref = fh.mlp_half_chunked_backward_plain(x, p["w1"], p["b1"], p["w2"], p["lns"], pre, g,
                                             nchunks)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dlns", "dlnb"), grads, ref):
        _close(a, b, 2e-2, f"chunked K={nchunks} {name}")


@pytest.mark.parametrize("c,shift,window", HALF_BACKWARD_CASES)
def test_attention_half_windowed_kernels(cuda, monkeypatch, c, shift, window):
    """The attention half on window tokens (hvt's ``fuse_nhwc: false``
    route), forward and backward through the autograd Function, at batch 2,
    the windows partitioned from the rolled map as the model does: the
    branch and every gradient within 2e-2·max|plain| (the NHWC half's
    tolerance), and head 0's logit scale, above the log 100 clamp, gets
    exactly 0."""
    heads = c // 32
    p, mask, _ = _half_inputs(c, window, shift, cuda, seed=13 * c + shift)
    xw = wa.window_partition(torch.roll(p["x"], (-shift, -shift), (1, 2)), window).contiguous()
    g = torch.randn(xw.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(c)).bfloat16()
    names = ("x", "wqkv", "bqkv", "ls", "bias", "wproj", "bproj", "lns", "lnb")

    def run():
        leaves = [(xw if k == "x" else p[k]).clone().requires_grad_() for k in names]
        x, wq, bq, ls, bias, wp, bp, lns, lnb = leaves
        out = fh.attention_half(x, wq, bq, ls, bias, mask, wp, bp, lns, lnb, heads)
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    before = fh.ATTN_WIN_KERNEL.launches, fh.ATTN_WIN_BWD_KERNEL.launches
    got = run()
    torch.cuda.synchronize()
    assert (fh.ATTN_WIN_KERNEL.launches, fh.ATTN_WIN_BWD_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got[0].dtype == got[1].dtype == torch.bfloat16 and got[4][0].item() == 0.0
    monkeypatch.setattr(fh, "attention_half_forward", fh.attention_half_plain)
    monkeypatch.setattr(fh, "attention_half_backward", fh.attention_half_backward_plain)
    ref = run()
    assert fh.ATTN_WIN_KERNEL.launches == before[0] + 1
    for name, a, b in zip(("branch",) + tuple(f"d{k}" for k in names), got, ref):
        _close(a, b, 2e-2, f"windowed attention half C={c} shift={shift} window={window} {name}")


@pytest.mark.parametrize("c,shift,dtype,window", [
    (96, 3, torch.bfloat16, 7), (768, 0, torch.bfloat16, 7), (96, 3, torch.float32, 7),
    (384, 0, torch.float32, 7), (192, 3, torch.bfloat16, 7), (384, 0, torch.bfloat16, 7),
    (192, 3, torch.float32, 7), (96, 4, torch.bfloat16, 8), (96, 4, torch.float32, 8),
    (384, 0, torch.bfloat16, 8), (384, 0, torch.float32, 8), (192, 6, torch.bfloat16, 12),
    (192, 6, torch.float32, 12),
])
def test_window_attention_split_kernels(cuda, monkeypatch, c, shift, dtype, window):
    """hvt's op on split q, k, v (nWB, H, N, D), forward and backward through
    the split kernels, against the same autograd Function with the plain
    versions: out, dq, dk and dv within 1e-2·max|plain| in bf16 (both round
    P to bf16 before P·v, and every output at the store) and 1e-4 in f32;
    dbias and dlogit_scale, f32 sums over windows in another order, 1e-3;
    head 0's logit scale, above the clamp, gets exactly 0. Window 7 at
    SwinV2-T's four stage widths, and window 8 (N = 64); window 12 (N = 144,
    the CUDA-core forward) forward only, as the backward kernel takes at
    most 64 tokens."""
    p, mask, qkv = _window_inputs(c, window, shift, dtype, cuda, seed=17 * c + shift)
    q, k, v = (t.contiguous() for t in wa.split_heads(qkv, c // 32))
    g = torch.randn(q.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(c)).to(dtype)
    grad = window * window <= wac.TC_ROWS

    def run():
        leaves = [t.clone().requires_grad_(grad) for t in (q, k, v, p["ls"], p["bias"])]
        out = wa.window_attention(*leaves, mask)
        if not grad:
            return [out]
        out.backward(g)
        return [out.detach()] + [t.grad for t in leaves]

    before = wac.SPLIT_KERNEL.launches, wac.SPLIT_BWD_KERNEL.launches
    got = run()
    torch.cuda.synchronize()
    assert (wac.SPLIT_KERNEL.launches, wac.SPLIT_BWD_KERNEL.launches) == \
        (before[0] + 1, before[1] + grad)
    assert got[0].dtype == dtype and (not grad or (got[1].dtype == dtype and got[4][0].item() == 0.0))
    monkeypatch.setattr(wac, "split_forward", wac.split_heads_forward)
    monkeypatch.setattr(wac, "split_backward", wac.split_heads_backward)
    ref = run()
    assert wac.SPLIT_KERNEL.launches == before[0] + 1
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, b, t in zip(("out", "dq", "dk", "dv", "dlogit_scale", "dbias"), got, ref,
                             (tol, tol, tol, tol, 1e-3, 1e-3)):
        _close(a, b, t, f"split attention C={c} shift={shift} window={window} {dtype} {name}")


def test_new_layouts_refuse_what_their_kernels_do_not_take(cuda):
    """A batch of windows that is not whole images of the mask's windows:
    the split forward runs (window id = row mod nW, as hvt's), its backward
    raises naming the shape, and so does the windowed attention half."""
    q = torch.randn(6, 2, 49, 32, device=cuda, requires_grad=True)
    mask = torch.zeros(4, 49, 49, device=cuda)
    out = wa.window_attention(q, q, q, torch.zeros(2, 1, 1, device=cuda),
                              torch.zeros(2, 49, 49, device=cuda), mask)
    with pytest.raises(ValueError, match="not a whole number of images"):
        out.sum().backward()
    xw = torch.zeros(6, 49, 96, device=cuda, dtype=torch.bfloat16)
    p = _params(96, 3, 49, cuda, seed=0)
    with pytest.raises(ValueError, match="not a whole number of images"):
        fh.attention_half(xw, p["wqkv"], p["bqkv"], p["ls"], p["bias"], mask, p["wproj"],
                          p["bproj"], p["lns"], p["lnb"], 3)
    with pytest.raises(ValueError, match="width 64"):
        fh.attention_half(xw[:4, :, :64], *[p[k] for k in ("wqkv", "bqkv", "ls", "bias")], mask,
                          *[p[k] for k in ("wproj", "bproj", "lns", "lnb")], 2)


def test_kernels_refuse_unsupported_shapes(cuda):
    """A CUDA tensor the kernel does not take raises; it never falls back.
    The MLP kernels take C at run time, a multiple of 32 up to 1024 with
    hidden 4C (the unchunked backward up to 768): C = 1536 and a hidden that
    is not 4C are refused."""
    big = torch.zeros((49, 1024), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C up to 768"):  # hvt trains C = 1024 chunked
        fh.mlp_half_backward(big, torch.zeros((4096, 1024), device=cuda), *[None] * 5)
    with pytest.raises(ValueError, match="LayerNorm"):
        fh.mlp_half_chunked_forward(torch.zeros((49, 1536), device=cuda, dtype=torch.bfloat16),
                                    torch.zeros((6144, 1536), device=cuda), *[None] * 5, 2)
    with pytest.raises(ValueError, match="is not 4C"):
        fh.mlp_half(torch.zeros((49, 64), device=cuda, dtype=torch.bfloat16),
                    torch.zeros((128, 64), device=cuda), *[None] * 5)
    with pytest.raises(ValueError, match="bf16"):
        fh.mlp_half(torch.zeros((49, 96), device=cuda), torch.zeros((384, 96), device=cuda),
                    *[None] * 5)


def test_training_step_kernel_path_matches_plain_path(cuda, monkeypatch):
    """One loss and gradient of the tiny SwinV2-T geometry (embed 96, depths
    2-2, heads 3-6, window 7, 56 px, bf16 activations) from the same seeded
    weights and batch: kernel path against plain path. Loss within 1e-2
    relative; every parameter's gradient at cosine ≥ 0.99 and norm within 5%."""
    import torch.nn as nn

    from hvt_torch.models import swinv2 as tswin
    from hvt_torch.objectives import soft_cross_entropy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = tswin.SwinTransformerV2(num_classes=10, embed_dim=96, depths=(2, 2), num_heads=(3, 6),
                                    window_size=7, drop_path_rate=0.0).to(cuda).train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():  # every parameter drawn: the zero-init res-post-norm hides no branch
        for name, p in model.named_parameters():
            if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.LayerNorm) and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("logit_scale"):
                p.copy_(math.log(10.0) + 0.3 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * (p[0].numel() ** -0.5 if p.ndim > 1 else 0.1))
    x = torch.randn(8, 56, 56, 3, generator=gen).to(cuda)
    targets = torch.softmax(torch.randn(8, 10, generator=gen), -1).to(cuda)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = soft_cross_entropy(model(x), targets)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone() for n, p in model.named_parameters()}

    before = wac.BWD_KERNEL.launches
    loss, grads = loss_and_grads()
    assert wac.BWD_KERNEL.launches == before + 4  # one per block
    monkeypatch.setattr(wac, "window_attention_packed", wac.window_attention_packed_plain)
    ref_loss, ref = loss_and_grads()
    assert wac.BWD_KERNEL.launches == before + 4
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for name, g in grads.items():
        r = ref[name]
        cos = float((g * r).sum() / (g.norm() * r.norm()))
        assert cos >= 0.99 and abs(float(g.norm() / r.norm()) - 1.0) <= 0.05, (name, cos)


# bn_train's four launches on the card, and the four steps of bn_stats that
# dispatch to them (each has a ``<name>_plain`` beside it).
BN_KERNELS = (bsc.SUMS_KERNEL, bsc.NORMALIZE_KERNEL, bsc.BWD_KERNEL, bsc.DX_KERNEL)
BN_STEPS = ("bn_moments", "bn_normalize", "bn_bwd_terms", "bn_dx")
# ResNet-50's 12 BatchNorm input shapes at 224 px as (H = W, C)
RESNET50_BN_SHAPES = ((112, 64), (56, 64), (56, 256), (56, 128), (28, 128), (28, 512), (28, 256),
                      (14, 256), (14, 1024), (14, 512), (7, 512), (7, 2048))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(50176, 64), (12544, 2048), (2003, 264)])
def test_bn_channel_reduction_kernels(cuda, m, c, dtype):
    """ResNet-50 BatchNorm widths (C = 64 and 2048; 264 = 8·33 leaves a
    ragged channel tile, 2003 rows a ragged last chunk): each of Σx, Σx², Σg
    and Σg·x̂ within 1e-5 of the matching Σ|·|, per channel, of an f64 sum of
    the same inputs (f32 partials over chunks summed in a fixed order)."""
    gen = torch.Generator(cuda).manual_seed(m + c)
    x = (torch.randn(m, c, device=cuda, generator=gen) * 2.0 + 0.5).to(dtype)
    g = torch.randn(m, c, device=cuda, generator=gen).to(dtype)
    mean = torch.randn(c, device=cuda, generator=gen) * 0.5
    rstd = torch.rand(c, device=cuda, generator=gen) + 0.5
    before = bsc.SUMS_KERNEL.launches, bsc.BWD_KERNEL.launches
    got = [*bs.channel_sums(x), *bs.bn_bwd_reduce(g, x, mean, rstd)]
    torch.cuda.synchronize()
    assert (bsc.SUMS_KERNEL.launches, bsc.BWD_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    xd, gd = x.double(), g.double()
    gxh = gd * ((xd - mean.double()) * rstd.double())
    for name, a, terms in zip(("Σx", "Σx²", "Σg", "Σg·x̂"), got, (xd, xd * xd, gd, gxh)):
        assert a.dtype == torch.float32 and a.shape == (c,)
        err = (a.double() - terms.sum(0)).abs()
        assert bool((err <= 1e-5 * terms.abs().sum(0)).all()), (name, float(err.max()))


def test_bn_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        bs.channel_sums(x[:, ::2])
    with pytest.raises(ValueError, match="multiple of 8"):
        bs.channel_sums(x[:, :12].contiguous())
    with pytest.raises(ValueError, match="bf16 or f32"):
        bs.channel_sums(x.half())
    with pytest.raises(ValueError, match="one dtype"):
        bs.bn_bwd_reduce(x, x.float(), torch.zeros(128, device=cuda), torch.ones(128, device=cuda))


@pytest.mark.parametrize("m,c", [(50176, 64), (12544, 2048), (2003, 264)])
def test_bn_finish_alone_gives_the_fused_calls_bits(cuda, m, c):
    """The data-parallel route's two launches, each reduction's rows launch
    alone (``channel_partials``, ``bwd_partials``) and ``bn_finish`` on its
    (chunks, 2, C) partials, give the fused call's five rows bit for bit
    (the same partials, the same finish); the plain finish, which adds the
    parts in another order, within 1e-5·max|plain|. Each wrapper counts its
    launches; bn_finish refuses partials that are not a contiguous
    (parts, 2, C) f32 on the card, and a backward finish without rstd."""
    gen = torch.Generator(cuda).manual_seed(c)
    x = (torch.randn(m, c, device=cuda, generator=gen) * 1.5 + 0.3).bfloat16()
    g = torch.randn(m, c, device=cuda, generator=gen).bfloat16()
    scale = torch.rand(c, device=cuda, generator=gen)
    fused = bsc.channel_stats(x, 1e-5)
    mean, rstd = fused[2], fused[4]
    fused_bwd = bsc.bn_bwd_terms(g, x, mean, rstd, scale)
    before = [k.launches for k in (bsc.SUMS_KERNEL, bsc.BWD_KERNEL, bsc.FINISH_KERNEL)]
    parts = (bsc.channel_partials(x), bsc.bwd_partials(g, x, mean, rstd))
    assert parts[0].shape == (bsc.launch_plan(m, c).chunks, 2, c)
    for kind, part, ref, args, eps in ((0, parts[0], fused, (), 1e-5),
                                       (1, parts[1], fused_bwd, (rstd, scale), 0.0)):
        got = bsc.bn_finish(part, m, eps, kind, *args)
        assert torch.equal(got, ref), kind
        plain = torch.stack(bs.bn_finish_plain(part, m, eps, kind, *args))
        assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max()), kind
    after = [k.launches for k in (bsc.SUMS_KERNEL, bsc.BWD_KERNEL, bsc.FINISH_KERNEL)]
    assert after == [before[0] + 1, before[1] + 1, before[2] + 2]
    with pytest.raises(ValueError, match=r"\(parts, 2, C\) f32"):
        bsc.bn_finish(fused[:2].clone(), m, 1e-5, 0)
    with pytest.raises(ValueError, match="rstd"):
        bsc.bn_finish(parts[1], m, 0.0, 1)


@pytest.mark.parametrize("m,c", [(200704, 128), (12544, 2048)])
def test_bn_train_through_the_kernels(cuda, monkeypatch, m, c):
    """``bn_train`` in bf16 through its four kernels against the same
    Function with the four steps' plain versions: y and dx (bf16 at the
    store) within 1e-2·max|plain|, mean, var, dscale and dbias (f32 sums in
    another order) within 1e-4·max|plain|."""
    gen = torch.Generator(cuda).manual_seed(c)
    x = (torch.randn(m, c, device=cuda, generator=gen) * 1.5 + 0.3).bfloat16()
    g = torch.randn(m, c, device=cuda, generator=gen).bfloat16()
    scale = torch.rand(c, device=cuda, generator=gen)
    bias = torch.randn(c, device=cuda, generator=gen) * 0.1

    def run():
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y, mean, var = bs.bn_train(*leaves, 1e-5, torch.bfloat16)
        y.backward(g)
        return [y, mean, var] + [t.grad for t in leaves]

    before = _launches(BN_KERNELS)
    got = run()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(BN_KERNELS), before)] == [1] * 4
    for name in BN_STEPS:
        monkeypatch.setattr(bs, name, getattr(bs, f"{name}_plain"))
    ref = run()
    assert _launches(BN_KERNELS) == [b + 1 for b in before]
    assert got[0].dtype == got[3].dtype == torch.bfloat16
    for name, a, b, tol in zip(("y", "mean", "var", "dx", "dscale", "dbias"), got, ref,
                               (1e-2, 1e-4, 1e-4, 1e-2, 1e-4, 1e-4)):
        _close(a, b, tol, f"bn_train {name} ({m}, {c})")


def _bn_case(h, c, dtype, device, batch=8, seed=0):
    gen = torch.Generator(device).manual_seed(seed + 17 * c + h)
    m = batch * h * h
    x = (torch.randn(m, c, device=device, generator=gen) * 1.5
         + torch.randn(c, device=device, generator=gen)).to(dtype)
    g = torch.randn(m, c, device=device, generator=gen).to(dtype)
    scale = torch.rand(c, device=device, generator=gen)
    bias = torch.randn(c, device=device, generator=gen) * 0.1
    return x, g, scale, bias


def _within_sums(got, terms, what):
    err = (got.double() - terms.sum(0)).abs()
    bound = 1e-5 * terms.abs().sum(0)
    assert bool(torch.isfinite(got).all()) and bool((err <= bound).all()), \
        (what, float((err / bound.clamp_min(1e-300)).max()) * 1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,c", RESNET50_BN_SHAPES)
def test_bn_four_launches_against_their_plain_versions(cuda, h, c, dtype):
    """Each of bn_train's launches at ResNet-50's BatchNorm shapes, batch 8:
    the two reductions' sums within 1e-5·Σ|terms| of f64 sums of the same
    inputs, their finishes (mean, var, rstd; scale·rstd, Σg/n, Σg·x̂/n)
    within 1e-5·max|plain| of the plain formulas on those sums; the
    normalize (both output dtypes) and dx bit-equal to their plain versions
    on the same per-channel vectors (the same separately rounded f32
    operations in the same order)."""
    x, g, scale, bias = _bn_case(h, c, dtype, cuda)
    m = x.shape[0]
    before = _launches(BN_KERNELS)
    mean, var, rstd = bsc.bn_moments(x, 1e-5)
    s, q = bsc.channel_sums(x)
    ys = {d: bsc.bn_normalize(x, mean, rstd, scale, bias, d)
          for d in (torch.bfloat16, torch.float32)}
    terms = bsc.bn_bwd_terms(g, x, mean, rstd, scale)
    sg, sgx, k, m1, m2 = terms
    dx = bsc.bn_dx(g, x, mean, rstd, terms)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(BN_KERNELS), before)] == [2, 2, 1, 1]
    xd, gd = x.double(), g.double()
    gxh = gd * ((xd - mean.double()) * rstd.double())
    for name, got, exact in (("Σx", s, xd), ("Σx²", q, xd * xd), ("Σg", sg, gd),
                             ("Σg·x̂", sgx, gxh)):
        _within_sums(got, exact, f"{name} ({m}, {c}) {dtype}")
    ref_var = torch.clamp_min(q / m - (s / m) * (s / m), 0.0)
    for name, got, ref in (("mean", mean, s / m), ("var", var, ref_var),
                           ("rstd", rstd, torch.rsqrt(ref_var + 1e-5)),
                           ("scale·rstd", k, scale * rstd), ("Σg/n", m1, sg / m),
                           ("Σg·x̂/n", m2, sgx / m)):
        _close(got, ref, 1e-5, f"{name} ({m}, {c}) {dtype}")
    for d, y in ys.items():
        ref = bs.bn_normalize_plain(x, mean, rstd, scale, bias, d)
        assert y.dtype == d and torch.equal(y, ref), \
            (m, c, dtype, d, float((y.float() - ref.float()).abs().max()))
    ref = bs.bn_dx_plain(g, x, mean, rstd, terms)
    assert dx.dtype == dtype and torch.equal(dx, ref), \
        (m, c, dtype, float((dx.float() - ref.float()).abs().max()))


def test_bn_reductions_rerun_bit_equal_across_shapes(cuda):
    """Repeated calls, and calls alternating between shapes of 1 and 8
    channel tiles that share the stream's scratch, give the same bits."""
    cases = [_bn_case(h, c, torch.bfloat16, cuda, seed=3)
             for h, c in ((112, 64), (56, 256), (7, 2048))]

    def run(case):
        x, g, scale, _ = case
        mean, var, rstd = bsc.bn_moments(x, 1e-5)
        return [mean, var, rstd, *bsc.bn_bwd_terms(g, x, mean, rstd, scale)]

    first = [run(case) for case in cases]
    for _ in range(3):
        for case, ref in zip(cases, first):
            assert all(torch.equal(a, b) for a, b in zip(run(case), ref))
        for case, ref in zip(reversed(cases), reversed(first)):
            assert all(torch.equal(a, b) for a, b in zip(run(case), ref))


def test_bn_train_under_checkpoint_is_bit_equal(cuda):
    """bn_train inside ``torch.utils.checkpoint`` (as ``remat_stages`` runs
    it): the forward's two launches twice, the backward's once, and y, dx,
    dscale and dbias bit-equal to the run without recomputation."""
    x, g, scale, bias = _bn_case(28, 512, torch.bfloat16, cuda, seed=5)

    def fn(x, scale, bias):
        return bs.bn_train(x, scale, bias, 1e-5, torch.bfloat16)[0]

    outs = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        before = _launches(BN_KERNELS)
        y = (torch.utils.checkpoint.checkpoint(fn, *leaves, use_reentrant=False) if remat
             else fn(*leaves))
        y.backward(g)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(_launches(BN_KERNELS), before)] == \
            ([2, 2, 1, 1] if remat else [1, 1, 1, 1])
        outs.append([y.detach(), *(t.grad for t in leaves)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_bn_train_kernel_route_never_calls_a_plain_version(cuda, monkeypatch):
    """With every plain version patched to raise, bn_train forward and
    backward on the card runs through its four launches only."""
    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the kernel route")

    for name in ("channel_sums_plain", "bn_bwd_reduce_plain", "_dx_acc",
                 *(f"{n}_plain" for n in BN_STEPS)):
        monkeypatch.setattr(bs, name, refuse)
    x, g, scale, bias = _bn_case(14, 1024, torch.bfloat16, cuda, seed=7)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    before = _launches(BN_KERNELS)
    y, mean, var = bs.bn_train(*leaves, 1e-5, torch.bfloat16)
    y.backward(g)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(BN_KERNELS), before)] == [1, 1, 1, 1]
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)


# Every block shape of SwinV2-T and SwinV2-B at 224 px, window 7: (grid, C,
# heads, shift), each stage unshifted and, where the map holds more than one
# window, shifted by 3.
RETIRED_SHAPES = [(g, c, h, s) for g, c, h in ((56, 96, 3), (28, 192, 6), (14, 384, 12),
                                               (7, 768, 24), (56, 128, 4), (28, 256, 8),
                                               (14, 512, 16), (7, 1024, 32))
                  for s in ((0, 3) if g > 7 else (0,))]
# (x's dtype, the weights' dtype): the four pairs the kernels take
RETIRED_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
DT_IDS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _retired_args(grid, c, heads, shift, xdt, wdt, seed, batch=2, window=7):
    """Both halves' arguments on a map of ``batch`` images rolled by -shift,
    z per window where shifted (bias + mask), else the bias broadcast: x in
    xdt, the four weights in wdt, vectors f32."""
    n = window * window
    p = _params(c, heads, n, "cuda", seed=seed)
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(batch, grid, grid, c, device="cuda", generator=gen)
    x = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    mask = (torch.as_tensor(wa.shift_attn_mask((grid, grid), window, shift), device="cuda")
            if shift else None)
    w = {k: p[k].to(wdt) for k in ("wqkv", "wproj", "w1", "w2")}
    attn = (x.to(xdt), w["wqkv"], p["bqkv"], wac.attention_scale(p["ls"]).reshape(-1, 1, 1),
            wac.merge_bias_mask(p["bias"], mask), w["wproj"], p["bproj"], p["lns"], p["lnb"])
    mlp = (x.to(xdt), w["w1"], p["b1"], w["w2"], p["b2"], p["lns"], p["lnb"])
    return attn, mlp


@pytest.mark.parametrize("xdt,wdt", RETIRED_DTYPES,
                         ids=[f"x{DT_IDS[a]}-w{DT_IDS[b]}" for a, b in RETIRED_DTYPES])
@pytest.mark.parametrize("grid,c,heads,shift", RETIRED_SHAPES,
                         ids=[f"{g}x{g}-C{c}-shift{s}" for g, c, _, s in RETIRED_SHAPES])
def test_retired_fused_halves_kernels(cuda, grid, c, heads, shift, xdt, wdt):
    """Both retired halves at every SwinV2-T and SwinV2-B block shape (batch
    2), for each pair of x's and the weights' dtypes, against their plain
    versions, one launch each. Both sides keep every product, the core and
    the LayerNorm at f32 accuracy (the kernel from bf16 pieces on tensor
    cores), so with f32 out they differ in summation order only: 1e-4·
    max|plain|; bf16 out rounds once at the store: 2e-2. The MLP with f32 x
    and bf16 weights rounds h to bf16 on both sides (the contract): where
    the two sides' f32 sums of fc1 straddle a rounding boundary (about one
    value in 7,000), h differs by one bf16 ulp, which moves its row's pre-LN
    sum by |w2|·ulp(h), up to about 3e-3·max|plain| after the LayerNorm:
    2e-3 there (the plain version on the CPU lands 1.7e-4 from hvt's kernel
    at SwinV2-T's stage 4, tests/test_torch_port_swin_block_tc_plan.py)."""
    attn, mlp = _retired_args(grid, c, heads, shift, xdt, wdt, seed=c + shift)
    tol = 1e-4 if xdt == torch.float32 else 2e-2
    mlp_tol = 2e-3 if (xdt, wdt) == (torch.float32, torch.bfloat16) else tol
    before = sb.ATTN_KERNEL.launches, sb.MLP_KERNEL.launches
    got_attn = sb.fused_attention_branch(*attn, window=7, num_heads=heads)
    got_mlp = sb.fused_mlp_branch(*mlp)
    torch.cuda.synchronize()
    assert (sb.ATTN_KERNEL.launches, sb.MLP_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    assert got_attn.dtype == got_mlp.dtype == xdt
    what = f"C={c} shift={shift} x {xdt} w {wdt}"
    _close(got_attn, sb.fused_attention_branch_plain(*attn, window=7, num_heads=heads), tol,
           f"fused_attention_branch {what}")
    _close(got_mlp, sb.fused_mlp_branch_plain(*mlp), mlp_tol, f"fused_mlp_branch {what}")


@pytest.mark.parametrize("xdt,wdt", RETIRED_DTYPES,
                         ids=[f"x{DT_IDS[a]}-w{DT_IDS[b]}" for a, b in RETIRED_DTYPES])
def test_retired_fused_halves_rerun_bit_identical(cuda, xdt, wdt):
    """Two calls on the same inputs give the same bits, and so does a third on
    an x that starts one element off a 16-byte boundary (the wrapper copies
    it onto one): every sum runs in a fixed order (no atomics), at
    SwinV2-T's shifted stage 1 and stage 4."""
    for grid, c, heads, shift in ((56, 96, 3, 3), (7, 768, 24, 0)):
        attn, mlp = _retired_args(grid, c, heads, shift, xdt, wdt, seed=7)
        x = attn[0]
        off = torch.empty(x.numel() + 1, dtype=xdt, device=cuda)[1:].view_as(x).copy_(x)
        assert off.data_ptr() % 16
        runs = [(sb.fused_attention_branch(xi, *attn[1:], window=7, num_heads=heads),
                 sb.fused_mlp_branch(xi, *mlp[1:])) for xi in (x, x, off)]
        torch.cuda.synchronize()
        for run in runs[1:]:
            assert torch.equal(runs[0][0], run[0]), f"attention C={c} x {xdt} w {wdt}"
            assert torch.equal(runs[0][1], run[1]), f"MLP C={c} x {xdt} w {wdt}"


@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("c,heads,window", [(96, 6, 7), (96, 3, 8), (160, 5, 7), (1536, 48, 7)],
                         ids=["headdim16", "window8", "C160", "C1536"])
def test_retired_fused_halves_other_shapes(cuda, c, heads, window, xdt, wdt):
    """Both halves beyond SwinV2-T's and SwinV2-B's shapes: head dim 16 (the
    CUDA-core core, attention_fwd_kernel), window 8 (N = 64, the tensor-core
    core's widest window), C = 160 (3C = 480, and C in tiles of 128 with
    masked columns) and C = 1536 (swinv2_large's stage 4, one 7 x 7 window:
    rows wider than the LayerNorm's register buckets). Tolerances as
    test_retired_fused_halves_kernels'."""
    grid = window if c == 1536 else 2 * window * (2 if window == 7 else 1)
    shift = window // 2 if grid > window else 0
    attn, mlp = _retired_args(grid, c, heads, shift, xdt, wdt, seed=c + window, window=window)
    tol = 1e-4 if xdt == torch.float32 else 2e-2
    got = sb.fused_attention_branch(*attn, window=window, num_heads=heads)
    _close(got, sb.fused_attention_branch_plain(*attn, window=window, num_heads=heads), tol,
           f"fused_attention_branch C={c} heads={heads} window={window} {xdt}")
    got = sb.fused_mlp_branch(*mlp)
    _close(got, sb.fused_mlp_branch_plain(*mlp), tol, f"fused_mlp_branch C={c} {xdt}")


def test_retired_fused_halves_refuse_what_they_do_not_take(cuda):
    """Forward only: an input that requires grad raises, naming the kernel,
    unless grad is off; a width that is no multiple of 32 and mixed weight
    dtypes raise too."""
    p = _params(96, 3, 49, cuda, seed=6)
    x = torch.randn(2, 14, 14, 96, device=cuda)
    mlp = [x, p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"]]
    w1 = p["w1"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="fused_mlp_branch: the kernel is forward only"):
        sb.fused_mlp_branch(mlp[0], w1, *mlp[2:])
    with torch.no_grad():
        assert sb.fused_mlp_branch(mlp[0], w1, *mlp[2:]).grad_fn is None
    z = wac.merge_bias_mask(p["bias"], None)
    attn = [x, p["wqkv"], p["bqkv"], wac.attention_scale(p["ls"]), z, p["wproj"], p["bproj"],
            p["lns"], p["lnb"]]
    with pytest.raises(RuntimeError, match="fused_attention_branch: the kernel is forward only"):
        sb.fused_attention_branch(x.clone().requires_grad_(), *attn[1:], window=7, num_heads=3)
    with pytest.raises(ValueError, match="all bf16 or all f32"):
        sb.fused_mlp_branch(x, p["w1"], p["b1"], p["w2"].bfloat16(), *mlp[4:])
    with pytest.raises(ValueError, match="a multiple of 32"):
        sb.fused_mlp_branch(x[..., :80], p["w1"][:320, :80], p["b1"][:320], p["w2"][:80, :320],
                            p["b2"][:80], p["lns"][:80], p["lnb"][:80])


# ---------------------------------------------------------------------------
# Evaluation at iNat21's eval batch (2048 images at 224 px)
# ---------------------------------------------------------------------------

EVAL_BATCH = 2048
STAGE1 = 56  # SwinV2's stage-1 map at 224 px: 3,136 tokens an image


def _big(shape, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).bfloat16()


@pytest.mark.parametrize("c", [96, 128])
def test_mlp_forward_past_int32_elements(cuda, c):
    """The MLP half's forward at SwinV2-T's and SwinV2-B's stage-1 width
    over 2048 images (6,422,528 rows): h holds 2.47e9 (C = 96) or 3.29e9
    (C = 128) elements, past 2³¹. The chain is row-wise, so whole images
    are held against the plain version on their own: the first, the one
    holding h's element 2³¹, and the last; 2e-2·max|plain| (the fused
    halves' tolerance)."""
    tpi = STAGE1 * STAGE1
    t = EVAL_BATCH * tpi
    assert t * 4 * c > 2**31
    p = _params(c, c // 32, 49, cuda, seed=c + 1)
    args = (p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    x = _big((t, c), cuda, seed=c)
    dp = torch.linspace(0.5, 1.5, EVAL_BATCH, device=cuda)
    before = fh.MLP_KERNEL.launches
    with torch.inference_mode():
        got = fh.mlp_half(x, *args, tpi=tpi, dp=dp)
    torch.cuda.synchronize()
    assert fh.MLP_KERNEL.launches == before + 1
    for img in (0, 2**31 // (4 * c) // tpi, EVAL_BATCH - 1):
        rows = slice(img * tpi, (img + 1) * tpi)
        ref = fh.mlp_half_plain(x[rows], *args, tpi=tpi, dp=dp[img:img + 1])
        _close(got[rows], ref, 2e-2, f"mlp_half C={c} image {img} of {EVAL_BATCH}")


@pytest.mark.parametrize("c", [96, 128])
def test_attention_half_forward_at_the_eval_batch(cuda, c):
    """The NHWC attention half's forward, shifted, at SwinV2-T's and
    SwinV2-B's stage-1 shape over 2048 images: ao and the f32 pre-LN sum
    span 2.47-3.29e9 bytes. Each image's windows are its own, so images 0,
    1,000 and 2,047 are held against the plain version alone; 2e-2."""
    heads, window, shift = c // 32, 7, 3
    p = _params(c, heads, 49, cuda, seed=c + 2)
    mask = torch.as_tensor(wa.shift_attn_mask((STAGE1, STAGE1), window, shift), device=cuda)
    args = (p["wqkv"], p["bqkv"], p["ls"], p["bias"], mask, p["wproj"], p["bproj"], p["lns"],
            p["lnb"], window, heads)
    x = _big((EVAL_BATCH, STAGE1, STAGE1, c), cuda, seed=c + 3)
    dp = torch.linspace(0.5, 1.5, EVAL_BATCH, device=cuda)
    before = fh.ATTN_KERNEL.launches
    with torch.inference_mode():
        got = fh.attention_half_nhwc(x, *args, dp=dp, shift=shift)
    torch.cuda.synchronize()
    assert fh.ATTN_KERNEL.launches == before + 1
    for img in (0, 1000, EVAL_BATCH - 1):
        ref = fh.attention_half_nhwc_plain(x[img:img + 1], *args, dp=dp[img:img + 1], shift=shift)
        _close(got[img:img + 1], ref, 2e-2, f"attention half C={c} image {img} of {EVAL_BATCH}")


def test_packed_forward_past_int32_elements(cuda):
    """The packed window attention at SwinV2-B's stage-1 shape (C = 128, 4
    heads, window 7, shifted) over 2048 images: qkv (131,072 windows, 49,
    384) holds 2.47e9 elements, past 2³¹. Whole images of 64 windows (the
    mask's period) are held against the plain version alone: the first,
    the one holding qkv's element 2³¹, and the last; 1e-2·max|plain|."""
    c, heads, window, nw = 128, 4, 7, 64
    n = window * window
    nwb = EVAL_BATCH * nw
    assert nwb * n * 3 * c > 2**31
    p = _params(c, heads, n, cuda, seed=5)
    mask = torch.as_tensor(wa.shift_attn_mask((STAGE1, STAGE1), window, 3), device=cuda)
    qkv = _big((nwb, n, 3 * c), cuda, seed=6)
    before = wac.KERNEL.launches
    with torch.inference_mode():
        got = wac.window_attention_packed(qkv, p["ls"], p["bias"], mask, num_heads=heads)
    torch.cuda.synchronize()
    assert wac.KERNEL.launches == before + 1
    for img in (0, 2**31 // (n * 3 * c) // nw, EVAL_BATCH - 1):
        w = slice(img * nw, (img + 1) * nw)
        ref = wac.window_attention_packed_plain(qkv[w], p["ls"], p["bias"], mask, num_heads=heads)
        _close(got[w], ref, 1e-2, f"packed attention image {img} of {EVAL_BATCH}")


def test_rows_past_the_grid_limit_are_refused_before_a_launch(cuda):
    """65,536 tiles of 128 rows are one more than gridDim.y holds: the MLP
    and attention-half wrappers raise, naming the limit, and launch nothing."""
    c = 32
    p = _params(c, 1, 49, cuda, seed=7)
    x = torch.zeros((fh.MAX_ROW_TILES * fh.TILE_ROWS + 1, c), dtype=torch.bfloat16, device=cuda)
    before = fh.MLP_KERNEL.launches
    with pytest.raises(ValueError, match="gridDim.y limit of 65535"):
        fh.mlp_half_forward(x, p["w1"], p["b1"], p["w2"], p["b2"], p["lns"], p["lnb"])
    assert fh.MLP_KERNEL.launches == before


@pytest.mark.parametrize("fuse", [False, True])
def test_eval_step_kernel_path_matches_plain_path(cuda, monkeypatch, fuse):
    """``build_eval_step`` on SwinV2-T (224 px, 100 classes, bf16, every
    parameter drawn) over 8 images, one of them padding, with tree
    distances: each forward kernel of the route launches 12 times and no
    backward kernel; against the same step with the kernels' plain
    versions: the count exact, ce_sum within 1e-2 relative, correct@1 and
    correct@5 within one image, tree_dist_sum within one image's 7."""
    import torch.nn as nn

    from hvt_torch import hierarchy
    from hvt_torch.data import DevicePrep
    from hvt_torch.data.synthetic import synthetic_class_names
    from hvt_torch.models import swinv2 as tswin
    from hvt_torch.train import step as tstep

    model = tswin.swinv2_tiny(100, fuse=fuse, drop_path_rate=0.2).to(cuda)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, nn.LayerNorm) and name.endswith("weight"):
                prm.copy_(1.0 + 0.1 * torch.randn(prm.shape, generator=gen))
            elif name.endswith("logit_scale"):
                prm.copy_(math.log(10.0) + 0.3 * torch.randn(prm.shape, generator=gen))
            else:
                prm.copy_(torch.randn(prm.shape, generator=gen)
                          * (prm[0].numel() ** -0.5 if prm.ndim > 1 else 0.1))
    td = hierarchy.tree_dist_matrix([hierarchy.HierarchicalLabel.parse(s)
                                     for s in synthetic_class_names(100)])
    prep = DevicePrep(mean=(118.0, 122.4, 95.9), std=(60.7, 58.4, 63.0))
    step = tstep.build_eval_step(model, prep, td)
    images = torch.randint(0, 256, (8, 224, 224, 3), generator=gen, dtype=torch.uint8).to(cuda)
    labels = torch.randint(0, 100, (8,), generator=gen, dtype=torch.int32).to(cuda)
    mask = torch.tensor([1.0] * 7 + [0.0], device=cuda)
    state = (dict(model.named_parameters()), {})
    forward = ((fh.MLP_KERNEL, fh.ATTN_KERNEL) if fuse else (wac.KERNEL,))
    backward = (fh.MLP_BWD_KERNEL, fh.ATTN_BWD_KERNEL, wac.BWD_KERNEL)
    before = [k.launches for k in forward + backward]
    got = {k: float(v) for k, v in step(*state, images, labels, mask).items()}
    assert [k.launches - b for k, b in zip(forward + backward, before)] == (
        [12] * len(forward) + [0] * len(backward))
    monkeypatch.setattr(fh, "mlp_half_forward", fh.mlp_half_plain)
    monkeypatch.setattr(fh, "attention_half_nhwc_forward", fh.attention_half_nhwc_plain)
    monkeypatch.setattr(wac, "window_attention_packed", wac.window_attention_packed_plain)
    ref = {k: float(v) for k, v in step(*state, images, labels, mask).items()}
    assert got["count"] == ref["count"] == 7.0
    assert abs(got["ce_sum"] - ref["ce_sum"]) <= 1e-2 * abs(ref["ce_sum"])
    for k in ("correct@1", "correct@5"):
        assert abs(got[k] - ref[k]) <= 1, k
    assert abs(got["tree_dist_sum"] - ref["tree_dist_sum"]) <= 7


def test_checkpoint_host_copy_precedes_the_next_update(cuda, tmp_path):
    """``Checkpointer.save`` copies CUDA tensors to the host before it
    returns: an in-place update queued on the card right after (as the next
    step's ``_foreach_`` update would be) does not reach the file."""
    from hvt_torch.train import checkpoint as tckpt

    w = torch.arange(1 << 22, dtype=torch.float32, device=cuda)
    want = w.cpu()
    ck = tckpt.Checkpointer(tmp_path, max_to_keep=1)
    ck.save(1, {"step": 1, "params": {"w": w}})
    torch._foreach_add_([w], 1.0)
    ck.close()
    assert torch.equal(ck.restore(1)["params"]["w"], want)


def test_trainer_restore_is_bit_equal_on_the_card(cuda, tmp_path):
    """A Trainer on the card (ResNet micro, EMA, stochastic depth drawn from
    the CUDA generator) saves at step 2 of 4; a new Trainer restored from it
    holds every parameter, running statistic, EMA copy, optimizer tensor,
    the count and the generator state bit for bit, and both go on to the
    same step 4."""
    from hvt_torch import config as tconfig
    from hvt_torch.train import checkpoint as tckpt
    from hvt_torch.train.loop import Trainer

    layer = {
        "run_name": "card", "seed": 3, "max_duration": "4ba", "grad_accum": 1,
        "machine": {"save_root": str(tmp_path)},
        "model": {"name": "resnet_micro_bottleneck", "args": {}},
        "train_dataset": {"source": "synthetic", "crop_size": 32, "global_batch_size": 8,
                          "synthetic_num_classes": 10, "synthetic_num_samples": 16},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "global_batch_size": 8,
                         "synthetic_num_classes": 10, "synthetic_num_samples": 8},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": "2ba", "num_checkpoints_to_keep": 3, "wandb": False},
        "algorithms": [{"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "1ba"}},
                       {"cls": "StochasticDepth", "args": {"drop_rate": 0.5}}],
    }
    straight = Trainer(tconfig.loads(layer), device=cuda)
    straight.fit()
    straight.close()
    saved = tckpt.load_raw(f"ckpt://{tmp_path}/card/checkpoints:2")
    resumed = Trainer(tconfig.loads({**layer, "run_name": "resumed",
                                     "load_path": f"ckpt://{tmp_path}/card/checkpoints:2"}),
                      device=cuda)
    got = tckpt.to_host(resumed.state_dict())
    assert got["step"] == saved["step"] == 2 and torch.equal(got["rng"], saved["rng"])
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        for name, t in saved[key].items():
            assert torch.equal(got[key][name], t), f"{key} {name}"
    for i, slots in saved["opt_state"]["state"].items():
        for slot, t in slots.items():
            assert torch.equal(got["opt_state"]["state"][i][slot], t), f"optimizer {i} {slot}"
    resumed.fit()
    resumed.close()
    assert resumed.step == straight.step == 4


# ---------------------------------------------------------------------------
# The training input path on the card: device augmentations, pinned batches
# ---------------------------------------------------------------------------

GEOMETRIC_OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")


def _aug_images(b, size, seed):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:size, 0:size]
    base = np.stack([gx, gy, (gx + gy) // 2], -1)
    return torch.from_numpy((base[None] + rng.integers(0, 64, (b, size, size, 3)))
                            .clip(0, 255).astype(np.uint8))


def _near(got, ref, exact):
    """uint8: equal, or (geometric, an f32 resize rounded) within 1 on under 1% of pixels."""
    d = (got.cpu().int() - ref.int()).abs()
    if exact:
        assert int(d.max()) == 0
    else:
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize("size", [64, 224])
def test_device_augmentations_match_the_cpu(cuda, size):
    """Each device augmentation on the card against the same function on the
    CPU, with the same draws (made on the card): RandAugment's pointwise
    ops equal, its geometric ops, both policies and ColOut within 1 on
    under 1% of pixels; MixUp and CutMix in f32 within 1e-5·max; the
    progressive resize at every bucket in f32 within 1e-5·max|x|."""
    from hvt_torch.data import device as dp
    from hvt_torch.data import randaugment as ra

    b = 16
    x_cpu = _aug_images(b, size, seed=size)
    x = x_cpu.to(cuda)
    gen = torch.Generator(cuda).manual_seed(7)
    sign = torch.where(torch.rand(b, generator=gen, device=cuda) < 0.5, 1.0, -1.0)
    factor = ra._factor(sign, 9)
    for name in ra.OP_NAMES:
        _near(ra._apply_op_static(name, x, sign, factor, 9),
              ra._apply_op_static(name, x_cpu, sign.cpu(), factor.cpu(), 9),
              exact=name not in GEOMETRIC_OPS)
    for stratified in (True, False):
        draws = ra.draw_rand_augment(gen, b, 2, stratified, cuda)
        _near(ra.rand_augment(x, draws, 9, stratified),
              ra.rand_augment(x_cpu, [(c.cpu(), s.cpu()) for c, s in draws], 9, stratified), False)
    draws = dp.draw_colout(gen, b, size, size, 0.1, 0.1, cuda)
    _near(dp.colout(x, draws), dp.colout(x_cpu, tuple(d.cpu() for d in draws)), False)
    xf = torch.randn((b, size, size, 3), generator=gen, device=cuda)
    onehot = dp.prepare_targets(torch.randint(0, 10, (b,), generator=gen, device=cuda), 10, 0.1)
    for fn, args in ((dp.mixup, (dp.draw_beta(gen, 0.2, cuda),)),
                     (dp.cutmix, dp.draw_cutmix(gen, 1.0, size, size, cuda))):
        gi, gt = fn(xf, onehot, *args)
        ri, rt = fn(xf.cpu(), onehot.cpu(), *(a.cpu() for a in args))
        assert float((gi.cpu() - ri).abs().max()) <= 1e-5 * float(ri.abs().max())
        assert float((gt.cpu() - rt).abs().max()) <= 1e-5
    for scale in (0.5, 0.625, 0.75, 0.875):
        got, ref = dp.progressive_resize(xf, scale), dp.progressive_resize(xf.cpu(), scale)
        assert got.shape == ref.shape
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(xf.abs().max())


def test_loader_pins_its_batches_for_the_card(cuda):
    """With ``pin_memory`` the producer thread builds each batch in
    page-locked memory, and the Trainer's copy of it is queued without a
    wait; the batches equal those of an unpinned loader."""
    from hvt_torch.data import loader as tloader
    from hvt_torch.data import synthetic as tsynthetic

    ds = tsynthetic.build_synthetic(num_samples=10, num_leaf_classes=5, crop_size=16)
    pinned = tloader.Loader(ds, None, 4, shuffle=True, pin_memory=True)
    plain = tloader.Loader(ds, None, 4, shuffle=True)
    for a, b in zip(pinned.epoch(1), plain.epoch(1)):
        for field in ("images", "labels", "mask"):
            t = tloader.host_tensor(getattr(a, field))
            assert t.is_pinned(), field
            assert not tloader.host_tensor(getattr(b, field)).is_pinned()
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            assert torch.equal(t.to(cuda, non_blocking=True).cpu(), torch.from_numpy(getattr(b, field)))


def test_train_step_with_every_augmentation_on_the_card(cuda, tmp_path):
    """A ResNet micro with bn_pallas trains 4 steps on the card with device
    RandAugment and ColOut, MixUp, CutMix and progressive resizing (its
    scale crossing 0.5 → 0.875): finite losses, the BatchNorm kernels
    launched every step, and the loop never waits on a pageable copy."""
    from hvt_torch import config as tconfig
    from hvt_torch.ops import bn_stats_cuda as bsc
    from hvt_torch.train.loop import Trainer

    layer = {
        "run_name": "aug", "seed": 3, "max_duration": "4ba", "grad_accum": 1,
        "machine": {"save_root": str(tmp_path)},
        "model": {"name": "resnet_micro_bottleneck", "args": {"bn_pallas": True}},
        "train_dataset": {"source": "synthetic", "crop_size": 64, "global_batch_size": 16,
                          "synthetic_num_classes": 10, "synthetic_num_samples": 32},
        "eval_dataset": {"source": "synthetic", "crop_size": 64, "global_batch_size": 16,
                         "synthetic_num_classes": 10, "synthetic_num_samples": 16},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "save": {"interval": None, "wandb": False},
        "algorithms": [
            {"cls": "RandAugment", "args": {"depth": 1, "severity": 9, "device": True}},
            {"cls": "ColOut", "args": {"device": True}},
            {"cls": "MixUp", "args": {"alpha": 0.2}}, {"cls": "CutMix", "args": {"alpha": 1.0}},
            {"cls": "ProgressiveResizing", "args": {"initial_scale": 0.5}}],
    }
    trainer = Trainer(tconfig.loads(layer), device=cuda)
    assert trainer.train_loader.pin_memory
    bsc.SUMS_KERNEL.launches = 0
    losses = []
    trainer.fit(on_step=lambda step, stats: losses.append(stats["loss_sum"]))
    trainer.close()
    assert len(losses) == 4 and all(math.isfinite(float(v)) for v in losses)
    layers = sum(isinstance(m, torch.nn.Module) and type(m).__name__ == "PallasBatchNorm"
                 for m in trainer.model.modules())
    assert bsc.SUMS_KERNEL.launches == 4 * layers


# ---------------------------------------------------------------------------
# Downstream: the probe's fit, the centroids and feature extraction
# ---------------------------------------------------------------------------


def _clusters(seed, classes=12, per_class=50, dim=64):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(classes, dim)) * 0.6
    y = rng.permutation(np.repeat(np.arange(classes), per_class))
    mix = rng.normal(size=(dim, dim)) / np.sqrt(dim) + np.eye(dim)
    return ((centres[y] + rng.normal(size=(y.size, dim))) @ mix + 3.0).astype(np.float32), y


def test_linear_probe_on_the_card_matches_the_cpu_f64(cuda):
    """The whole grid search in f32 on the card against f64 on the CPU: the
    same alpha, the test predictions equal on >= 99.5% of rows, the refit's
    objective within 1e-4 relative; 10 iterations in f64 on the card and on
    the CPU within 1e-8 of each other."""
    from hvt_torch.downstream import linear as L

    x, y = _clusters(0)
    x_test, y_test = _clusters(0, per_class=25)
    card = L.LinearProbe(device=cuda).fit(x, y)
    cpu = L.LinearProbe().fit(x, y)
    assert card.model_.weight.dtype == torch.float32 and card.model_.weight.is_cuda
    assert card.best_alpha_ == cpu.best_alpha_
    assert np.mean(card.predict(x_test) == cpu.predict(x_test)) >= 0.995
    assert abs(card.model_.objective - cpu.model_.objective) <= 1e-4 * cpu.model_.objective
    x64 = torch.from_numpy(x).double()
    card64 = L.fit_ovr(x64.to(cuda), y, cpu.best_alpha_, max_iter=10)
    cpu64 = L.fit_ovr(x64, y, cpu.best_alpha_, max_iter=10)
    assert abs(card64.objective - cpu64.objective) <= 1e-8 * cpu64.objective


def test_centroids_on_the_card_match_the_cpu(cuda):
    """Flat and hierarchical nearest centroids (f64 on both): predictions
    equal, centroids within 1e-12 relative."""
    from hvt_torch import hierarchy
    from hvt_torch.data.synthetic import synthetic_class_names
    from hvt_torch.downstream import centroid as C

    x, y = _clusters(1, classes=40, per_class=5)
    queries, _ = _clusters(2, classes=40, per_class=130)  # past one chunk of 4096
    card, cpu = C.NearestCentroid(cuda).fit(x, y), C.NearestCentroid().fit(x, y)
    _close(card.centroids_.cpu(), cpu.centroids_, 1e-12, "centroids")
    np.testing.assert_array_equal(card.predict(queries), cpu.predict(queries))
    names = synthetic_class_names(40)
    table, _ = hierarchy.assign_tier_indices(names)
    lookups = hierarchy.parent_lookup_from_classes(names)
    hcard = C.HierarchicalNearestCentroid(lookups, cuda).fit(x, table[y])
    hcpu = C.HierarchicalNearestCentroid(lookups).fit(x, table[y])
    np.testing.assert_array_equal(hcard.predict(queries), hcpu.predict(queries))


@pytest.mark.parametrize("name", ["resnet50", "swinv2_tiny"])
def test_extract_features_on_the_card_matches_the_plain_path(cuda, tmp_path, monkeypatch, name):
    """``extract_features`` at 224 px on the synthetic source (20 images,
    batch 8, a padded tail): the features on the card against the plain
    path (SwinV2-T fused: the kernels' plain versions on the card, 12
    launches of each fused forward kernel a batch; ResNet-50, which runs no
    kernel in eval: the CPU), worst row cosine >= 0.999 and max|Δ| within
    5e-2·max|f|; the labels equal; a second call reads the cache."""
    from hvt_torch import config as config_lib
    from hvt_torch.downstream import features
    from hvt_torch.models import build_model, torch_compat
    from hvt_torch.train import ema as ema_lib

    swin = name.startswith("swin")
    model = build_model(config_lib.loads({"model": {"name": name}}), 10)
    path = tmp_path / "weights.pt"
    if swin:
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            for pname, prm in model.named_parameters():
                if pname.endswith("logit_scale"):
                    prm.copy_(math.log(10.0) + 0.3 * torch.randn(prm.shape, generator=gen))
                elif "norm" in pname and pname.endswith("weight"):
                    prm.copy_(1.0 + 0.1 * torch.randn(prm.shape, generator=gen))
                else:
                    prm.copy_(torch.randn(prm.shape, generator=gen)
                              * (prm[0].numel() ** -0.5 if prm.ndim > 1 else 0.1))
        torch_compat.save_swin_checkpoint(dict(model.named_parameters()), str(path))
    else:
        torch_compat.save_resnet_checkpoint(dict(model.named_parameters()),
                                            ema_lib.batch_stats(model), str(path))
    data = {"source": "synthetic", "synthetic_num_classes": 10, "synthetic_num_samples": 20,
            "global_batch_size": 8, "crop_size": 224}

    def config(root):
        return config_lib.loads({
            "model": {"name": name, "variant": "simpleshot", "pretrained_checkpoint": f"torch://{path}",
                      "args": {"fuse": True} if swin else {}},
            "machine": {"save_root": str(tmp_path / root)}, "save": {"wandb": False},
            "train_dataset": data, "eval_dataset": data})

    before = (fh.MLP_KERNEL.launches, fh.ATTN_KERNEL.launches)
    got, labels = features.extract_features(config("card"), True, "simpleshot", device=cuda)
    launches = (fh.MLP_KERNEL.launches - before[0], fh.ATTN_KERNEL.launches - before[1])
    assert launches == ((36, 36) if swin else (0, 0))  # 3 batches
    if swin:
        monkeypatch.setattr(fh, "mlp_half_forward", fh.mlp_half_plain)
        monkeypatch.setattr(fh, "attention_half_nhwc_forward", fh.attention_half_nhwc_plain)
    ref, ref_labels = features.extract_features(config("plain"), True, "simpleshot",
                                                device=cuda if swin else "cpu")
    assert got.shape == ref.shape == (20, 768 if swin else 2048)
    np.testing.assert_array_equal(labels, ref_labels)
    g, r = torch.from_numpy(got), torch.from_numpy(ref)
    assert float(torch.nn.functional.cosine_similarity(g, r, dim=1).min()) >= 0.999
    _close(g, r, 5e-2, f"{name} features")
    again, _ = features.extract_features(config("card"), True, "simpleshot", device=cuda)
    np.testing.assert_array_equal(again, got)


# ---------------------------------------------------------------------------
# The rest of training: accumulation, SAM, recomputation, bn_custom
# ---------------------------------------------------------------------------


def _tiny_swin(device, seed=0, **kw):
    """The tiny SwinV2-T geometry (embed 96, depths 2-2, heads 3-6, window 7,
    56 px, bf16 activations) with every parameter drawn."""
    import torch.nn as nn

    from hvt_torch.models import swinv2 as tswin

    model = tswin.SwinTransformerV2(num_classes=10, embed_dim=96, depths=(2, 2), num_heads=(3, 6),
                                    window_size=7, img_size=56, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.LayerNorm) and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("logit_scale"):
                p.copy_(math.log(10.0) + 0.3 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * (p[0].numel() ** -0.5 if p.ndim > 1 else 0.1))
    return model.to(device)


def _gradients(model, device, accum=1, sam_rho=None, size=56, batch=8):
    """One step's gradient pass (``build_gradients``) on a seeded uint8 batch
    with a generator seeded 0: (loss, {name: f32 gradient}, {name: buffer},
    the generator's state)."""
    from hvt_torch.data import device as tdevice
    from hvt_torch.objectives import soft_cross_entropy
    from hvt_torch.train import step as tstep

    prep = tdevice.DevicePrep(mean=(0.46, 0.48, 0.38), std=(0.24, 0.23, 0.25),
                              compute_dtype=torch.bfloat16)
    gradients = tstep.build_gradients(model, soft_cross_entropy, prep,
                                      tstep.StepSettings(10, smoothing=0.1, grad_accum=accum,
                                                         sam_rho=sam_rho))
    gen = torch.Generator().manual_seed(1)
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen, dtype=torch.uint8).to(device)
    labels = torch.randint(0, 10, (batch,), generator=gen).to(device)
    generator = torch.Generator(device).manual_seed(0)
    model.train()
    loss, _ = gradients(images, labels, torch.ones(batch, device=device), generator,
                        sam=sam_rho is not None)
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return (float(loss), grads, {n: b.clone() for n, b in model.named_buffers()},
            generator.get_state())


def _cosines(grads, ref, cosine, norm_rtol):
    for name, g in grads.items():
        r = ref[name]
        cos = float((g * r).sum() / (g.norm() * r.norm()).clamp_min(1e-30))
        ratio = float(g.norm() / r.norm().clamp_min(1e-30))
        assert cos >= cosine and abs(ratio - 1.0) <= norm_rtol, (name, cos, ratio)


_FUSED = (fh.MLP_KERNEL, fh.ATTN_KERNEL, fh.MLP_BWD_KERNEL, fh.ATTN_BWD_KERNEL)


def _launches(kernels):
    return [k.launches for k in kernels]


def test_accumulation_equals_one_pass_on_the_fused_route(cuda):
    """Two microbatches against one pass from the same weights and batch on
    ``fuse: true`` (no BatchNorm, drop path 0): each gradient's cosine >=
    0.999 and norm within 1%, the loss within 1e-3; each fused kernel
    launches once a block per microbatch."""
    model = _tiny_swin(cuda, fuse=True, drop_path_rate=0.0)
    before = _launches(_FUSED)
    loss, grads, _, _ = _gradients(model, cuda, accum=1)
    middle = _launches(_FUSED)
    loss2, grads2, _, _ = _gradients(model, cuda, accum=2)
    after = _launches(_FUSED)
    assert [m - b for m, b in zip(middle, before)] == [4] * 4
    assert [a - m for a, m in zip(after, middle)] == [8] * 4
    assert abs(loss2 - loss) <= 1e-3 * abs(loss)
    _cosines(grads2, grads, 0.999, 0.01)


def test_sam_kernel_path_matches_plain_path(cuda, monkeypatch):
    """SAM (rho 0.05) with two microbatches on ``fuse: true``: the kernel
    path (each fused kernel once a block per microbatch per pass) against
    the plain path, loss within 1e-2, every gradient at cosine >= 0.99 and
    norm within 5%."""
    model = _tiny_swin(cuda, fuse=True, drop_path_rate=0.0)
    before = _launches(_FUSED)
    loss, grads, _, _ = _gradients(model, cuda, accum=2, sam_rho=0.05)
    assert [a - b for a, b in zip(_launches(_FUSED), before)] == [16] * 4
    monkeypatch.setattr(fh, "mlp_half_forward", fh.mlp_half_plain)
    monkeypatch.setattr(fh, "attention_half_nhwc_forward", fh.attention_half_nhwc_plain)
    monkeypatch.setattr(fh, "mlp_half_backward", fh.mlp_half_backward_plain)
    monkeypatch.setattr(fh, "attention_half_nhwc_backward", fh.attention_half_nhwc_backward_plain)
    ref_loss, ref, _, _ = _gradients(model, cuda, accum=2, sam_rho=0.05)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    _cosines(grads, ref, 0.99, 0.05)


@pytest.mark.parametrize("case", ["swinv2 fuse", "resnet bn_pallas"])
def test_recomputation_is_bit_equal_on_the_card(cuda, case):
    """The same weights, batch and generator (drop path on) with and without
    recomputation, cuDNN deterministic: gradients, running statistics, loss
    and the generator's state equal bit for bit. Each forward kernel runs
    twice a step under recomputation and each backward kernel once: on
    SwinV2 the fused forwards 8 and the backwards 4 (4 blocks); on the micro
    ResNet the sums kernel 9 + 8 (the 8 BatchNorms of its two recomputed
    stages) and the reduce 9, the normalize as the sums and dx as the
    reduce."""
    from hvt_torch.models import resnet as tresnet

    if case.startswith("swin"):
        models = [_tiny_swin(cuda, fuse=True, drop_path_rate=0.3, remat=r) for r in (False, True)]
        kernels, size = _FUSED, 56
        want = ([4, 4, 4, 4], [8, 8, 4, 4])
    else:
        models = [tresnet.resnet_micro_bottleneck(10, dtype="bfloat16", bn_pallas=True,
                                                  stochastic_depth_rate=0.5, seed=4,
                                                  remat_stages=r).to(cuda) for r in ((), (1, 2))]
        kernels, size = BN_KERNELS, 64
        want = ([9, 9, 9, 9], [17, 17, 9, 9])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        results = []
        for model, w in zip(models, want):
            before = _launches(kernels)
            results.append(_gradients(model, cuda, size=size))
            assert [a - b for a, b in zip(_launches(kernels), before)] == w
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss, grads, bufs, state), (rloss, rgrads, rbufs, rstate) = results
    assert loss == rloss and torch.equal(state, rstate)
    for name, g in grads.items():
        assert torch.equal(rgrads[name], g), (name, float((rgrads[name] - g).abs().max()))
    for name, b in bufs.items():
        assert torch.equal(rbufs[name], b), name


def test_bn_custom_launches_no_batch_norm_kernel(cuda):
    """``bn_custom`` (torch's reductions in the custom BatchNorm backward)
    against ``bn_pallas`` from the same weights and batch on the micro
    ResNet: no BatchNorm kernel launch against 9 of each of the four, every gradient at
    cosine >= 0.99 and norm within 5%."""
    from hvt_torch.models import resnet as tresnet

    pallas = tresnet.resnet_micro_bottleneck(10, dtype="bfloat16", bn_pallas=True, seed=5).to(cuda)
    custom = tresnet.resnet_micro_bottleneck(10, dtype="bfloat16", bn_custom=True, seed=5).to(cuda)
    kernels = BN_KERNELS
    before = _launches(kernels)
    _, ref, _, _ = _gradients(pallas, cuda, size=64)
    middle = _launches(kernels)
    _, grads, _, _ = _gradients(custom, cuda, size=64)
    assert [m - b for m, b in zip(middle, before)] == [9, 9, 9, 9]
    assert _launches(kernels) == middle
    _cosines(grads, ref, 0.99, 0.05)


# ---------------------------------------------------------------------------
# Flash attention (ViT's and DINOv2's use_flash route)
# ---------------------------------------------------------------------------

FLASH_SHAPES = ((64, 12, 197), (64, 12, 257), (8, 12, 1025), (4, 12, 1370))


def _flash_case(b, h, n, device, dtype=torch.bfloat16, seed=0):
    """Seeded packed qkv (B, N, 3·H·64) and dO (B, N, H·64), q and k at unit
    variance (logits of unit variance at sm_scale 1/8)."""
    from hvt_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    c = h * fa.HEAD_DIM
    qkv = torch.as_tensor(rng.normal(size=(b, n, 3 * c)).astype(np.float32), device=device)
    dout = torch.as_tensor(rng.normal(size=(b, n, c)).astype(np.float32), device=device)
    return qkv.to(dtype), dout.to(dtype)


def _flash_check(b, h, n, cuda, dtype=torch.bfloat16, tol=1e-2, grad_tol=2e-2):
    """Kernel against plain version on one case: o within tol·max|o|, dq, dk
    and dv each within grad_tol·max|plain|, or, where the exact dq and dk
    are 0 (N = 1), within grad_tol·1e-3·max|plain dqkv|, and for f32 inputs,
    whose dO and v enter dP rounded to bf16 against an f32 D, within the
    most that moves dq or dk: 2^-7·max Σ_d|dO_d|·|v_d|·sm_scale·max(|q|,
    |k|); the lse within
    1e-4·max|lse| for bf16 inputs (f32 sums of exact products), and for f32
    ones, whose q and k the kernel rounds to bf16 (2^-9 each), within
    2^-8·sm_scale·max Σ_d|q_d|·|k_d|, the most a logit can move. Returns the
    kernel's (o, lse, dqkv)."""
    from hvt_torch.ops import flash_attention as fa

    qkv, dout = _flash_case(b, h, n, cuda, dtype)
    scale = fa.HEAD_DIM ** -0.5
    out, lse = fa.forward(qkv, h, scale)
    ref, ref_lse = fa.forward_plain(qkv, h, scale)
    torch.cuda.synchronize()
    _close(out, ref, tol, f"flash o {b}x{h}x{n} {dtype}")
    if dtype == torch.bfloat16:
        _close(lse, ref_lse, 1e-4, f"flash lse {b}x{h}x{n} {dtype}")
    else:  # each logit moves by at most 2^-8·Σ|q_d·k_d|·sm_scale, and the lse by its largest move
        q, k, _ = qkv.view(b, n, 3, h, fa.HEAD_DIM).permute(2, 0, 3, 1, 4)
        bound = 2.0 ** -8 * scale * float((q.abs() @ k.abs().transpose(-1, -2)).max())
        err = float((lse - ref_lse).abs().max())
        assert err <= bound, f"flash lse {b}x{h}x{n} {dtype}: max|Δ| {err:.3g} > {bound:.3g}"
    dqkv = fa.backward(qkv, out, lse, dout, h, scale)
    ref_d = fa.backward_plain(qkv, ref, ref_lse, dout, h, scale)
    torch.cuda.synchronize()
    c = h * fa.HEAD_DIM
    floor = 1e-3 * float(ref_d.abs().max())  # dq and dk are 0 in exact arithmetic at N = 1
    if dtype == torch.float32:  # dP from bf16-rounded dO and v against an f32 D
        q, k, v = qkv.view(b, n, 3, h, fa.HEAD_DIM).permute(2, 0, 3, 1, 4)
        go = dout.view(b, n, h, fa.HEAD_DIM).transpose(1, 2)
        ds = 2.0 ** -7 * float((go.abs() @ v.abs().transpose(-1, -2)).max())
        moved = ds * scale * float(torch.maximum(q.abs().max(), k.abs().max()))
        floor = max(floor, moved / grad_tol)  # dq and dk within that move
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(dqkv[..., i * c:(i + 1) * c], ref_d[..., i * c:(i + 1) * c], grad_tol,
               f"flash {name} {b}x{h}x{n} {dtype}", floor)
    return out, lse, dqkv


@pytest.mark.parametrize("b,h,n", FLASH_SHAPES)
def test_flash_attention_matches_plain_at_the_models_shapes(cuda, b, h, n):
    """ViT-B/16 at 224 px (N = 197), DINOv2-B/14 at 224 (257), ViT-B/16 at 512
    (1,025), DINOv2 at 518 (1,370), bf16, forward and the three gradients
    against the plain versions (f32 throughout): the kernel rounds the
    unnormalised p, P and dS·sm_scale to bf16 before their products and o
    and the gradients at the store, so o within 1e-2·max|o| and the gradients
    within 2e-2·max|plain|; the log-sum-exp (f32 sums of exact bf16 products)
    within 1e-4·max|lse|."""
    from hvt_torch.ops import flash_attention as fa

    before = (fa.FWD_KERNEL.launches, fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches)
    _flash_check(b, h, n, cuda)
    after = (fa.FWD_KERNEL.launches, fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches)
    assert [a - z for a, z in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("n", [193, 197, 257, 1, 64, 65, 208, 209, 256, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_masks_the_last_key_tile(cuda, n, dtype):
    """A last key tile of 1 to 64 keys (193 = 3·64 + 1, 197 = 3·64 + 5, 257 =
    4·64 + 1, and 1, 64, 65), and the edges of the kernels' plan
    (``flash_plan``: 208 and 209 around one 208- and one 224-key tile, 256
    the widest single tile, 257 the first two-tile forward and three-chunk
    dK/dV, 1,025 seven streamed key tiles), bf16 and f32 (f32 operands enter
    the tensor cores rounded to bf16: the same tolerances): finite, against
    the plain versions (the lse for f32 within _flash_check's rounding
    bound), each image's rows bit-equal whether it is run alone or inside
    the batch (nothing past N leaks in from the next image's rows), and a
    rerun of the backward bit-equal."""
    out, lse, dqkv = _flash_check(3, 4, n, cuda, dtype)
    from hvt_torch.ops import flash_attention as fa

    qkv, dout = _flash_case(3, 4, n, cuda, dtype)
    scale = fa.HEAD_DIM ** -0.5
    assert torch.equal(fa.backward(qkv, out, lse, dout, 4, scale), dqkv)
    last = qkv[2:].clone()
    o2, l2 = fa.forward(last, 4, scale)
    d2 = fa.backward(last, o2, l2, dout[2:].clone(), 4, scale)
    assert torch.equal(o2, out[2:]) and torch.equal(l2, lse[2:]) and torch.equal(d2, dqkv[2:])


def test_flash_attention_autograd_and_strided_qkv(cuda):
    """``flash_attention_qkv`` under autograd gives the wrapper's gradient,
    and ``flash_attention`` on (B, H, N, 64) views the same o, bit for bit."""
    from hvt_torch.ops import flash_attention as fa

    qkv, dout = _flash_case(4, 6, 197, cuda)
    scale = fa.HEAD_DIM ** -0.5
    leaf = qkv.clone().requires_grad_(True)
    out = fa.flash_attention_qkv(leaf, 6, scale)
    out.backward(dout)
    o, lse = fa.forward(qkv, 6, scale)
    assert torch.equal(out.detach(), o)
    assert torch.equal(leaf.grad, fa.backward(qkv, o, lse, dout, 6, scale))
    q, k, v = qkv.view(4, 197, 3, 6, 64).permute(2, 0, 3, 1, 4).unbind(0)
    split = fa.flash_attention(q, k, v, scale)
    assert torch.equal(split, o.view(4, 197, 6, 64).transpose(1, 2))


def test_flash_attention_refuses_other_head_dims_before_launch(cuda):
    """Head dim 32 (and vit_micro's 16) raises, naming the ROADMAP item, and
    launches nothing; a model with such heads says so in cuda_unsupported."""
    from hvt_torch.models import vit
    from hvt_torch.ops import flash_attention as fa

    qkv = torch.zeros(2, 10, 3 * 4 * 32, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    before = fa.FWD_KERNEL.launches
    with pytest.raises(ValueError, match="head dim 64, not 32.*Kernel coverage"):
        fa.flash_attention_qkv(qkv, 4, 32 ** -0.5)
    assert fa.FWD_KERNEL.launches == before
    model = vit.vit_micro(5, use_flash=True, img_size=32)
    assert "head dim 64, not 16" in model.cuda_unsupported(32, training=True)[0]
    assert vit.vit_base_patch16_224(5, use_flash=True).cuda_unsupported(224, True) == []


@pytest.mark.parametrize("n", [1, 64, 197, 209, 257, 1025])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_dq_kernel_writes_d(cuda, n, dtype):
    """The dQ kernel's D (``backward_dq`` fills ``delta``) against
    ``delta_rows`` within 1e-5·max over rows of Σ|dO∘O|: both are f32 sums
    of the same products in another order (exact products for bf16; for f32
    each rounded once). On the f32 route O (the forward's f32 output) and dO
    hold values bf16 cannot, and D must sum those, not the bf16 copies that
    the products read: the control shows that D of the bf16 copies misses
    the tolerance. A rerun gives the same bits, D included."""
    from hvt_torch.ops import flash_attention as fa

    qkv, dout = _flash_case(3, 4, n, cuda, dtype)
    scale = fa.HEAD_DIM ** -0.5
    out, lse = fa.forward(qkv, 4, scale)
    runs = []
    for _ in range(2):
        delta = torch.full((3, 4, n), float("nan"), device=cuda)
        dqkv = torch.empty_like(qkv)
        fa.backward_dq(qkv, out, dout, lse, delta, dqkv, 4, scale)
        runs.append((delta, dqkv[..., :4 * fa.HEAD_DIM]))
    torch.cuda.synchronize()
    ref = fa.delta_rows(out, dout, 4)
    limit = 1e-5 * float((out.float() * dout.float()).abs().view(3, n, 4, 64).sum(-1).max())
    err = float((runs[0][0] - ref).abs().max())
    assert torch.isfinite(runs[0][0]).all() and err <= limit, f"D n={n}: {err:.3g} > {limit:.3g}"
    if dtype == torch.float32 and n > 1:
        assert not torch.equal(out, out.bfloat16().float())
        assert not torch.equal(dout, dout.bfloat16().float())
        copies = fa.delta_rows(out.bfloat16(), dout.bfloat16(), 4)
        assert float((copies - ref).abs().max()) > limit, "the control does not discriminate"
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("n", [197, 209])
def test_flash_backward_with_an_all_negative_row(cuda, n):
    """One query row (image 0, row 3, every head) whose logits all lie below
    -100 (k's first column 1 at every key, that row's q -6,400 there: about
    -800 at sm_scale 1/8). A padded key of dQ's last tile (224 slots) has s =
    0, and exp2(-lse·log2 e) is inf there: the kernel sets P = 0 for keys at
    or past N, so o, dq, dk and dv stay finite and within _flash_check's
    tolerances of the plain versions, and the D written is finite."""
    from hvt_torch.ops import flash_attention as fa

    qkv, dout = _flash_case(3, 4, n, cuda)
    c = 4 * fa.HEAD_DIM
    for head in range(4):
        qkv[:, :, c + head * fa.HEAD_DIM] = 1.0
        qkv[0, 3, head * fa.HEAD_DIM] = -6400.0
    scale = fa.HEAD_DIM ** -0.5
    out, lse = fa.forward(qkv, 4, scale)
    ref, ref_lse = fa.forward_plain(qkv, 4, scale)
    assert (ref_lse[0, :, 3] < -100).all()
    _close(out, ref, 1e-2, f"o all-negative row n={n}")
    delta = torch.empty((3, 4, n), device=cuda)
    dqkv = torch.empty_like(qkv)
    fa.backward_dq(qkv, out, dout, lse, delta, dqkv, 4, scale)
    got = fa.backward(qkv, out, lse, dout, 4, scale)
    ref_d = fa.backward_plain(qkv, ref, ref_lse, dout, 4, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(delta).all()
    floor = 1e-3 * float(ref_d.abs().max())
    for i, name in enumerate(("dq", "dk", "dv")):
        _close(got[..., i * c:(i + 1) * c], ref_d[..., i * c:(i + 1) * c], 2e-2,
               f"flash {name} all-negative row n={n}", floor)


def test_flash_backward_is_two_launches_and_no_eager_d(cuda, monkeypatch):
    """Through autograd on the card, the backward is the dQ kernel (which
    writes D) and then the dK/dV kernel (which reads it): ``delta_rows``,
    the eager D, patched to raise, is never called."""
    from hvt_torch.ops import flash_attention as fa

    def eager(*_):
        raise AssertionError("delta_rows called on the CUDA path")

    monkeypatch.setattr(fa, "delta_rows", eager)
    order = []
    for name in ("BWD_DQ_KERNEL", "BWD_DKV_KERNEL"):
        kernel = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _k=kernel, _n=name: (order.append(_n), _k(*a)))
    for dtype in (torch.bfloat16, torch.float32):
        qkv, dout = _flash_case(2, 6, 197, cuda, dtype)
        leaf = qkv.clone().requires_grad_(True)
        fa.flash_attention_qkv(leaf, 6, fa.HEAD_DIM ** -0.5).backward(dout)
        torch.cuda.synchronize()
        assert torch.isfinite(leaf.grad).all()
    assert order == ["BWD_DQ_KERNEL", "BWD_DKV_KERNEL"] * 2


# ---------------------------------------------------------------------------
# Tensor parallelism's pieces on the card: two gloo ranks on one device
# ---------------------------------------------------------------------------

GRID_WIDTHS = (96, 768)  # SwinV2-T's first and last stage


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """Two ranks of a gloo world on cuda:0 (``tests/torch_ddp_jobs.py``'s
    ``cuda_grid``), the world one model group: what each returned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    import torch_ddp_worker

    return torch_ddp_worker.spawn("cuda_grid", 2, tmp_path_factory.mktemp("cuda-grid"),
                                  {"widths": GRID_WIDTHS}, timeout=300.0)


def test_model_group_functions_on_cuda_tensors(grid_ranks):
    """The row-parallel output sums its ranks' partials and passes its
    cotangent through; the column-parallel input passes x and sums the
    ranks' cotangents; a gathered weight is the ranks' shards in order, its
    gradient this rank's slice of the full one. Exact on small integers."""
    for r, out in enumerate(grid_ranks):
        assert out["model"] == (r, 2) and out["backend"] == "gloo"
        y, dx = out["reduce"]
        assert torch.equal(y, torch.full((4, 3), 3.0)) and torch.equal(dx, torch.full((4, 3), r + 1.0))
        z, dx = out["copy"]
        assert torch.equal(z, torch.full((4, 3), 2.0)) and torch.equal(dx, torch.full((4, 3), 3.0))
        for dim in (0, 1):
            g, dw, want, device = out[f"gather{dim}"]
            assert device == "cuda"
            assert torch.equal(g, torch.arange(48, dtype=torch.float32).reshape(8, 6))
            assert torch.equal(dw, want)


def test_gloo_all_gather_of_cuda_tensors_goes_through_the_host(grid_ranks):
    """gloo takes no CUDA tensor in all_gather: the port copies to the host
    and back, chosen by the group's backend; ZeRO-1's slice gather puts the
    ranks' slices along their dim."""
    for out in grid_ranks:
        staged, device = out["staged"]
        assert device == "cuda" and torch.equal(staged, torch.tensor([[0.0] * 3, [1.0] * 3]))
        assert torch.equal(out["slices"], torch.cat([torch.full((6, 2), 1.0),
                                                     torch.full((6, 2), 2.0)], 1))


@pytest.mark.parametrize("c", GRID_WIDTHS)
def test_mlp_half_kernels_on_weights_gathered_from_shards(grid_ranks, c):
    """The fused MLP's forward and backward kernels (one launch each) on
    fc1/fc2 gathered from each rank's shards, against the plain half on the
    full weights: the output within 2e-2·max|plain| (the fused halves'
    tolerance), each shard's gradient within 2e-2·max|plain| of its slice
    of the plain half's full-weight gradient."""
    for r, out in enumerate(grid_ranks):
        rec = out["mlp"][c]
        assert rec["launches"] == (1, 1)
        _close(*rec["y"], 2e-2, f"mlp_half C={c} rank {r}")
        for name, (got, want) in zip(("dw1", "db1", "dw2"), rec["grads"]):
            assert got.shape == want.shape
            _close(got, want, 2e-2, f"{name} shard, C={c} rank {r}")


# ---------------------------------------------------------------------------
# The Switch-MoE's index dispatch and routing on the card
# ---------------------------------------------------------------------------


def _one_hot_moe(layer, x):
    """hvt's MoeMlp formula (hvt/ops/moe.py:85-113) in plain torch: the
    (g, s, E, cap) one-hot dispatch and combine einsums, in x's dtype."""
    import torch.nn.functional as F

    g, m = x.shape[0], x.shape[-1]
    tokens = x.reshape(g, -1, m)
    s, e = tokens.shape[1], layer.num_experts
    cap = layer.capacity(s)
    probs = torch.softmax(tokens.float() @ layer.router, -1)
    onehot = F.one_hot(probs.argmax(-1), e).float()
    ranks = (onehot.cumsum(1) - 1.0) * onehot
    dispatch = onehot * (ranks < cap)
    # jax's one_hot of a rank past the capacity is zeros; dispatch zeroes those rows here
    slot = F.one_hot(ranks.long().clamp(max=cap - 1), cap).float() * dispatch[..., None]
    gate = (probs * dispatch).sum(-1)
    cdt = x.dtype
    slot = slot.to(cdt)
    expert_in = torch.einsum("gsec,gsm->egcm", slot, tokens)
    h = F.gelu(torch.einsum("egcm,emh->egch", expert_in, layer.w1.to(cdt))
               + layer.b1.to(cdt)[:, None, None, :])
    out = (torch.einsum("egch,ehm->egcm", h, layer.w2.to(cdt))
           + layer.b2.to(cdt)[:, None, None, :])
    combine = slot * gate.to(cdt)[:, :, None, None]
    return torch.einsum("gsec,egcm->gsm", combine, out).reshape(x.shape)


@pytest.mark.parametrize("c,grid", [(384, 14), (768, 7)])
def test_moe_index_dispatch_equals_the_one_hot_formula(cuda, c, grid):
    """SwinV2-T MoE-8's two block shapes at batch 16 in bf16: the port's
    index dispatch and combine against hvt's one-hot einsums, equal
    bit for bit (each einsum has one non-zero term an element; the expert
    products are the same batched matmuls on the same rows)."""
    from hvt_torch.ops import moe

    layer = moe.MoeMlp(c, 8, 4 * c, c)
    layer.reset_parameters(torch.Generator().manual_seed(c))
    with torch.no_grad():
        layer.router.mul_(50.0)  # spread the routing so that some images drop tokens
    layer = layer.to(cuda)
    x = torch.randn(16, grid, grid, c, generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    layer.train()
    with torch.no_grad():
        got = layer(x)
        want = _one_hot_moe(layer, x)
    assert 0.0 < layer.dropped_share() < 1.0
    assert got.dtype == torch.bfloat16 and torch.equal(got, want), float(
        (got.float() - want.float()).abs().max())


def test_moe_argmax_tie_takes_the_first_expert_on_cuda(cuda):
    """A zero router makes every probability 1/E: argmax on the card takes
    expert 0, as jnp.argmax, and the capacity keeps each image's first
    ceil(s / E · 1.25) tokens."""
    from hvt_torch.ops import moe

    layer = moe.MoeMlp(96, 8, 384, 96).to(cuda)
    x = torch.randn(4, 7, 7, 96, device=cuda, dtype=torch.bfloat16)
    _, expert, slot, kept, _ = layer.route(x.reshape(4, 49, 96))
    assert int(expert.max()) == 0
    assert slot[0].tolist() == list(range(49))
    assert kept.sum(1).tolist() == [layer.capacity(49)] * 4 == [8] * 4


# ---------------------------------------------------------------------------
# int8 serving: the int8 conv kernel (1×1 convs too) and int8_linear's
# _int_mm route against their plain versions (exact int32 sums in f64). The
# sums are exact on both sides, so the int32 accumulations and the
# dequantized f32 outputs are bit-equal, and bf16 outputs too (one rounding
# of the same f32 value).
# ---------------------------------------------------------------------------

from hvt_torch.ops import int8_cuda as i8  # noqa: E402
from hvt_torch.ops import quant as q8  # noqa: E402

INT8_CONVS = [  # (N, H, W, C, KH, KW, O, groups, stride, pads (top, bottom, left, right))
    (3, 11, 13, 24, 3, 3, 40, 1, 1, (1, 1, 1, 1)),  # ragged M and N tiles, 8-byte loads
    (2, 10, 9, 20, 3, 3, 36, 1, 2, (0, 1, 1, 1)),  # flax SAME at stride 2, byte loads
    (2, 17, 17, 3, 7, 7, 64, 1, 2, (3, 3, 3, 3)),  # a ResNet stem
    (2, 16, 16, 3, 4, 4, 96, 1, 4, (0, 0, 0, 0)),  # a patchify stem
    (2, 14, 14, 96, 2, 2, 192, 1, 2, (0, 0, 0, 0)),  # ConvNeXt's downsample
    (2, 15, 15, 96, 7, 7, 96, 96, 1, (3, 3, 3, 3)),  # depthwise 7x7
    (2, 15, 15, 40, 5, 5, 40, 40, 2, (1, 2, 1, 2)),  # depthwise 5x5, TF-SAME at stride 2
    (2, 9, 9, 128, 3, 3, 128, 2, 2, (1, 1, 1, 1)),  # grouped 3x3, 64 a group
    (2, 9, 9, 48, 3, 3, 72, 6, 1, (1, 1, 1, 1)),  # grouped, 8 in and 12 out a group
    (3, 1, 1, 13, 1, 1, 5, 1, 1, (0, 0, 0, 0)),  # a squeeze-excite 1x1, M = 3, odd C
    (2, 7, 7, 64, 1, 1, 256, 1, 2, (0, 0, 0, 0)),  # a strided 1x1 shortcut
]


def _int8_conv_case(case, device, seed=0):
    n, h, w, c, kh, kw, o, g, s, pads = case
    rng = np.random.default_rng(seed)
    xq = torch.as_tensor(rng.integers(-127, 128, (n, h, w, c)), dtype=torch.int8, device=device)
    wq = torch.as_tensor(rng.integers(-127, 128, (kh, kw, c // g, o)), dtype=torch.int8,
                         device=device)
    sx = torch.tensor(0.013, device=device)
    sw = torch.as_tensor(rng.uniform(1e-3, 2e-2, o), dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.normal(size=o), dtype=torch.float32, device=device)
    return xq, wq, sx, sw, b, dict(stride=s, pads=pads, groups=g)


@pytest.mark.parametrize("case", INT8_CONVS)
def test_int8_conv_matches_plain_bit_for_bit(cuda, case):
    xq, wq, sx, sw, b, kw = _int8_conv_case(case, cuda)
    acc_ref = i8.conv_acc_plain(xq, wq, i8._norm_stride(kw["stride"]), kw["pads"], kw["groups"])
    before = i8.CONV_KERNEL.launches + i8.INT_MM.launches
    acc = i8.int8_conv2d(xq, wq, sx, sw, **kw)
    torch.cuda.synchronize()
    assert i8.CONV_KERNEL.launches + i8.INT_MM.launches == before + 1
    assert torch.equal(acc, acc_ref)
    for dtype in (torch.float32, torch.bfloat16):
        for bias in (b, None):
            got = i8.int8_conv2d(xq, wq, sx, sw, bias, dtype, **kw)
            ref = i8.dequant_plain(acc_ref, sx, sw, bias, dtype)
            assert got.dtype == dtype and torch.equal(got, ref), (dtype, bias is None)


def test_int8_conv_off_an_8_byte_boundary_and_rerun(cuda):
    case = (2, 9, 9, 32, 3, 3, 48, 1, 1, (1, 1, 1, 1))
    xq, wq, sx, sw, b, kw = _int8_conv_case(case, cuda, seed=3)
    ref = i8.int8_conv2d(xq, wq, sx, sw, b, torch.float32, **kw)
    for off in (1, 3, 4):
        xs = torch.empty(xq.numel() + 16, dtype=torch.int8, device=cuda)[off:off + xq.numel()]
        ws = torch.empty(wq.numel() + 16, dtype=torch.int8, device=cuda)[off:off + wq.numel()]
        xs.copy_(xq.reshape(-1))
        ws.copy_(wq.reshape(-1))
        got = i8.int8_conv2d(xs.view(xq.shape), ws.view(wq.shape), sx, sw, b, torch.float32, **kw)
        assert torch.equal(got, ref), off
    assert torch.equal(i8.int8_conv2d(xq, wq, sx, sw, b, torch.float32, **kw), ref)


@pytest.mark.parametrize("m,k,n", [(3, 40, 24), (16, 13, 5), (17, 96, 288), (100, 768, 3072),
                                   (6272, 384, 96), (33, 2048, 10)])
def test_int8_linear_matches_plain_at_ragged_shapes_and_small_m(cuda, m, k, n):
    rng = np.random.default_rng(m + k + n)
    xq = torch.as_tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8, device=cuda)
    wq = torch.as_tensor(rng.integers(-127, 128, (n, k)), dtype=torch.int8, device=cuda)
    sx = torch.tensor(0.021, device=cuda)
    sw = torch.as_tensor(rng.uniform(1e-3, 2e-2, n), dtype=torch.float32, device=cuda)
    b = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    acc_ref = i8.linear_acc_plain(xq, wq)
    before = (i8.INT_MM.launches, i8.DEQUANT_KERNEL.launches)
    assert torch.equal(i8.int8_linear(xq, wq, sx, sw), acc_ref)
    assert (i8.INT_MM.launches, i8.DEQUANT_KERNEL.launches) == (before[0] + 1, before[1] + 1)
    for dtype in (torch.float32, torch.bfloat16):
        got = i8.int8_linear(xq.view(1, m, k), wq, sx, sw, b, dtype)
        assert got.shape == (1, m, n)
        assert torch.equal(got[0], i8.dequant_plain(acc_ref, sx, sw, b, dtype))


def test_int8_quantize_on_cuda_bit_equal_to_the_cpu(cuda):
    """The scales and int8 values on the card equal the CPU's (hvt's f32
    division), at absmax values where a product with 1/127 lands one ulp off."""
    amax = np.array([1.5132238, 7.5053263, 3.5341387, 4.469841], dtype=np.float32)
    assert (amax / np.float32(127) != amax * np.float32(1 / np.float32(127))).all()
    rng = np.random.default_rng(5)
    for a in amax:
        x = rng.uniform(-1, 1, (4, 33)).astype(np.float32)
        x = torch.from_numpy(x / np.abs(x).max() * a)
        assert float(x.abs().max()) == a
        xq, sx = q8.quantize_act(x)
        xq_c, sx_c = q8.quantize_act(x.to(cuda))
        assert torch.equal(sx_c.cpu(), sx) and torch.equal(xq_c.cpu(), xq)
        wq, sw = q8.quantize_weight(x, (1,))
        wq_c, sw_c = q8.quantize_weight(x.to(cuda), (1,))
        assert torch.equal(sw_c.cpu(), sw) and torch.equal(wq_c.cpu(), wq)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_1x1_conv_runs_int_mm_under_the_context(cuda, stride):
    """A 1×1 conv without pads under the int8 context: one _int_mm and one
    dequant, no conv kernel; bit-equal to the same layer on the CPU."""
    from hvt_torch.models import common

    torch.manual_seed(stride)
    conv = torch.nn.Conv2d(64, 256, 1, stride=stride)
    model = torch.nn.Sequential(conv)
    x = torch.randn(3, 14, 14, 64)
    with torch.inference_mode(), q8.Int8(model.to(cuda)):
        common.conv_nhwc(conv, x.to(cuda))  # quantizes the weight
        before = (i8.CONV_KERNEL.launches, i8.INT_MM.launches, i8.DEQUANT_KERNEL.launches)
        got = common.conv_nhwc(conv, x.to(cuda))
        torch.cuda.synchronize()
        after = (i8.CONV_KERNEL.launches, i8.INT_MM.launches, i8.DEQUANT_KERNEL.launches)
    assert after == (before[0], before[1] + 1, before[2] + 1)
    with torch.inference_mode(), q8.Int8(model.cpu()):
        want = common.conv_nhwc(conv, x)
    assert torch.equal(got.cpu(), want)


def test_int8_context_on_cuda_launches_no_float_product(cuda, monkeypatch):
    """Under an int8 context a covered layer on a CUDA tensor runs the int8
    kernels; the float products are patched to raise."""
    import torch.nn.functional as F

    conv = torch.nn.Conv2d(16, 32, 3, padding=1).to(cuda)
    fc = torch.nn.Linear(32, 24).to(cuda)
    model = torch.nn.Sequential(conv, fc)
    x = torch.randn(2, 8, 8, 16, device=cuda)
    from hvt_torch.models import common

    def refuse(*a, **k):
        raise AssertionError("a float product ran under int8")

    monkeypatch.setattr(F, "conv2d", refuse)
    monkeypatch.setattr(F, "linear", refuse)
    with torch.inference_mode(), q8.Int8(model):
        y = common.linear(fc, common.conv_nhwc(conv, x))
    assert y.shape == (2, 8, 8, 24) and torch.isfinite(y).all()
