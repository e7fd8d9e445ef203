"""The precision plan of the tensor-core window-attention forward, on the CPU.

``csrc/attention_fwd_tc.cuh`` runs both products of the attention core's
forward on tensor cores (bf16 operands, f32 accumulation) and keeps hvt's
contracts by these means: the normalisation is folded out of q·kᵀ (cos =
(q·kᵀ)·invQ·invK), so bf16 q and k enter unrounded; f32 inputs are split into
three bf16 pieces p0 + p1 + p2, cos takes the six piece products (p0p0, p0p1,
p1p0, p1p1, p0p2, p2p0) and the norms the pieces' sum; P, computed in f32,
meets v by contract: kept f32 (hvt's packed kernel, and the split kernel on
f32 v) as bf16 halves hi = bf16(P), lo = bf16(P − hi), hi·v + lo·v for bf16
v and hi·p0 + hi·p1 + lo·p0 for f32 v; rounded to v's dtype (hvt's split
kernel on bf16 v, ``attn.astype(v.dtype)``) as hi alone, one product.
``_plan_forward`` below emulates that operand handling in plain torch:
bf16-exact operands multiplied in f32 (each product exact, the sum in f32,
as the tensor cores accumulate). The card cannot be asked here, so this
shows the plan before the card runs it.

At SwinV2-T's four stage shapes (window 7; C = 96, 192, 384, 768 with 3, 6,
12, 24 heads; stages 1-3 shifted by 3 with the mask) and at window 8 (N = 64,
C = 96, shifted by 4) at batch 2, from numpy-seeded qkv, the emulation is
held against hvt's ``_packed_forward`` and ``_forward`` (the packed and the
split-q/k/v Pallas kernels, in interpret mode) within the tolerances
``chip_smoke.py`` holds the kernels to: 1e-2·max|ref| with bf16 inputs (the
output rounded to bf16 on both sides) and 1e-4 with f32 inputs. A control
shows the test can fail: P as one bf16 against f32 v misses 1e-4.

The kernel's grid is checked here too: ``tc_forward_chunks`` sizes the
chunks of images a block loops over, and the kernel's rule (image b of
chunk k covers window b·nWZ + wz for b in [k·per_block, (k+1)·per_block)
while that window exists) must cover every (image, window id) exactly once
at about one wave of blocks.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import window_attention_pallas as jwap
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH = 2
# (grid, C, heads, window): SwinV2-T's four stages at window 7, and window 8
CASES = ((56, 96, 3, 7), (28, 192, 6, 7), (14, 384, 12, 7), (7, 768, 24, 7), (16, 96, 3, 8))
IDS = ["stage1", "stage2", "stage3", "stage4", "window8"]


def _inputs(case: int, dtype: torch.dtype):
    """qkv (nWB, N, 3C) in ``dtype``, held as f32; z (nWZ, H, N, N); scale
    (H,) with head 0 clamped at 100."""
    grid, c, heads, window = CASES[case]
    rng = np.random.default_rng(50 + case)
    n = window * window
    nwb = BATCH * (grid // window) ** 2
    qkv = rng.normal(size=(nwb, n, 3 * c)) + rng.normal(size=3 * c) * 0.5
    ls = np.log(10.0) + rng.normal(size=heads) * 0.3
    ls[0] = 5.0
    bias = 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n))))
    shift = window // 2 if grid > window else 0
    z = bias[None]
    if shift:
        z = z + wa.shift_attn_mask((grid, grid), window, shift)[:, None]

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dt).float()

    scale = torch.exp(torch.clamp(t(ls, torch.float32), max=float(np.log(100.0))))
    return t(qkv), t(z, torch.float32), scale, heads


def _pieces(x: torch.Tensor, count: int) -> list:
    """x as ``count`` bf16 pieces (held in f32), largest first."""
    out = []
    for _ in range(count):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def _bf16_exact(x: torch.Tensor) -> bool:
    return bool(torch.equal(x, x.to(torch.bfloat16).float()))


def _mm(a: list, b: list, terms) -> torch.Tensor:
    """Σ a[i] @ b[j] over the piece products ``terms``, as the tensor cores
    run them: every piece bf16-exact, each product exact in f32."""
    assert all(_bf16_exact(x) for x in a + b)
    return sum(a[i] @ b[j] for i, j in terms)


SIX = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))  # f32 inputs: cos
THREE = ((0, 0), (0, 1), (1, 0))  # hi·p0 + hi·p1 + lo·p0: P against f32 v
TWO = ((0, 0), (1, 0))  # hi·v + lo·v: P against bf16 v


def _plan_forward(q, k, v, z, scale, f32_inputs: bool, round_p: bool = False,
                  halves: bool = True):
    """The kernel's operand handling on (g, H, N, D) f32 q, k, v: out (g, H,
    N, D) in f32, before the store's rounding. ``round_p``: P rounded to bf16
    once (the split contract on bf16 v). The control: with ``halves`` False,
    P enters as its hi half alone where the contract keeps it f32."""
    g, heads, n, _ = q.shape
    nwz = z.shape[0]
    count = 3 if f32_inputs else 1
    Q, K, V = (_pieces(x, count) for x in (q, k, v))
    q, k = sum(Q), sum(K)  # what the norms see
    iq = torch.rsqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    ik = torch.rsqrt((k * k).sum(-1, keepdim=True) + 1e-24)
    cos = _mm(Q, [x.transpose(-1, -2) for x in K], SIX if f32_inputs else ((0, 0),))
    cos = cos * iq * ik.transpose(-1, -2)
    logits = (cos * scale.reshape(1, heads, 1, 1)).reshape(g // nwz, nwz, heads, n, n) + z[None]
    p = torch.softmax(logits.reshape(g, heads, n, n), dim=-1)
    if round_p:
        assert not f32_inputs
        return _mm([p.to(torch.bfloat16).float()], V, ((0, 0),))
    terms = THREE if f32_inputs else TWO
    if not halves:
        terms = tuple(term for term in terms if term[0] == 0)
    return _mm(_pieces(p, 2), V, terms)


def _jnp(x: torch.Tensor, dtype: torch.dtype):
    return jnp.asarray(x.contiguous().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _hvt_packed(qkv, z, scale, heads, dtype):
    """hvt's packed Pallas forward ``_packed_forward`` in interpret mode on
    qkv in ``dtype``: (g, H, N, D) f32 of its output (in that dtype)."""
    g, n, c3 = qkv.shape
    out = jwap._packed_forward(_jnp(qkv, dtype), jnp.asarray(scale.numpy()).reshape(heads, 1, 1),
                               jnp.asarray(z.numpy()), heads, interpret=True)
    out = torch.as_tensor(np.array(out.astype(jnp.float32)))
    return out.reshape(g, n, heads, c3 // 3 // heads).transpose(1, 2)


def _hvt_split(q, k, v, z, scale, dtype):
    """hvt's split-q/k/v Pallas forward ``_forward`` in interpret mode on q,
    k, v in ``dtype``: f32 of its output (in that dtype)."""
    heads = q.shape[1]
    out = jwap._forward(*(_jnp(x, dtype) for x in (q, k, v)),
                        jnp.asarray(scale.numpy()).reshape(heads, 1, 1), jnp.asarray(z.numpy()),
                        interpret=True)
    return torch.as_tensor(np.array(out.astype(jnp.float32)))


def _rel_err(got, ref) -> float:
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert torch.isfinite(got).all()
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


@pytest.mark.parametrize("layout", ["packed", "split"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_precision_plan_matches_hvt_forward(case, dtype, layout):
    qkv, z, scale, heads = _inputs(case, dtype)
    q, k, v = (t.contiguous() for t in wa.split_heads(qkv, heads))
    f32_inputs = dtype == torch.float32
    assert f32_inputs or all(_bf16_exact(x) for x in (q, k, v))
    round_p = layout == "split" and not f32_inputs
    got = _plan_forward(q, k, v, z, scale, f32_inputs, round_p).to(dtype).float()
    if layout == "packed":
        ref = _hvt_packed(qkv, z, scale, heads, dtype)
    else:
        ref = _hvt_split(q, k, v, z, scale, dtype)
    tol = 1e-4 if f32_inputs else 1e-2
    err = _rel_err(got, ref)
    assert err <= tol, f"{layout} {IDS[case]} {dtype}: max|Δ| {err:.3g}·max|ref| > {tol}"


def test_single_bf16_p_misses_the_f32_tolerance():
    """The control: f32 inputs in three pieces, but P enters P·v as one bf16
    (its hi half alone). The output then misses 1e-4·max|ref| against hvt's
    packed forward, which the plan meets (above)."""
    qkv, z, scale, heads = _inputs(0, torch.float32)
    q, k, v = (t.contiguous() for t in wa.split_heads(qkv, heads))
    ref = _hvt_packed(qkv, z, scale, heads, torch.float32)
    assert _rel_err(_plan_forward(q, k, v, z, scale, True), ref) < 1e-4
    assert _rel_err(_plan_forward(q, k, v, z, scale, True, halves=False), ref) > 1e-4


def _block_shapes():
    """(nWB, nWZ, heads) of SwinV2-T's block shapes at batch 64 (each stage
    unshifted, and shifted where the map holds more than one window), and
    batches that are not whole images (nWB not a multiple of nWZ) or hold
    fewer windows than a block's id count."""
    shapes = []
    for grid, _, heads, _ in CASES[:4]:
        nw = (grid // 7) ** 2
        shapes.append((64 * nw, 1, heads))
        if nw > 1:
            shapes.append((64 * nw, nw, heads))
    return shapes + [(6, 4, 3), (2, 4, 3), (4096 + 17, 64, 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("nwb,nwz,heads", _block_shapes())
def test_forward_chunks_cover_every_window_once(nwb, nwz, heads, dtype):
    per_block, chunks = wac.tc_forward_chunks(nwb, nwz, heads, dtype)
    seen = collections.Counter()
    for chunk in range(chunks):
        for wz in range(nwz):  # the kernel's rule: images b of the chunk whose window exists
            b0 = chunk * per_block
            b_end = min(b0 + per_block, (nwb - wz + nwz - 1) // nwz)
            seen.update(b * nwz + wz for b in range(b0, b_end))
    assert sorted(seen) == list(range(nwb)) and set(seen.values()) == {1}
    blocks, target = chunks * nwz * heads, wac.TC_FWD_BLOCKS[dtype]
    assert blocks <= target or chunks == 1  # one wave at most, unless one chunk is more
    assert blocks > target // 2 or per_block == 1  # and at least half a wave where it can
