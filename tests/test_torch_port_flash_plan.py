"""The Hopper flash-attention kernels' plan and walk, on the CPU.

The forward, dK/dV and dQ kernels (csrc/flash_attention.cu) run only on
the card. Their plan (``hvt_torch.ops.flash_attention.flash_plan``, the
host code's ``fwd_plan``, ``dkv_plan`` and ``dq_plan`` in Python;
chip_smoke.py holds the two equal) is checked here for every N from 1 to
1,400 at 12 and 16 heads:

* every query and key row of every (image, head) is covered exactly once,
  by the outer 64-row tiles and by the inner tiles of each;
* the forward's key slots are at most 208 at N = 197 (ViT-B/16 at 224 px)
  and under 320 at N = 257 (DINOv2 at 224 px), and each inner width is one
  the source instantiates;
* a block's dynamic shared memory fits the H100's 227 KB, and two blocks
  fit an SM (the design's overlap), and no TMA box side passes 256;
* the blocks of one (image, head) are consecutive in the linear block
  index, and one block takes the whole (image, head) at N <= 256, so each
  operand of a head crosses device memory once.

Then the walk itself, emulated in plain torch: the online softmax over the
plan's key tiles with the unnormalised p rounded to bf16 before p·v, the
backward's chunks with Pᵀ and dSᵀ·sm_scale rounded to bf16, and dQ's key
tiles (keys past N given P = 0 explicitly) with dS·sm_scale rounded and D
formed from O and dO in the dQ kernel's order, from bf16 inputs, at N = 1,
5, 197, 257 and 1,025 (B = 2, H = 2). Held, as max|Δ| over max|ref|, against the plain versions (f32
throughout; the card's tolerances, chip_smoke.py FLASH_TOL: o 1e-2, lse
1e-4, gradients 2e-2, with the gradients' scale at least 1e-3·max|dqkv|
where the exact dq and dk are 0, N = 1) and against hvt's ``_attend_flash``
through the ``hvt_flash`` fixture (jax's reference attention, which rounds
the logits and P to bf16: o 3e-2, gradients 5e-2, as
tests/test_torch_port_vit.py holds the plain versions). The dQ kernel's
plain version (``backward_dq_plain``: dq and D) is held against hvt's D,
``jnp.sum(o.astype(f32) * do.astype(f32), -1)`` (jax's flash_attention.py:274),
and against hvt's dq; and a query row whose logits all lie below -100, whose
padded keys would give P = exp2(-lse·log2 e) = inf and so NaN in dS·k, keeps
the emulated dq finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.models import vit as jvit
from hvt_torch.ops import flash_attention as fa
from test_torch_port_vit import hvt_flash  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FWD_WIDTHS = set(range(64, 257, 16))  # the forward's instances, csrc/flash_attention.cu
DKV_WIDTHS = set(range(64, 129, 16))  # dK/dV's
DQ_WIDTHS = set(range(64, 129, 16))  # dQ's
SM_SHARED = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it reserved a block
LN2 = 0.6931471805599453


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def covered(plan: fa.KernelPlan, batch: int, heads: int) -> None:
    """Each (image, head)'s blocks consecutive, its outer tiles (and so its
    rows [0, n)) once each, and against each the inner tiles' rows [0, n)
    once each, no inner tile wholly past n."""
    blocks = plan.blocks(batch, heads)
    assert len(blocks) == batch * heads * plan.blocks_per_head
    seen = {}
    for index, (image, head, outer) in enumerate(blocks):
        seen.setdefault((image, head), []).append((index, list(outer)))
    assert len(seen) == batch * heads
    for owned in seen.values():
        indices = [i for i, _ in owned]
        assert indices == list(range(indices[0], indices[0] + len(indices))), "not consecutive"
        tiles = sorted(t for _, ts in owned for t in ts)
        assert tiles == list(range(plan.outer))
    assert (plan.outer - 1) * fa.ROWS < plan.n <= plan.outer * fa.ROWS
    inner = np.concatenate([np.arange(j * plan.inner, (j + 1) * plan.inner)
                            for j in range(plan.tiles)])
    keys = np.bincount(inner[inner < plan.n], minlength=plan.n)
    assert (keys == 1).all() and inner.size == plan.tiles * plan.inner
    assert (plan.tiles - 1) * plan.inner < plan.n, "an inner tile past n"


@pytest.mark.parametrize("heads", [12, 16])
def test_plan_covers_every_row_once_and_fits(heads):
    for n in range(1, 1401):
        fwd, dkv, dq = fa.flash_plan(n)
        for plan, widths in ((fwd, FWD_WIDTHS), (dkv, DKV_WIDTHS), (dq, DQ_WIDTHS)):
            what = f"{plan.kernel} at n={n}"
            assert plan.inner in widths and plan.inner % 16 == 0, what
            assert plan.outer == -(-n // fa.ROWS), what
            assert plan.smem <= fa.SMEM_PER_BLOCK, what
            assert 2 * (plan.smem + 1024) <= SM_SHARED, f"{what}: not two blocks an SM"
            assert max(plan.boxes.values()) <= fa.BOX_MOST, what
            assert plan.blocks_per_head == (1 if plan.resident else plan.outer), what
            if n <= 256:  # a whole (image, head) a block: its operands read once
                assert plan.resident and plan.blocks_per_head == 1, what
            covered(plan, 2 if n % 97 else 3, heads)
        assert dkv.inner <= fa.DKV_CHUNK and (fwd.tiles == 1 or fwd.inner <= fa.FWD_STREAM)
        assert dq.inner <= fa.DQ_TILE and set(dq.boxes) == {"q", "do", "o", "k", "v", "dq"}
    assert fa.flash_plan(197)[0].tiles * fa.flash_plan(197)[0].inner <= 208
    assert fa.flash_plan(257)[0].tiles * fa.flash_plan(257)[0].inner < 320


def test_plan_at_the_models_lengths():
    """The walks the ViT-B/16 and DINOv2-B/14 shapes take."""
    rows = {n: [(p.inner, p.tiles, p.blocks_per_head) for p in fa.flash_plan(n)]
            for n in (197, 257, 1025, 1370)}
    assert rows == {197: [(208, 1, 1), (112, 2, 1), (112, 2, 1)],
                    257: [(144, 2, 1), (96, 3, 5), (96, 3, 5)],
                    1025: [(160, 7, 17), (128, 9, 17), (128, 9, 17)],
                    1370: [(160, 9, 22), (128, 11, 22), (128, 11, 22)]}


# ---------------------------------------------------------------------------
# The walk, emulated
# ---------------------------------------------------------------------------

def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _padded(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., n, d) zero-filled to `rows` rows, as TMA fills rows past n."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[-2]))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.view(b, n, heads, c // heads).transpose(1, 2)


def emulate_forward(qkv: torch.Tensor, heads: int, sm_scale: float):
    """(o (B, N, D) f32, lse (B, H, N)) as the forward kernel computes them:
    bf16 operands, an online softmax over the plan's key tiles in f32 (base
    2, masked keys -inf), p rounded to bf16 before p·v."""
    b, n, c3 = qkv.shape
    plan = fa.flash_plan(n)[0]
    q, k, v = (_bf(t) for t in fa._split(qkv, heads))
    q = _padded(q, plan.outer * fa.ROWS)
    k, v = (_padded(t, plan.tiles * plan.inner) for t in (k, v))
    scale_log2 = float(np.float32(sm_scale) * np.float32(np.log2(np.e)))
    m = torch.full(q.shape[:-1], -torch.inf)
    l, o = torch.zeros(q.shape[:-1]), torch.zeros(q.shape)
    for j in range(plan.tiles):
        cols = slice(j * plan.inner, (j + 1) * plan.inner)
        key = torch.arange(cols.start, cols.stop)
        s = torch.where(key < n, (q @ k[..., cols, :].transpose(-1, -2)) * scale_log2, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(m_new == -torch.inf, torch.zeros(()), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        l = alpha * l + p.sum(-1)
        o = o * alpha[..., None] + _bf(p) @ v[..., cols, :]
        m = m_new
    o = (o / l[..., None])[..., :n, :]
    lse = ((m + torch.log2(l)) * LN2)[..., :n]
    return o.transpose(1, 2).reshape(b, n, c3 // 3), lse


def kernel_delta(out, dout, heads: int) -> torch.Tensor:
    """D = rowsum(dO∘O) (B, H, N) f32 as the dQ kernel forms it: each product
    rounded to f32, the 32 of each half of a row added in column order (two
    threads a row), then the two halves added (one shuffle)."""
    prod = _heads(out.float(), heads) * _heads(dout.float(), heads)
    halves = []
    for h in range(2):
        acc = torch.zeros(prod.shape[:-1])
        for col in range(32 * h, 32 * h + 32):
            acc = acc + prod[..., col]
        halves.append(acc)
    return halves[0] + halves[1]


def emulate_backward(qkv, out, lse, dout, heads: int, sm_scale: float,
                     mask: bool = True) -> torch.Tensor:
    """dqkv (B, N, 3·D) f32 as the kernels compute it: D from out and dout in
    the dQ kernel's order; dQ over its plan's key tiles (keys past n zero k
    and v, and P = 0, unless ``mask`` is false), dS·sm_scale rounded to bf16
    before dS·k; dK/dV over its query chunks (rows past n: zero q and dO,
    zero lse and D), Pᵀ and dSᵀ·sm_scale rounded to bf16 before Pᵀ·dO and
    dSᵀ·q."""
    b, n, c3 = qkv.shape
    _, plan, dq_plan = fa.flash_plan(n)
    delta = kernel_delta(out, dout, heads)
    q, k, v = (_bf(t) for t in fa._split(qkv, heads))
    go = _bf(_heads(dout, heads))
    scale_log2 = float(np.float32(sm_scale) * np.float32(np.log2(np.e)))
    lse2 = lse.float() * float(np.float32(np.log2(np.e)))
    rows = plan.tiles * plan.inner
    qp, gp = _padded(q, rows), _padded(go, rows)
    lp = torch.nn.functional.pad(lse2, (0, rows - n))
    dp_ = torch.nn.functional.pad(delta, (0, rows - n))
    keys = plan.outer * fa.ROWS
    kp, vp = _padded(k, keys), _padded(v, keys)
    dk, dv = torch.zeros(kp.shape), torch.zeros(kp.shape)
    for ch in range(plan.tiles):
        cols = slice(ch * plan.inner, (ch + 1) * plan.inner)
        p_t = torch.exp2((kp @ qp[..., cols, :].transpose(-1, -2)) * scale_log2
                         - lp[..., None, cols])
        dp_t = vp @ gp[..., cols, :].transpose(-1, -2)
        ds_t = p_t * ((dp_t - dp_[..., None, cols]) * sm_scale)
        dv = dv + _bf(p_t) @ gp[..., cols, :]
        dk = dk + _bf(ds_t) @ qp[..., cols, :]
    keys = dq_plan.tiles * dq_plan.inner
    kq, vq = _padded(k, keys), _padded(v, keys)
    dq = torch.zeros(q.shape)
    for j in range(dq_plan.tiles):
        cols = slice(j * dq_plan.inner, (j + 1) * dq_plan.inner)
        p = torch.exp2((q @ kq[..., cols, :].transpose(-1, -2)) * scale_log2 - lse2[..., None])
        if mask:
            p = torch.where(torch.arange(cols.start, cols.stop) < n, p, torch.zeros(()))
        ds = p * ((go @ vq[..., cols, :].transpose(-1, -2) - delta[..., None]) * sm_scale)
        dq = dq + _bf(ds) @ kq[..., cols, :]
    grads = [dq, dk[..., :n, :], dv[..., :n, :]]
    return torch.stack(grads, 2).permute(0, 3, 2, 1, 4).reshape(b, n, c3)


def close(got, ref, tol, what, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), max(np.abs(ref).max(), floor)
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _inputs(n: int, b: int = 2, h: int = 2):
    rng = np.random.default_rng(n)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * 64)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(b, n, h * 64)).astype(np.float32))
    return qkv.bfloat16(), dout.bfloat16()


def _grads_close(got, ref, h, tol, what):
    c = h * 64
    floor = 1e-3 * float(ref.abs().max())  # dq and dk are 0 in exact arithmetic at N = 1
    for i, name in enumerate(("dq", "dk", "dv")):
        close(got[..., i * c:(i + 1) * c], ref[..., i * c:(i + 1) * c], tol, f"{name} {what}",
              floor)


def _hvt_grads(qkv, dout, h: int, n: int):
    """hvt's ``_attend_flash`` on qkv's q, k, v (bf16): (o (B, H, N, 64) f32,
    dqkv (B, N, 3·D) f32 of sum(o·dO))."""
    b = qkv.shape[0]
    q, k, v = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in fa._split(qkv, h))
    g = jnp.asarray(_heads(dout, h).float().numpy())

    def fwd(q_, k_, v_):
        return jvit._attend_flash(q_, k_, v_, n_real=n, sm_scale=0.125)

    def loss(q_, k_, v_):
        return jnp.sum(fwd(q_, k_, v_).astype(jnp.float32) * g)

    ref = np.asarray(jax.jit(fwd)(q, k, v).astype(jnp.float32))
    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    ref_d = torch.stack([torch.from_numpy(np.array(r.astype(jnp.float32))) for r in ref_g], 2)
    return ref, ref_d.permute(0, 3, 2, 1, 4).reshape(b, n, 3 * h * 64)


@pytest.mark.parametrize("n", [1, 5, 197, 257, 1025])
def test_emulated_walk_matches_the_plain_versions(n):
    qkv, dout = _inputs(n)
    o, lse = emulate_forward(qkv, 2, 0.125)
    ref, ref_lse = fa.forward_plain(qkv, 2, 0.125)
    close(o, ref.float(), 1e-2, f"o n={n}")
    close(lse, ref_lse, 1e-4, f"lse n={n}")
    dqkv = emulate_backward(qkv, ref, ref_lse, dout, 2, 0.125)
    _grads_close(dqkv, fa.backward_plain(qkv.float(), ref.float(), ref_lse, dout.float(), 2,
                                         0.125), 2, 2e-2, f"n={n}")


@pytest.mark.parametrize("n", [1, 5, 197, 257, 1025])
def test_emulated_walk_matches_hvts_attend_flash(hvt_flash, n):
    qkv, dout = _inputs(n)
    h = 2
    ref, ref_d = _hvt_grads(qkv, dout, h, n)
    o, lse = emulate_forward(qkv, h, 0.125)
    close(_heads(o, h), ref, 3e-2, f"o against hvt n={n}")
    dqkv = emulate_backward(qkv, o.bfloat16(), lse, dout, h, 0.125)
    _grads_close(dqkv, ref_d, h, 5e-2, f"against hvt n={n}")


@pytest.mark.parametrize("n", [1, 5, 197, 257, 1025])
def test_dq_plain_matches_hvts_d_and_dq(hvt_flash, n):
    """``backward_dq_plain``'s (dq, D) and the emulated kernel's D: D against
    hvt's, ``jnp.sum(o.astype(f32) * do.astype(f32), -1)`` on the same bf16
    o and dO, within 1e-5·max over rows of Σ|dO∘O| (f32 sums of the same
    exact bf16 products in other orders); dq against ``jax.grad`` of hvt's
    ``_attend_flash`` within 5e-2 (jax's reference rounds the logits and P
    to bf16), with the gradients' scale at least 1e-3·max|hvt dqkv| (dq is
    0 in exact arithmetic at N = 1)."""
    qkv, dout = _inputs(n)
    h = 2
    out, lse = fa.forward_plain(qkv, h, 0.125)  # out bf16, as the kernel's o for bf16 qkv
    dq, delta = fa.backward_dq_plain(qkv, out, dout, lse, h, 0.125)
    o_h, g_h = (jnp.asarray(_heads(t, h).float().numpy()).astype(jnp.bfloat16)
                for t in (out, dout))
    hvt_d = np.asarray(jnp.sum(o_h.astype(jnp.float32) * g_h.astype(jnp.float32), -1))
    scale = float((_heads(out, h).float() * _heads(dout, h).float()).abs().sum(-1).max())
    for what, got in (("plain", delta), ("kernel order", kernel_delta(out, dout, h))):
        assert got.dtype == torch.float32 and got.shape == (2, h, n), what
        err = float(np.abs(got.numpy() - hvt_d).max())
        assert err <= 1e-5 * scale, f"D ({what}) n={n}: max|Δ| {err:.3g} > 1e-5·{scale:.3g}"
    _, ref_d = _hvt_grads(qkv, dout, h, n)
    c = h * 64
    assert dq.dtype == qkv.dtype and dq.shape == (2, n, c)
    close(dq.float(), ref_d[..., :c], 5e-2, f"dq against hvt n={n}",
          1e-3 * float(ref_d.abs().max()))


@pytest.mark.parametrize("n", [197, 209])
def test_emulated_dq_masks_the_padded_keys_of_an_all_negative_row(n):
    """One query row (image 0, row 3, both heads) whose logits all lie below
    -100: k's first column 1 at every key, that row's q -6,400 there, so
    sm_scale·q·k is about -800 (a common k column of unit size, so that
    bf16's rounding of dS, summed against it, stays at the scale of the
    other columns). Its lse2 = lse·log2 e is then about -1,150, and a
    padded key of dQ's last tile (224 slots: 27 at N = 197, 15 at 209), whose
    zero k gives s = 0, would give P = exp2(-lse2) = inf and NaN in dS·k:
    the control without the explicit mask shows it. With the mask the
    emulated walk's dq, dk, dv are finite and within 2e-2 of the plain
    backward (f32), as in test_emulated_walk_matches_the_plain_versions."""
    qkv, dout = _inputs(n)
    h, c = 2, 2 * 64
    qkv = qkv.float()
    for head in range(h):
        qkv[:, :, c + head * 64] = 1.0
        qkv[0, 3, head * 64] = -6400.0
    qkv = qkv.bfloat16()
    ref, ref_lse = fa.forward_plain(qkv, h, 0.125)
    lse2 = ref_lse[0, :, 3] * float(np.float32(np.log2(np.e)))
    assert (ref_lse[0, :, 3] < -100).all() and torch.isinf(torch.exp2(-lse2)).all()
    unmasked = emulate_backward(qkv, ref, ref_lse, dout, h, 0.125, mask=False)
    assert torch.isnan(unmasked[0, 3, :c]).any(), "the trap did not bite"
    dqkv = emulate_backward(qkv, ref, ref_lse, dout, h, 0.125)
    assert torch.isfinite(dqkv).all()
    _grads_close(dqkv, fa.backward_plain(qkv.float(), ref.float(), ref_lse, dout.float(), h,
                                         0.125), h, 2e-2, f"all-negative row n={n}")
