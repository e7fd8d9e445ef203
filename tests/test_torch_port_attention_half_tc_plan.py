"""The attention half's forward and backward under the tensor-core precision plan, on the CPU.

On the card, the attention half (``attention_half_nhwc`` and
``attention_half``, ``csrc/fused_halves.cuh``) computes its attention output
on tensor cores in the forward, and the backward (``csrc/fused_halves_bwd.cuh``)
recomputes it with the same device code and runs the core's backward on
tensor cores: q, k and v (an f32-accumulated projection plus an f32 bias)
and dao = dproj·Wproj (f32) enter as three bf16 pieces each, P and the
scaled dS as bf16 hi + lo halves, the normalisation folded out of the
products (``csrc/attention_fwd_tc.cuh`` with P kept f32,
``csrc/attention_bwd_tc.cuh`` with three pieces). Here the port's plain
forward and backward run with their attention core replaced by that operand
handling, emulated in plain torch by ``_plan_forward``
(tests/test_torch_port_attention_fwd_precision.py) and ``_plan_backward``
(tests/test_torch_port_attention_bwd_precision.py). The card cannot be asked
here, so this shows the plan before the card runs it.

At SwinV2-T's four stage shapes (window 7; C = 96, 192, 384, 768 with 3, 6,
12, 24 heads; stages 1-3 shifted by 3 with the mask) at batch 2, with
drop-path scales 0 and 1/keep and head 0's logit scale above the log 100
clamp, from numpy-seeded inputs (x in f32, so that no output rounding hides
the core's error):

* the forward, the branch alone and x + dp·branch, is held against hvt's
  ``attention_half_nhwc`` forward (its Pallas kernel in interpret mode)
  within 5e-3·max|ref|, the bound tests/test_torch_port_attention_half.py
  holds the plain forward to in f32. Both sides round x, the weights and
  the attention output to bf16 for the products and sum in another order,
  and the odd rounding of the attention output flips: the plain forward
  (an f32 core) lands about 1e-3 from hvt's at stage 1, the plan about
  1.4e-3. The windowed ``attention_half`` is held the same way at stage 2
  against hvt's ``attention_half``. A control shows the test can fail: q
  and k as one bf16 piece each miss that bound (the logit scale, up to
  100, multiplies their 2^-9 error: about 4e-2 at stage 1).
* every gradient (dx, the weights, biases, dbias and the logit scale) is
  held against hvt's ``attention_half_nhwc`` VJP (its Pallas forward and
  backward in interpret mode) within 5e-3·max|ref|, the bound
  tests/test_torch_port_fused_train.py holds the plain backward to. The
  logit scale's gradient is exactly 0 above the clamp. The control: q and k
  as one bf16 piece each (v and dao still in three) miss that bound.

The forward's chunk plan (``tc_half_fwd_chunks``: block (k·nWZ + wz, h) takes
windows u·nWZ + wz for u in [k·per_block, (k + 1)·per_block)) covers every
(image, window id, head) exactly once at every SwinV2-T and SwinV2-B block
shape (stages unshifted, and shifted where the map holds more than one
window) at batches 1, 64 and 128.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_port_attention_bwd_precision as bwd_plan
import test_torch_port_attention_fwd_precision as fwd_plan

from hvt.ops import fused_halves_pallas as jfh
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-3
WINDOW, BATCH, KEEP = 7, 2, 0.8
STAGES = ((56, 96, 3), (28, 192, 6), (14, 384, 12), (7, 768, 24))  # (grid, C, heads)
BASE_STAGES = ((56, 128, 4), (28, 256, 8), (14, 512, 16), (7, 1024, 32))  # SwinV2-B
NAMES = ("x", "wqkv", "bqkv", "ls", "bias", "wproj", "bproj", "lns", "lnb")
TRANSPOSED = ("wqkv", "wproj")  # flax (in, out) vs nn.Linear (out, in)
SCALES = np.asarray([0.0, 1.0 / KEEP], np.float32)  # image 0 dropped, image 1 kept


def _inputs(stage: int):
    """One block's inputs in flax layouts: the un-rolled map x, g, the
    parameters (LN scales around 1, head 0's logit scale above the clamp),
    the shift and its mask."""
    grid, c, heads = STAGES[stage]
    n = WINDOW * WINDOW
    rng = np.random.default_rng(60 + stage)
    ls = np.log(10.0) + rng.normal(size=(heads, 1, 1)) * 0.3
    ls[0] = 5.0
    p = {
        "x": rng.normal(size=(BATCH, grid, grid, c)),
        "wqkv": rng.normal(size=(c, 3 * c)) / math.sqrt(c),
        "bqkv": np.concatenate([rng.normal(size=c) * 0.1, np.zeros(c), rng.normal(size=c) * 0.1]),
        "ls": ls,
        "bias": 16.0 / (1.0 + np.exp(-rng.normal(size=(heads, n, n)))),
        "wproj": rng.normal(size=(c, c)) / math.sqrt(c),
        "bproj": rng.normal(size=c) * 0.1,
        "lns": 1.0 + rng.normal(size=c) * 0.1,
        "lnb": rng.normal(size=c) * 0.1,
        "g": rng.normal(size=(BATCH, grid, grid, c)),
    }
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    shift = WINDOW // 2 if grid > WINDOW else 0
    mask = wa.shift_attn_mask((grid, grid), WINDOW, shift) if shift else None
    return p, shift, mask, heads


@functools.lru_cache(maxsize=None)
def _hvt_gradients(stage: int):
    """hvt's ``attention_half_nhwc`` VJP in interpret mode on the rolled map
    (its kernels take it pre-rolled), the loss rolling the output back."""
    p, shift, mask, heads = _inputs(stage)
    dp = jnp.broadcast_to(jnp.asarray(SCALES)[:, None, None], (BATCH, 8, 128))
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(x, wq, bq, ls, bias, wp, bp, lns, lnb):
        out = jfh.attention_half_nhwc(x, wq, bq, ls, bias, jmask, wp, bp, lns, lnb, WINDOW, heads,
                                      True, dp=dp)
        return jnp.sum(jnp.roll(out, (shift, shift), (1, 2)) * jnp.asarray(p["g"]))

    args = [jnp.asarray(np.roll(p["x"], (-shift, -shift), (1, 2)))]
    args += [jnp.asarray(p[k]) for k in NAMES[1:]]
    ref = [np.asarray(r) for r in jax.jit(jax.grad(loss, argnums=tuple(range(9))))(*args)]
    ref[0] = np.roll(ref[0], (shift, shift), (1, 2))
    return ref


def _heads(qkv: torch.Tensor, heads: int, one_piece_qk: bool):
    """(g, N, 3C) f32 → q, k, v (g, H, N, D); q and k rounded to one bf16
    piece for the control."""
    q, k, v = wa.split_heads(qkv.float(), heads)
    if one_piece_qk:
        q, k = (t.to(torch.bfloat16).float() for t in (q, k))
    return q, k, v


def _plan_core(one_piece_qk: bool):
    """Stand-ins for the port's ``packed_heads_forward`` and
    ``packed_heads_backward`` (as ``_attn_branch_backward`` calls them) that
    run the tensor-core kernels' operand handling on f32 inputs."""

    def forward(qkv, z, scale, heads):
        g, n, c3 = qkv.shape
        q, k, v = _heads(qkv, heads, one_piece_qk)
        out = fwd_plan._plan_forward(q, k, v, z, scale, f32_inputs=True)
        return out.transpose(1, 2).reshape(g, n, c3 // 3)

    def backward(qkv, dout, z, scale, heads):
        g, n, c3 = qkv.shape
        q, k, v = _heads(qkv, heads, one_piece_qk)
        go = dout.float().reshape(g, n, heads, c3 // 3 // heads).transpose(1, 2)
        dq, dk, dv, dz, dscale = bwd_plan._plan_backward(q, k, v, go, z, scale, True)
        return torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(g, n, c3), dz, dscale

    return forward, backward


def _port_gradients(stage: int, monkeypatch, one_piece_qk: bool = False):
    """The port's ``attention_half_nhwc`` on CPU tensors (the un-rolled map
    and ``shift``), its backward's attention core under the plan."""
    p, shift, mask, heads = _inputs(stage)
    forward, backward = _plan_core(one_piece_qk)
    monkeypatch.setattr(fh, "packed_heads_forward", forward)
    monkeypatch.setattr(fh, "packed_heads_backward", backward)
    leaves = [torch.from_numpy(np.ascontiguousarray(p[k].T if k in TRANSPOSED else p[k]))
              .requires_grad_() for k in NAMES]
    x, wq, bq, ls, bias, wp, bp, lns, lnb = leaves
    out = fh.attention_half_nhwc(x, wq, bq, ls, bias, None if mask is None else torch.from_numpy(mask),
                                 wp, bp, lns, lnb, WINDOW, heads, dp=torch.from_numpy(SCALES),
                                 shift=shift)
    (out * torch.from_numpy(p["g"])).sum().backward()
    grads = [leaf.grad.numpy() for leaf in leaves]
    return [g.T if name in TRANSPOSED else g for name, g in zip(NAMES, grads)]


def _relative_errors(got, ref) -> dict:
    return {name: float(np.abs(np.float64(a) - b).max() / np.abs(np.float64(b)).max())
            for name, a, b in zip(NAMES, got, ref)}


@pytest.mark.parametrize("stage", range(4), ids=["stage1", "stage2", "stage3", "stage4"])
def test_attention_half_backward_under_the_plan_matches_hvt(stage, monkeypatch):
    ref = _hvt_gradients(stage)
    got = _port_gradients(stage, monkeypatch)
    assert ref[3][0, 0, 0] == 0.0 and got[3][0, 0, 0] == 0.0  # exactly 0 above the clamp
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape and np.isfinite(a).all(), name
    errors = _relative_errors(got, ref)
    assert max(errors.values()) <= TOL, errors


def test_one_bf16_piece_of_q_and_k_misses_the_bound(monkeypatch):
    """The control, at stage 1: q and k rounded to one bf16 piece each in the
    recomputed forward and in the core's backward. The logit scale (up to
    100) multiplies their 2^-9 error, and a gradient lands more than
    5e-3·max|ref| from hvt's."""
    ref = _hvt_gradients(0)
    errors = _relative_errors(_port_gradients(0, monkeypatch, one_piece_qk=True), ref)
    assert max(errors.values()) > TOL, errors


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def _port_leaves(p):
    return [torch.from_numpy(np.ascontiguousarray(p[k].T if k in TRANSPOSED else p[k]))
            for k in NAMES]


@functools.lru_cache(maxsize=None)
def _hvt_forward(stage: int, resid: bool):
    """hvt's ``attention_half_nhwc`` forward in interpret mode on the rolled
    map, its output rolled back: the branch, or x + dp·branch."""
    p, shift, mask, heads = _inputs(stage)
    dp = jnp.broadcast_to(jnp.asarray(SCALES)[:, None, None], (BATCH, 8, 128)) if resid else None
    args = [jnp.asarray(np.roll(p["x"], (-shift, -shift), (1, 2)))]
    args += [jnp.asarray(p[k]) for k in NAMES[1:]]
    out = jfh.attention_half_nhwc(*args[:5], None if mask is None else jnp.asarray(mask),
                                  *args[5:], WINDOW, heads, True, dp=dp)
    return np.roll(np.asarray(out, np.float32), (shift, shift), (1, 2))


def _port_forward(stage: int, monkeypatch, resid: bool, one_piece_qk: bool = False):
    """The port's ``attention_half_nhwc`` forward on CPU tensors (the
    un-rolled map and ``shift``), its attention core under the plan."""
    p, shift, mask, heads = _inputs(stage)
    monkeypatch.setattr(fh, "packed_heads_forward", _plan_core(one_piece_qk)[0])
    x, wq, bq, ls, bias, wp, bp, lns, lnb = _port_leaves(p)
    out = fh.attention_half_nhwc(x, wq, bq, ls, bias, None if mask is None else torch.from_numpy(mask),
                                 wp, bp, lns, lnb, WINDOW, heads,
                                 dp=torch.from_numpy(SCALES) if resid else None, shift=shift)
    return out.detach().numpy()


def _relative_error(got, ref) -> float:
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.abs(np.float64(got) - ref).max() / np.abs(np.float64(ref)).max())


@pytest.mark.parametrize("stage", range(4), ids=["stage1", "stage2", "stage3", "stage4"])
def test_attention_half_forward_under_the_plan_matches_hvt(stage, monkeypatch):
    errors = {resid: _relative_error(_port_forward(stage, monkeypatch, resid),
                                     _hvt_forward(stage, resid)) for resid in (False, True)}
    assert max(errors.values()) <= TOL, errors


def test_windowed_attention_half_forward_under_the_plan_matches_hvt(monkeypatch):
    """Stage 2 (C = 192, 6 heads, shifted by 3 with the mask): the windows
    partitioned from the rolled map, as the model's block makes them."""
    p, shift, mask, heads = _inputs(1)
    xw = wa.window_partition(torch.roll(torch.from_numpy(p["x"]), (-shift, -shift), (1, 2)),
                             WINDOW).numpy()
    ref = jfh.attention_half(jnp.asarray(xw), *[jnp.asarray(p[k]) for k in NAMES[1:5]],
                             jnp.asarray(mask), *[jnp.asarray(p[k]) for k in NAMES[5:]], heads,
                             True)
    monkeypatch.setattr(fh, "packed_heads_forward", _plan_core(False)[0])
    _, wq, bq, ls, bias, wp, bp, lns, lnb = _port_leaves(p)
    got = fh.attention_half(torch.from_numpy(xw), wq, bq, ls, bias, torch.from_numpy(mask), wp,
                            bp, lns, lnb, heads)
    assert _relative_error(got.detach().numpy(), np.asarray(ref, np.float32)) <= TOL


def test_one_bf16_piece_of_q_and_k_misses_the_forward_bound(monkeypatch):
    """The control, at stage 1: q and k rounded to one bf16 piece each move
    the branch more than 5e-3·max|ref| from hvt's."""
    error = _relative_error(_port_forward(0, monkeypatch, False, one_piece_qk=True),
                            _hvt_forward(0, False))
    assert error > TOL, error


@pytest.mark.parametrize("batch", [1, 64, 128])
@pytest.mark.parametrize("model", ["swinv2_tiny", "swinv2_base"])
def test_forward_chunk_plan_covers_every_window_and_head_once(model, batch):
    for grid, c, heads in STAGES if model == "swinv2_tiny" else BASE_STAGES:
        nw = (grid // WINDOW) ** 2
        for nwz in sorted({1, nw}):
            nwb = batch * nw
            per_block, chunks = fh.tc_half_fwd_chunks(nwb, nwz, heads)
            seen = np.zeros((batch, nw, heads), np.int64)
            for k in range(chunks):
                for wz in range(nwz):
                    u = np.arange(k * per_block, min((k + 1) * per_block, nwb // nwz))
                    w = u * nwz + wz
                    seen[w // nw, w % nw, :] += 1
            assert (seen == 1).all(), (model, batch, grid, nwz, per_block, chunks)
