"""The chunked MLP half and hvt's routing, the port against hvt on the CPU.

* ``mlp_half_chunked``: seeded numpy inputs go through hvt's
  ``mlp_half_chunked(..., interpret=True)`` (its Pallas forward and per-chunk
  backward kernels in interpret mode) under ``jax.grad`` and through the
  port's autograd Function on CPU tensors, whose forward and backward run
  the plain versions ``mlp_half_chunked_plain`` and
  ``mlp_half_chunked_backward_plain``; K ∈ {2, 4} at C = 64.
  - f32 x and g: branch and every gradient within 5e-3·max|ref|, the
    tolerance of ``tests/test_torch_port_fused_train.py``: both sides round
    every product's operands to bf16 and sum in another order, so an operand
    can land on the other side of a rounding boundary.
  - bf16 x and g: the pre-LN sum and each chunk's dx partial are rounded to
    bf16 on both sides, and the partials' f32 sum once more; the same
    5e-3·max|ref| holds, where dx taken without those roundings (one f32
    product over the whole hidden dim) is further from hvt's than its bf16
    ulp.
  - no kernel launch counter moves on CPU tensors;
  - ``torch.autograd.gradcheck`` holds the plain backward to finite
    differences in f64 (no bf16 rounding on f64).
* The routing copy (``fits_vmem``, ``mlp_chunks``, ``mlp_route``) returns
  hvt's answers for every stage of every SwinV2 variant, in training and in
  eval, at hvt's default budget and at a 4 MiB threshold (hvt's
  ``HVT_FITS_VMEM_MB``, the port's ``FITS_THRESHOLD_BYTES``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.models import swinv2 as jswin
from hvt.ops import fused_halves_pallas as jfh
from hvt_torch.ops import fused_halves_cuda as fh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 5e-3
NAMES = ("x", "w1", "b1", "w2", "b2", "lns", "lnb")
TRANSPOSED = ("w1", "w2")  # flax (in, out) vs nn.Linear (out, in)


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _params(rng, t, c):
    p = {
        "x": rng.normal(size=(t, c)),
        "w1": rng.normal(size=(c, 4 * c)) / math.sqrt(c),
        "b1": rng.normal(size=4 * c) * 0.1,
        "w2": rng.normal(size=(4 * c, c)) / math.sqrt(4 * c),
        "b2": rng.normal(size=c) * 0.1,
        "lns": 1.0 + rng.normal(size=c) * 0.1,
        "lnb": rng.normal(size=c) * 0.1,
    }
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def _launches():
    return [k.launches for k in (fh.MLP_CHUNKED_KERNEL, fh.MLP_CHUNKED_BWD_KERNEL, fh.MLP_KERNEL,
                                 fh.MLP_BWD_KERNEL)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nchunks", [2, 4])
def test_mlp_half_chunked_matches_pallas(nchunks, dtype):
    rng = np.random.default_rng(50 + nchunks)
    t, c = 96, 64
    p = _params(rng, t, c)
    gout = rng.normal(size=(t, c)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(x, *weights):
        out = jfh.mlp_half_chunked(x.astype(jd), *weights, nchunks, True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(gout).astype(jd).astype(jnp.float32)), out

    (_, ref_out), ref = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))(
        *(jnp.asarray(p[k]) for k in NAMES))
    ref = [np.asarray(r, np.float32) for r in ref]

    before = _launches()
    leaves = [torch.tensor(p[k].T.copy() if k in TRANSPOSED else p[k], requires_grad=True)
              for k in NAMES]
    out = fh.mlp_half_chunked(leaves[0].to(td), *leaves[1:], nchunks)
    assert out.dtype == td
    (out.float() * torch.from_numpy(gout).to(td).float()).sum().backward()
    assert _launches() == before  # a CPU tensor never reaches a kernel
    _close(out.detach().float(), np.asarray(ref_out, np.float32), TOL, f"K={nchunks} {dtype} branch")
    for name, leaf, r in zip(NAMES, leaves, ref):
        got = leaf.grad.numpy()
        _close(got.T if name in TRANSPOSED else got, r, TOL, f"K={nchunks} {dtype} d{name}")


def test_bf16_rounding_of_the_chunk_partials_is_hvts():
    """In bf16, dx of K chunks is the f32 sum of K bf16-rounded partials,
    rounded: the plain backward gives hvt's dx to the bit at K = 2 and K = 4,
    while the same partials summed unrounded (K = 1, one product over the
    whole hidden dim) differ from hvt's K = 4 dx."""
    rng = np.random.default_rng(61)
    t, c = 64, 64
    p = _params(rng, t, c)
    g = rng.normal(size=(t, c)).astype(np.float32)
    xb = jnp.asarray(p["x"]).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    tw = {k: torch.from_numpy(p[k].T.copy() if k in TRANSPOSED else p[k]) for k in NAMES}
    x = tw["x"].bfloat16()
    dxs = {}
    for k in (1, 2, 4):
        _, pre = fh.mlp_half_chunked_plain(x, tw["w1"], tw["b1"], tw["w2"], tw["b2"], tw["lns"],
                                           tw["lnb"], k)
        dxs[k] = fh.mlp_half_chunked_backward_plain(x, tw["w1"], tw["b1"], tw["w2"], tw["lns"],
                                                    pre, torch.from_numpy(g).bfloat16(), k)[0]
    for k in (2, 4):
        _, vjp = jax.vjp(lambda xx: jfh.mlp_half_chunked(
            xx, *(jnp.asarray(p[n]) for n in NAMES[1:]), k, True), xb)
        ref = np.asarray(vjp(gb)[0], np.float32)
        np.testing.assert_array_equal(dxs[k].float().numpy(), ref, err_msg=f"K={k}")
    assert not np.array_equal(dxs[1].float().numpy(), ref)


@pytest.mark.parametrize("nchunks", [2, 4])
def test_mlp_half_chunked_plain_backward_passes_gradcheck_in_f64(nchunks):
    """C = 8, hidden 32, 24 tokens."""
    rng = np.random.default_rng(70 + nchunks)
    c = 8
    leaves = [torch.tensor(rng.normal(size=(24, c)), requires_grad=True)]
    for shape, std, mean in [((4 * c, c), 0.3, 0.0), ((4 * c,), 0.1, 0.0), ((c, 4 * c), 0.2, 0.0),
                             ((c,), 0.1, 0.0), ((c,), 0.1, 1.0), ((c,), 0.1, 0.0)]:
        leaves.append(torch.tensor(mean + std * rng.normal(size=shape), requires_grad=True))
    assert fh.mlp_half_chunked(*leaves, nchunks).dtype == torch.float64
    assert torch.autograd.gradcheck(lambda *a: fh.mlp_half_chunked(*a, nchunks), leaves)


# ---------------------------------------------------------------------------
# hvt's routing
# ---------------------------------------------------------------------------

VARIANTS = ("swinv2_tiny", "swinv2_tiny_window8_256", "swinv2_tiny_window16_256", "swinv2_small",
            "swinv2_base", "swinv2_large", "swinv2_large_window12_192")


def _stages(name):
    """(C, heads, tokens per window) of each stage of hvt's variant at its
    own image size (the window is clipped to the map, as the blocks do)."""
    model = getattr(jswin, name)(10)
    img = {"swinv2_tiny_window8_256": 256, "swinv2_tiny_window16_256": 256,
           "swinv2_large_window12_192": 192}.get(name, 224)
    grid = img // model.patch_size
    out = []
    for stage, heads in enumerate(model.num_heads):
        window = min(grid, model.window_size)
        out.append((model.embed_dim * 2**stage, heads, window * window))
        grid //= 2
    return out


@pytest.mark.parametrize("threshold_mb", [None, 4])
@pytest.mark.parametrize("name", VARIANTS)
def test_routing_matches_hvt(name, threshold_mb, monkeypatch):
    if threshold_mb is not None:
        monkeypatch.setenv("HVT_FITS_VMEM_MB", str(threshold_mb))
        monkeypatch.setattr(fh, "FITS_THRESHOLD_BYTES", threshold_mb * 2**20)
    else:
        monkeypatch.delenv("HVT_FITS_VMEM_MB", raising=False)
        monkeypatch.delenv("HVT_FUSED_VMEM_MB", raising=False)
    for c, heads, n in _stages(name):
        for train in (True, False):
            what = f"{name} C={c} train={train}"
            assert fh.fits_vmem(c, heads, n, train=train) == jfh.fits_vmem(c, heads, n, train=train), what
            assert fh.fits_vmem(c, heads, n, mlp_hidden=4 * c, train=train) == \
                jfh.fits_vmem(c, heads, n, mlp_hidden=4 * c, train=train), what
            k = jfh.mlp_chunks(c, 4 * c, train=train)
            assert fh.mlp_chunks(c, 4 * c, train=train) == k, what
            fused = jfh.fits_vmem(c, heads, n, mlp_hidden=4 * c, train=train)
            assert fh.mlp_route(c, 4 * c, train) == (1 if fused else k), what
            assert fh.mlp_route(c, 4 * c, train, chunked=False) == (1 if fused else 0), what


def test_default_routing_chunks_swinv2_base_stage_4_in_training_only():
    """The path this routing puts on the card: SwinV2-B's C = 1024 MLP is
    chunked in K = 2 in training, unchunked in eval, and every other stage
    of SwinV2-T and SwinV2-B takes the unchunked kernel."""
    assert fh.mlp_route(1024, 4096, train=True) == 2
    assert fh.mlp_route(1024, 4096, train=False) == 1
    for c in (96, 192, 384, 768, 128, 256, 512):
        assert fh.mlp_route(c, 4 * c, train=True) == fh.mlp_route(c, 4 * c, train=False) == 1
    assert fh.mlp_unsupported(1024, 4096, 2, training=True) is None
    assert fh.mlp_unsupported(1024, 4096, 1, training=True) is not None  # no C = 1024 MLP backward
    assert fh.mlp_unsupported(1536, 6144, 4, training=True) is not None
