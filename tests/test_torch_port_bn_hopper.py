"""The four-launch BatchNorm of the card (``csrc/bn_stats.cu``) on the CPU:
its plain versions against hvt, its launch plan, and its dispatch.

* ``bn_moments_plain`` + ``bn_normalize_plain`` and ``bn_bwd_terms_plain``
  + ``bn_dx_plain`` (the kernels' plain versions, which ``bn_train`` runs on
  the CPU) against hvt's ``_bn_train_fwd``/``_bn_train_bwd`` on the same
  seeded inputs, hvt's reductions through ``use_pallas=False`` and through
  the Pallas kernels in interpret mode, with bf16 and f32 x and both output
  dtypes (dy in the output's dtype). Tolerances: y and dx in f32 within
  1e-5 and 1e-4 of max|ref| (the moments differ only in the sums' order;
  dx adds three terms of dy's size that cancel); in bf16 within 1e-2 of
  max|ref| (an ulp of a rounding at the store); mean and var within 1e-5 of
  max|ref|; dscale and dbias per channel within 1e-5 of Σ|terms| of their
  f64 sums.
* ``launch_plan`` at every ResNet-50 BatchNorm shape at 88-224 px and
  batch 8, 256 and 2,048: rows and channels covered once, the grid within
  its limits, the scratch sized, at least one block an SM where there are
  rows enough, and a finish of at most two partials a thread.
* dispatch: on the CPU ``bn_train`` runs only plain versions; the CUDA
  wrappers raise on a CPU tensor and on what the kernels do not take; the
  eager ``dmean``/``dvar`` branch is chosen by the arguments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import bn_stats_pallas as bsp
from hvt_torch.ops import bn_stats as bs
from hvt_torch.ops import bn_stats_cuda as bsc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EPS = 1e-5
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _inputs(m, c, x_dtype, out_dtype, seed):
    """x (mean away from 0), dy, scale, bias as torch tensors of the wanted
    dtypes and hvt's jnp arrays of the same values."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, c)) * 1.5 + rng.normal(size=c)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.2, 1.5, size=c).astype(np.float32))
    bias = torch.from_numpy((0.3 * rng.normal(size=c)).astype(np.float32))
    x, dy = x.to(x_dtype), dy.to(out_dtype)
    jx = jnp.asarray(_np(x)).astype(_JNP[x_dtype])
    jdy = jnp.asarray(_np(dy)).astype(_JNP[out_dtype])
    return x, dy, scale, bias, jx, jdy


@pytest.mark.parametrize("hvt_route", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["y_bf16", "y_f32"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("m,c", [(1024, 64), (1024, 256), (256, 2048)])
def test_plain_passes_match_hvt_bn_train(m, c, x_dtype, out_dtype, hvt_route):
    use_pallas, interpret = (False, False) if hvt_route == "jnp" else (True, True)
    x, dy, scale, bias, jx, jdy = _inputs(m, c, x_dtype, out_dtype, seed=c + m)
    (ry, rmean, rvar), res = bsp._bn_train_fwd(jx, jnp.asarray(scale.numpy()),
                                               jnp.asarray(bias.numpy()), EPS,
                                               _JNP[out_dtype], use_pallas, interpret)
    zeros = jnp.zeros((c,), jnp.float32)
    rdx, rdscale, rdbias = bsp._bn_train_bwd(EPS, _JNP[out_dtype], use_pallas, interpret, res,
                                             (jdy, zeros, zeros))

    mean, var, rstd = bs.bn_moments_plain(x, EPS)
    y = bs.bn_normalize_plain(x, mean, rstd, scale, bias, out_dtype)
    terms = bs.bn_bwd_terms_plain(dy, x, mean, rstd, scale)
    sg, sgx = terms[0], terms[1]
    dx = bs.bn_dx_plain(dy, x, mean, rstd, terms)
    assert y.dtype == out_dtype and dx.dtype == x_dtype

    what = f"({m}, {c}) x {x_dtype} y {out_dtype} vs hvt {hvt_route}"
    _close(mean, np.asarray(rmean), 1e-5, f"mean {what}")
    _close(var, np.asarray(rvar), 1e-5, f"var {what}")
    _close(_np(y), np.asarray(ry, np.float32), 1e-2 if out_dtype == torch.bfloat16 else 1e-5,
           f"y {what}")
    _close(_np(dx), np.asarray(rdx, np.float32), 1e-2 if x_dtype == torch.bfloat16 else 1e-4,
           f"dx {what}")
    xd, gd = x.double(), dy.double()
    gxh = gd * ((xd - mean.double()) * rstd.double())
    for name, got, ref, terms in (("dbias", sg, rdbias, gd), ("dscale", sgx, rdscale, gxh)):
        err = np.abs(got.double().numpy() - np.asarray(ref, np.float64))
        bound = 1e-5 * terms.abs().sum(0).numpy()
        assert (err <= bound).all(), f"{name} {what}: worst |Δ|/Σ|terms| {(err / bound).max() * 1e-5:.3g}"


# ResNet-50's BatchNorm inputs as (map index, channels, layers); map i is the
# image size halved i + 1 times, each halving rounding up (stride-2 convs
# with padding): at 224 px 112, 56, 28, 14, 7.
RESNET50_BN = ((0, 64, 1), (1, 64, 6), (1, 256, 4), (1, 128, 1), (2, 128, 7), (2, 512, 5),
               (2, 256, 1), (3, 256, 11), (3, 1024, 7), (3, 512, 1), (4, 512, 5), (4, 2048, 4))
SIZES = (88, 112, 136, 168, 176, 192, 224)
BATCHES = (8, 256, 2048)
SMS = 132
FINISH_THREADS = 256  # threads of a finish block (csrc kBnFinish)
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535  # tiles along x, chunks along y


def resnet50_bn_shapes(size: int) -> list[tuple[int, int]]:
    maps = []
    for _ in range(5):
        size = -(-size // 2)
        maps.append(size)
    assert sum(n for _, _, n in RESNET50_BN) == 53
    return [(maps[i], c) for i, c, _ in RESNET50_BN]


def test_resnet50_maps_at_224_and_112_px():
    assert sorted({h for h, _ in resnet50_bn_shapes(224)}) == [7, 14, 28, 56, 112]
    assert sorted({h for h, _ in resnet50_bn_shapes(112)}) == [4, 7, 14, 28, 56]
    assert sorted({h for h, _ in resnet50_bn_shapes(88)}) == [3, 6, 11, 22, 44]


def _covered_once(starts_ends, total):
    """Intervals [a, b) that tile [0, total) without overlap."""
    at = 0
    for a, b in sorted(starts_ends):
        if a >= b:
            continue
        assert a == at, (a, at)
        at = b
    assert at == total


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("size", SIZES)
def test_launch_plan_covers_every_resnet50_batch_norm(size, batch):
    for h, c in resnet50_bn_shapes(size):
        m = batch * h * h
        plan = bsc.launch_plan(m, c)
        what = f"{size} px, batch {batch}: ({m}, {c}) {plan}"
        ty = bsc.THREADS // plan.tx
        # the grid: tiles along x, chunks along y
        assert 1 <= plan.tx <= 32 and plan.tx * ty <= bsc.THREADS, what
        assert 0 < plan.chunks <= MAX_GRID_Y, what
        assert 0 < plan.tiles <= MAX_GRID_X, what
        # every channel group once: tile t, lane tx → channels (t·TX + tx)·8 ..+8
        groups = [(t * plan.tx + tx) * 8 for t in range(plan.tiles) for tx in range(plan.tx)]
        assert sorted(g for g in groups if g < c) == list(range(0, c, 8)), what
        # every row once: chunk i's rows [i·rpc, min((i+1)·rpc, m)), each lane's
        # rows r0 + ty, TY apart (the lanes of a chunk tile it)
        rpc = plan.rows_per_chunk
        assert rpc == -(-m // plan.chunks), what
        _covered_once([(i * rpc, min((i + 1) * rpc, m)) for i in range(plan.chunks)], m)
        # the reductions' scratch: one (2, C) f32 partial a chunk
        assert plan.scratch == plan.chunks * 2 * c, what
        # one block an SM where the rows allow MIN_ROWS_PER_THREAD a thread
        busy = -(-m // rpc) * plan.tiles  # blocks that hold rows
        if m >= -(-SMS // plan.tiles) * ty * bsc.MIN_ROWS_PER_THREAD:
            assert busy >= SMS, what
        # the finish: a block of FINISH_THREADS a group of 8 channels, each
        # thread at most two of the chunks' partials
        assert -(-plan.chunks // FINISH_THREADS) <= 2, what


def test_launch_plan_at_the_narrowest_maps_fills_the_card():
    """7×7×2048 at 224 px and 3×3 or 4×4 at 88-112 px, batch 256: at least
    one block an SM on 256-channel tiles, each thread at least one row."""
    for h in (7, 4, 3):
        m = 256 * h * h
        plan = bsc.launch_plan(m, 2048)
        ty = bsc.THREADS // plan.tx
        assert plan.tiles == 2048 // (8 * bsc.MAX_TX), plan
        assert -(-m // plan.rows_per_chunk) * plan.tiles >= SMS, plan
        assert plan.rows_per_chunk >= ty, plan


def _raise(*_a, **_k):
    raise AssertionError("called")


def test_bn_train_on_the_cpu_runs_only_the_plain_versions(monkeypatch):
    for name in ("channel_sums", "bn_moments", "bn_normalize", "bn_bwd_reduce", "bn_bwd_terms",
                 "bn_dx"):
        monkeypatch.setattr(bsc, name, _raise)
    kernels = (bsc.SUMS_KERNEL, bsc.NORMALIZE_KERNEL, bsc.BWD_KERNEL, bsc.DX_KERNEL)
    before = [k.launches for k in kernels]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 16, generator=gen).bfloat16().requires_grad_()
    scale = torch.rand(16, generator=gen).requires_grad_()
    bias = torch.randn(16, generator=gen).requires_grad_()
    y, mean, var = bs.bn_train(x, scale, bias, EPS, torch.bfloat16)
    y.float().square().sum().backward()
    assert y.dtype == x.grad.dtype == torch.bfloat16 and scale.grad.shape == (16,)
    assert [k.launches for k in kernels] == before


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(64, 128, dtype=torch.bfloat16)
    v = torch.zeros(128)
    with pytest.raises(ValueError, match="not the CUDA device"):
        bsc.bn_moments(x, EPS)
    with pytest.raises(ValueError, match="not the CUDA device"):
        bsc.channel_sums(x)
    with pytest.raises(ValueError, match="not the CUDA device"):
        bsc.bn_normalize(x, v, v, v, v, torch.bfloat16)
    with pytest.raises(ValueError, match="not the CUDA device"):
        bsc.bn_bwd_terms(x, x, v, v, v)
    with pytest.raises(ValueError, match="not the CUDA device"):
        bsc.bn_dx(x, x, v, v, torch.zeros(5, 128))
    with pytest.raises(ValueError, match="multiple of 8"):
        bsc.bn_moments(torch.zeros(64, 12, dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError, match="contiguous"):
        bsc.bn_moments(torch.zeros(64, 256, dtype=torch.bfloat16)[:, ::2], EPS)
    unaligned = torch.zeros(64 * 128 + 1, dtype=torch.bfloat16)[1:].view(64, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bsc.bn_dx(unaligned, unaligned, v, v, torch.zeros(5, 128))
    with pytest.raises(ValueError, match="bf16 or f32"):
        bsc.bn_moments(x.half(), EPS)
    with pytest.raises(ValueError, match="one dtype"):
        bsc.bn_bwd_terms(x, x.float(), v, v, v)
    with pytest.raises(ValueError, match="out_dtype"):
        bsc.bn_normalize(x, v, v, v, v, torch.float16)


def test_the_dmean_dvar_branch_is_chosen_by_the_arguments(monkeypatch):
    """Through y alone the backward runs the dx step; with the mean and var
    outputs in the loss it runs the same reduction step and the eager
    formula with their exact contributions, never the dx step."""
    calls = {"bn_bwd_terms": 0, "bn_dx": 0}
    for name in calls:
        fn = getattr(bs, name)

        def counted(*a, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(bs, name, counted)
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn(32, 8, generator=gen) * 2 + 1
    scale = torch.rand(8, generator=gen)
    bias = torch.randn(8, generator=gen)
    for through_moments, want in ((False, {"bn_bwd_terms": 1, "bn_dx": 1}),
                                  (True, {"bn_bwd_terms": 1, "bn_dx": 0})):
        calls.update(dict.fromkeys(calls, 0))
        x = x0.clone().requires_grad_()
        y, mean, var = bs.bn_train(x, scale, bias, EPS, torch.float32)
        loss = y.square().sum() + (mean.sin().sum() + var.square().sum() if through_moments else 0)
        loss.backward()
        assert calls == want, (through_moments, calls)
        assert torch.isfinite(x.grad).all()
