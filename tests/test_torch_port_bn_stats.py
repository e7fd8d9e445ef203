"""The port's BatchNorm reductions and modules against hvt's, on the CPU.

The same seeded numpy inputs go through hvt (``hvt/ops/bn_stats_pallas.py``,
its Pallas kernels in interpret mode where a kernel is named, flax
``nn.BatchNorm`` and ``common.PallasBatchNorm``) and through the port's plain
versions (``hvt_torch/ops/bn_stats.py``, ``hvt_torch/models/common.py``), in
f32. Tolerances:

* the reductions, per channel: |Δ| ≤ 1e-5·Σ|terms| (f32 sums in another
  order; Σ|terms| bounds the rounding of any order);
* ``bn_train``'s y, mean and var: max|Δ| ≤ 1e-5·max|ref|; its gradients
  (through y and through the mean and var outputs): 1e-4·max|ref| (the
  backward adds three terms of the size of dy that cancel);
* the modules' outputs: max|Δ| ≤ 1e-5·max|ref|; their running statistics
  after 3 training forwards: 1e-5·max|ref|.

hvt's side runs first in each test and is copied to numpy before torch runs
a backward.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.models import common as jcommon
from hvt.ops import bn_stats_pallas as bsp
from hvt_torch.models import common as tcommon
from hvt_torch.ops import bn_stats as bs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _sums_close(got, ref, terms, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    bound = 1e-5 * np.abs(np.asarray(terms, np.float64)).sum(0)
    assert (err <= bound).all(), f"{what}: worst |Δ|/Σ|terms| {float((err / bound).max()) * 1e-5:.3g}"


# C = 64 takes hvt's rows-into-lanes fold; 2048 is ResNet-50's widest BatchNorm
@pytest.mark.parametrize("m,c", [(1024, 64), (1024, 256), (256, 2048)])
def test_plain_reductions_match_the_pallas_kernels(m, c):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(m, c)) * 2.0 + 0.5).astype(np.float32)
    g = rng.normal(size=(m, c)).astype(np.float32)
    mean = (0.5 * rng.normal(size=c)).astype(np.float32)
    rstd = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    ref = [np.asarray(a) for a in (*bsp.channel_sums(jnp.asarray(x), interpret=True),
                                   *bsp.bn_bwd_reduce(jnp.asarray(g), jnp.asarray(x),
                                                      jnp.asarray(mean), jnp.asarray(rstd),
                                                      interpret=True))]
    got = [a.numpy() for a in (*bs.channel_sums(_t(x)),
                               *bs.bn_bwd_reduce(_t(g), _t(x), _t(mean), _t(rstd)))]
    gxh = g * ((x - mean) * rstd)
    for name, a, r, terms in zip(("Σx", "Σx²", "Σg", "Σg·x̂"), got, ref, (x, x * x, g, gxh)):
        assert a.dtype == np.float32
        _sums_close(a, r, terms, f"{name} ({m}, {c})")


def _bn_loss(y, mean, var, xp, through_moments):
    """Σy² + Σsin y, and with ``through_moments`` also Σsin(mean) + Σvar², so
    the mean and var cotangents are nonzero and their exact contributions are
    checked too."""
    loss = (y ** 2).sum() + xp.sin(y).sum()
    return loss + xp.sin(mean).sum() + (var ** 2).sum() if through_moments else loss


@pytest.mark.parametrize("through_moments", [False, True])
def test_bn_train_forward_and_gradients_match_hvt(through_moments):
    rng = np.random.default_rng(2 + through_moments)
    m, c = 2048, 64
    x = (rng.normal(size=(m, c)) * 1.5 + 0.7).astype(np.float32)
    scale = rng.uniform(0.2, 1.5, size=c).astype(np.float32)
    bias = (0.3 * rng.normal(size=c)).astype(np.float32)

    def jloss(x, scale, bias):
        y, mean, var = bsp.bn_train(x, scale, bias, 1e-5, jnp.float32, True, True)
        return _bn_loss(y, mean, var, jnp, through_moments), (y, mean, var)

    (_, ref_out), ref_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref_out = [np.asarray(a) for a in ref_out]
    ref_g = [np.asarray(a) for a in ref_g]

    leaves = [_t(a).requires_grad_() for a in (x, scale, bias)]
    y, mean, var = bs.bn_train(*leaves, 1e-5, torch.float32)
    _bn_loss(y, mean, var, torch, through_moments).backward()
    for name, a, r in zip(("y", "mean", "var"), (y, mean, var), ref_out):
        _close(a.detach(), r, 1e-5, f"bn_train {name}")
    for name, a, r in zip(("dx", "dscale", "dbias"), leaves, ref_g):
        _close(a.grad, r, 1e-4, f"bn_train {name}")


def test_bn_train_gradcheck_in_f64():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(24, 8, generator=gen, dtype=torch.float64) * 2 + 1).requires_grad_()
    scale = torch.rand(8, generator=gen, dtype=torch.float64).requires_grad_()
    bias = torch.randn(8, generator=gen, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: bs.bn_train(*a, 1e-5, torch.float64), (x, scale, bias))


def test_reductions_dispatch_by_device_only():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bs.channel_sums(x)
    with pytest.raises(ValueError, match="unsupported device"):
        bs.bn_bwd_reduce(x, x, torch.zeros(8), torch.ones(8))


def _variables(rng, c):
    return {"params": {"scale": rng.uniform(0.0, 1.0, c).astype(np.float32),
                       "bias": (0.1 * rng.normal(size=c)).astype(np.float32)},
            "batch_stats": {"mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}


def _port_module(cls, v):
    mod = cls(len(v["params"]["scale"]))
    with torch.no_grad():
        mod.weight.copy_(_t(v["params"]["scale"]))
        mod.bias.copy_(_t(v["params"]["bias"]))
        mod.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        mod.running_var.copy_(_t(v["batch_stats"]["var"]))
    return mod


@pytest.mark.parametrize("port_cls,ref", [
    (tcommon.BatchNorm, nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)),
    (tcommon.PallasBatchNorm, jcommon.PallasBatchNorm(use_running_average=False)),
])
def test_batch_norm_modules_match_hvt_over_three_updates(port_cls, ref):
    """Three training forwards (output and running statistics after each:
    the flax update with the biased variance, not torch's), then eval on the
    running statistics. The inputs' mean sits well away from 0, where E[x²] −
    E[x]² and torch's own variance would differ most."""
    rng = np.random.default_rng(7)
    c = 16
    v = _variables(rng, c)
    xs = [(rng.normal(size=(4, 6, 6, c)) * 2.0 + 3.0).astype(np.float32) for _ in range(3)]
    ref_ys, stats = [], v["batch_stats"]
    for x in xs:
        y, upd = ref.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
                           mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, upd["batch_stats"])
        ref_ys.append((np.asarray(y), stats))
    ref_eval = np.asarray(ref.clone(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": stats}, jnp.asarray(xs[0])))

    mod = _port_module(port_cls, v).train()
    for i, (x, (ry, rstats)) in enumerate(zip(xs, ref_ys)):
        _close(mod(_t(x)).detach(), ry, 1e-5, f"{port_cls.__name__} y, update {i + 1}")
        _close(mod.running_mean, rstats["mean"], 1e-5, f"running mean, update {i + 1}")
        _close(mod.running_var, rstats["var"], 1e-5, f"running var, update {i + 1}")
    mod.eval()
    _close(mod(_t(xs[0])).detach(), ref_eval, 1e-5, f"{port_cls.__name__} eval")


def test_pallas_batch_norm_refuses_a_layout_it_would_copy():
    mod = tcommon.PallasBatchNorm(8).train()
    x = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1)  # NHWC shape, NCHW memory
    with pytest.raises(RuntimeError, match="view"):
        mod(x)
