"""ResNet's BatchNorm options against hvt's, on the CPU: ``bn_groups``
(``GroupedBatchNorm``), ``bn_custom`` and their priority over ``bn_pallas``.

* ``GroupedBatchNorm`` against hvt's ``common.GroupedBatchNorm`` at groups 1,
  2 and 4, over three training forwards (output and running statistics
  after each, the pooled moments of the law of total variance) and the
  gradients of x, scale and bias, in f32 within 1e-5·max|ref| and in bf16
  (output and dx rounded to bf16 on both sides) within 8e-3·max|ref|, two
  bf16 ulps; a batch the groups do not divide raises in both.
* ``resnet_micro_bottleneck`` with ``bn_groups: 4`` (alone, with
  ``bn_pallas``, and under 2 microbatches, where the groups split each
  microbatch as hvt's do), with ``bn_custom``, and with both ``bn_custom``
  and ``bn_pallas``: three train steps against hvt's ``build_train_step``
  at ``test_torch_port_accum_sam.py``'s ResNet tolerances, and the
  BatchNorm module each knob picks, as hvt's ``make_batch_norm`` picks it.

hvt's side runs first in each test and is copied to numpy before torch runs
a backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_accum_sam import RESNET_TOL, check_both, run_both

from hvt.models import common as jcommon
from hvt_torch.models import common as tcommon
from hvt_torch.models import resnet as tresnet
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_batch_norm_matches_hvt(groups, dtype):
    rng = np.random.default_rng(groups)
    c = 16
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=c)).astype(np.float32)},
         "batch_stats": {"mean": (0.1 * rng.normal(size=c)).astype(np.float32),
                         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    xs = [(rng.normal(size=(8, 5, 5, c)) * 2.0 + 3.0).astype(np.float32) for _ in range(3)]
    cot = rng.normal(size=xs[0].shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 8e-3

    ref = jcommon.GroupedBatchNorm(groups=groups)
    stats, ref_ys = v["batch_stats"], []
    for x in xs:
        y, upd = ref.apply({"params": v["params"], "batch_stats": stats},
                           jnp.asarray(x).astype(jdt), mutable=["batch_stats"])
        stats = jax.tree.map(np.asarray, upd["batch_stats"])
        ref_ys.append((np.asarray(y.astype(jnp.float32)), stats))

    def loss(params, x):
        y, _ = ref.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                         mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot)

    ref_g = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], jnp.asarray(xs[0]).astype(jdt))
    ref_dx = np.asarray(ref_g[1].astype(jnp.float32))
    ref_dscale, ref_dbias = (np.asarray(ref_g[0][k]) for k in ("scale", "bias"))
    if groups > 1:  # every batch divides into one group
        with pytest.raises(ValueError, match=f"not divisible by bn groups {groups}"):
            ref.apply(v, jnp.zeros((groups * 2 + 1, 2, 2, c), jdt), mutable=["batch_stats"])

    mod = tcommon.GroupedBatchNorm(c, groups)
    with torch.no_grad():
        mod.weight.copy_(_t(v["params"]["scale"]))
        mod.bias.copy_(_t(v["params"]["bias"]))
        mod.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        mod.running_var.copy_(_t(v["batch_stats"]["var"]))
    mod.train()
    for i, (x, (ry, rstats)) in enumerate(zip(xs, ref_ys)):
        y = mod(_t(x).to(tdt))
        assert y.dtype == tdt
        _close(y.detach().float(), ry, tol, f"y, update {i + 1}")
        _close(mod.running_mean, rstats["mean"], 1e-5, f"running mean, update {i + 1}")
        _close(mod.running_var, rstats["var"], 1e-5, f"running var, update {i + 1}")
    x = _t(xs[0]).to(tdt).requires_grad_()
    (mod(x).float() * _t(cot)).sum().backward()
    _close(x.grad.float(), ref_dx, tol, "dx")
    _close(mod.weight.grad, ref_dscale, tol, "dscale")
    _close(mod.bias.grad, ref_dbias, tol, "dbias")
    if groups > 1:
        with pytest.raises(ValueError, match=f"not divisible by bn groups {groups}"):
            mod(torch.zeros(groups * 2 + 1, 2, 2, c, dtype=tdt))


KNOBS = {
    "bn_groups=4": ({"bn_groups": 4}, {}, tcommon.GroupedBatchNorm),
    "bn_groups=4 bn_pallas": ({"bn_groups": 4, "bn_pallas": True}, {}, tcommon.GroupedBatchNorm),
    "bn_groups=4 grad_accum=2": ({"bn_groups": 4}, {"grad_accum": 2}, tcommon.GroupedBatchNorm),
    "bn_custom": ({"bn_custom": True}, {}, tcommon.CustomBatchNorm),
    "bn_custom bn_pallas": ({"bn_custom": True, "bn_pallas": True}, {}, tcommon.PallasBatchNorm),
}


@pytest.mark.parametrize("case", list(KNOBS))
def test_micro_resnet_with_batch_norm_knobs_matches_hvt(case):
    kw, settings, cls = KNOBS[case]
    model = tresnet.resnet_micro_bottleneck(NUM_CLASSES, **kw)
    norms = [m for m in model.modules() if isinstance(m, tcommon._BatchNormBase)]
    assert norms and all(type(m) is cls for m in norms), case
    assert model.cuda_unsupported(32, training=True) == []
    ref, got = run_both("resnet", kw, settings, seed=len(case))
    check_both("resnet", ref, got, RESNET_TOL)
