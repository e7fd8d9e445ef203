"""The port's training path against hvt's, on the CPU.

Every comparison feeds the same seeded numpy inputs (and the same flax
parameter tree, carried across by ``swin_state_dict_from_flax``) to hvt
and to the port, in f32:

* objectives (flat, multitask, HXE, BCE) and their gradients, and
  ``batch_stats``: max|Δ| ≤ 1e-5·max|ref| (f32 reductions in another order);
* the schedules: 1e-6 absolute (hvt computes in f32, the port in f64);
* the four optimizers, with and without clipping, over 5 steps against
  optax, and the decay mask name for name: parameters within 1e-6·max|p|;
* the whole train step (``adamw``, smoothing 0.1, clip 5.0, drop path 0)
  on ``swinv2_micro`` and a tiny SwinV2-T geometry for 3 steps against
  hvt's ``build_train_step``, on both routes. ``fuse: false``: losses within
  1e-5 relative, step-1 gradients within 1e-3·max|ref| per tensor,
  parameters after 3 steps within 1e-4·max|p| per tensor except at most
  1e-3 of its elements, and every element within 3·lr (Adam turns a
  gradient's rounding into a different fraction of an lr step where that
  gradient is near Adam's eps). ``fuse: true`` (bf16 operands on both
  sides): losses and the gradient norm within 2e-3 relative, step-1
  gradients within 5e-2·max|ref|, parameters within 6·lr and a mean |Δ|
  of 0.1·lr per tensor (``FUSED_TOL``, ``_close_after_adam``);
* the synthetic train loader's batches, element for element;
* the entry point: ``python -m hvt_torch.main --device cpu`` trains on
  both routes, no device and no card raises, and what the port once
  refused (accumulation, ghost BatchNorm, SAM) trains (ResNet's training
  path is in ``test_torch_port_resnet.py``).

hvt's side runs first in each test and is copied to numpy before torch
runs a backward (JAX beside torch autograd, ROADMAP.md queue 3).
"""

import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from hvt import config as jconfig
from hvt import metrics as jmetrics
from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.data import loader as jloader
from hvt.models import swinv2 as jswin
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import main as tmain
from hvt_torch import metrics as tmetrics
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.data import loader as tloader
from hvt_torch.data import synthetic as tsynthetic
from hvt_torch.models import convert
from hvt_torch.models import swinv2 as tswin
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Objectives and metrics
# ---------------------------------------------------------------------------


def _classes(n):
    return tsynthetic.synthetic_class_names(n)


def _objective_cases():
    rng = np.random.default_rng(0)
    b, n = 6, 24
    mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
    logits = (3 * rng.normal(size=(b, n))).astype(np.float32)
    labels = rng.integers(0, n, size=b)
    soft = np.asarray(jdevice.prepare_targets(jnp.asarray(labels), n, 0.1))
    hx = types.SimpleNamespace(hxe_tree_weights="exponential", hxe_alpha=0.5)
    jhxe = jobjectives.HXELoss.from_config(hx, _classes(n))
    thxe = tobjectives.HXELoss.from_config(hx, _classes(n))
    tiers = (2, 4, 8)
    tier_logits = [(2 * rng.normal(size=(b, k))).astype(np.float32) for k in tiers]
    tier_targets = [np.eye(k, dtype=np.float32)[rng.integers(0, k, size=b)] for k in tiers]
    coeffs = (0.2, 0.3, 0.5)
    return {
        "flat": (jobjectives.soft_cross_entropy, tobjectives.soft_cross_entropy, logits, soft, mask),
        "hxe": (jhxe, thxe, logits, soft, mask),
        "bce": (jobjectives.binary_cross_entropy, tobjectives.binary_cross_entropy, logits,
                (rng.random((b, n)) < 0.2).astype(np.float32), None),
        "multitask": (lambda o, t, m: jobjectives.multitask_cross_entropy(o, t, coeffs, m),
                      lambda o, t, m: tobjectives.multitask_cross_entropy(o, t, coeffs, m),
                      tier_logits, tier_targets, mask),
    }


@pytest.mark.parametrize("name", ["flat", "hxe", "bce", "multitask"])
def test_objectives_and_their_gradients_match_hvt(name):
    jfn, tfn, logits, targets, mask = _objective_cases()[name]
    multi = isinstance(logits, list)
    jm = None if mask is None else jnp.asarray(mask)
    if multi:
        jtargets = [jnp.asarray(t) for t in targets]
        ref, ref_g = jax.value_and_grad(lambda o: jfn(o, jtargets, jm))([jnp.asarray(x) for x in logits])
    else:
        ref, ref_g = jax.value_and_grad(lambda o: jfn(o, jnp.asarray(targets), jm))(jnp.asarray(logits))
    ref, ref_g = float(ref), [np.asarray(g) for g in (ref_g if multi else [ref_g])]
    leaves = [torch.tensor(x, requires_grad=True) for x in (logits if multi else [logits])]
    tm = None if mask is None else _t(mask)
    ttargets = [_t(t) for t in targets] if multi else _t(targets)
    got = tfn(leaves if multi else leaves[0], ttargets, tm)
    got.backward()
    _close(float(got.detach()), ref, 1e-5, f"{name} loss")
    for g, r in zip(leaves, ref_g):
        _close(g.grad, r, 1e-5, f"{name} gradient")


def test_build_objective_and_targets_match_hvt():
    for variant, loss_name, kind in [("", "", "soft_cross_entropy"),
                                     ("", "binary_cross_entropy", "binary_cross_entropy"),
                                     ("hxe", "", "HXELoss")]:
        layer = {"hierarchy": {"variant": variant}, "model": {"loss_name": loss_name}}
        fn = tobjectives.build_objective(tconfig.loads(layer), None, _classes(8))
        assert getattr(fn, "__name__", type(fn).__name__) == kind
    cfg = tconfig.loads({"hierarchy": {"variant": "multitask", "multitask_coeffs": [1.0, 2.0]}})
    _, _, logits, targets, mask = _objective_cases()["multitask"]
    got = tobjectives.build_objective(cfg, None)([_t(x) for x in logits[:2]],
                                                [_t(t) for t in targets[:2]], _t(mask))
    ref = jobjectives.multitask_cross_entropy([jnp.asarray(x) for x in logits[:2]],
                                              [jnp.asarray(t) for t in targets[:2]], (1.0, 2.0),
                                              jnp.asarray(mask))
    _close(float(got), float(ref), 1e-5, "built multitask")
    with pytest.raises(ValueError, match="hierarchy.variant"):
        tobjectives.build_objective(tconfig.loads({"hierarchy": {"variant": "nope"}}), None)
    labels = np.array([[0, 1], [1, 3], [0, 2]], np.int32)
    for num, lab in [(5, labels[:, 1]), ((2, 4), labels)]:
        ref = jdevice.prepare_targets(jnp.asarray(lab), num, 0.1)
        got = tdevice.prepare_targets(_t(lab), num, 0.1)
        for g, r in zip(got if isinstance(num, tuple) else [got],
                        ref if isinstance(num, tuple) else [ref]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-7)


@pytest.mark.parametrize("multitask", [False, True])
def test_batch_stats_and_accumulator_match_hvt(multitask):
    rng = np.random.default_rng(4)
    b = 16
    logits = rng.normal(size=(b, 12)).astype(np.float32)
    logits[3, 5] = logits[3].max() + 1.0
    labels = rng.integers(0, 12, size=b).astype(np.int32)
    labels[3] = 5
    mask = (rng.random(b) < 0.8).astype(np.float32)
    if multitask:
        outputs = [rng.normal(size=(b, 3)).astype(np.float32), logits]
        labels = np.stack([rng.integers(0, 3, size=b), labels], 1).astype(np.int32)
        jout, tout = [jnp.asarray(o) for o in outputs], [_t(o) for o in outputs]
    else:
        jout, tout = jnp.asarray(logits), _t(logits)
    ref = jmetrics.batch_stats(jout, jnp.asarray(labels), jnp.asarray(mask))
    got = tmetrics.batch_stats(tout, _t(labels), _t(mask))
    assert set(got) == set(ref)
    for k in ref:
        _close(float(got[k]), float(ref[k]), 1e-5, k)
    jacc, tacc = jmetrics.MetricAccumulator(), tmetrics.MetricAccumulator()
    for acc, stats in ((jacc, ref), (tacc, got)):
        acc.update({**stats, "loss_sum": 2.0, "batches": 1.0})
        acc.update({**stats, "loss_sum": 3.0, "batches": 1.0})
    assert tacc.compute() == pytest.approx(jacc.compute(), rel=1e-6)


# ---------------------------------------------------------------------------
# Schedules and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("CosineAnnealingWithWarmupScheduler", {"t_warmup": "3ba", "alpha_f": 0.1}),
    ("CosineAnnealingWithWarmupScheduler", {"t_warmup": "1ep"}),
    ("ConstantWithWarmupScheduler", {"t_warmup": "0.25dur", "alpha": 1.0}),
])
def test_schedules_match_hvt(name, args):
    cfg = types.SimpleNamespace(name=name, args=args)
    ref = jschedule.build_multiplier_schedule(cfg, steps_per_epoch=4, total_steps=20)
    got = tschedule.build_multiplier_schedule(cfg, steps_per_epoch=4, total_steps=20)
    for step in range(24):
        assert got(step) == pytest.approx(float(ref(step)), abs=1e-6), step
    for text in ("36ep", "100ba", "0.5dur", 7):
        assert tschedule.parse_duration(text) == tschedule.Duration(
            *jschedule.dataclasses.astuple(jschedule.parse_duration(text)))
    with pytest.raises(ValueError, match="cannot parse"):
        tschedule.parse_duration("3 epochs")


_OPT_PARAMS = {  # name: shape; decayed iff ndim > 1 and no skip substring
    "layer.kernel": (5, 4), "layer.bias": (4,), "conv.kernel": (2, 2, 3, 4),
    "attn.logit_scale": (3, 1, 1), "attn.cpb_fc1.weight": (8, 2),
}


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", toptim.NAMES)
def test_optimizers_match_optax_over_five_steps(name, clip):
    rng = np.random.default_rng(len(name) + 10 * int(clip or 0))
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in _OPT_PARAMS.items()}
    grads = [{k: (rng.normal(size=s) * rng.uniform(0.1, 2.0)).astype(np.float32)
              for k, s in _OPT_PARAMS.items()} for _ in range(5)]
    cfg = types.SimpleNamespace(name=name, lr=0.1, weight_decay=0.05, momentum=0.875)
    jmult = jschedule.cosine_with_warmup(0, 8)  # first multipliers nonzero
    tx = joptim.build_optimizer(cfg, jmult, grad_clip_norm=clip,
                                no_decay_substrings=("cpb_", "logit_scale"))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    tparams = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    opt = toptim.Optimizer(tparams.items(), name, 0.1, 0.05, 0.875,
                           tschedule.cosine_with_warmup(0, 8), grad_clip_norm=clip,
                           no_decay_substrings=("cpb_fc", "logit_scale"))
    for g in grads:
        for k, p in tparams.items():
            p.grad = _t(g[k])
        norm = opt.step()
        ref_norm = float(optax.global_norm(g))
        assert float(norm) == pytest.approx(ref_norm, rel=1e-6)
        factor = clip / ref_norm if clip is not None and ref_norm >= clip else 1.0
        for k, p in tparams.items():  # clipped in place
            _close(p.grad, g[k] * factor, 1e-6, f"{name} clip={clip} {k} gradient")
    for k, p in tparams.items():
        _close(p.detach(), jparams[k], 1e-6, f"{name} clip={clip} {k}")


def test_warmup_first_update_does_not_move_the_weights():
    p = torch.nn.Parameter(torch.ones(3, 2))
    opt = toptim.Optimizer([("w", p)], "adamw", 1e-3, 0.05, 0.9,
                           tschedule.cosine_with_warmup(5, 30))
    p.grad = torch.ones(3, 2)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3, 2))
    opt.step()
    assert not torch.equal(p.detach(), torch.ones(3, 2))


def test_decay_mask_matches_hvt_parameter_for_parameter():
    jm = _jax_model("tiny")
    x = jnp.zeros((1, 56, 56, 3))
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, train=False))["params"]
    mask = joptim.decay_mask(params, jm.no_weight_decay_substrings)
    flags = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), mask, params)
    ref = {k: bool(v.all()) for k, v in convert.swin_state_dict_from_flax(flags).items()}
    assert all(v.all() == v.any() for v in convert.swin_state_dict_from_flax(flags).values())
    model = _port_model("tiny", _randomized(params, 0))
    got = toptim.decay_mask(model.named_parameters(), model.no_weight_decay_substrings)
    assert got == ref
    assert got["stage0_block0.attn.qkv.weight"] and not got["stage0_block0.attn.cpb_fc1.weight"]
    assert not got["stage0_block0.attn.logit_scale"] and not got["head.bias"]


# ---------------------------------------------------------------------------
# The whole train step against hvt's build_train_step
# ---------------------------------------------------------------------------

GEOMETRIES = {
    "micro": (dict(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window_size=4), 32),
    "tiny": (dict(embed_dim=96, depths=(2, 2), num_heads=(3, 6), window_size=7), 56),
}
NUM_CLASSES = 10
# Losses (relative), the step-1 gradient norm (relative) and each step-1
# gradient (max|Δ| over max|ref|). The fused route rounds every product's
# operands to bf16 on both sides (hvt's Pallas halves in interpret mode, the
# port's plain halves), so its operands round apart now and then, and the
# flips compound over the blocks into a cancelling sum such as a logit
# scale's gradient (measured: losses 4e-4, norm 3e-4, worst tensor 2.1e-2).
UNFUSED_TOL = {"loss": 1e-5, "norm": 1e-4, "grad": 1e-3}
FUSED_TOL = {"loss": 2e-3, "norm": 2e-3, "grad": 5e-2}


def _jax_model(geometry, fuse=False):
    kw, _ = GEOMETRIES[geometry]
    return jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, fuse=fuse,
                                   drop_path_rate=0.0, **kw)


def _port_model(geometry, tree, fuse=False):
    kw, _ = GEOMETRIES[geometry]
    model = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32, fuse=fuse,
                                    drop_path_rate=0.0, **kw)
    return convert.swin_params_from_flax(model, tree)


def _randomized(shapes, seed):
    """Every leaf drawn at a scale that keeps activations O(1) (LN scales
    around 1, so the zero-initialised res-post-norm hides no branch)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "logit_scale":
            return np.log(10.0) + 0.3 * rng.normal(size=shape)
        if name in ("bias", "q_bias", "v_bias", "cpb_b1"):
            return 0.1 * rng.normal(size=shape)
        if name == "cpb_w1":
            return rng.normal(size=shape)
        return rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close_after_adam(got, ref, lr, steps, what, fused=False):
    """Adam moves an element by about ±lr whatever its gradient's size, so an
    element whose gradient is near Adam's eps (1e-8) moves by a different
    fraction of lr on each side: every element within steps·lr, and at most
    1e-3 of a tensor's elements beyond 1e-4·max|p|. On the fused route a
    near-zero gradient element can change sign between the two sides (their
    bf16 operands round apart), and Adam then moves it ±lr the other way:
    every element within 2·steps·lr, and the tensor's mean |Δ| ≤ 0.1·lr."""
    diff = np.abs(got - ref)
    bound = (2 if fused else 1) * steps * lr
    assert diff.max() <= bound, f"{what}: max|Δ| {diff.max():.3g} > {bound:.3g}"
    if fused:
        assert diff.mean() <= 0.1 * lr, f"{what}: mean|Δ| {diff.mean():.3g} > 0.1·lr"
        return
    off = float(np.mean(diff > 1e-4 * np.abs(ref).max()))
    assert off <= 1e-3, f"{what}: {off:.3g} of the elements beyond 1e-4·max|p|"


def _optim_cfg():
    return types.SimpleNamespace(name="adamw", lr=1e-3, weight_decay=0.05, momentum=0.9)


@pytest.mark.parametrize("geometry,fuse", [("micro", False), ("tiny", False), ("micro", True),
                                           ("tiny", True)])
def test_three_adamw_steps_match_hvt_build_train_step(geometry, fuse):
    _, img = GEOMETRIES[geometry]
    tol = FUSED_TOL if fuse else UNFUSED_TOL
    rng = np.random.default_rng(30)
    batches = [(rng.integers(0, 256, size=(4, img, img, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=4).astype(np.int32),
                np.ones(4, np.float32)) for _ in range(3)]
    jm = _jax_model(geometry, fuse)
    shapes = jax.eval_shape(lambda: _jax_model(geometry).init(
        jax.random.key(0), jnp.zeros((1, img, img, 3)), train=False))["params"]
    tree = _randomized(shapes, seed=40)
    mean, std = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))

    # hvt: step-1 gradients, then three steps of its jitted train step
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)
    objective = jobjectives.soft_cross_entropy
    images, labels, mask = (jnp.asarray(a) for a in batches[0])

    def loss_fn(params):
        out = jm.apply({"params": params}, jprep.normalize(images), train=True)
        targets = jdevice.prepare_targets(labels, NUM_CLASSES, 0.1)
        return objective(out, targets, mask)

    ref_grads = convert.swin_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, tree))))
    tx = joptim.build_optimizer(_optim_cfg(), jschedule.cosine_with_warmup(0, 10),
                                grad_clip_norm=5.0, no_decay_substrings=jm.no_weight_decay_substrings)
    jtrain = jstep.build_train_step(jm, objective, tx, jprep,
                                    jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    params = jax.tree.map(jnp.asarray, tree)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params))
    ref_losses = []
    for im, la, ma in batches:
        state, stats = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                              jax.random.key(0), scale=1.0)
        ref_losses.append(float(stats["loss_sum"]))
    ref_params = convert.swin_state_dict_from_flax(jax.tree.map(np.asarray, state.params))

    # the port
    model = _port_model(geometry, tree, fuse)
    opt = toptim.Optimizer(model.named_parameters(), "adamw", 1e-3, 0.05, 0.9,
                           tschedule.cosine_with_warmup(0, 10), grad_clip_norm=5.0,
                           no_decay_substrings=model.no_weight_decay_substrings)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    losses = []
    for i, (im, la, ma) in enumerate(batches):
        stats = step(_t(im), _t(la), _t(ma))
        losses.append(float(stats["loss_sum"]))
        if i == 0:  # p.grad holds the clipped gradient after the step
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            grad_norm = float(stats["grad_norm"])
    assert set(grads) == set(ref_grads)
    ref_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in ref_grads.values()))
    clip_factor = min(1.0, 5.0 / ref_norm)
    np.testing.assert_allclose(losses, ref_losses, rtol=tol["loss"])
    assert ref_losses[0] != ref_losses[2]
    assert grad_norm == pytest.approx(ref_norm, rel=tol["norm"])
    for name, g in grads.items():
        _close(g, ref_grads[name] * clip_factor, tol["grad"], f"step-1 gradient {name}")
    for name, p in model.state_dict().items():
        _close_after_adam(p.numpy(), ref_params[name], lr=1e-3, steps=3, what=name, fused=fuse)


# ---------------------------------------------------------------------------
# Loader, Trainer and entry point
# ---------------------------------------------------------------------------


def _train_layer(**dataset):
    return {
        "run_name": "train_test", "seed": 5, "max_duration": "2ba", "grad_accum": 1,
        "model": {"name": "swinv2_micro", "args": {"drop_path_rate": 0.2}},
        "train_dataset": {"source": "synthetic", "crop_size": 32, "synthetic_num_classes": NUM_CLASSES,
                          "synthetic_num_samples": 10, "global_batch_size": 4, **dataset},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "synthetic_num_classes": NUM_CLASSES,
                         "synthetic_num_samples": 6, "global_batch_size": 4},
        "optim": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "algorithms": [{"cls": "LabelSmoothing", "args": {"smoothing": 0.1}},
                       {"cls": "GradientClipping", "args": {"clipping_type": "norm",
                                                            "clipping_threshold": 5.0}}],
    }


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_synthetic_train_loader_matches_hvt(shuffle, drop_last):
    layer = _train_layer(shuffle=shuffle, drop_last=drop_last)
    ref, ref_info = jloader.build_loader(jconfig.loads(layer), is_train=True)
    got, info = tloader.build_loader(tconfig.loads(layer), is_train=True)
    assert got.batches_per_epoch == ref.batches_per_epoch and info.num_classes == ref_info.num_classes
    for epoch in range(2):
        np.testing.assert_array_equal(got.epoch_indices(epoch), ref.epoch_indices(epoch))
        pairs = list(zip(got.epoch(epoch), ref.epoch(epoch)))
        assert len(pairs) == ref.batches_per_epoch
        for a, b in pairs:
            for field in ("images", "labels", "mask"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_folder_train_source_raises(tmp_path):
    """A folder train source trains (test_torch_port_loader.py); one the
    machine does not name, or whose train/ split is missing, raises."""
    layer = _train_layer()
    layer["train_dataset"].update(source="imagefolder", path="fix")
    with pytest.raises(KeyError):
        tloader.build_loader(tconfig.loads(layer), is_train=True)
    layer["machine"] = {"datasets": {"fix": str(tmp_path)}}
    with pytest.raises(FileNotFoundError):
        tloader.build_loader(tconfig.loads(layer), is_train=True)


def test_main_trains_on_the_cpu(tmp_path):
    exp = tmp_path / "micro.yaml"
    exp.write_text(yaml.safe_dump({**_train_layer(), "machine": {"save_root": str(tmp_path)}}))
    out = subprocess.run(
        [sys.executable, "-m", "hvt_torch.main", "--machine", "configs/machines/local.yaml",
         "--exp", str(exp), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-3].startswith("[train_test] step=2, train-epoch/acc@1=")
    assert lines[-2].startswith("[train_test] step=2, eval/acc@1=")
    metrics = json.loads(lines[-1])
    assert np.isfinite(metrics["cross-entropy"]) and 0.0 <= metrics["acc@1"] <= 1.0


def test_trainer_takes_its_steps_and_draws_drop_path(tmp_path):
    seen, trainers = [], []

    class Recording(tmain.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    layer = {**_train_layer(), "machine": {"save_root": str(tmp_path)}}
    layer["max_duration"] = "3ba"  # 2 batches per epoch: crosses an epoch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmain, "Trainer", Recording)
        metrics = tmain.main(tconfig.loads(layer), device="cpu",
                             on_step=lambda step, stats: seen.append((step, float(stats["loss_sum"]))))
    assert [s for s, _ in seen] == [1, 2, 3] and all(np.isfinite([v for _, v in seen]))
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy"}  # the last evaluation's
    assert set(trainers[0].train_metrics) == {"acc@1", "acc@5", "cross-entropy", "loss", "lr"}
    model = tswin.swinv2_micro(NUM_CLASSES, drop_path_rate=0.2)
    rates = [getattr(model, n).drop_path_rate for n in model.layer_names if "block" in n]
    assert rates == pytest.approx([0.0, 0.2])  # hvt's np.linspace(0, rate, depth)


def test_main_trains_the_fused_route_on_the_cpu(tmp_path):
    """``fuse: true`` with drop path 0.2: two steps through the fused halves'
    autograd Functions (their plain versions on the CPU), both drop-path
    draws per block, finite losses."""
    seen = []
    layer = {**_train_layer(), "machine": {"save_root": str(tmp_path)}}
    layer["model"]["args"]["fuse"] = True
    metrics = tmain.main(tconfig.loads(layer), device="cpu",
                         on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 2 and all(np.isfinite(seen)) and np.isfinite(metrics["cross-entropy"])


def test_entry_point_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(tconfig.loads(_train_layer()))


@pytest.mark.parametrize("change", [
    {"grad_accum": 2},
    {"model": {"name": "resnet_micro_bottleneck", "args": {"bn_groups": 2}}},
    {"algorithms": [{"cls": "SAM", "args": {}}]},
])
def test_trainer_trains_what_was_refused(change, tmp_path):
    """Gradient accumulation, ghost BatchNorm and SAM (rho 0.05, every
    step): two steps each through ``hvt_torch.main``, finite losses."""
    seen = []
    layer = {**_train_layer(), **change, "machine": {"save_root": str(tmp_path)}}
    metrics = tmain.main(tconfig.loads(layer), device="cpu",
                         on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 2 and all(np.isfinite(seen)) and np.isfinite(metrics["cross-entropy"])
