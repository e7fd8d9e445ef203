"""Gradient accumulation and SAM in the port's train step against hvt's, on
the CPU.

The same seeded numpy inputs and flax variables (every leaf drawn) go
through hvt's ``build_train_step`` and the port's, three steps each, in f32,
with drop path 0 and no MixUp (JAX's PRNG and torch's draw differently):

* accumulation 2 and 4 on ``resnet_micro_bottleneck`` (the BatchNorm
  running statistics chained through the microbatches; DecoupledSGDW) and
  on ``swinv2_micro`` on both routes (adamw);
* SAM at intervals 1 and 2, each with accumulation 1 and 2, on the micro
  ResNet (the first pass's statistics kept).

Tolerances are ``test_torch_port_train.py``'s and
``test_torch_port_resnet.py``'s: ResNet losses and metric sums within 1e-5
relative, ``grad_norm`` within 1e-4, parameters and running statistics
within 1e-5·max|ref| per tensor; SwinV2 ``fuse: false`` losses 1e-5, norm
1e-4, ``fuse: true`` 2e-3 and 2e-3, parameters after Adam as
``_close_after_adam`` holds them there. The counts of correct predictions
are equal.

Port only, exact: a SAM step whose ``rho`` is too small to move any
parameter (the perturbed parameters equal the parameters bit for bit, which
a forward hook checks) equals a plain step bit for bit with drop path 0.5,
MixUp, CutMix and device RandAugment on, since both passes draw the same;
the Trainer's ``grad_accum: auto`` resolves to 4 under a faked memory limit,
its probe leaving the model, optimizer and generator untouched, and trains;
a run with SAM and accumulation resumed from its checkpoint equals the
straight run bit for bit.

hvt's side runs first in each test and is copied to numpy before torch runs
a backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.models import resnet as jresnet
from hvt.models import swinv2 as jswin
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.models import convert
from hvt_torch.models import resnet as tresnet
from hvt_torch.models import swinv2 as tswin
from hvt_torch.train import loop as tloop
from hvt_torch.train import microbatch as tmicrobatch
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep

# This module keeps torch's default thread count, as its bounds were set
# under: SAM's second pass at rho 0.5 routes max-pool gradients through ties,
# and at one thread another order of the convolutions' sums moves the
# step-2 gradient norm of test_sam_matches_hvt[2-2] by 8e-4 against hvt's.

NUM_CLASSES = 10
IMG, BATCH = 32, 8
SWIN_MICRO = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window_size=4)
RESNET_TOL = {"loss": 1e-5, "norm": 1e-4, "state": 1e-5}
UNFUSED_TOL = {"loss": 1e-5, "norm": 1e-4}
FUSED_TOL = {"loss": 2e-3, "norm": 2e-3}
MEAN_STD = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))
LR = {"resnet": 0.2, "swin": 1e-3}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _close_after_adam(got, ref, lr, steps, what, fused=False):
    """``test_torch_port_train.py``'s hold on parameters after Adam steps."""
    diff = np.abs(got - ref)
    bound = (2 if fused else 1) * steps * lr
    assert diff.max() <= bound, f"{what}: max|Δ| {diff.max():.3g} > {bound:.3g}"
    if fused:
        assert diff.mean() <= 0.1 * lr, f"{what}: mean|Δ| {diff.mean():.3g} > 0.1·lr"
        return
    off = float(np.mean(diff > 1e-4 * np.abs(ref).max()))
    assert off <= 1e-3, f"{what}: {off:.3g} of the elements beyond 1e-4·max|p|"


def randomized(shapes, seed, family):
    """Every leaf drawn at a scale that keeps activations O(1): ResNet as
    ``test_torch_port_resnet.py`` draws it, SwinV2 as
    ``test_torch_port_train.py`` does."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if family == "resnet":
            if name in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, size=shape)
            elif name in ("bias", "mean"):
                a = 0.1 * rng.normal(size=shape)
            else:
                a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "logit_scale":
            a = np.log(10.0) + 0.3 * rng.normal(size=shape)
        elif name in ("bias", "q_bias", "v_bias", "cpb_b1"):
            a = 0.1 * rng.normal(size=shape)
        elif name == "cpb_w1":
            a = rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def models(family, kw, img=IMG):
    """(hvt's model, a function making the port's from flax variables, the variables' shapes)."""
    if family == "resnet":
        jm = jresnet.resnet_micro_bottleneck(NUM_CLASSES, stem_s2d=True, **kw)

        def port(variables):
            model = tresnet.resnet_micro_bottleneck(NUM_CLASSES, **kw)
            return convert.resnet_params_from_flax(model, variables)
    else:
        kw = {**SWIN_MICRO, **kw}
        jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32,
                                     drop_path_rate=0.0, **kw)

        def port(variables):
            model = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32,
                                            drop_path_rate=0.0, img_size=img, **kw)
            return convert.swin_params_from_flax(model, variables["params"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, img, img, 3)),
                                            train=False))
    return jm, port, shapes


def flat_state(family, variables):
    v = jax.tree.map(np.asarray, variables)
    if family == "resnet":
        return convert.resnet_state_dict_from_flax(v["params"], v["batch_stats"])
    return convert.swin_state_dict_from_flax(v["params"])


def run_both(family, model_kw, settings_kw, steps=3, seed=0, img=IMG, batch=BATCH):
    """``steps`` train steps of hvt's ``build_train_step`` and of the port's
    from the same variables and batches (smoothing 0.1, clip 5.0; ResNet on
    DecoupledSGDW, SwinV2 on adamw). Returns, for each side, the losses, the
    per-step stats as floats and the final state as numpy, flat in the
    port's names."""
    rng = np.random.default_rng(100 + seed)
    batches = [(rng.integers(0, 256, size=(batch, img, img, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=batch).astype(np.int32),
                np.ones(batch, np.float32)) for _ in range(steps)]
    jm, port, shapes = models(family, model_kw, img)
    variables = randomized(shapes, 200 + seed, family)
    optim = ("decoupledsgdw", 5e-4) if family == "resnet" else ("adamw", 0.05)
    lr = LR[family]

    # hvt
    optim_cfg = type("Optim", (), dict(name=optim[0], lr=lr, weight_decay=optim[1], momentum=0.9))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                                no_decay_substrings=getattr(jm, "no_weight_decay_substrings", ()))
    jprep = jdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=jnp.float32)
    jtrain = jstep.build_train_step(jm, jobjectives.soft_cross_entropy, tx, jprep,
                                    jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1,
                                                       **settings_kw))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                       opt_state=tx.init(params))
    ref = {"stats": []}
    for im, la, ma in batches:
        state, out = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                            jax.random.key(0), scale=1.0)
        ref["stats"].append({k: float(v) for k, v in out.items()})
    ref["state"] = flat_state(family, {"params": state.params, "batch_stats": state.batch_stats})

    # the port
    model = port(variables)
    opt = toptim.Optimizer(model.named_parameters(), optim[0], lr, optim[1], 0.9,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                           no_decay_substrings=model.no_weight_decay_substrings)
    tprep = tdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1,
                                                     **settings_kw))
    generator = torch.Generator().manual_seed(seed)
    got = {"stats": [{k: float(v) for k, v in step(_t(im), _t(la), _t(ma), generator).items()}
                     for im, la, ma in batches]}
    got["state"] = {k: v.numpy() for k, v in model.state_dict().items()}
    return ref, got


def check_both(family, ref, got, tol, fused=False, steps=3):
    """The losses, metric sums, ``grad_norm`` of every step and the state
    after the last, each within ``tol``."""
    for i, (r, g) in enumerate(zip(ref["stats"], got["stats"])):
        assert g["loss_sum"] == pytest.approx(r["loss_sum"], rel=tol["loss"]), f"loss, step {i}"
        assert g["ce_sum"] == pytest.approx(r["ce_sum"], rel=tol["loss"]), f"ce_sum, step {i}"
        assert g["grad_norm"] == pytest.approx(r["grad_norm"], rel=tol["norm"]), f"norm, step {i}"
        for k in ("correct@1", "correct@5", "count", "batches"):
            assert g[k] == r[k], f"{k}, step {i}"
    assert ref["stats"][0]["loss_sum"] != ref["stats"][-1]["loss_sum"]
    assert set(got["state"]) == set(ref["state"])
    for name, r in ref["state"].items():
        if family == "resnet":
            _close(got["state"][name], r, tol["state"], f"{name} after {steps} steps")
        else:
            _close_after_adam(got["state"][name], r, LR[family], steps, name, fused)


@pytest.mark.parametrize("family,fuse,accum", [
    ("resnet", False, 2), ("resnet", False, 4),
    ("swin", False, 2), ("swin", False, 4), ("swin", True, 2), ("swin", True, 4),
])
def test_accumulation_matches_hvt(family, fuse, accum):
    kw = {} if family == "resnet" else {"fuse": fuse}
    ref, got = run_both(family, kw, {"grad_accum": accum}, seed=accum + 10 * fuse)
    tol = RESNET_TOL if family == "resnet" else (FUSED_TOL if fuse else UNFUSED_TOL)
    check_both(family, ref, got, tol, fused=fuse)


@pytest.mark.parametrize("interval,accum", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_sam_matches_hvt(interval, accum):
    """SAM at rho 0.5 (the hot recipe's) on the micro ResNet: over three
    steps it fires at every step (interval 1) or at steps 0 and 2 (interval
    2); its statistics are the first pass's."""
    ref, got = run_both("resnet", {}, {"grad_accum": accum, "sam_rho": 0.5,
                                       "sam_interval": interval}, seed=20 + 2 * interval + accum)
    check_both("resnet", ref, got, RESNET_TOL)
    plain, _ = run_both("resnet", {}, {"grad_accum": accum}, seed=20 + 2 * interval + accum)
    assert plain["stats"][0]["grad_norm"] != ref["stats"][0]["grad_norm"]  # SAM moved it
    # the first step's loss and statistics are the first pass's, as without SAM
    assert got["stats"][0]["loss_sum"] == pytest.approx(plain["stats"][0]["loss_sum"], rel=1e-6)


# ---------------------------------------------------------------------------
# Port only: both SAM passes draw the same
# ---------------------------------------------------------------------------

AUGMENTED = dict(mixup_alpha=0.2, cutmix_alpha=1.0, randaugment=(1, 9, True), smoothing=0.1)


def _augmented_run(family, accum, sam_rho, steps=2):
    if family == "resnet":
        model = tresnet.resnet_micro_bottleneck(NUM_CLASSES, stochastic_depth_rate=0.5, seed=3)
    else:
        model = tswin.swinv2_micro(NUM_CLASSES, dtype="float32", drop_path_rate=0.5, fuse=True,
                                   seed=3)
    opt = toptim.Optimizer(model.named_parameters(), "adamw", 1e-3, 0.05, 0.9,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0)
    prep = tdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=torch.float32)
    step = tstep.build_train_step(
        model, tobjectives.soft_cross_entropy, opt, prep,
        tstep.StepSettings(NUM_CLASSES, grad_accum=accum, sam_rho=sam_rho, **AUGMENTED))
    forwards = []
    start = {}

    def hook(module, args):
        forwards.append(all(torch.equal(p, start[n]) for n, p in module.named_parameters()))

    model.register_forward_pre_hook(hook)
    rng = np.random.default_rng(7)
    generator = torch.Generator().manual_seed(11)
    stats = []
    for _ in range(steps):
        start.update({n: p.detach().clone() for n, p in model.named_parameters()})
        stats.append(step(_t(rng.integers(0, 256, size=(BATCH, IMG, IMG, 3), dtype=np.uint8)),
                          _t(rng.integers(0, NUM_CLASSES, size=BATCH)), torch.ones(BATCH),
                          generator))
    return model, generator, stats, forwards


@pytest.mark.parametrize("family,accum", [("resnet", 1), ("resnet", 2), ("swin", 2)])
def test_sam_at_a_vanishing_rho_equals_a_plain_step(family, accum):
    model, generator, stats, forwards = _augmented_run(family, accum, sam_rho=1e-45)
    ref_model, ref_generator, ref_stats, ref_forwards = _augmented_run(family, accum, None)
    assert len(forwards) == 2 * len(ref_forwards) == 2 * 2 * accum  # SAM ran its second pass
    assert all(forwards)  # at parameters equal to the unperturbed ones
    assert torch.equal(generator.get_state(), ref_generator.get_state())
    for got, ref in zip(stats, ref_stats):
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    ref_state = ref_model.state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(t, ref_state[name]), name


# ---------------------------------------------------------------------------
# The Trainer: auto, and resume
# ---------------------------------------------------------------------------


def _layer(save_root, **change):
    layer = {
        "run_name": "accum_sam", "seed": 5, "max_duration": "2ba", "grad_accum": "auto",
        "machine": {"save_root": str(save_root)},
        "model": {"name": "resnet_micro_bottleneck", "args": {"stochastic_depth_rate": 0.3}},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                          "synthetic_num_samples": 16, "global_batch_size": BATCH},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                         "synthetic_num_samples": 4, "global_batch_size": 4},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "algorithms": [{"cls": "LabelSmoothing", "args": {"smoothing": 0.08}},
                       {"cls": "MixUp", "args": {"alpha": 0.2}},
                       {"cls": "SAM", "args": {"rho": 0.5, "interval": 2}}],
    }
    layer.update(change)
    return layer


def test_trainer_auto_resolves_to_four_microbatches_and_trains(monkeypatch, tmp_path):
    """The card is faked: a limit of 300 bytes, and a probe that runs the
    Trainer's real gradient pass on the CPU and reports 100 bytes per image
    of the largest microbatch the model saw. A batch of 8 then needs 4
    microbatches; each probe ran SAM's two passes; the probes left the
    model, the optimizer and the generator as a Trainer built at
    ``grad_accum: 4`` has them; the Trainer then trains."""
    probed = []

    def probe(model, run, device):
        sizes = []
        handle = model.register_forward_pre_hook(lambda m, args: sizes.append(args[0].shape[0]))
        try:
            tmicrobatch.probe_step(model, run)
        finally:
            handle.remove()
        probed.append(sizes)
        return 100.0 * max(sizes)

    monkeypatch.setattr(tmicrobatch, "probe_peak_bytes", probe)
    monkeypatch.setattr(tmicrobatch, "optimizer_state_bytes", lambda opt: 0)
    monkeypatch.setattr(tmicrobatch, "device_bytes_limit", lambda device: 300)
    trainer = tloop.Trainer(tconfig.loads(_layer(tmp_path)), device="cpu")
    assert trainer.grad_accum == 4 and trainer.settings.grad_accum == 4
    assert probed == [[8, 8], [4, 4, 4, 4], [2] * 8]  # two passes of 1, 2, 4 microbatches
    fixed = tloop.Trainer(tconfig.loads(_layer(tmp_path / "fixed", grad_accum=4)), device="cpu")
    got, ref = trainer.model.state_dict(), fixed.model.state_dict()
    for name in ref:
        assert torch.equal(got[name], ref[name]), name
    assert all(p.grad is None for p in trainer.model.parameters())
    assert not trainer.optimizer.state and trainer.optimizer.count == 0
    assert torch.equal(trainer.generator.get_state(), fixed.generator.get_state())
    seen = []
    trainer.fit(on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    trainer.close()
    fixed.close()
    assert len(seen) == 2 and all(np.isfinite(seen)) and trainer.step == 2


def test_resume_with_sam_and_accumulation_is_bit_equal(tmp_path):
    """Four steps straight, and the same run resumed from its step-2
    checkpoint: SAM (interval 2) fires at steps 0 and 2, two microbatches a
    step, drop path and MixUp drawn from the saved generator; the resumed
    run's parameters, running statistics, optimizer state and generator
    equal the straight run's."""
    layer = _layer(tmp_path / "straight", grad_accum=2, max_duration="4ba",
                   save={"interval": "2ba", "num_checkpoints_to_keep": 3})
    straight = tloop.Trainer(tconfig.loads(layer), device="cpu")
    straight.fit()
    straight.close()
    ckpt = tmp_path / "straight" / "accum_sam" / "checkpoints"
    resumed = tloop.Trainer(tconfig.loads({**layer, "load_path": f"ckpt://{ckpt}:2",
                                           "machine": {"save_root": str(tmp_path / "resumed")}}),
                            device="cpu")
    assert resumed.step == 2
    resumed.fit()
    resumed.close()
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4
    for name, t in a["params"].items():
        assert torch.equal(t, b["params"][name]), name
    for name, t in a["batch_stats"].items():
        assert torch.equal(t, b["batch_stats"][name]), name
    assert torch.equal(a["rng"], b["rng"])
    for i, st in a["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["opt_state"]["state"][i][k]), (i, k)
