"""The port's ResNet training path against hvt's, on the CPU.

The same flax variables (params and ``batch_stats``, every leaf drawn from a
seeded numpy generator, never left at init) go through hvt and, after
``hvt_torch.models.convert.resnet_params_from_flax``, through the port on
``device="cpu"`` (the plain versions of the BatchNorm kernels), in f32.
Tolerances:

* forward, eval mode and train mode, and the running statistics after the
  train-mode forward: max|Δ| ≤ 1e-5·max|ref| per tensor, except the real
  ResNet-50 at 64 px in train mode, 1e-3 (its last stage is 2×2 at batch
  2: each of those BatchNorms normalises over 8 values, which magnifies the
  f32 rounding of the convolutions, XLA's and oneDNN's, in another order);
* the converter: name for name and shape for shape, with hvt's decay mask;
* three DecoupledSGDW steps with EMA (update interval 1ba and 2ba),
  smoothing 0.08 and clip 2.0 on ``resnet_micro_bottleneck`` against hvt's
  ``build_train_step``: losses within 1e-5 relative; parameters, running
  statistics and their EMA copies within 1e-5·max|ref| per tensor;
* the Trainer and ``python -m hvt_torch.main --device cpu`` train it with
  EMA; ``InferenceEngine`` serves it (held against a direct forward).

hvt's side runs first in each test and is copied to numpy before torch runs
a backward.
"""

import io
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.models import resnet as jresnet
from hvt.train import ema as jema
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import main as tmain
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.downstream import serve as serve_lib
from hvt_torch.models import build_model, convert
from hvt_torch.models import common as tcommon
from hvt_torch.models import resnet as tresnet
from hvt_torch.train import ema as tema
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep
from hvt_torch.train.loop import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 10


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _shapes(model, img):
    return jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, img, img, 3)),
                                             train=False))


def _randomized(shapes, seed):
    """Every leaf drawn: kernels N(0, 1/fan_in), BatchNorm scales U(0.5, 1.5)
    and biases N(0, 0.1²), running means N(0, 0.1²) and vars U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_state(params, batch_stats):
    return convert.resnet_state_dict_from_flax(jax.tree.map(np.asarray, params),
                                               jax.tree.map(np.asarray, batch_stats))


FORWARD_CASES = [
    ("resnet_micro", {}, 32, 1e-5),
    ("resnet_micro", {"blurpool": True, "bn_pallas": True}, 32, 1e-5),
    ("resnet_micro_bottleneck", {"blurpool": True, "stem_s2d": True}, 32, 1e-5),
    ("resnet_micro_bottleneck", {"stem_s2d": True, "bn_pallas": True}, 32, 1e-5),
    ("resnet_micro_bottleneck", {"bn_pallas": False}, 32, 1e-5),
    ("resnet50", {"stem_s2d": True, "bn_pallas": True}, 64, 1e-3),
]


@pytest.mark.parametrize("name,kw,img,train_tol", FORWARD_CASES)
def test_forward_matches_hvt_in_train_and_eval_mode(name, kw, img, train_tol):
    jm = getattr(jresnet, name)(NUM_CLASSES, dtype=jnp.float32, **kw)
    variables = _randomized(_shapes(jm, img), seed=len(name) + img)
    x = np.random.default_rng(1).normal(size=(2, img, img, 3)).astype(np.float32)
    ref_eval = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    ref_train, mut = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ref_train = np.asarray(ref_train)
    ref_stats = _flax_state(variables["params"], mut["batch_stats"])

    model = getattr(tresnet, name)(NUM_CLASSES, dtype="float32", **kw)
    convert.resnet_params_from_flax(model, variables)
    with torch.no_grad():
        got_eval = model.eval()(_t(x))
        got_train = model.train()(_t(x))
    _close(got_eval, ref_eval, 1e-5, f"{name} {kw} eval logits")
    _close(got_train, ref_train, train_tol, f"{name} {kw} train logits")
    state = model.state_dict()
    for key, ref in ref_stats.items():
        if "running" in key:
            _close(state[key], ref, train_tol, f"{name} {kw} {key}")


def test_bn_pallas_selects_the_kernel_batch_norm():
    on, off = tresnet.resnet_micro_bottleneck(3, bn_pallas=True), tresnet.resnet_micro_bottleneck(3)
    assert isinstance(on.stem.bn, tcommon.PallasBatchNorm)
    assert isinstance(off.stage1_block0.conv2.bn, tcommon.BatchNorm)
    assert on.stage2_block0.conv2.conv.weight.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("name,kw,num_classes", [
    ("resnet50", {"stem_s2d": True}, NUM_CLASSES),
    ("resnet50", {}, (3, 7)),
    ("resnet18", {}, NUM_CLASSES),
    ("resnet_micro_bottleneck", {"blurpool": True}, NUM_CLASSES),
])
def test_converter_maps_every_tensor_and_the_decay_mask(name, kw, num_classes):
    jm = getattr(jresnet, name)(num_classes, dtype=jnp.float32, **kw)
    shapes = _shapes(jm, 64)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = _flax_state(zeros["params"], zeros["batch_stats"])
    model = getattr(tresnet, name)(num_classes, **kw)
    ref = model.state_dict()
    assert set(state) == set(ref)
    assert all(tuple(ref[k].shape) == v.shape for k, v in state.items())
    # hvt's decay mask, carried across name for name
    mask = joptim.decay_mask(shapes["params"], ())
    flags = jax.tree.map(lambda m, s: np.full(s.shape, m, np.float32), mask, shapes["params"])
    ref_mask = {k: bool(v.all()) for k, v in convert.resnet_state_dict_from_flax(flags).items()}
    got = toptim.decay_mask(model.named_parameters(), model.no_weight_decay_substrings)
    assert got == ref_mask
    assert got["stem.conv.weight"] and not got["stem.bn.weight"]


def test_init_is_seeded_with_hvts_distributions():
    model = tresnet.resnet50(NUM_CLASSES, seed=3)
    again = tresnet.resnet50(NUM_CLASSES, seed=3)
    torch.testing.assert_close(model.state_dict(), again.state_dict())
    w = model.stage3_block0.conv2.conv.weight
    assert abs(float(w.std()) - (2.0 / w[0].numel()) ** 0.5) < 0.02 * (2.0 / w[0].numel()) ** 0.5
    scale = torch.cat([m.weight for m in model.modules() if isinstance(m, tcommon.BatchNorm)])
    assert 0.0 <= float(scale.min()) and float(scale.max()) <= 1.0 and abs(float(scale.mean()) - 0.5) < 0.01
    assert float(tresnet.resnet_micro(NUM_CLASSES).stem.bn.weight.min()) == 1.0  # "ones"
    rates = [getattr(tresnet.resnet50(3, stochastic_depth_rate=0.3), n).drop_path_rate
             for n in model.layer_names]
    assert rates == pytest.approx([0.3 * i / 15 for i in range(16)])  # hvt's per-block rate


@pytest.mark.parametrize("args,cls", [
    ({"bn_groups": 2}, tcommon.GroupedBatchNorm),
    ({"bn_custom": True}, tcommon.CustomBatchNorm),
    ({"remat_stages": [1, 2]}, tcommon.BatchNorm),
])
def test_factory_builds_the_batch_norm_knobs(args, cls):
    """Each knob builds ResNet-50 as hvt's factory does, and a train-mode
    forward and backward runs (4 images of 32 px; the groups split them in
    2), the recomputed stages' blocks running twice."""
    cfg = tconfig.loads({"model": {"name": "resnet50", "args": args}})
    model = build_model(cfg, NUM_CLASSES)
    norms = [m for m in model.modules() if isinstance(m, tcommon._BatchNormBase)]
    assert len(norms) == 53 and all(type(m) is cls for m in norms)
    assert model.remat_names == {n for n in model.layer_names
                                 if int(n[5]) in args.get("remat_stages", ())}
    calls = []
    for name in model.layer_names:
        getattr(model, name).register_forward_pre_hook(lambda m, a: calls.append(m))
    out = model.train()(torch.randn(4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    out.float().square().mean().backward()
    assert out.shape == (4, NUM_CLASSES) and torch.isfinite(out).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    assert len(calls) == 16 + 7 * bool(args.get("remat_stages"))  # stages 1 and 2: 3 + 4 blocks


def test_factory_builds_resnet_with_the_algorithms_knobs():
    cfg = tconfig.loads({
        "model": {"name": "resnet_micro_bottleneck", "args": {"bn_pallas": True}},
        "precision": {"compute_dtype": "float32"}, "seed": 4,
        "algorithms": [{"cls": "BlurPool"}, {"cls": "StochasticDepth", "args": {"drop_rate": 0.2}}],
    })
    model = build_model(cfg, NUM_CLASSES)
    assert isinstance(model, tresnet.ResNet) and model.blurpool and model.bn_pallas
    assert model.dtype == torch.float32
    assert [getattr(model, n).drop_path_rate for n in model.layer_names] == pytest.approx([0.0, 0.2])
    assert model.cuda_unsupported(32, training=True) == []
    narrow = tresnet.ResNet((1,), NUM_CLASSES, width=4, bn_pallas=True)  # BatchNorms of 4 channels
    found = narrow.cuda_unsupported(32, training=True)
    assert found and all("multiple of 8" in line for line in found)
    assert narrow.cuda_unsupported(32) == []  # eval runs no kernel


# ---------------------------------------------------------------------------
# Three train steps with EMA against hvt's build_train_step
# ---------------------------------------------------------------------------


def test_ema_config_and_schedule_match_hvt():
    for half, interval in (("100ba", "20ba"), ("4ba", "1ba")):
        args = {"half_life": half, "update_interval": interval}
        ref, got = jema.EmaConfig.from_args(args), tema.EmaConfig.from_args(args)
        assert (got.half_life_steps, got.update_interval_steps, got.decay) == (
            ref.half_life_steps, ref.update_interval_steps, pytest.approx(ref.decay, rel=1e-12))
    model = torch.nn.Linear(2, 2)
    ema = tema.Ema(tema.EmaConfig(100, 20), model)
    assert [s for s in range(45) if ema.update(s)] == [0, 20, 40] and ema.updates == 3


@pytest.mark.parametrize("interval,bn_pallas", [(1, True), (2, False)])
def test_three_sgdw_steps_with_ema_match_hvt_build_train_step(interval, bn_pallas):
    img, batch = 32, 4
    rng = np.random.default_rng(50 + interval)
    batches = [(rng.integers(0, 256, size=(batch, img, img, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=batch).astype(np.int32),
                np.ones(batch, np.float32)) for _ in range(3)]
    kw = dict(stem_s2d=True, bn_pallas=bn_pallas)
    jm = jresnet.resnet_micro_bottleneck(NUM_CLASSES, **kw)
    variables = _randomized(_shapes(jm, img), seed=60 + interval)
    mean, std = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))
    ema_cfg = dict(half_life_steps=4, update_interval_steps=interval)
    lr, wd, momentum, clip, smoothing = 0.2, 5e-4, 0.875, 2.0, 0.08

    # hvt
    optim_cfg = type("Optim", (), dict(name="DecoupledSGDW", lr=lr, weight_decay=wd, momentum=momentum))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10), grad_clip_norm=clip,
                                no_decay_substrings=())
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)
    jtrain = jstep.build_train_step(
        jm, jobjectives.soft_cross_entropy, tx, jprep,
        jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=smoothing,
                           ema=jema.EmaConfig(**ema_cfg)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), ema_params=jax.tree.map(jnp.copy, params),
                       ema_batch_stats=jax.tree.map(jnp.copy, stats))
    ref_losses = []
    for im, la, ma in batches:
        state, out = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                            jax.random.key(0), scale=1.0)
        ref_losses.append(float(out["loss_sum"]))
    ref_live = _flax_state(state.params, state.batch_stats)
    ref_ema = _flax_state(state.ema_params, state.ema_batch_stats)

    # the port
    model = tresnet.resnet_micro_bottleneck(NUM_CLASSES, **kw)
    convert.resnet_params_from_flax(model, variables)
    opt = toptim.Optimizer(model.named_parameters(), "decoupledsgdw", lr, wd, momentum,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=clip,
                           no_decay_substrings=model.no_weight_decay_substrings)
    ema = tema.Ema(tema.EmaConfig(**ema_cfg), model)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=smoothing),
                                  ema)
    losses = [float(step(_t(im), _t(la), _t(ma))["loss_sum"]) for im, la, ma in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert ref_losses[0] != ref_losses[2]
    assert ema.updates == {1: 3, 2: 2}[interval]  # steps 0, 1, 2 / steps 0 and 2
    live = model.state_dict()
    averaged = {**ema.params, **ema.batch_stats}
    assert set(averaged) == set(ref_ema) == set(live)
    for name in ref_live:
        _close(live[name], ref_live[name], 1e-5, f"{name} after 3 steps")
        _close(averaged[name], ref_ema[name], 1e-5, f"EMA {name} after 3 steps")
    assert not torch.equal(averaged["stem.conv.weight"], live["stem.conv.weight"])


# ---------------------------------------------------------------------------
# Trainer, entry point and serving
# ---------------------------------------------------------------------------


def _train_layer(save_root, **model_args):
    return {
        "run_name": "resnet_test", "seed": 5, "max_duration": "3ba", "grad_accum": 1,
        "machine": {"save_root": str(save_root)},
        "model": {"name": "resnet_micro_bottleneck", "args": {"stem_s2d": True, **model_args}},
        "train_dataset": {"source": "synthetic", "crop_size": 32,
                          "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 8,
                          "global_batch_size": 4},
        "eval_dataset": {"source": "synthetic", "crop_size": 32,
                         "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 6,
                         "global_batch_size": 4},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "algorithms": [
            {"cls": "ChannelsLast"},
            {"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "2ba"}},
            {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}},
            {"cls": "GradientClipping", "args": {"clipping_type": "norm",
                                                 "clipping_threshold": 2.0}},
        ],
    }


def test_trainer_holds_and_exposes_the_ema(tmp_path):
    trainer = Trainer(tconfig.loads(_train_layer(tmp_path, bn_pallas=True)), device="cpu")
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    seen = []
    metrics = trainer.fit(on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 3 and all(np.isfinite(seen)) and np.isfinite(trainer.train_metrics["loss"])
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy"}  # the last evaluation's
    assert trainer.ema.updates == 2  # steps 0 and 2
    live = trainer.model.state_dict()
    assert trainer.eval_params is trainer.ema.params
    for name, avg in {**trainer.eval_params, **trainer.eval_batch_stats}.items():
        assert torch.isfinite(avg).all(), name
    w = "stage1_block0.conv2.conv.weight"
    assert not torch.equal(trainer.eval_params[w], live[w])
    assert not torch.equal(trainer.eval_batch_stats["stem.bn.running_var"], init["stem.bn.running_var"])
    # without EMA, evaluation uses the live tensors
    layer = _train_layer(tmp_path / "plain")
    layer["algorithms"] = layer["algorithms"][2:]
    plain = Trainer(tconfig.loads(layer), device="cpu")
    assert plain.ema is None
    assert plain.eval_params["stem.conv.weight"] is plain.model.stem.conv.weight


def test_main_trains_resnet_with_ema_on_the_cpu(tmp_path):
    exp = tmp_path / "resnet.yaml"
    exp.write_text(yaml.safe_dump(_train_layer(tmp_path, bn_pallas=True)))
    out = subprocess.run(
        [sys.executable, "-m", "hvt_torch.main", "--machine", "configs/machines/local.yaml",
         "--exp", str(exp), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-3].startswith("[resnet_test] step=3, train-epoch/acc@1=")
    assert lines[-2].startswith("[resnet_test] step=3, eval/acc@1=")
    metrics = json.loads(lines[-1])
    assert np.isfinite(metrics["cross-entropy"]) and 0.0 <= metrics["acc@1"] <= 1.0


def test_inference_engine_serves_resnet_on_the_cpu():
    cfg = tconfig.loads({
        "run_name": "resnet_serve", "seed": 0,
        "model": {"name": "resnet_micro_bottleneck", "args": {"bn_pallas": True}},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "resize_size": 36,
                         "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 8,
                         "global_batch_size": 4},
        "precision": {"compute_dtype": "float32"},
    })
    engine = serve_lib.InferenceEngine(cfg, batch=4, topk=5, device="cpu")
    try:
        assert not engine.model.training
        arr = np.random.default_rng(3).integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        rec = engine.predict_image(buf.getvalue())
        with Image.open(io.BytesIO(buf.getvalue())) as img:
            x = engine.transform(img.convert("RGB"))
        prep = tdevice.DevicePrep.from_config(cfg.eval_dataset, cfg.precision)
        with torch.inference_mode():
            logits = engine.model(prep.normalize(torch.from_numpy(x[None].copy())))
        top_p, top_i = torch.softmax(logits, -1).topk(5)
        assert rec["class_ids"] == top_i[0].tolist()
        np.testing.assert_allclose(rec["probs"], top_p[0].numpy(), atol=1e-5)
    finally:
        engine.close()
