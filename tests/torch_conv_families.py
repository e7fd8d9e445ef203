"""What the ConvNeXt, RegNet-Y and EfficientNet port tests share.

Each test file holds one family of ``hvt_torch/models`` against hvt's on the
CPU: the same seeded numpy inputs, and flax variables with every leaf drawn
away from init (ConvNeXt's ``gamma`` is 1e-6 there, BatchNorm's running
statistics 0 and 1), go through hvt and, after
``hvt_torch.models.convert.convnet_params_from_flax``, through the port.
Drop rates are 0 wherever they would draw: JAX's PRNG is not torch's.
hvt's reference gradients go through ``jax.jit``; hvt's side runs first and
is copied to numpy before torch runs a backward.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.train import ema as jema
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.models import build_model, convert
from hvt_torch.models import torch_compat as ttc
from hvt_torch.train import ema as tema
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep

NUM_CLASSES = 10
IMG = 32
MEAN_STD = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))


def close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def randomized(shapes, seed):
    """Every leaf of a flax variables tree drawn: norm scales and ConvNeXt's
    gamma U(0.5, 1.5), biases and running means N(0, 0.1²), running
    variances U(0.5, 1.5), kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "gamma", "var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def shapes_of(jm, img=IMG):
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, img, img, 3)),
                                          train=False))


@functools.lru_cache(maxsize=None)
def _variables(jfamily, name, seed, num_classes, kw):
    jm = getattr(jfamily, name)(num_classes, dtype=jnp.float32, **dict(kw))
    return randomized(shapes_of(jm), seed)


def variables(jfamily, name, seed, num_classes=NUM_CLASSES, **kw):
    """hvt's ``name`` (f32) variables drawn away from init, made once per case."""
    return _variables(jfamily, name, seed, num_classes, tuple(sorted(kw.items())))


def hvt_init(jm, seed):
    """hvt's own (jitted) init of ``jm`` from ``seed``, as the port's names."""
    init = jax.jit(lambda key: jm.init(key, jnp.zeros((1, IMG, IMG, 3)), train=False))
    return flax_state(jax.tree.map(np.asarray, init(jax.random.key(seed))))


def port(tfamily, name, tree, num_classes=NUM_CLASSES, **kw):
    model = getattr(tfamily, name)(num_classes, **kw)
    return convert.convnet_params_from_flax(model, tree)


def images(seed, batch=3, img=IMG):
    return np.random.default_rng(seed).normal(size=(batch, img, img, 3)).astype(np.float32)


def flax_state(tree):
    """Variables as the port's state-dict names."""
    return convert.convnet_state_dict_from_flax(jax.tree.map(np.asarray, tree["params"]),
                                                jax.tree.map(np.asarray,
                                                             tree.get("batch_stats")))


def check_forward(jfamily, tfamily, name, dtype, kw, seed, stats):
    """Eval and train-mode logits (f32: 1e-5 and 1e-4; bf16: 2e-2·max|ref|)
    and, where ``stats``, the running statistics after the train forward
    (1e-5 in f32)."""
    tree = variables(jfamily, name, seed, **kw)
    jm = getattr(jfamily, name)(NUM_CLASSES, dtype=getattr(jnp, dtype), **kw)
    model = port(tfamily, name, tree, dtype=dtype, **kw)
    x = images(seed + 1)
    tol = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}[dtype]
    ref_eval = np.asarray(jm.apply(tree, jnp.asarray(x), train=False).astype(jnp.float32))
    ref_train, mut = jm.apply(tree, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ref_train = np.asarray(ref_train.astype(jnp.float32))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.dtype == got_train.dtype == torch.float32
    close(got_eval, ref_eval, tol[0], f"{name} {dtype} eval logits")
    close(got_train, ref_train, tol[1], f"{name} {dtype} train logits")
    if stats:
        ref_stats = flax_state({"params": tree["params"], "batch_stats": mut["batch_stats"]})
        state = model.state_dict()
        running = [k for k in ref_stats if "running" in k]
        assert running and len(running) == len([k for k in state if "running" in k])
        for key in running:
            close(state[key], ref_stats[key], 1e-5 if dtype == "float32" else 2e-2,
                  f"{name} {dtype} {key}")


def check_features_and_multitask(jfamily, tfamily, name, kw, seed, width):
    """``features_only`` (f32, eval and train mode) within 1e-5, and a
    multitask head's tiers (f32 logits each) within 1e-5 in eval mode."""
    tree = variables(jfamily, name, seed, **kw)
    jm = getattr(jfamily, name)(NUM_CLASSES, dtype=jnp.float32, **kw)
    model = port(tfamily, name, tree, dtype="float32", **kw)
    x = images(seed + 1)
    for train in (False, True):
        ref = jm.apply(tree, jnp.asarray(x), train=train, features_only=True,
                       mutable=["batch_stats"] if train else False)
        ref = ref[0] if train else ref
        with torch.no_grad():
            got = model.train(train)(torch.from_numpy(x), features_only=True)
        assert got.shape == (3, width) and model.num_features == width
        close(got, ref, 1e-5, f"{name} features train={train}")
    tiers = (2, 3, 5)
    mtree = variables(jfamily, name, seed + 2, num_classes=tiers, **kw)
    jmt = getattr(jfamily, name)(tiers, dtype=jnp.float32, **kw)
    mt = port(tfamily, name, mtree, num_classes=tiers, dtype="float32", **kw)
    assert set(k for k in mt.state_dict() if k.startswith("head.")) == {
        f"head.tier{i}.{p}" for i in range(3) for p in ("weight", "bias")}
    ref = jmt.apply(mtree, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = mt.eval()(torch.from_numpy(x))
    assert len(got) == 3 and [t.shape[1] for t in got] == list(tiers)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32
        close(g, r, 1e-5, f"{name} multitask tier {i}")


def train_grads(jm, tree, x, g):
    """hvt's train-mode gradients of Σ logits·g (jitted), as the port's names."""
    stats = tree.get("batch_stats", {})

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * g)

    grads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, tree["params"]))
    return convert.convnet_state_dict_from_flax(jax.tree.map(np.asarray, grads))


def close_gradients(got, ref, tol, what, zero=()):
    """Each gradient within ``tol``·max|ref| of its tensor; those named in
    ``zero``, 0 in exact arithmetic (a bias whose shift a train-mode
    BatchNorm's mean removes), only rounding noise on both sides: within
    1e-5 of the largest gradient of the model."""
    assert set(got) == set(ref)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for n, r in ref.items():
        if n in zero:
            for side in (got[n], r):
                assert float(np.abs(np.asarray(side)).max()) <= 1e-5 * top, f"{what} {n}"
        else:
            close(got[n], r, tol, f"{what} {n}")


def check_gradients(jfamily, tfamily, name, kw, seed, tol=1e-4, zero=()):
    """Train-mode gradients of Σ logits·g against jitted ``jax.grad``, in f32,
    with and without ``remat`` on both sides (``close_gradients``); the
    port's ``remat`` bit-equal to its plain forward."""
    tree = variables(jfamily, name, seed, **kw)
    x = images(seed + 1, batch=4)
    g = np.random.default_rng(seed + 2).normal(size=(4, NUM_CLASSES)).astype(np.float32)
    grads, buffers = {}, {}
    for remat in (False, True):
        jm = getattr(jfamily, name)(NUM_CLASSES, dtype=jnp.float32, remat=remat, **kw)
        ref = train_grads(jm, tree, jnp.asarray(x), jnp.asarray(g))
        model = port(tfamily, name, tree, dtype="float32", remat=remat, **kw).train()
        (model(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        buffers[remat] = dict(model.named_buffers())
        close_gradients(grads[remat], ref, tol, f"{name} remat={remat} gradient", zero)
    for n, t in grads[False].items():
        assert torch.equal(t, grads[True][n]), n
    for n, t in buffers[False].items():
        assert torch.equal(t, buffers[True][n]), n


def check_remat_bit_equal(model_fn, stochastic=True, generator_seed=3):
    """``remat`` gives the same loss, gradients and running statistics (each
    BatchNorm updated once) bit for bit from the same generator state; where
    the model draws (``stochastic``), another generator state gives another
    loss."""
    x = torch.from_numpy(images(6, batch=4))
    runs = []
    for remat in (False, True):
        model = model_fn(remat).train()
        gen = torch.Generator().manual_seed(generator_seed)
        loss = model(x, generator=gen).square().sum()
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers()}, gen.get_state()))
        with torch.no_grad():
            other = model(x, generator=torch.Generator().manual_seed(generator_seed + 1))
            assert (float(other.square().sum()) != runs[-1][0]) == stochastic
    (loss, grads, bufs, state), (rloss, rgrads, rbufs, rstate) = runs
    assert loss == rloss and torch.equal(state, rstate)
    for n, t in grads.items():
        assert torch.equal(t, rgrads[n]), n
    for n, t in bufs.items():
        assert torch.equal(t, rbufs[n]), n


def three_steps(jfamily, tfamily, name, kw, optim, lr, wd, momentum, clip, smoothing, ema=None,
                seed=30):
    """Three steps through hvt's ``build_train_step`` and the port's, from
    the same variables and batches (f32, warmup 1 of a 10-step cosine).
    Returns (losses, ref losses, port state, ref state, port EMA state or
    None, ref EMA state or None, step-1 gradients, ref step-1 gradients)."""
    rng = np.random.default_rng(seed)
    batches = [(rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=4).astype(np.int32),
                np.ones(4, np.float32)) for _ in range(3)]
    tree = variables(jfamily, name, seed, **kw)
    jm = getattr(jfamily, name)(NUM_CLASSES, dtype=jnp.float32, **kw)
    mean, std = MEAN_STD
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)

    images0, labels0, mask0 = (jnp.asarray(a) for a in batches[0])
    stats0 = tree.get("batch_stats", {})

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": stats0}, jprep.normalize(images0),
                          train=True, mutable=["batch_stats"])
        targets = jdevice.prepare_targets(labels0, NUM_CLASSES, smoothing)
        return jobjectives.soft_cross_entropy(out, targets, mask0)

    ref_grads = convert.convnet_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray,
                                                                         tree["params"]))))
    optim_cfg = type("Optim", (), dict(name=optim, lr=lr, weight_decay=wd, momentum=momentum))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10),
                                grad_clip_norm=clip, no_decay_substrings=())
    jtrain = jstep.build_train_step(
        jm, jobjectives.soft_cross_entropy, tx, jprep,
        jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=smoothing,
                           ema=None if ema is None else jema.EmaConfig(**ema)))
    params = jax.tree.map(jnp.asarray, tree["params"])
    stats = jax.tree.map(jnp.asarray, stats0)
    extra = {} if ema is None else dict(ema_params=jax.tree.map(jnp.copy, params),
                                        ema_batch_stats=jax.tree.map(jnp.copy, stats))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), **extra)
    ref_losses = []
    for im, la, ma in batches:
        state, out = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                            jax.random.key(0), scale=1.0)
        ref_losses.append(float(out["loss_sum"]))
    ref_state = flax_state({"params": state.params, "batch_stats": state.batch_stats})
    ref_ema = None if ema is None else flax_state({"params": state.ema_params,
                                                   "batch_stats": state.ema_batch_stats})

    model = port(tfamily, name, tree, dtype="float32", **kw)
    opt = toptim.Optimizer(model.named_parameters(), optim.lower(), lr, wd, momentum,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=clip,
                           no_decay_substrings=model.no_weight_decay_substrings)
    averager = None if ema is None else tema.Ema(tema.EmaConfig(**ema), model)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=smoothing),
                                  averager)
    losses = []
    for i, (im, la, ma) in enumerate(batches):
        stats = step(*(torch.from_numpy(np.array(a)) for a in (im, la, ma)))
        losses.append(float(stats["loss_sum"]))
        if i == 0:  # p.grad holds the clipped gradient after the step
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            grad_norm = float(stats["grad_norm"])
    ref_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                           for g in ref_grads.values()))
    assert abs(grad_norm - ref_norm) <= 1e-4 * ref_norm, (grad_norm, ref_norm)
    scale = min(1.0, clip / ref_norm)
    ema_state = None if averager is None else {**averager.params, **averager.batch_stats}
    return (losses, ref_losses, model.state_dict(), ref_state, ema_state, ref_ema, grads,
            {n: g * scale for n, g in ref_grads.items()})


def check_sgd_steps(result, ema, zero=()):
    """Three SGD-family steps (``three_steps``' result): losses 1e-5
    relative, the step-1 gradients 1e-3 (``close_gradients``), parameters
    and running statistics (and with ``ema`` their averages) 1e-5·max|ref|
    per tensor."""
    losses, ref_losses, state, ref_state, ema_state, ref_ema, grads, ref_grads = result
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert ref_losses[0] != ref_losses[2]
    close_gradients(grads, ref_grads, 1e-3, "step-1 gradient", zero)
    assert set(state) == set(ref_state) and any("running" in k for k in state)
    for name, t in state.items():
        close(t, ref_state[name], 1e-5, f"{name} after 3 steps")
    if ema:
        assert set(ema_state) == set(ref_ema)
        for name, t in ema_state.items():
            close(t, ref_ema[name], 1e-5, f"EMA {name} after 3 steps")


def torch_bn(t, name: str, c: int) -> dict:
    """A torch BatchNorm2d's five entries, ``t(*shape)`` drawing each tensor."""
    return {f"{name}.weight": t(c), f"{name}.bias": t(c), f"{name}.running_mean": t(c),
            f"{name}.running_var": t(c).abs() + 0.5,
            f"{name}.num_batches_tracked": torch.tensor(7, dtype=torch.int64)}


def close_after_adam(got, ref, lr, steps, what):
    """Adam moves an element by about ±lr whatever its gradient's size: every
    element within steps·lr, at most 1e-3 of a tensor's elements beyond
    1e-4·max|p| (``test_torch_port_vit``'s bound)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert diff.max() <= steps * lr, f"{what}: max|Δ| {diff.max():.3g} > {steps * lr:.3g}"
    off = float(np.mean(diff > 1e-4 * np.abs(ref).max()))
    assert off <= 1e-3, f"{what}: {off:.3g} of the elements beyond 1e-4·max|p|"


def check_converter_and_decay_mask(jfamily, tfamily, name, num_classes, img=IMG):
    """hvt's parameter tree carried through ``convert`` names every tensor
    of the port's model (built on the meta device) with the same shape, and
    the port's decay mask equals hvt's ``decay_mask``."""
    jm = getattr(jfamily, name)(num_classes)
    shapes = shapes_of(jm, img)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = convert.convnet_state_dict_from_flax(zeros["params"], zeros.get("batch_stats"))
    with torch.device("meta"):
        model = getattr(tfamily, name)(num_classes)
    ref = model.state_dict()
    assert set(state) == set(ref)
    assert all(tuple(ref[k].shape) == v.shape for k, v in state.items())
    mask = joptim.decay_mask(shapes["params"], ())
    flags = jax.tree.map(lambda m, s: np.broadcast_to(np.float32(m), s.shape), mask,
                         shapes["params"])
    ref_mask = {k: bool(v.all()) for k, v in convert.convnet_state_dict_from_flax(flags).items()}
    got = toptim.decay_mask(model.named_parameters(), model.no_weight_decay_substrings)
    assert got == ref_mask
    return model, got


def check_torch_file(tmp_path, sd, hvt_convert, port_convert, make_model):
    """A torch state dict through hvt's converter (then ``convert``) and the
    port's: the same tensors bit for bit; ``load_torch_variables`` reads the
    file; the result loads strictly into ``make_model()``."""
    ref = hvt_convert(sd)
    ref_params, ref_stats = ref if isinstance(ref, tuple) else (ref, None)
    want = convert.convnet_state_dict_from_flax(ref_params, ref_stats)
    got = port_convert(sd)
    params, stats = got if isinstance(got, tuple) else (got, {})
    assert set({**params, **stats}) == set(want)
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    path = tmp_path / "weights.pt"
    torch.save({"model": sd}, path)
    fparams, fstats = ttc.load_torch_variables(f"torch://{path}")
    assert set(fparams) == set(params) and set(fstats) == set(stats)
    model = make_model()
    model.load_state_dict({**fparams, **fstats}, strict=True)
    return model


def check_factory_variant(jfamily, name, img):
    """``name`` through the port's factory (meta device) with hvt's parameter
    shapes (``jax.eval_shape``), the bf16 default, no kernel refusal."""
    cfg = tconfig.loads({"model": {"name": name, "args": {}},
                         "train_dataset": {"crop_size": img}})
    with torch.device("meta"):
        model = build_model(cfg, NUM_CLASSES)
    shapes = shapes_of(getattr(jfamily, name)(NUM_CLASSES), img)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = convert.convnet_state_dict_from_flax(zeros["params"], zeros.get("batch_stats"))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in want.items()}
    assert model.cuda_unsupported(img, training=True) == model.cuda_unsupported(img) == []
    return model


def train_layer(tmp_path, name, **extra):
    """A two-step Trainer config of ``name`` on the synthetic source with one
    evaluation at the end (and hvt's before the first step)."""
    layer = {
        "run_name": f"{name}_test", "seed": 5, "max_duration": "2ba", "grad_accum": 1,
        "model": {"name": name, "args": {}},
        "machine": {"save_root": str(tmp_path)}, "save": {"wandb": False},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                          "synthetic_num_samples": 8, "global_batch_size": 4},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                         "synthetic_num_samples": 4, "global_batch_size": 4},
        "precision": {"compute_dtype": "float32"},
        "scheduler": {"args": {"t_warmup": "1ba"}},
    }
    for key, value in extra.items():
        layer[key] = {**layer.get(key, {}), **value} if isinstance(value, dict) else value
    return tconfig.loads(layer)


def check_main_and_serving(tmp_path, name, **extra):
    """``hvt_torch.main.main`` trains ``name`` two steps on the CPU and
    evaluates it; ``InferenceEngine`` serves it, each record held against a
    direct forward of the engine's model."""
    import io

    from PIL import Image

    from hvt_torch import main as tmain
    from hvt_torch.downstream import serve as serve_lib

    seen = []
    config = train_layer(tmp_path, name, **extra)
    metrics = tmain.main(config, device="cpu",
                         on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 2 and all(np.isfinite(seen)) and np.isfinite(metrics["cross-entropy"])
    engine = serve_lib.InferenceEngine(config, batch=4, topk=5, device="cpu")
    try:
        assert not engine.model.training
        arr = np.random.default_rng(3).integers(0, 256, size=(40, 48, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        rec = engine.predict_image(buf.getvalue())
        with Image.open(io.BytesIO(buf.getvalue())) as img:
            x = engine.transform(img.convert("RGB"))
        prep = tdevice.DevicePrep.from_config(config.eval_dataset, config.precision)
        with torch.inference_mode():
            logits = engine.model(prep.normalize(torch.from_numpy(x[None].copy())))
        top_p, top_i = torch.softmax(logits, -1).topk(5)
        assert rec["class_ids"] == top_i[0].tolist()
        np.testing.assert_allclose(rec["probs"], top_p[0].numpy(), atol=1e-5)
    finally:
        engine.close()
