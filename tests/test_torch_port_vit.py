"""The port's ViT and its flash attention against hvt's, on the CPU.

hvt's ``use_flash`` route calls jax's TPU flash-attention op, which runs on a
TPU only. Here hvt's ``flash_available`` is patched to true and the op to
jax's own ``mha_reference_no_custom_vjp`` (``mha_reference``'s backward raises
with segment ids), so hvt's route (padding to 128, segment ids, slicing back)
runs on the CPU with gradients; the port's route runs the flash kernels'
plain versions on CPU tensors. The same seeded numpy inputs, and flax
parameters drawn away from init (carried across by
``hvt_torch.models.convert.vit_params_from_flax``), go through both.
Tolerances (max|Δ| over max|ref| per tensor):

* flash attention alone at N = 197 and 257, head dim 64 and 16: f32 output
  1e-5 and gradients 1e-4 (both sides in f32, another order of sums); bf16
  3e-2 for the output and 5e-2 for the gradients (hvt's reference rounds
  the logits and P to bf16, the port's plain version keeps them in f32);
* ``vit_micro`` in f32, both routes, eval and train mode: logits and
  features 1e-5;
* three AdamW steps of ``vit_micro`` through ``build_train_step`` on both
  routes: losses 1e-5 relative, the step-1 gradient norm 1e-4, each step-1
  gradient 1e-3, the parameters after three steps as
  ``test_torch_port_train._close_after_adam`` holds them;
* the ``torch://`` converters on seeded timm- and HF-layout state dicts: the
  same tensors as hvt's converters carried through ``convert``, bit for bit;
  ``resize_pos_embed`` against hvt's 1e-5 (hvt resizes in f32, the port
  in f64);
* the factory builds every ``vit_*`` name with hvt's parameter shapes, and
  ``cuda_unsupported`` names the kernel's head dim.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.models import torch_compat as jtc
from hvt.models import vit as jvit
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.models import build_model, convert
from hvt_torch.models import torch_compat as ttc
from hvt_torch.models import vit as tvit
from hvt_torch.ops import flash_attention as tfa
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES = 10
IMG = 32  # vit_micro: patch 8, 16 patches + the class token


@pytest.fixture
def hvt_flash(monkeypatch):
    """hvt's flash route on the CPU, through jax's reference attention."""
    monkeypatch.setattr(jvit, "flash_available", lambda: True)
    monkeypatch.setattr(jfa, "flash_attention", jfa.mha_reference_no_custom_vjp)


def close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def randomized(shapes, seed):
    """Every leaf of a flax ViT/DINOv2 tree drawn: LayerNorm scales and
    LayerScales U(0.5, 1.5), biases N(0, 0.1²), cls_token and pos_embed
    N(0, 0.5²), kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "ls1", "ls2"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name == "bias":
            a = 0.1 * rng.normal(size=shape)
        elif name in ("cls_token", "pos_embed"):
            a = 0.5 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def flax_tree(name: str, seed: int, **kw):
    """hvt's ``name`` (f32) params drawn away from init, built once per case."""
    jm = getattr(jvit, name)(NUM_CLASSES, dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))["params"]
    return randomized(shapes, seed)


def port_vit(tree, **kw):
    model = tvit.vit_micro(NUM_CLASSES, dtype="float32", img_size=IMG, **kw)
    return convert.vit_params_from_flax(model, tree)


# ---------------------------------------------------------------------------
# (a) flash attention alone
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 16])
@pytest.mark.parametrize("n", [197, 257])
def test_flash_attention_matches_hvts_attend_flash(hvt_flash, n, hd, dtype):
    rng = np.random.default_rng(n + hd)
    b, h = 2, 2
    q, k, v, g = (rng.normal(size=(b, h, n, hd)).astype(np.float32) for _ in range(4))
    scale = hd ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out_tol, grad_tol = FLASH_TOL[dtype]

    def fwd(q_, k_, v_):
        return jvit._attend_flash(q_, k_, v_, n_real=n, sm_scale=scale)

    def loss(q_, k_, v_):
        return jnp.sum(fwd(q_, k_, v_).astype(jnp.float32) * jnp.asarray(g))

    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    ref = np.asarray(jax.jit(fwd)(*args).astype(jnp.float32))
    ref_g = [np.asarray(r.astype(jnp.float32))
             for r in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]

    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, scale)
    assert out.dtype == tdt and out.shape == (b, h, n, hd)
    (out.float() * torch.from_numpy(g)).sum().backward()
    close(out.detach().float(), ref, out_tol, f"o n={n} hd={hd} {dtype}")
    for name, leaf, r in zip("qkv", leaves, ref_g):
        assert leaf.grad.dtype == tdt
        close(leaf.grad.float(), r, grad_tol, f"d{name} n={n} hd={hd} {dtype}")


def test_flash_plain_backward_is_the_forwards_gradient():
    """The plain dK/dV and dQ (from the saved log-sum-exp and D) against
    torch autograd of the plain forward, in f64 (1e-10), at N = 197."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 197, 3 * 2 * 64))).requires_grad_(True)
    dout = torch.from_numpy(rng.normal(size=(2, 197, 2 * 64)))
    out, lse = tfa.forward_plain(qkv, 2, 0.125)
    ref, = torch.autograd.grad(out, qkv, dout)
    got = tfa.backward(qkv.detach(), out.detach(), lse.detach(), dout, 2, 0.125)
    close(got, ref, 1e-10, "dqkv")
    with torch.no_grad():
        close(tfa.flash_attention_qkv(qkv, 2, 0.125), out.detach(), 0.0, "o through the Function")


# ---------------------------------------------------------------------------
# (b) the model, both routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", ["token", "avg"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_logits_and_features_match_hvt(hvt_flash, use_flash, pool):
    """Eval and train mode (drop path 0: hvt's masks are jax's draws),
    logits and ``features_only``."""
    tree = flax_tree("vit_micro", 11, pool=pool)
    jm = jvit.vit_micro(NUM_CLASSES, dtype=jnp.float32, pool=pool, use_flash=use_flash)
    model = port_vit(tree, pool=pool, use_flash=use_flash)
    x = np.random.default_rng(2).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            logits = model(torch.from_numpy(x))
            feats = model(torch.from_numpy(x), features_only=True)
        ref = jm.apply({"params": tree}, jnp.asarray(x), train=train,
                       rngs={"dropout": jax.random.key(0)})
        ref_f = jm.apply({"params": tree}, jnp.asarray(x), train=train, features_only=True,
                         rngs={"dropout": jax.random.key(0)})
        close(logits, ref, 1e-5, f"logits use_flash={use_flash} train={train}")
        close(feats, ref_f, 1e-5, f"features use_flash={use_flash} train={train}")
        assert feats.shape == (3, 32) and logits.dtype == torch.float32


def test_multitask_head_and_bf16_routes_agree():
    """A multitask head gives one f32 tensor per tier; in bf16 the two
    routes differ only by where P is rounded (within 3e-2 of the logits)."""
    model = tvit.vit_micro((2, 3, 5), img_size=IMG, seed=4)
    flash = tvit.vit_micro((2, 3, 5), img_size=IMG, seed=4, use_pallas=True)
    assert flash.block0.attn.use_flash and model.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, IMG, IMG, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = model.eval()(x), flash.eval()(x)
    assert [t.shape for t in a] == [(2, 2), (2, 3), (2, 5)]
    for ta, tb in zip(a, b):
        assert ta.dtype == torch.float32
        close(tb, ta, 3e-2, "bf16 flash vs dense logits")


def test_drop_path_and_recomputation():
    """Train mode with drop path draws from the generator (another draw,
    another output); ``remat`` gives the same loss and gradients bit for bit
    from the same generator state, on the flash route."""
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, IMG, IMG, 3)).astype(np.float32))
    grads, losses = [], []
    for remat in (False, True):
        model = tvit.vit_micro(NUM_CLASSES, dtype="float32", img_size=IMG, seed=1,
                               drop_path_rate=0.5, use_flash=True, remat=remat).train()
        loss = model(x, generator=torch.Generator().manual_seed(3)).square().sum()
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad for n, p in model.named_parameters()})
        with torch.no_grad():
            other = model(x, generator=torch.Generator().manual_seed(4)).square().sum()
            assert float(other) != losses[-1]
            assert float(model.eval()(x).square().sum()) != losses[-1]
    assert losses[0] == losses[1]
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


# ---------------------------------------------------------------------------
# (c) three AdamW steps
# ---------------------------------------------------------------------------


def _close_after_adam(got, ref, lr, steps, what):
    """Adam moves an element by about ±lr whatever its gradient's size:
    every element within steps·lr, at most 1e-3 of a tensor's elements
    beyond 1e-4·max|p| (test_torch_port_train's bound on the unfused route).
    The key third of the qkv bias is held to the first bound alone: its
    gradient is 0 in exact arithmetic (q·b_k shifts all of a query's logits
    alike), so Adam moves it by ±lr on rounding noise, on each side its own."""
    diff = np.abs(got - ref)
    assert diff.max() <= steps * lr, f"{what}: max|Δ| {diff.max():.3g} > {steps * lr:.3g}"
    if what.endswith("attn.qkv.bias"):
        d = ref.shape[0] // 3
        diff, ref = np.concatenate([diff[:d], diff[2 * d:]]), np.concatenate([ref[:d], ref[2 * d:]])
    off = float(np.mean(diff > 1e-4 * np.abs(ref).max()))
    assert off <= 1e-3, f"{what}: {off:.3g} of the elements beyond 1e-4·max|p|"


@pytest.mark.parametrize("use_flash", [True, False])
def test_three_adamw_steps_match_hvt_build_train_step(hvt_flash, use_flash):
    lr = 1e-3
    rng = np.random.default_rng(30)
    batches = [(rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=4).astype(np.int32),
                np.ones(4, np.float32)) for _ in range(3)]
    tree = flax_tree("vit_micro", 40)
    jm = jvit.vit_micro(NUM_CLASSES, dtype=jnp.float32, use_flash=use_flash)
    mean, std = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)
    images, labels, mask = (jnp.asarray(a) for a in batches[0])

    def loss_fn(params):
        out = jm.apply({"params": params}, jprep.normalize(images), train=True)
        return jobjectives.soft_cross_entropy(out, jdevice.prepare_targets(labels, NUM_CLASSES,
                                                                           0.1), mask)

    ref_grads = convert.vit_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, tree))))
    optim_cfg = type("Optim", (), dict(name="adamw", lr=lr, weight_decay=0.05, momentum=0.9))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(0, 10), grad_clip_norm=1.0,
                                no_decay_substrings=jm.no_weight_decay_substrings)
    jtrain = jstep.build_train_step(jm, jobjectives.soft_cross_entropy, tx, jprep,
                                    jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    params = jax.tree.map(jnp.asarray, tree)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params))
    ref_losses = []
    for im, la, ma in batches:
        state, stats = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                              jax.random.key(0), scale=1.0)
        ref_losses.append(float(stats["loss_sum"]))
    ref_params = convert.vit_state_dict_from_flax(jax.tree.map(np.asarray, state.params))

    model = port_vit(tree, use_flash=use_flash)
    opt = toptim.Optimizer(model.named_parameters(), "adamw", lr, 0.05, 0.9,
                           tschedule.cosine_with_warmup(0, 10), grad_clip_norm=1.0,
                           no_decay_substrings=model.no_weight_decay_substrings)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    losses = []
    for i, (im, la, ma) in enumerate(batches):
        stats = step(*(torch.from_numpy(np.array(a)) for a in (im, la, ma)))
        losses.append(float(stats["loss_sum"]))
        if i == 0:  # p.grad holds the clipped gradient after the step
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            grad_norm = float(stats["grad_norm"])
    assert set(grads) == set(ref_grads)
    ref_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                           for g in ref_grads.values()))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert ref_losses[0] != ref_losses[2]
    assert grad_norm == pytest.approx(ref_norm, rel=1e-4)
    clip = min(1.0, 1.0 / ref_norm)
    for name, g in grads.items():
        close(g, ref_grads[name] * clip, 1e-3, f"step-1 gradient {name}")
    for name, p in model.state_dict().items():
        _close_after_adam(p.numpy(), ref_params[name], lr, 3, name)


# ---------------------------------------------------------------------------
# (d) torch:// files
# ---------------------------------------------------------------------------


def vit_state_dict(layout: str, rng, depth=2, d=32, p=8, n=17, classes=5) -> dict:
    """A seeded timm- or HF-layout ViT state dict (HF under ``vit.``)."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def lin(name, o, i):
        return {f"{name}.weight": t(o, i), f"{name}.bias": t(o)}

    def ln(name):
        return {f"{name}.weight": t(d), f"{name}.bias": t(d)}

    sd = {}
    if layout == "timm":
        sd.update(cls_token=t(1, 1, d), pos_embed=t(1, n, d))
        sd.update({"patch_embed.proj.weight": t(d, 3, p, p), "patch_embed.proj.bias": t(d)})
        for i in range(depth):
            b = f"blocks.{i}"
            sd.update({**ln(f"{b}.norm1"), **ln(f"{b}.norm2"), **lin(f"{b}.attn.qkv", 3 * d, d),
                       **lin(f"{b}.attn.proj", d, d), **lin(f"{b}.mlp.fc1", 4 * d, d),
                       **lin(f"{b}.mlp.fc2", d, 4 * d)})
        sd.update({**ln("norm"), **lin("head", classes, d)})
        return sd
    sd.update({"vit.embeddings.cls_token": t(1, 1, d),
               "vit.embeddings.position_embeddings": t(1, n, d),
               "vit.embeddings.patch_embeddings.projection.weight": t(d, 3, p, p),
               "vit.embeddings.patch_embeddings.projection.bias": t(d)})
    for i in range(depth):
        b = f"vit.encoder.layer.{i}"
        sd.update({**ln(f"{b}.layernorm_before"), **ln(f"{b}.layernorm_after"),
                   **lin(f"{b}.attention.attention.query", d, d),
                   **lin(f"{b}.attention.attention.key", d, d),
                   **lin(f"{b}.attention.attention.value", d, d),
                   **lin(f"{b}.attention.output.dense", d, d),
                   **lin(f"{b}.intermediate.dense", 4 * d, d),
                   **lin(f"{b}.output.dense", d, 4 * d)})
    sd.update({**ln("vit.layernorm"), **lin("classifier", classes, d)})
    return sd


@pytest.mark.parametrize("layout", ["timm", "hf"])
def test_vit_torch_files_convert_as_hvts(tmp_path, layout):
    sd = vit_state_dict(layout, np.random.default_rng(len(layout)))
    ref = convert.vit_state_dict_from_flax(jtc.convert_vit_state_dict(sd))
    got = ttc.convert_vit_state_dict(sd)
    assert set(got) == set(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
    path = tmp_path / "vit.pt"
    torch.save({"model": sd}, path)
    params, stats = ttc.load_torch_variables(f"torch://{path}")
    assert stats == {} and set(params) == set(ref)
    model = tvit.vit_micro(5, img_size=IMG)
    model.load_state_dict(params, strict=True)  # every name and shape of the port's model


@pytest.mark.parametrize("grid,new", [(4, 6), (6, 4), (16, 37), (5, 5)])
def test_resize_pos_embed_matches_hvts(grid, new):
    pos = np.random.default_rng(grid).normal(size=(1, grid * grid + 1, 8)).astype(np.float32)
    ref = jtc.resize_pos_embed(pos, new)
    got = ttc.resize_pos_embed(torch.from_numpy(pos), new)
    assert got.shape == ref.shape == (1, new * new + 1, 8)
    close(got, ref, 1e-5, f"pos embed {grid} → {new}")  # hvt resizes in f32, the port in f64
    np.testing.assert_array_equal(got[:, 0].numpy(), pos[:, 0])


# ---------------------------------------------------------------------------
# (e) the factory and the kernels' refusals
# ---------------------------------------------------------------------------

VIT_NAMES = ("vit_tiny_patch16_224", "vit_small_patch16_224", "vit_base_patch16_224",
             "vit_base_patch32_224", "vit_large_patch16_224", "vit_micro")


def shape_tree(jm, img):
    """hvt's parameter shapes at ``img`` px, as the port's names → shapes
    (zero-byte broadcast arrays through ``convert``)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, img, img, 3)),
                                            train=False))["params"]
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    return {k: tuple(v.shape) for k, v in convert.vit_state_dict_from_flax(zeros).items()}


def factory_checks(name, module, img, head_dim):
    """Build ``name`` through the port's factory (on the meta device: no
    weights drawn) and check its parameter shapes against hvt's, its class,
    and ``cuda_unsupported`` on both routes."""
    cfg = {"model": {"name": name, "args": {}}, "train_dataset": {"crop_size": img}}
    with torch.device("meta"):
        model = build_model(tconfig.loads(cfg), NUM_CLASSES)
        flash = build_model(tconfig.loads(cfg, {"model": {"args": {"use_pallas": True}}}),
                            NUM_CLASSES)
    jm = getattr(module, name)(NUM_CLASSES)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shape_tree(jm, img)
    assert model.dtype == torch.bfloat16 and not model.block0.attn.use_flash
    assert flash.block0.attn.use_flash
    assert model.cuda_unsupported(img, training=True) == []
    why = flash.cuda_unsupported(img, training=True)
    if head_dim == tfa.HEAD_DIM:
        assert why == []
    else:
        assert why == [f"attention ({model.depth} blocks, use_flash): the flash-attention kernel "
                       f"takes head dim 64, not {head_dim}: {tfa.COVERAGE_ITEM}"]


@pytest.mark.parametrize("name", VIT_NAMES)
def test_factory_builds_every_vit(name):
    patch = 32 if "patch32" in name else 8 if name == "vit_micro" else 16
    factory_checks(name, jvit, 2 * patch, 16 if name == "vit_micro" else 64)


def test_other_families_stay_refused():
    """The three conv families build their classes now that they are ported."""
    from hvt_torch.models import convnext, efficientnet, regnet

    for name, cls in (("convnext_tiny", convnext.ConvNeXt),
                      ("efficientnet_b0", efficientnet.EfficientNet),
                      ("regnety_004", regnet.RegNetY)):
        with torch.device("meta"):
            model = build_model(tconfig.loads({"model": {"name": name}}), NUM_CLASSES)
        assert isinstance(model, cls) and model.cuda_unsupported(224, training=True) == []


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def _train_layer(tmp_path, **args):
    return {
        "run_name": "vit_test", "seed": 5, "max_duration": "2ba", "grad_accum": 2,
        "model": {"name": "vit_micro", "args": {"drop_path_rate": 0.1, **args}},
        "machine": {"save_root": str(tmp_path)},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                          "synthetic_num_samples": 8, "global_batch_size": 4},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                         "synthetic_num_samples": 4, "global_batch_size": 4},
        "optim": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "algorithms": [{"cls": "LabelSmoothing", "args": {"smoothing": 0.1}},
                       {"cls": "GradientClipping", "args": {"clipping_type": "norm",
                                                            "clipping_threshold": 1.0}}],
    }


@pytest.mark.parametrize("args", [{"use_flash": True, "remat": True}, {}])
def test_main_trains_vit_micro_on_the_cpu(tmp_path, args):
    """``hvt_torch.main`` on vit_micro (AdamW, smoothing, clip, drop path,
    two microbatches; the flash route with recomputation): two steps and
    the evaluation, finite."""
    from hvt_torch import main as tmain

    seen = []
    metrics = tmain.main(tconfig.loads(_train_layer(tmp_path, **args)), device="cpu",
                         on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 2 and all(np.isfinite(seen)) and np.isfinite(metrics["cross-entropy"])


def test_trainer_refuses_on_the_card_a_head_dim_the_kernel_cannot_take(tmp_path, monkeypatch):
    from hvt_torch import device as device_lib
    from hvt_torch import main as tmain

    monkeypatch.setattr(device_lib, "resolve", lambda device=None: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="vit_micro.*head dim 64, not 16"):
        tmain.main(tconfig.loads(_train_layer(tmp_path, use_flash=True)))
