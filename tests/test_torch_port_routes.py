"""The fused SwinV2 block's routes, the port against hvt's model on the CPU.

A small SwinV2 (embed 32, depths 2-2, heads 1-2, window 7, 112 px, batch 2,
f32 activations) with every parameter drawn from one seeded flax tree runs
through hvt's ``SwinTransformerV2`` (its Pallas halves in interpret mode)
and, after ``swin_params_from_flax``, through the port (the plain versions
of its kernels), with hvt's routing knobs set away from their defaults.
Stage 1's map has 784 tokens an image, stage 2's 196, not a multiple of 8:
there hvt keeps the MLP half's residual outside the kernel
(``mlp_resid_images_per_block`` is 0), and so must the port.

* The route each block's halves take is recorded on both sides (hvt's by
  spying on its kernel entry points as its model traces them, the port's on
  its own) and must be the same, block for block.
* Eval logits for ``fuse_nhwc: false``, ``fuse_resid: false`` and, on the
  unfused route, ``use_pallas: false``: within 2e-2·max|ref| where a fused
  half runs (both round every product's operands to bf16; the JAX suite's
  rule for these kernels), 1e-4 on the unfused reference route (f32 only).
* One training step's gradients of Σ logits·G at drop path 0, for
  ``fuse_nhwc: false`` and for ``fuse_attn_train: false`` with
  ``fallback_xla`` true and false: every parameter's gradient within
  5e-2·max|ref| (the fused route's tolerance of
  tests/test_torch_port_train.py, ``FUSED_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.models import swinv2 as jswin
from hvt.ops import fused_halves_pallas as jfh
from hvt.ops import window_attention as jwa
from hvt_torch.models import convert
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=7)
IMAGE, BATCH, NUM_CLASSES = 112, 2, 10
FUSED_TOL, REFERENCE_TOL, GRAD_TOL = 2e-2, 1e-4, 5e-2


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _randomized(shapes, seed):
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


@pytest.fixture(scope="module")
def tree_and_batch():
    jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, **GEOMETRY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMAGE, IMAGE, 3)),
                                            train=False))["params"]
    rng = np.random.default_rng(97)
    x = rng.normal(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    g = rng.normal(size=(BATCH, NUM_CLASSES)).astype(np.float32)
    return _randomized(shapes, seed=98), x, g


def _spy(monkeypatch, module, name, log, label):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        entry = label(args, kwargs)
        if entry is not None:
            log.append(entry)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def _hvt_routes(monkeypatch):
    """Spy on hvt's entry points: the route of each block's attention half
    and MLP half, in call order (the materialising (1, N, C) dummy calls of
    hvt's ``_fused_call`` left out)."""
    log = []
    resid = lambda a, k: k.get("dp") is not None  # noqa: E731
    _spy(monkeypatch, jfh, "attention_half_nhwc_spmd", log,
         lambda a, k: "nhwc_resid" if resid(a, k) else "nhwc")
    _spy(monkeypatch, jfh, "attention_half_spmd", log, lambda a, k: "windows")
    _spy(monkeypatch, jwa, "window_attention_qkv", log,
         lambda a, k: None if a[0].shape[0] == 1 else
         ("packed" if k["use_pallas"] and a[0].shape[0] > 1 else "reference"))
    _spy(monkeypatch, jfh, "mlp_half_spmd", log,
         lambda a, k: "mlp_resid" if resid(a, k) else "mlp")
    _spy(monkeypatch, jfh, "mlp_half_chunked_spmd", log, lambda a, k: "mlp_chunked")
    return log


def _port_routes(monkeypatch):
    log = []
    resid = lambda a, k: k.get("dp") is not None  # noqa: E731
    _spy(monkeypatch, fh, "attention_half_nhwc", log,
         lambda a, k: "nhwc_resid" if resid(a, k) else "nhwc")
    _spy(monkeypatch, fh, "attention_half", log, lambda a, k: "windows")
    _spy(monkeypatch, wa, "window_attention_qkv", log,
         lambda a, k: "packed" if k["use_pallas"] else "reference")
    _spy(monkeypatch, fh, "mlp_half", log, lambda a, k: "mlp_resid" if resid(a, k) else "mlp")
    _spy(monkeypatch, fh, "mlp_half_chunked", log, lambda a, k: "mlp_chunked")
    return log


def _models(tree, knobs):
    jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, drop_path_rate=0.0,
                                 **GEOMETRY, **knobs)
    tm = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32, drop_path_rate=0.0,
                                 **GEOMETRY, **knobs)
    return jm, convert.swin_params_from_flax(tm, tree)


# (knobs, hvt's routes of the four blocks: attention half then MLP half each)
EVAL = {
    "fuse_nhwc_false": (dict(fuse=True, fuse_nhwc=False),
                        ["windows", "mlp_resid"] * 2 + ["windows", "mlp"] * 2, FUSED_TOL),
    "fuse_resid_false": (dict(fuse=True, fuse_resid=False), ["nhwc", "mlp"] * 4, FUSED_TOL),
    "unfused_use_pallas_false": (dict(fuse=False, use_pallas=False), ["reference"] * 4,
                                 REFERENCE_TOL),
}


@pytest.mark.parametrize("case", list(EVAL))
def test_eval_logits_and_routes_match_hvt(tree_and_batch, monkeypatch, case):
    knobs, routes, tol = EVAL[case]
    tree, x, _ = tree_and_batch
    jm, tm = _models(tree, knobs)
    hvt_log, port_log = _hvt_routes(monkeypatch), _port_routes(monkeypatch)
    ref = jm.apply({"params": tree}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert hvt_log == routes, hvt_log
    assert port_log == routes, port_log
    _close(got, ref, tol, f"{case} logits")


TRAIN = {
    "fuse_nhwc_false": (dict(fuse=True, fuse_nhwc=False),
                        ["windows", "mlp_resid"] * 2 + ["windows", "mlp"] * 2),
    "fuse_attn_train_false_fallback_xla": (
        dict(fuse=True, fuse_attn_train=False, fallback_xla=True),
        ["reference", "mlp_resid"] * 2 + ["reference", "mlp"] * 2),
    "fuse_attn_train_false_packed": (
        dict(fuse=True, fuse_attn_train=False, fallback_xla=False),
        ["packed", "mlp_resid"] * 2 + ["packed", "mlp"] * 2),
}


@pytest.mark.parametrize("case", list(TRAIN))
def test_training_gradients_and_routes_match_hvt(tree_and_batch, monkeypatch, case):
    """hvt's packed route off the TPU runs its jnp reference; the port's
    packed route on CPU tensors runs the packed kernel's plain version."""
    knobs, routes = TRAIN[case]
    tree, x, g = tree_and_batch
    jm, tm = _models(tree, knobs)
    hvt_log, port_log = _hvt_routes(monkeypatch), _port_routes(monkeypatch)

    def loss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x), train=True) * jnp.asarray(g))

    ref = convert.swin_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, tree))))
    tm.train()
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    assert hvt_log == routes, hvt_log
    assert port_log == routes, port_log
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(grads) == set(ref)
    for name, got in grads.items():
        _close(got, ref[name], GRAD_TOL, f"{case} gradient {name}")
