"""Recomputation (ResNet's ``remat_stages``, SwinV2's ``remat``) and SwinV2's
``ape``, on the CPU.

* Port only, exact: one step's gradients, running statistics and generator
  state with recomputation (each block's forward run again in the
  backward) equal those without it bit for bit, with drop
  path 0.5 (the recomputation draws the forward's masks and the BatchNorms
  update once): ResNet under both policies, with torch's BatchNorm and with
  ``bn_pallas``, and SwinV2 on both routes. An unknown policy raises.
* Against hvt: three train steps with ``remat_stages`` (both policies) and
  with SwinV2's ``remat`` (both routes) against hvt's ``nn.remat`` models,
  at ``test_torch_port_accum_sam.py``'s tolerances, drop path 0.
* ``ape``: the train-mode forward and the gradients of every parameter
  against hvt's (1e-5·max|ref|, f32) through ``swin_params_from_flax``;
  ``torch_compat`` both ways against hvt's ``convert_swin_state_dict`` and
  ``export_swin_state_dict``; no weight decay on the embedding; another
  input size raises, naming both sizes.

hvt's side runs first in each test and is copied to numpy before torch runs
a backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_accum_sam import (FUSED_TOL, MEAN_STD, RESNET_TOL, SWIN_MICRO, UNFUSED_TOL,
                                       check_both, randomized, run_both)

from hvt.models import swinv2 as jswin
from hvt.models import torch_compat as jcompat
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.models import common as tcommon
from hvt_torch.models import convert
from hvt_torch.models import resnet as tresnet
from hvt_torch.models import swinv2 as tswin
from hvt_torch.models import torch_compat as tcompat
from hvt_torch.train import optim as toptim
from hvt_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES = 10
IMG = 32


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _model(family, remat, **kw):
    if family == "resnet":
        return tresnet.resnet_micro_bottleneck(NUM_CLASSES, stochastic_depth_rate=0.5, seed=2,
                                               remat_stages=(1, 2) if remat else (), **kw)
    return tswin.swinv2_micro(NUM_CLASSES, dtype="float32", drop_path_rate=0.5, remat=remat,
                              seed=2, **kw)


def _one_step(model):
    """One step's gradients (the train step's gradient pass), the running
    statistics after it, the generator's state and the blocks' forward
    calls."""
    calls = []
    for name in model.layer_names:
        if "block" in name:
            getattr(model, name).register_forward_pre_hook(lambda m, a: calls.append(m))
    prep = tdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=torch.float32)
    gradients = tstep.build_gradients(model, tobjectives.soft_cross_entropy, prep,
                                      tstep.StepSettings(NUM_CLASSES, smoothing=0.1))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, size=(4, IMG, IMG, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, NUM_CLASSES, size=4))
    generator = torch.Generator().manual_seed(9)
    model.train()
    loss, _ = gradients(images, labels, torch.ones(4), generator)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return (loss, grads, {n: b.clone() for n, b in model.named_buffers()}, generator.get_state(),
            len(calls))


@pytest.mark.parametrize("family,kw", [
    ("resnet", {"remat_policy": "nothing"}),
    ("resnet", {"remat_policy": "dots", "bn_pallas": True}),
    ("swin", {"fuse": False}),
    ("swin", {"fuse": True}),
])
def test_recomputation_is_bit_equal_to_none(family, kw):
    plain_kw = {k: v for k, v in kw.items() if k != "remat_policy"}
    loss, grads, buffers, state, calls = _one_step(_model(family, True, **kw))
    ref_loss, ref_grads, ref_buffers, ref_state, ref_calls = _one_step(
        _model(family, False, **plain_kw))
    assert calls == 2 * ref_calls  # each block's forward ran again in the backward
    assert torch.equal(loss, ref_loss)
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name
    assert set(buffers) == set(ref_buffers)
    for name, b in buffers.items():
        assert torch.equal(b, ref_buffers[name]), name
    assert torch.equal(state, ref_state)
    if family == "resnet":  # the statistics moved, once
        assert not torch.equal(buffers["stem.bn.running_mean"], torch.zeros(8))


def test_an_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy 'offload'"):
        tresnet.resnet_micro_bottleneck(NUM_CLASSES, remat_stages=(1,), remat_policy="offload")
    assert tcommon.REMAT_POLICIES == ("nothing", "dots")


@pytest.mark.parametrize("family,kw", [
    ("resnet", {"remat_stages": (1, 2), "remat_policy": "nothing"}),
    ("resnet", {"remat_stages": (2,), "remat_policy": "dots"}),
    ("swin", {"remat": True, "fuse": False}),
    ("swin", {"remat": True, "fuse": True}),
])
def test_remat_matches_hvt(family, kw):
    ref, got = run_both(family, kw, {}, seed=len(kw) + kw.get("fuse", 0))
    tol = RESNET_TOL if family == "resnet" else (FUSED_TOL if kw["fuse"] else UNFUSED_TOL)
    check_both(family, ref, got, tol, fused=kw.get("fuse", False))


# ---------------------------------------------------------------------------
# ape
# ---------------------------------------------------------------------------


def _ape_models():
    jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, drop_path_rate=0.0,
                                 ape=True, **SWIN_MICRO)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    assert shapes["params"]["absolute_pos_embed"].shape == (1, 8, 8, 16)
    tree = randomized(shapes, 5, "swin")
    model = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32,
                                    drop_path_rate=0.0, ape=True, img_size=IMG, **SWIN_MICRO)
    return jm, tree, convert.swin_params_from_flax(model, tree["params"])


def test_ape_forward_and_gradients_match_hvt():
    jm, tree, model = _ape_models()
    x = np.random.default_rng(4).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    targets = np.eye(NUM_CLASSES, dtype=np.float32)[[1, 7]]

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), train=True)
        return jnp.sum(jax.nn.log_softmax(out) * targets), out

    (_, ref_out), ref_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree["params"]))
    ref_out = np.asarray(ref_out)
    ref_g = convert.swin_state_dict_from_flax(jax.tree.map(np.asarray, ref_g))
    ref_pos = np.asarray(tree["params"]["absolute_pos_embed"])

    assert torch.equal(model.absolute_pos_embed.detach(), torch.from_numpy(ref_pos))
    model.train()
    out = model(torch.from_numpy(x))
    (torch.log_softmax(out, -1) * torch.from_numpy(targets)).sum().backward()
    _close(out.detach(), ref_out, 1e-5, "logits")
    for name, p in model.named_parameters():
        _close(p.grad, ref_g[name], 1e-5, f"gradient {name}")
    assert np.abs(ref_g["absolute_pos_embed"]).max() > 0


def test_ape_init_decay_and_size():
    model = tswin.swinv2_micro(NUM_CLASSES, ape=True, img_size=IMG, seed=1)
    pos = model.absolute_pos_embed
    assert pos.shape == (1, 8, 8, 16)
    assert 0.01 < float(pos.detach().std()) < 0.02 and float(pos.detach().abs().max()) <= 0.04
    assert tswin.swinv2_micro(NUM_CLASSES).absolute_pos_embed is None
    mask = toptim.decay_mask(model.named_parameters(), model.no_weight_decay_substrings)
    assert mask["absolute_pos_embed"] is False and mask["stage0_block0.attn.qkv.weight"]
    with pytest.raises(ValueError, match=r"8x8 token grid \(32 px\).*16x16 \(64 px\)"):
        model(torch.zeros(1, 64, 64, 3))


def test_ape_torch_compat_both_ways_match_hvt():
    _, tree, model = _ape_models()
    params = {k: v.detach() for k, v in model.named_parameters()}
    ref_sd = jcompat.export_swin_state_dict(tree["params"])
    sd = tcompat.export_swin_state_dict(params)
    assert set(sd) == set(ref_sd)
    assert tuple(sd["absolute_pos_embed"].shape) == ref_sd["absolute_pos_embed"].shape == (1, 64, 16)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), ref_sd[name], err_msg=name)
    back = tcompat.convert_swin_state_dict(sd)
    ref_back = convert.swin_state_dict_from_flax(jcompat.convert_swin_state_dict(ref_sd))
    assert set(back) == set(ref_back) == set(params)
    for name, t in back.items():
        np.testing.assert_array_equal(t.numpy(), ref_back[name], err_msg=name)
        assert torch.equal(t, params[name]), name
