"""int8 w8a8 serving (``hvt_torch.ops.quant``, ``hvt_torch.ops.int8_cuda``)
against hvt's ``hvt/ops/quant.py``, on the CPU.

The same seeded numpy inputs and flax weights (every leaf drawn) go through
hvt and, converted, through the port. Held here:

* ``quantize_weight`` / ``quantize_act`` bit-equal to hvt's on arrays that
  hold exact rounding ties (values (k + ½)·scale, where the scale is a power
  of two), dynamic and static;
* ``int8_linear`` and ``int8_conv2d``'s plain versions against one flax
  ``Dense`` / ``Conv`` under hvt's ``wrap_int8`` (``_quant_dense`` /
  ``_quant_conv``, run op by op: under ``jax.jit`` XLA's CPU compiler fuses
  the epilogue into other roundings): bit-equal in f32, within one bf16 ulp
  in bf16, at a
  dense layer, 3×3 convs at stride 1 and 2 with ``SAME`` and explicit pads,
  a 2×2 stride-2 patchify, a 7×7 depthwise, a grouped 3×3 and a 1×1 on
  (B, 1, 1, C) at an odd C; the int32 sums equal to an int64 reference;
* the layer inventory: the port's calibration keys equal hvt's
  ``collect_act_scales`` keys on the same weights and batches, the values
  within 1e-6 relative, for ``swinv2_micro`` on both routes and with its
  MLP halves routed unfused, ``resnet_micro`` (and the bottleneck micro with
  ``stem_s2d``), ``vit_micro`` with flash on and off, ``dinov2_micro``,
  ``convnext_micro``, ``efficientnet_micro`` and ``regnety_micro``; the only
  keys hvt has and the port lacks are its fused route's dummies (the
  attention and MLP modules hvt calls on zeros to make their parameters,
  whose outputs it drops), listed by name from the port's routing;
* the whole model: the port's int8 logits against hvt's ``wrap_int8``
  logits, dynamic and calibrated, in f32, within ``LOGIT_TOL`` of
  max|logit| with top-1 equal. Why not bit-equal: the layers between the
  products (LayerNorm, GELU, softmax, BatchNorm) round differently in torch
  and XLA, so an activation that lands within an f32 rounding of a tie
  between two int8 steps quantizes one step apart, and the layers after it
  carry that step: up to 1e-3 of max|logit| here (DINOv2 and SwinV2
  unfused, calibrated), 2e-7 (f32's rounding) where no input flips;
* ``build_topk_step``, ``predict`` (dynamic and ``calibrate``) and
  ``InferenceEngine`` with ``quantize="int8"`` against hvt's records;
  hvt's usage errors; a tensor-parallel model refused;
* the CLIs: ``--quantize int8`` and ``--calibrate N`` end to end, hvt's parser
  errors, ``--artifact`` still refused.
"""

import functools
import io
import json
import pathlib
import socket
import subprocess
import sys
import time
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas.ops.tpu import flash_attention as jfa
from PIL import Image

import test_torch_port_predict as port_predict
import torch_conv_families as fam
from hvt import config as jconfig
from hvt.downstream import predict as jpredict
from hvt.downstream import serve as jserve
from hvt.models import build_model as jbuild_model
from hvt.models import vit as jvit
from hvt.ops import fused_halves_pallas as jfh
from hvt.ops import quant as jquant
from hvt_torch import config as tconfig
from hvt_torch.downstream import predict as tpredict
from hvt_torch.downstream import serve as tserve
from hvt_torch.models import build_model as tbuild_model
from hvt_torch.models import convert
from hvt_torch.ops import fused_halves_cuda as tfh
from hvt_torch.ops import int8_cuda
from hvt_torch.ops import quant as tquant
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 10
IMG = 32
LOGIT_TOL = 2e-3  # of max|logit|: see the module docstring
SCALE_RTOL = 1e-6


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.int8)


# ---------------------------------------------------------------------------
# quantize_weight / quantize_act
# ---------------------------------------------------------------------------

def _with_ties(rng, shape, amax):
    """Values in [-amax, amax] with amax itself present and a third of them
    exact ties (k + ½)·amax/127 of the int8 rounding (amax/127 a power of 2)."""
    step = amax / 127.0
    x = rng.uniform(-amax, amax, size=shape)
    ties = (rng.integers(-127, 127, size=shape) + 0.5) * step
    x = np.where(rng.random(shape) < 1 / 3, ties, x)
    x.reshape(-1)[0] = amax
    return x.astype(np.float32)


@pytest.mark.parametrize("amax", [127 / 16, 127 / 4, 3.7])
def test_quantize_act_bit_equal_to_hvt(amax):
    x = _with_ties(np.random.default_rng(int(amax * 100)), (6, 7, 11), amax)
    jq, js = jquant.quantize_act(jnp.asarray(x))
    tq, ts = tquant.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()) == _bits(np.float32(js))
    if amax == 127 / 16:  # the ties are exact: half to even on both sides
        assert (np.abs(x / (amax / 127) - np.round(x / (amax / 127))) == 0.5).any()
    static = float(js) * 1.25
    jq, _ = jquant.quantize_act(jnp.asarray(x), static)
    tq, ts = tquant.quantize_act(torch.from_numpy(x), static)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32 and float(ts) == np.float32(static)
    # bf16 inputs widen to f32 first, as hvt's astype(f32)
    xb = torch.from_numpy(x).bfloat16()
    jq, js = jquant.quantize_act(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    tq, ts = tquant.quantize_act(xb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits(ts.numpy()) == _bits(np.float32(js))


@pytest.mark.parametrize("layout", ["dense", "conv"])
def test_quantize_weight_bit_equal_to_hvt(layout):
    rng = np.random.default_rng(3)
    if layout == "dense":
        k = np.stack([_with_ties(rng, (24,), a) for a in (127 / 8, 127 / 32, 0.3, 5.0)], 1)
        jq, js = jquant.quantize_weight(jnp.asarray(k), reduce_axes=(0,))
        tq, ts = tquant.quantize_weight(torch.from_numpy(k.T.copy()), (1,))
        np.testing.assert_array_equal(tq.numpy().T, np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts.numpy().reshape(-1)), _bits(np.asarray(js).reshape(-1)))
    else:
        k = np.stack([_with_ties(rng, (3, 3, 5), a) for a in (127 / 8, 0.02, 2.5)], -1)
        k[..., 2] = 0.0  # an all-zero channel: the scale is EPS/127
        jq, js = jquant.quantize_weight(jnp.asarray(k), reduce_axes=(0, 1, 2))
        w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())  # OIHW
        tq, ts = tquant.quantize_weight(w, (1, 2, 3))
        np.testing.assert_array_equal(tq.numpy().transpose(2, 3, 1, 0), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts.numpy().reshape(-1)), _bits(np.asarray(js).reshape(-1)))
        assert float(ts.reshape(-1)[2]) == np.float32(np.float32(1e-8) / np.float32(127.0))


# ---------------------------------------------------------------------------
# The products' plain versions against one flax layer under wrap_int8
# ---------------------------------------------------------------------------

LAYERS = {  # case: (input shape, layer kwargs); Dense when "kernel_size" is absent
    "dense": ((3, 5, 40), {"features": 24}),
    "conv3x3_s1_same": ((2, 9, 9, 16), {"features": 24, "kernel_size": (3, 3), "padding": "SAME"}),
    "conv3x3_s2_same": ((2, 10, 9, 16), {"features": 24, "kernel_size": (3, 3), "strides": 2,
                                         "padding": "SAME"}),
    "conv3x3_s2_pads": ((2, 9, 10, 8), {"features": 16, "kernel_size": (3, 3), "strides": 2,
                                        "padding": ((1, 0), (2, 1))}),
    "patchify_2x2_s2": ((2, 8, 8, 12), {"features": 24, "kernel_size": (2, 2), "strides": 2,
                                        "padding": "VALID"}),
    "depthwise_7x7": ((2, 9, 9, 12), {"features": 12, "kernel_size": (7, 7), "padding": 3,
                                      "feature_group_count": 12}),
    "grouped_3x3": ((2, 7, 7, 16), {"features": 32, "kernel_size": (3, 3), "padding": 1,
                                    "feature_group_count": 4}),
    "se_1x1_odd": ((3, 1, 1, 13), {"features": 5, "kernel_size": (1, 1)}),
}


def _flax_layer(case, dtype):
    shape, kw = LAYERS[case]
    use_bias = case != "conv3x3_s2_pads"
    if "kernel_size" in kw:
        return nn.Conv(dtype=dtype, use_bias=use_bias, **kw), shape
    return nn.Dense(dtype=dtype, use_bias=use_bias, **kw), shape


def _same_pads(h, w, kh, kw, s):
    """flax's (XLA's) ``SAME`` as explicit (top, bottom, left, right): an
    output of ceil(size / s), the total pad split with the odd one at the
    end (asymmetric at stride 2)."""
    pads = []
    for size, k in ((h, kh), (w, kw)):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def _flax_pads(kw, h, w):
    """Explicit (top, bottom, left, right) of flax's padding forms."""
    kh, kwid = kw["kernel_size"]
    s = kw.get("strides", 1)
    pad = kw.get("padding", "SAME")
    if pad == "SAME":
        return _same_pads(h, w, kh, kwid, s)
    if pad == "VALID":
        return (0, 0, 0, 0)
    if isinstance(pad, int):
        return (pad, pad, pad, pad)
    return (*pad[0], *pad[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_int8_products_match_hvts_rewrite(case, dtype):
    rng = np.random.default_rng(sorted(LAYERS).index(case))
    jdt = jnp.dtype(dtype)
    mod, shape = _flax_layer(case, jdt)
    x = rng.normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
        mod.init(jax.random.key(0), xj))
    # op by op, as hvt's source reads: under jax.jit XLA's CPU compiler fuses
    # the epilogue and moves the last bit of about a third of the outputs
    ref = np.asarray(jquant.wrap_int8(lambda v, a: mod.apply(v, a))(params, xj)
                     .astype(jnp.float32))
    kernel = np.asarray(params["params"]["kernel"])
    bias = params["params"].get("bias")
    bias_t = None if bias is None else torch.from_numpy(np.array(bias))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    xq, sx = tquant.quantize_act(xt)
    _, kw = LAYERS[case]
    if "kernel_size" not in kw:
        wq, sw = tquant.quantize_weight(torch.from_numpy(kernel.T.copy()), (1,))
        got = int8_cuda.int8_linear(xq, wq, sx, sw.reshape(-1), bias_t, xt.dtype)
        acc = int8_cuda.int8_linear(xq, wq, sx, sw.reshape(-1))
        want = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64).T
    else:
        groups = kw.get("feature_group_count", 1)
        wq, sw = tquant.quantize_weight(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                                        (1, 2, 3))
        wq = wq.permute(2, 3, 1, 0).contiguous()  # HWIO
        pads = _flax_pads(kw, shape[1], shape[2])
        conv = functools.partial(int8_cuda.int8_conv2d, stride=kw.get("strides", 1), pads=pads,
                                 groups=groups)
        got = conv(xq, wq, sx, sw.reshape(-1), bias_t, xt.dtype)
        acc = conv(xq, wq, sx, sw.reshape(-1))
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()), (kw.get("strides", 1),) * 2,
            ((pads[0], pads[1]), (pads[2], pads[3])), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups, preferred_element_type=jnp.int32))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    else:  # within one bf16 ulp (2⁻⁷ of the value's binade)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(got - ref) <= ulp).all()


@pytest.mark.parametrize("stride,static", [(1, False), (2, False), (2, True)])
def test_int8_1x1_conv_takes_the_product_route(stride, static, monkeypatch):
    """A 1×1 conv with one group and no pads: the quantizer keeps its int8
    weight as (O, C), once, and runs it through ``int8_linear`` on the
    strided grid, with the activation's scale taken from all of x (hvt's);
    bit-equal to ``int8_conv2d`` on the same weight laid out HWIO. A padded
    1×1 keeps the conv route and the HWIO layout."""
    from hvt_torch.models import common

    torch.manual_seed(stride + static)
    conv = torch.nn.Conv2d(13, 24, 1, stride=stride)
    padded = torch.nn.Conv2d(13, 24, 1, padding=1)
    ctx = tquant.Int8(torch.nn.ModuleDict({"a": conv, "b": padded}),
                      {"a": 0.03, "b": 0.03} if static else None)
    x = torch.randn(2, 7, 9, 13)
    real, convs = int8_cuda.int8_conv2d, []
    monkeypatch.setattr(int8_cuda, "int8_conv2d",
                        lambda *a, **k: convs.append(k) or real(*a, **k))
    with torch.inference_mode(), ctx:
        y = common.conv_nhwc(conv, x)
        y_padded = common.conv_nhwc(padded, x)
    wq, sw = ctx._weight(conv)
    assert wq.shape == (24, 13) and wq.is_contiguous() and ctx._weight(conv)[0] is wq
    assert ctx._weight(padded)[0].shape == (1, 1, 13, 24)
    assert len(convs) == 1 and convs[0]["pads"] == (1, 1, 1, 1)  # the padded one alone
    xq, sx = tquant.quantize_act(x, 0.03 if static else None)
    want = real(xq, wq.t().reshape(1, 1, 13, 24), sx, sw, conv.bias, torch.float32,
                stride=stride, pads=(0, 0, 0, 0))
    assert y.shape == (2, -(-7 // stride), -(-9 // stride), 24) and torch.equal(y, want)
    assert y_padded.shape == (2, 9, 11, 24)


def test_products_refuse_what_int32_or_the_shapes_cannot_hold():
    xq = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\(N, K\) expected"):
        int8_cuda.int8_linear(xq, torch.zeros((3, 5), dtype=torch.int8), 1.0, torch.ones(3))
    big = int8_cuda.MAX_K + 1
    with pytest.raises(ValueError, match="does not fit int32"):
        int8_cuda.int8_linear(torch.zeros((2, big), dtype=torch.int8),
                              torch.zeros((3, big), dtype=torch.int8), 1.0, torch.ones(3))
    with pytest.raises(ValueError, match="groups 3"):
        int8_cuda.int8_conv2d(torch.zeros((1, 4, 4, 4), dtype=torch.int8),
                              torch.zeros((3, 3, 1, 6), dtype=torch.int8), 1.0, torch.ones(6),
                              groups=3)
    with pytest.raises(ValueError, match="leaves no output"):
        int8_cuda.int8_conv2d(torch.zeros((1, 2, 2, 4), dtype=torch.int8),
                              torch.zeros((3, 3, 4, 6), dtype=torch.int8), 1.0, torch.ones(6))
    assert _same_pads(10, 9, 3, 3, 2) == (0, 1, 1, 1)  # flax/XLA: the odd one at the end


# ---------------------------------------------------------------------------
# Whole models: the layer inventory and the logits
# ---------------------------------------------------------------------------

MODELS = {  # case: (model name, args, the routing threshold in MiB or None)
    "swinv2_unfused": ("swinv2_micro", {"fuse": False}, None),
    "swinv2_fused": ("swinv2_micro", {"fuse": True}, None),
    "swinv2_fused_mlp_unfused": ("swinv2_micro", {"fuse": True, "fuse_mlp_chunked": False}, 2),
    "resnet": ("resnet_micro", {}, None),
    "resnet_bottleneck_s2d": ("resnet_micro_bottleneck", {"stem_s2d": True}, None),
    "vit": ("vit_micro", {}, None),
    "vit_flash": ("vit_micro", {"use_flash": True}, None),
    "dinov2": ("dinov2_micro", {}, None),
    "convnext": ("convnext_micro", {}, None),
    "efficientnet": ("efficientnet_micro", {}, None),
    "regnety": ("regnety_micro", {}, None),
}


@pytest.fixture
def routing(request, monkeypatch):
    """hvt's flash route on the CPU (jax's reference attention) and, for a
    case with a threshold, hvt's and the port's routing threshold."""
    monkeypatch.setattr(jvit, "flash_available", lambda: True)
    monkeypatch.setattr(jfa, "flash_attention", jfa.mha_reference_no_custom_vjp)
    mb = MODELS[request.param][2]
    if mb is not None:
        monkeypatch.setenv("HVT_FITS_VMEM_MB", str(mb))
        monkeypatch.setattr(tfh, "FITS_THRESHOLD_BYTES", mb * 2**20)
    return request.param


def _layer(case):
    name, args, _ = MODELS[case]
    return {"model": {"name": name, "args": {"dtype": "float32", **args}}, "seed": 0,
            "train_dataset": {"crop_size": IMG}}


@functools.lru_cache(maxsize=None)
def _flax_variables(case):
    jm = jbuild_model(jconfig.loads(_layer(case)), NUM_CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    return fam.randomized(dict(shapes), seed=7)


def _models(case):
    layer = _layer(case)
    jm = jbuild_model(jconfig.loads(layer), NUM_CLASSES)
    variables = _flax_variables(case)
    tm = tbuild_model(tconfig.loads(layer), NUM_CLASSES)
    name = layer["model"]["name"]
    if name.startswith("swin"):
        convert.swin_params_from_flax(tm, variables["params"])
    elif name.startswith("resnet"):
        convert.resnet_params_from_flax(tm, variables)
    elif name.startswith(("vit", "dinov2")):
        convert.vit_params_from_flax(tm, variables["params"])
    else:
        convert.convnet_params_from_flax(tm, variables)
    return jm, variables, tm.eval()


def _images(seed, n=4):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


CALIBRATION = (_images(11), _images(12))


def _hvt_forward(jm, variables):
    return lambda images: jm.apply(variables, images, train=False)


def _fused_dummies(tm) -> set:
    """hvt's keys of the modules its fused route calls on zero dummies: each
    fused attention half's ``attn/proj`` and each fused MLP half's ``mlp/fc1``
    and ``mlp/fc2``, by the port's routing (the same decisions as hvt's)."""
    if not getattr(tm, "fuse", False):
        return set()
    out, grid = set(), IMG // tm.patch_embed.stride[0]
    for stage, depth in enumerate(tm.depths):
        for i in range(depth):
            block = getattr(tm, f"stage{stage}_block{i}")
            window = min(grid, block.window)
            if not block.fuse or grid % window:
                continue
            name = f"stage{stage}_block{i}"
            if block.attn_route(window * window, False) not in ("packed", "reference"):
                out.add(f"{name}/attn/proj")
            if block.mlp_route(False) > 0:
                out |= {f"{name}/mlp/fc1", f"{name}/mlp/fc2"}
        grid //= 2
    return out


@pytest.mark.parametrize("routing", sorted(MODELS), indirect=True)
def test_layer_inventory_matches_hvt(routing):
    jm, variables, tm = _models(routing)
    ref = jquant.collect_act_scales(_hvt_forward(jm, variables),
                                    [jnp.asarray(b) for b in CALIBRATION])
    with torch.inference_mode():
        got = tquant.collect_act_scales(tm, lambda b: tm(torch.from_numpy(b)), CALIBRATION)
    dummies = _fused_dummies(tm)
    assert set(got) == set(ref) - dummies and dummies <= set(ref)
    if routing == "swinv2_fused":
        assert dummies and not any("/attn/" in k or "/mlp/" in k for k in got)
    if routing == "swinv2_fused_mlp_unfused":
        assert any(k.endswith("/mlp/fc1") for k in got) and not any("/attn/" in k for k in got)
    if routing == "resnet_bottleneck_s2d":
        assert not any(k.startswith("stem") for k in got)
    if routing == "resnet":
        assert "stem/Conv_0" in got
    assert got and not any("head" in k for k in got)
    for key, value in got.items():
        assert abs(value - ref[key]) <= SCALE_RTOL * ref[key], (key, value, ref[key])


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("routing", sorted(MODELS), indirect=True)
def test_int8_logits_match_hvts_wrap_int8(routing, calibrated):
    jm, variables, tm = _models(routing)
    x = _images(5)
    forward = _hvt_forward(jm, variables)
    jscales = tscales = None
    if calibrated:
        jscales = jquant.collect_act_scales(forward, [jnp.asarray(b) for b in CALIBRATION])
        with torch.inference_mode():
            tscales = tquant.collect_act_scales(tm, lambda b: tm(torch.from_numpy(b)), CALIBRATION)
    ref = np.asarray(jax.jit(jquant.wrap_int8(forward, act_scales=jscales))(jnp.asarray(x)))
    with torch.inference_mode(), tquant.Int8(tm, tscales):
        got = tm(torch.from_numpy(x)).numpy()
    fam.close(got, ref, LOGIT_TOL, f"{routing} int8 logits")
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    with torch.inference_mode():
        full = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - full).max() > 0  # the int8 products ran


def test_int8_refuses_a_tensor_parallel_model():
    _, _, tm = _models("vit")
    tm.block0.mlp.tp = True
    with pytest.raises(ValueError, match="mesh.model shards"):
        tquant.Int8(tm)


# ---------------------------------------------------------------------------
# predict, the engine and the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return port_predict.downstream.write_folder(tmp_path_factory.mktemp("quant-fixture"))


def _pair(case, folder, tmp_path):
    return port_predict._pair(case, folder, tmp_path)


def _records_close(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("classes", "class_ids", "label", "path", "tier_ids"):
            assert g.get(key) == r.get(key), (key, g, r)
        np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-4)


@pytest.mark.parametrize("calibrate", [0, 1, 2])
@pytest.mark.parametrize("case", ["resnet_folder", "swin_fused_multitask"])
def test_predict_int8_records_match_hvt(case, calibrate, folder, tmp_path):
    jcfg, tcfg = _pair(case, folder, tmp_path)
    ref = list(jpredict.predict(jcfg, topk=3, quantize="int8", calibrate=calibrate))
    got = list(tpredict.predict(tcfg, topk=3, quantize="int8", calibrate=calibrate, device="cpu"))
    _records_close(got, ref)
    full = list(tpredict.predict(tcfg, topk=3, device="cpu"))
    assert any(g["probs"] != f["probs"] for g, f in zip(got, full))


def test_build_topk_step_and_live_scales_match_hvt(folder, tmp_path):
    jcfg, tcfg = _pair("resnet_folder", folder, tmp_path)
    from hvt_torch.data import DevicePrep, build_loader

    loader, info = build_loader(tcfg, is_train=False)
    model = tpredict._resolve_weights(tcfg, tbuild_model(tcfg, info.num_classes), True).eval()
    prep = DevicePrep.from_config(tcfg.eval_dataset, tcfg.precision)
    scales = tpredict.live_act_scales(model, prep, loader, 2)
    assert set(scales) == {k for k in tquant.layer_keys(model).values()}
    step = tpredict.build_topk_step(model, prep, None, 3, torch.device("cpu"), quantize="int8",
                                    act_scales=scales)
    images = next(iter(loader.epoch(0))).images
    top_i, top_p, tiers, n_allowed = step(images)
    assert top_i.shape == (images.shape[0], 3) and tiers is None and n_allowed is None
    with pytest.raises(ValueError, match="expected int8"):
        tpredict.build_topk_step(model, prep, None, 3, torch.device("cpu"), quantize="int4")
    with pytest.raises(ValueError, match="expected int8"):
        next(iter(jpredict.predict(jcfg, quantize="int4")))
    with pytest.raises(ValueError, match="calibration loader yielded no batches"):
        tpredict.live_act_scales(model, prep, loader, 0)


def test_predict_and_engine_usage_errors_match_hvt(folder, tmp_path):
    jcfg, tcfg = _pair("resnet_folder", folder, tmp_path)
    for predict, kw in ((jpredict.predict, {}), (tpredict.predict, {"device": "cpu"})):
        with pytest.raises(ValueError, match="requires quantize"):
            next(iter(predict(jcfg if predict is jpredict.predict else tcfg, calibrate=2, **kw)))
        with pytest.raises(ValueError, match="expected int8"):
            next(iter(predict(jcfg if predict is jpredict.predict else tcfg, quantize="int4",
                              **kw)))
    with pytest.raises(ValueError, match="requires quantize"):
        jserve.InferenceEngine(jcfg, topk=2, batch=1, calibrate=1)
    with pytest.raises(ValueError, match="requires quantize"):
        tserve.InferenceEngine(tcfg, topk=2, batch=1, calibrate=1, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        tpredict.predict(tcfg, artifact="dir", device="cpu")


def _png(seed: int) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, size=(40, 44, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("calibrate", [0, 1])
def test_engine_int8_records_match_hvt(calibrate, folder, tmp_path):
    jcfg, tcfg = _pair("resnet_folder", folder, tmp_path)
    ref_engine = jserve.InferenceEngine(jcfg, topk=3, batch=2, quantize="int8",
                                        calibrate=calibrate)
    engine = tserve.InferenceEngine(tcfg, topk=3, batch=2, quantize="int8", calibrate=calibrate,
                                    device="cpu")
    try:
        assert engine.quantize == "int8" and (engine.act_scales is not None) == bool(calibrate)
        for seed in range(3):
            _records_close([engine.predict_image(_png(seed))],
                           [ref_engine.predict_image(_png(seed))])
    finally:
        engine.close()
        ref_engine.close()


def _exp_file(tmp_path) -> pathlib.Path:
    path = tmp_path / "quant.yaml"
    path.write_text(yaml.safe_dump(port_predict._layer("resnet_micro", "synthetic")))
    return path


def _cli(module, *args, timeout=300):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def test_predict_cli_quantize_and_calibrate(tmp_path):
    exp = _exp_file(tmp_path)
    machine = str(ROOT / "configs/machines/local.yaml")
    out = _cli("hvt_torch.predict", "--machine", machine, "--exp", str(exp), "--output",
               str(tmp_path / "q.jsonl"), "--topk", "2", "--quantize", "int8", "--calibrate", "1",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in (tmp_path / "q.jsonl").read_text().splitlines()]
    assert len(rows) == 7 and all(len(r["class_ids"]) == 2 for r in rows)
    for module in ("hvt_torch.predict", "hvt_torch.serve"):
        out = _cli(module, "--machine", machine, "--exp", str(exp), "--calibrate", "2")
        assert out.returncode == 2 and "--calibrate requires --quantize int8" in out.stderr
        out = _cli(module, "--machine", machine, "--exp", str(exp), "--quantize", "int4")
        assert out.returncode == 2 and "invalid choice: 'int4'" in out.stderr
        out = _cli(module, "--artifact", "some/dir")
        assert out.returncode == 2 and "not ported to hvt_torch yet" in out.stderr


def test_serve_cli_int8_calibrated_answers_requests(tmp_path):
    exp = _exp_file(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "hvt_torch.serve", "--machine",
         str(ROOT / "configs/machines/local.yaml"), "--exp", str(exp), "--port", str(port),
         "--batch", "2", "--topk", "2", "--quantize", "int8", "--calibrate", "2",
         "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 240
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    assert json.loads(r.read())["status"] == "ok"
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
                time.sleep(0.5)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict?topk=2", data=_png(4))
        with urllib.request.urlopen(req, timeout=60) as r:
            rec = json.loads(r.read())
        assert len(rec["class_ids"]) == 2 and len(rec["probs"]) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
