"""The port's RegNet-Y against hvt's, on the CPU.

The same seeded numpy inputs and flax variables drawn away from init
(params and ``batch_stats``) go through hvt and, after
``hvt_torch.models.convert.convnet_params_from_flax``, through the port at
``regnety_micro`` (``tests/torch_conv_families.py`` holds the shared
checks). Tolerances (max|Δ| over max|ref| per tensor):

* logits, eval and train mode: f32 1e-5 and 1e-4, bf16 2e-2; the running
  statistics after the train forward (flax momentum 0.9, eps 1e-5) 1e-5 in
  f32; features and a multitask head's tiers 1e-5;
* train-mode gradients against jitted ``jax.grad`` 1e-4, with and without
  ``remat`` on both sides; the port's ``remat`` bit-equal to none, running
  statistics included;
* three steps with ``regnety_040.yaml``'s DecoupledSGDW (lr 2.048, momentum
  0.875, wd 5e-4, clip 2.0, smoothing 0.08) and EMA against hvt's
  ``build_train_step``: losses 1e-5 relative, step-1 gradients 1e-3,
  parameters, running statistics and their EMA 1e-5;
* init: seeded, hvt's distributions (variance_scaling(2, fan_out) convs,
  lecun_normal head); the converter and decay mask; the ``torch://``
  converter (HF layout, running statistics) bit for bit against hvt's;
  every variant through the factory with hvt's shapes; StochasticDepth
  raises as in hvt; the Trainer and ``InferenceEngine``.
"""

import numpy as np
import pytest
import torch

import torch_conv_families as fam
from hvt.models import factory as jfactory
from hvt.models import regnet as jregnet
from hvt.models import torch_compat as jtc
from hvt_torch import config as tconfig
from hvt_torch.models import build_model
from hvt_torch.models import common as tcommon
from hvt_torch.models import regnet as tregnet
from hvt_torch.models import torch_compat as ttc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "regnety_micro"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_running_statistics_match_hvt(dtype):
    fam.check_forward(jregnet, tregnet, NAME, dtype, {}, seed=21, stats=True)


def test_features_and_multitask_head_match_hvt():
    fam.check_features_and_multitask(jregnet, tregnet, NAME, {}, seed=22, width=24)


def test_gradients_and_remat_match_jax_grad():
    fam.check_gradients(jregnet, tregnet, NAME, {}, seed=23)


def test_remat_is_bit_equal_running_statistics_included():
    fam.check_remat_bit_equal(
        lambda remat: tregnet.regnety_micro(fam.NUM_CLASSES, seed=2, remat=remat),
        stochastic=False)


def test_three_decoupled_sgdw_steps_with_ema_match_hvt_build_train_step():
    fam.check_sgd_steps(fam.three_steps(jregnet, tregnet, NAME, {}, "decoupledsgdw", 2.048, 5e-4,
                                        0.875, 2.0, 0.08,
                                        ema=dict(half_life_steps=4, update_interval_steps=1)),
                        ema=True)


def test_init_is_seeded_with_hvts_distributions():
    classes = 1000  # a head large enough to measure its spread
    model = tregnet.regnety_micro(classes, seed=3)
    torch.testing.assert_close(model.state_dict(),
                               tregnet.regnety_micro(classes, seed=3).state_dict())
    ref = fam.hvt_init(jregnet.regnety_micro(classes), 3)
    for name, t in model.state_dict().items():
        r = ref[name]
        if t.ndim == 4 and t.numel() >= 1000:  # variance_scaling(2, fan_out, "normal")
            std = (2.0 / (t.shape[0] * t.shape[2] * t.shape[3])) ** 0.5
            assert abs(float(t.std()) - std) < 0.1 * std and abs(float(r.std()) - std) < 0.1 * std
            # not truncated: both reach past the 2σ a truncated draw stops at
            assert float(t.abs().max()) > 2 * std and np.abs(r).max() > 2 * std
        elif name == "head.weight":  # lecun_normal, truncated at 2σ
            std = (1.0 / t.shape[1]) ** 0.5
            assert abs(float(t.std()) - std) < 0.05 * std and abs(float(r.std()) - std) < 0.05 * std
            bound = 2 * std / 0.87962566103423978
            assert float(t.abs().max()) <= bound and np.abs(r).max() <= bound
        elif t.ndim == 1:  # BatchNorm ones and zeros, running 0 and 1, biases zero
            np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    norms = [m for m in model.modules() if isinstance(m, tcommon.BatchNorm)]
    assert norms and all((m.momentum, m.eps) == (0.9, 1e-5) for m in norms)


@pytest.mark.parametrize("num_classes", [fam.NUM_CLASSES, (3, 7)])
def test_converter_maps_every_tensor_and_the_decay_mask(num_classes):
    model, mask = fam.check_converter_and_decay_mask(jregnet, tregnet, "regnety_040", num_classes)
    assert mask["stage1_block0.conv2.weight"] and not mask["stage1_block0.bn2.weight"]
    assert not mask["stage1_block0.se_reduce.bias"]
    assert model.stage1_block0.conv2.groups == 192 // 64
    assert model.stage1_block0.se_reduce.weight.shape == (32, 192, 1, 1)  # round(128 / 4)


def regnet_state_dict(rng, stem=8, widths=(16, 24), depths=(1, 2), group=8, classes=5) -> dict:
    """A seeded HF-layout RegNet-Y state dict under ``regnet.``."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def conv_bn(name, o, i, k=1):
        return {f"{name}.convolution.weight": t(o, i, k, k), **fam.torch_bn(t, f"{name}.normalization", o)}

    sd = conv_bn("regnet.embedder.embedder", stem, 3, 3)
    in_dim = stem
    for s, (w, depth) in enumerate(zip(widths, depths)):
        for b in range(depth):
            p = f"regnet.encoder.stages.{s}.layers.{b}"
            se = max(1, round(in_dim / 4))
            sd.update({**conv_bn(f"{p}.layer.0", w, in_dim), **conv_bn(f"{p}.layer.1", w, group, 3),
                       f"{p}.layer.2.attention.0.weight": t(se, w, 1, 1),
                       f"{p}.layer.2.attention.0.bias": t(se),
                       f"{p}.layer.2.attention.2.weight": t(w, se, 1, 1),
                       f"{p}.layer.2.attention.2.bias": t(w), **conv_bn(f"{p}.layer.3", w, w)})
            if b == 0:
                sd.update(conv_bn(f"{p}.shortcut", w, in_dim))
            in_dim = w
    sd.update({"classifier.1.weight": t(classes, widths[-1]), "classifier.1.bias": t(classes)})
    return sd


def test_torch_files_convert_as_hvts(tmp_path):
    sd = regnet_state_dict(np.random.default_rng(7))
    model = fam.check_torch_file(tmp_path, sd, jtc.convert_regnet_state_dict,
                                 ttc.convert_regnet_state_dict,
                                 lambda: tregnet.regnety_micro(5))
    assert torch.equal(model.stage1_block1.bn2.running_var,
                       sd["regnet.encoder.stages.1.layers.1.layer.1.normalization.running_var"])


@pytest.mark.parametrize("name", sorted(n for n in jfactory._registry() if n.startswith("regnety")))
def test_factory_builds_every_regnet(name):
    model = fam.check_factory_variant(jregnet, name, 32)
    assert isinstance(model, tregnet.RegNetY) and model.dtype == torch.bfloat16


def test_stochastic_depth_raises_as_in_hvt():
    """RegNet-Y has no ``drop_path_rate``: the factory passes it from
    StochasticDepth, and both hvt and the port raise."""
    cfg = tconfig.loads({"model": {"name": NAME, "args": {}},
                         "algorithms": [{"cls": "StochasticDepth", "args": {"drop_rate": 0.3}}]})
    with pytest.raises(TypeError, match="drop_path_rate"):
        jfactory.build_model(cfg, fam.NUM_CLASSES)
    with pytest.raises(TypeError, match="drop_path_rate"):
        build_model(cfg, fam.NUM_CLASSES)


def test_main_trains_and_the_engine_serves_regnety_micro(tmp_path):
    fam.check_main_and_serving(
        tmp_path, NAME, optim={"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875,
                               "weight_decay": 5e-4},
        algorithms=[{"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "1ba"}},
                    {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}])
