"""The port's EfficientNet against hvt's, on the CPU.

The same seeded numpy inputs and flax variables drawn away from init
(params and ``batch_stats``) go through hvt and, after
``hvt_torch.models.convert.convnet_params_from_flax``, through the port at
``efficientnet_micro`` (two stages: a stride-2 5×5 depthwise conv with
hvt's TF-SAME pad, squeeze-excite, an expand-ratio-1 block and an identity
block; ``tests/torch_conv_families.py`` holds the shared checks), drop
connect and dropout 0 where they would draw. Tolerances (max|Δ| over
max|ref| per tensor):

* logits, eval and train mode: f32 1e-5 and 1e-4, bf16 2e-2; the running
  statistics after the train forward (flax momentum 0.99, eps 1e-3) 1e-5 in
  f32; features and a multitask head's tiers 1e-5;
* train-mode gradients against jitted ``jax.grad`` 1e-4, with and without
  ``remat`` on both sides (the projection BatchNorms' biases, whose gradient
  is 0 in exact arithmetic, within 1e-5 of the largest gradient on both
  sides); the port's ``remat`` bit-equal to none with
  drop connect and the head's dropout drawing from the generator;
* three DecoupledSGDW steps with ``inat21.yaml``'s settings (lr 2.0,
  momentum 0.875, wd 5e-4, clip 2.0, smoothing 0.08) against hvt's
  ``build_train_step``: losses 1e-5 relative, step-1 gradients 1e-3,
  parameters and running statistics 1e-5;
* ``block_plan``, ``round_filters`` and ``round_repeats`` equal to hvt's for
  every variant; init: seeded, hvt's N(0, 0.02²); the converter and decay
  mask; the ``torch://`` converter (HF layout, running statistics) bit for
  bit against hvt's; every variant through the factory with hvt's shapes;
  StochasticDepth raises as in hvt; the Trainer and ``InferenceEngine``.
"""

import numpy as np
import pytest
import torch

import torch_conv_families as fam
from hvt.models import efficientnet as jeff
from hvt.models import factory as jfactory
from hvt.models import torch_compat as jtc
from hvt_torch import config as tconfig
from hvt_torch.models import build_model
from hvt_torch.models import common as tcommon
from hvt_torch.models import efficientnet as teff
from hvt_torch.models import torch_compat as ttc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "efficientnet_micro"
NO_DRAWS = {"drop_connect_rate": 0.0, "dropout_rate": 0.0}
# each block's projection BatchNorm bias: its shift reaches a 1×1 conv and
# the train-mode BatchNorm after it (the next block's expand, or top_bn
# past the residual), whose mean removes it, so its gradient is 0
ZERO_GRADS = tuple(f"block{i}.project_bn.bias" for i in range(3))
VARIANTS = sorted(n for n in jfactory._registry() if n.startswith("efficientnet"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_and_running_statistics_match_hvt(dtype):
    fam.check_forward(jeff, teff, NAME, dtype, NO_DRAWS, seed=31, stats=True)


def test_features_and_multitask_head_match_hvt():
    fam.check_features_and_multitask(jeff, teff, NAME, NO_DRAWS, seed=32, width=64)


def test_gradients_and_remat_match_jax_grad():
    fam.check_gradients(jeff, teff, NAME, NO_DRAWS, seed=33, zero=ZERO_GRADS)


def test_remat_is_bit_equal_with_drop_connect_and_dropout():
    fam.check_remat_bit_equal(
        lambda remat: teff.efficientnet_micro(fam.NUM_CLASSES, seed=2, drop_connect_rate=0.6,
                                              dropout_rate=0.5, remat=remat))


def test_three_decoupled_sgdw_steps_match_hvt_build_train_step():
    fam.check_sgd_steps(fam.three_steps(jeff, teff, NAME, NO_DRAWS, "DecoupledSGDW", 2.0, 5e-4,
                                        0.875, 2.0, 0.08), ema=False, zero=ZERO_GRADS)


@pytest.mark.parametrize("name", VARIANTS)
def test_block_plan_and_rounding_match_hvt(name):
    """The flattened blocks (widths, strides, kernels, skips, drop rates) and
    the scaled widths of every variant, as hvt computes them."""
    jm = getattr(jeff, name)(fam.NUM_CLASSES)
    with torch.device("meta"):
        tm = getattr(teff, name)(fam.NUM_CLASSES)
    assert tm.block_plan() == jm.block_plan()
    assert tm.num_features == jm.num_features and tm.dropout_rate == jm.dropout_rate
    assert tm.drop_connect_rate == jm.drop_connect_rate == 0.2
    for channels in (16, 32, 40, 112, 320, 1280):
        for width in (1.0, 1.1, 1.2, 1.4, 1.6):
            assert teff.round_filters(channels, width) == jeff.round_filters(channels, width)
    assert [teff.round_repeats(r, 2.2) for r in range(1, 5)] == [
        jeff.round_repeats(r, 2.2) for r in range(1, 5)]


def test_init_is_seeded_with_hvts_distributions():
    classes = 1000  # a head large enough to measure its spread
    model = teff.efficientnet_micro(classes, seed=3)
    torch.testing.assert_close(model.state_dict(),
                               teff.efficientnet_micro(classes, seed=3).state_dict())
    ref = fam.hvt_init(jeff.efficientnet_micro(classes), 3)
    for name, t in model.state_dict().items():
        r = ref[name]
        if t.ndim > 1 and t.numel() >= 1000:  # N(0, 0.02²) kernels
            assert abs(float(t.std()) - 0.02) < 0.002 and abs(float(r.std()) - 0.02) < 0.002, name
        elif t.ndim == 1:  # BatchNorm ones and zeros, running 0 and 1, biases zero
            np.testing.assert_array_equal(t.numpy(), r, err_msg=name)
    norms = [m for m in model.modules() if isinstance(m, tcommon.BatchNorm)]
    assert norms and all((m.momentum, m.eps) == (0.99, 1e-3) for m in norms)


@pytest.mark.parametrize("num_classes", [fam.NUM_CLASSES, (3, 7)])
def test_converter_maps_every_tensor_and_the_decay_mask(num_classes):
    model, mask = fam.check_converter_and_decay_mask(jeff, teff, "efficientnet_b0", num_classes)
    assert mask["block1.dwconv.weight"] and not mask["block1.dw_bn.weight"]
    assert not hasattr(model.block0, "expand_conv") and model.block1.expand_conv is not None
    assert model.block1.se_reduce.weight.shape == (4, 96, 1, 1)  # int(16 · 0.25) of the input


def efficientnet_state_dict(rng, classes=5) -> dict:
    """A seeded HF-layout EfficientNet state dict (under ``efficientnet.``)
    at ``efficientnet_micro``'s geometry."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    e = "efficientnet"
    sd = {f"{e}.embeddings.convolution.weight": t(8, 3, 3, 3),
          **fam.torch_bn(t, f"{e}.embeddings.batchnorm", 8)}
    # (in, out, expand, kernel) of the three blocks
    for i, (cin, cout, expand, k) in enumerate(((8, 16, 1, 3), (16, 24, 6, 5), (24, 24, 6, 5))):
        p, exp, se = f"{e}.encoder.blocks.{i}", cin * expand, int(cin * 0.25)
        if expand != 1:
            sd.update({f"{p}.expansion.expand_conv.weight": t(exp, cin, 1, 1),
                       **fam.torch_bn(t, f"{p}.expansion.expand_bn", exp)})
        sd.update({f"{p}.depthwise_conv.depthwise_conv.weight": t(exp, 1, k, k),
                   **fam.torch_bn(t, f"{p}.depthwise_conv.depthwise_norm", exp),
                   f"{p}.squeeze_excite.reduce.weight": t(se, exp, 1, 1),
                   f"{p}.squeeze_excite.reduce.bias": t(se),
                   f"{p}.squeeze_excite.expand.weight": t(exp, se, 1, 1),
                   f"{p}.squeeze_excite.expand.bias": t(exp),
                   f"{p}.projection.project_conv.weight": t(cout, exp, 1, 1),
                   **fam.torch_bn(t, f"{p}.projection.project_bn", cout)})
    sd.update({f"{e}.encoder.top_conv.weight": t(64, 24, 1, 1),
               **fam.torch_bn(t, f"{e}.encoder.top_bn", 64),
               "classifier.weight": t(classes, 64), "classifier.bias": t(classes)})
    return sd


def test_torch_files_convert_as_hvts(tmp_path):
    sd = efficientnet_state_dict(np.random.default_rng(9))
    model = fam.check_torch_file(tmp_path, sd, jtc.convert_efficientnet_state_dict,
                                 ttc.convert_efficientnet_state_dict,
                                 lambda: teff.efficientnet_micro(5))
    assert torch.equal(model.block2.dw_bn.running_mean,
                       sd["efficientnet.encoder.blocks.2.depthwise_conv.depthwise_norm.running_mean"])


@pytest.mark.parametrize("name", VARIANTS)
def test_factory_builds_every_efficientnet(name):
    model = fam.check_factory_variant(jeff, name, 32)
    assert isinstance(model, teff.EfficientNet) and model.dtype == torch.bfloat16


def test_stochastic_depth_raises_as_in_hvt():
    """EfficientNet's stochastic depth is ``drop_connect_rate``: the
    ``drop_path_rate`` the factory passes from StochasticDepth raises in hvt
    and in the port."""
    cfg = tconfig.loads({"model": {"name": NAME, "args": {}},
                         "algorithms": [{"cls": "StochasticDepth", "args": {"drop_rate": 0.3}}]})
    with pytest.raises(TypeError, match="drop_path_rate"):
        jfactory.build_model(cfg, fam.NUM_CLASSES)
    with pytest.raises(TypeError, match="drop_path_rate"):
        build_model(cfg, fam.NUM_CLASSES)


def test_main_trains_and_the_engine_serves_efficientnet_micro(tmp_path):
    fam.check_main_and_serving(
        tmp_path, NAME, optim={"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875,
                               "weight_decay": 5e-4},
        algorithms=[{"cls": "BlurPool"}, {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}])
