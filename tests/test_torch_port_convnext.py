"""The port's ConvNeXt against hvt's, on the CPU.

The same seeded numpy inputs and flax parameters drawn away from init (the
layer scale ``gamma`` is 1e-6 at init) go through hvt and, after
``hvt_torch.models.convert.convnet_params_from_flax``, through the port at
``convnext_micro`` (``tests/torch_conv_families.py`` holds the shared
checks). Tolerances (max|Δ| over max|ref| per tensor):

* logits, eval and train mode: f32 1e-5 and 1e-4, bf16 2e-2; features
  and a multitask head's tiers 1e-5;
* train-mode gradients against jitted ``jax.grad`` 1e-4, with and without
  ``remat`` on both sides; the port's ``remat`` bit-equal to none, with
  drop path drawing from the generator too;
* three adamw steps with ``convnext_tiny.yaml``'s settings (lr 0.004, wd
  0.05, smoothing 0.1, clip 5.0) against hvt's ``build_train_step``: losses
  1e-5 relative, the step-1 gradients 1e-3, the parameters after three
  steps as ``test_torch_port_vit`` holds Adam's;
* init: seeded, hvt's distributions (trunc_normal(0.02) kernels, gamma
  1e-6); the converter and decay mask; the ``torch://`` converters (timm
  and HF layouts) bit for bit against hvt's; every variant through the
  factory with hvt's shapes; StochasticDepth's rates; the open model name;
  the Trainer and ``InferenceEngine``.
"""

import numpy as np
import pytest
import torch

import torch_conv_families as fam
from hvt.models import convnext as jconvnext
from hvt.models import factory as jfactory
from hvt.models import torch_compat as jtc
from hvt_torch import config as tconfig
from hvt_torch.models import build_model
from hvt_torch.models import convnext as tconvnext
from hvt_torch.models import torch_compat as ttc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "convnext_micro"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_hvt_in_eval_and_train_mode(dtype):
    fam.check_forward(jconvnext, tconvnext, NAME, dtype, {}, seed=11, stats=False)


def test_features_and_multitask_head_match_hvt():
    fam.check_features_and_multitask(jconvnext, tconvnext, NAME, {}, seed=12, width=128)


def test_gradients_and_remat_match_jax_grad():
    fam.check_gradients(jconvnext, tconvnext, NAME, {}, seed=13)


def test_remat_is_bit_equal_with_drop_path():
    def model(remat):
        m = tconvnext.convnext_micro(fam.NUM_CLASSES, dtype="float32", seed=2,
                                     drop_path_rate=0.5, remat=remat)
        for block in m.modules():  # gamma away from its 1e-6, so the branches count
            if isinstance(block, tconvnext.ConvNeXtBlock):
                block.gamma.data.fill_(1.0)
        return m

    fam.check_remat_bit_equal(model)


def test_three_adamw_steps_match_hvt_build_train_step():
    lr = 0.004
    losses, ref_losses, state, ref_state, _, _, grads, ref_grads = fam.three_steps(
        jconvnext, tconvnext, NAME, {}, "adamw", lr, 0.05, 0.9, 5.0, 0.1)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert ref_losses[0] != ref_losses[2]
    fam.close_gradients(grads, ref_grads, 1e-3, "step-1 gradient")
    assert set(state) == set(ref_state)
    for name, p in state.items():
        fam.close_after_adam(p.numpy(), ref_state[name], lr, 3, name)


def test_init_is_seeded_with_hvts_distributions():
    model = tconvnext.convnext_micro(fam.NUM_CLASSES, seed=3)
    again = tconvnext.convnext_micro(fam.NUM_CLASSES, seed=3)
    torch.testing.assert_close(model.state_dict(), again.state_dict())
    jm = jconvnext.convnext_micro(fam.NUM_CLASSES)
    ref = fam.hvt_init(jm, 3)
    for name, t in model.state_dict().items():
        r = ref[name]
        if name.endswith("gamma"):
            assert torch.all(t == torch.tensor(1e-6)) and np.all(r == np.float32(1e-6))
        elif t.ndim > 1 and t.numel() >= 4096:  # kernels: trunc_normal(0.02) within ±0.04
            assert abs(float(t.std()) - float(r.std())) < 0.05 * float(r.std()), name
            assert float(t.abs().max()) <= 0.04 and float(np.abs(r).max()) <= 0.04
        elif t.ndim == 1:  # LayerNorms ones and zeros, biases zero
            np.testing.assert_array_equal(t.numpy(), r, err_msg=name)


@pytest.mark.parametrize("num_classes", [fam.NUM_CLASSES, (3, 7)])
def test_converter_maps_every_tensor_and_the_decay_mask(num_classes):
    _, mask = fam.check_converter_and_decay_mask(jconvnext, tconvnext, "convnext_tiny",
                                                 num_classes)
    assert mask["stem_conv.weight"] and not mask["stage0_block0.gamma"]
    assert not mask["norm.weight"] and mask["stage2_block8.mlp.fc1.weight"]


def convnext_state_dict(layout: str, rng, dims=(8, 16), depths=(1, 2), classes=5) -> dict:
    """A seeded timm- or HF-layout ConvNeXt state dict (HF under ``convnext.``)."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def lin(name, o, i, *k):
        return {f"{name}.weight": t(o, i, *k), f"{name}.bias": t(o)}

    def ln(name, d):
        return {f"{name}.weight": t(d), f"{name}.bias": t(d)}

    hf = layout == "hf"
    sd = {}
    if hf:
        sd.update({**lin("convnext.embeddings.patch_embeddings", dims[0], 3, 4, 4),
                   **ln("convnext.embeddings.layernorm", dims[0])})
    else:
        sd.update({**lin("stem.0", dims[0], 3, 4, 4), **ln("stem.1", dims[0])})
    for s, (d, depth) in enumerate(zip(dims, depths)):
        sp = f"convnext.encoder.stages.{s}" if hf else f"stages.{s}"
        if s > 0:
            down = f"{sp}.downsampling_layer" if hf else f"{sp}.downsample"
            sd.update({**ln(f"{down}.0", dims[s - 1]), **lin(f"{down}.1", d, dims[s - 1], 2, 2)})
        for i in range(depth):
            p = f"{sp}.layers.{i}" if hf else f"{sp}.blocks.{i}"
            names = (("dwconv", "layernorm", "pwconv1", "pwconv2", "layer_scale_parameter") if hf
                     else ("conv_dw", "norm", "mlp.fc1", "mlp.fc2", "gamma"))
            sd.update({**lin(f"{p}.{names[0]}", d, 1, 7, 7), **ln(f"{p}.{names[1]}", d),
                       **lin(f"{p}.{names[2]}", 4 * d, d), **lin(f"{p}.{names[3]}", d, 4 * d),
                       f"{p}.{names[4]}": t(d)})
    if hf:
        sd.update({**ln("convnext.layernorm", dims[-1]), **lin("classifier", classes, dims[-1])})
    else:
        sd.update({**ln("head.norm", dims[-1]), **lin("head.fc", classes, dims[-1])})
    return sd


@pytest.mark.parametrize("layout", ["timm", "hf"])
def test_torch_files_convert_as_hvts(tmp_path, layout):
    sd = convnext_state_dict(layout, np.random.default_rng(len(layout)))
    model = fam.check_torch_file(
        tmp_path, sd, jtc.convert_convnext_state_dict, ttc.convert_convnext_state_dict,
        lambda: tconvnext.ConvNeXt(5, depths=(1, 2), dims=(8, 16)))
    assert model.downsample1_conv.weight.shape == (16, 8, 2, 2)


@pytest.mark.parametrize("name", sorted(n for n in jfactory._registry() if n.startswith("convnext")))
def test_factory_builds_every_convnext(name):
    model = fam.check_factory_variant(jconvnext, name, 32)
    assert isinstance(model, tconvnext.ConvNeXt) and model.dtype == torch.bfloat16


def test_stochastic_depth_sets_the_drop_path_rates():
    """StochasticDepth sets ``drop_path_rate``, as hvt's factory does; the
    blocks take linspace(0, rate, total), as hvt's."""
    cfg = tconfig.loads({"model": {"name": NAME, "args": {}},
                         "algorithms": [{"cls": "StochasticDepth", "args": {"drop_rate": 0.3}}]})
    model = build_model(cfg, fam.NUM_CLASSES)
    rates = [m.drop_path_rate for m in model.modules() if isinstance(m, tconvnext.ConvNeXtBlock)]
    assert rates == pytest.approx(np.linspace(0, 0.3, 5).tolist())
    assert jfactory.build_model(cfg, fam.NUM_CLASSES).drop_path_rate == 0.3


def test_open_model_name_resolves_a_builder():
    """hvt's ``module.path:symbol`` escape hatch, with hvt's messages for a
    module that does not import and a symbol that is not a builder."""
    cfg = tconfig.loads({"model": {"name": "hvt_torch.models.convnext:convnext_micro"},
                         "precision": {"compute_dtype": "float32"}, "seed": 4})
    model = build_model(cfg, fam.NUM_CLASSES)
    assert isinstance(model, tconvnext.ConvNeXt) and model.dtype == torch.float32
    torch.testing.assert_close(model.state_dict(),
                               tconvnext.convnext_micro(fam.NUM_CLASSES, seed=4).state_dict())
    with pytest.raises(ValueError, match="cannot import module 'no_such_pkg.models'"):
        build_model(tconfig.loads({"model": {"name": "no_such_pkg.models:net"}}), 3)
    with pytest.raises(ValueError, match=r"hvt_torch.models.convnext.NUM is not a callable"):
        build_model(tconfig.loads({"model": {"name": "hvt_torch.models.convnext:NUM"}}), 3)
    with pytest.raises(ValueError, match="unknown model 'convnext_huge'"):
        build_model(tconfig.loads({"model": {"name": "convnext_huge"}}), 3)


def test_main_trains_and_the_engine_serves_convnext_micro(tmp_path):
    fam.check_main_and_serving(tmp_path, NAME, optim={"name": "adamw", "lr": 1e-3,
                                                      "weight_decay": 0.05},
                               model={"name": NAME, "args": {"drop_path_rate": 0.1}})
