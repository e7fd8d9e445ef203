"""The port's DINOv2 against hvt's, on the CPU.

As ``test_torch_port_vit.py`` (whose helpers this file shares): hvt's flash
route runs jax's reference attention on the CPU, the port's the flash
kernels' plain versions; the same seeded inputs and flax parameters drawn
away from init go through both. Tolerances (max|Δ| over max|ref| per
tensor):

* ``dinov2_micro`` in f32, plain MLP and SwiGLU, both attention routes, eval
  and train mode: logits and the [cls ‖ mean patch] features 1e-5;
* the HF-layout ``torch://`` converter (plain MLP and SwiGLU, with and
  without resizing the position embedding to another grid): hvt's
  converter's tensors carried through ``convert``, 1e-6 (bit for bit where
  nothing is resized);
* ``extract_features`` on ``dinov2_micro`` with ``use_flash`` from the same
  ``torch://`` file over a JPEG folder, against hvt's: 1e-4 (both in f32;
  hvt decodes through its own loader, which the port's matches bit for bit);
* the factory builds every ``dinov2_*`` name with hvt's parameter shapes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt import config as jconfig
from hvt.downstream import features as jfeatures
from hvt.models import dinov2 as jdinov2
from hvt.models import torch_compat as jtc
from hvt_torch import config as tconfig
from hvt_torch.downstream import features as tfeatures
from hvt_torch.models import convert
from hvt_torch.models import dinov2 as tdinov2
from hvt_torch.models import torch_compat as ttc
from test_torch_port_downstream import write_folder
from test_torch_port_vit import hvt_flash  # noqa: F401 (the fixture)
from test_torch_port_vit import IMG, NUM_CLASSES, close, factory_checks, randomized
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def flax_tree(seed: int, use_swiglu: bool):
    jm = jdinov2.dinov2_micro(NUM_CLASSES, use_swiglu=use_swiglu)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))["params"]
    return randomized(shapes, seed)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("use_swiglu", [False, True])
def test_logits_and_features_match_hvt(hvt_flash, use_swiglu, use_flash):
    tree = flax_tree(13, use_swiglu)
    jm = jdinov2.dinov2_micro(NUM_CLASSES, use_swiglu=use_swiglu, use_pallas=use_flash)
    model = tdinov2.dinov2_micro(NUM_CLASSES, use_swiglu=use_swiglu, use_pallas=use_flash,
                                 img_size=IMG)
    assert model.dtype == torch.float32 and model.block0.attn.use_flash == use_flash
    convert.vit_params_from_flax(model, tree)
    x = np.random.default_rng(7).normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    for train in (False, True):
        model.train(train)
        with torch.no_grad():
            logits = model(torch.from_numpy(x))
            feats = model(torch.from_numpy(x), features_only=True)
        ref = jm.apply({"params": tree}, jnp.asarray(x), train=train)
        ref_f = jm.apply({"params": tree}, jnp.asarray(x), train=train, features_only=True)
        what = f"swiglu={use_swiglu} use_flash={use_flash} train={train}"
        close(logits, ref, 1e-5, f"logits {what}")
        close(feats, ref_f, 1e-5, f"features {what}")
        assert feats.shape == (3, 2 * 32) and model.num_features == 64


def dinov2_state_dict(rng, swiglu: bool, depth=2, d=32, p=8, n=17, classes=5) -> dict:
    """A seeded HF-layout (``dinov2.``-prefixed) DINOv2 state dict."""
    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def lin(name, o, i):
        return {f"{name}.weight": t(o, i), f"{name}.bias": t(o)}

    def ln(name):
        return {f"{name}.weight": t(d), f"{name}.bias": t(d)}

    sd = {"dinov2.embeddings.cls_token": t(1, 1, d), "dinov2.embeddings.mask_token": t(1, d),
          "dinov2.embeddings.position_embeddings": t(1, n, d),
          "dinov2.embeddings.patch_embeddings.projection.weight": t(d, 3, p, p),
          "dinov2.embeddings.patch_embeddings.projection.bias": t(d)}
    hidden = (int(4 * d * 2 / 3) + 7) // 8 * 8
    for i in range(depth):
        b = f"dinov2.encoder.layer.{i}"
        sd.update({**ln(f"{b}.norm1"), **ln(f"{b}.norm2"),
                   **lin(f"{b}.attention.attention.query", d, d),
                   **lin(f"{b}.attention.attention.key", d, d),
                   **lin(f"{b}.attention.attention.value", d, d),
                   **lin(f"{b}.attention.output.dense", d, d),
                   f"{b}.layer_scale1.lambda1": t(d), f"{b}.layer_scale2.lambda1": t(d)})
        if swiglu:
            sd.update({**lin(f"{b}.mlp.weights_in", 2 * hidden, d),
                       **lin(f"{b}.mlp.weights_out", d, hidden)})
        else:
            sd.update({**lin(f"{b}.mlp.fc1", 4 * d, d), **lin(f"{b}.mlp.fc2", d, 4 * d)})
    sd.update({**ln("dinov2.layernorm"), **lin("classifier", classes, 2 * d)})
    return sd


@pytest.mark.parametrize("grid", [None, 6])
@pytest.mark.parametrize("swiglu", [False, True])
def test_dinov2_torch_files_convert_as_hvts(tmp_path, swiglu, grid):
    sd = dinov2_state_dict(np.random.default_rng(3 + swiglu), swiglu)
    ref = convert.vit_state_dict_from_flax(jtc.convert_dinov2_state_dict(sd, grid))
    got = ttc.convert_dinov2_state_dict(sd, grid)
    assert set(got) == set(ref)
    for name, r in ref.items():
        close(got[name], r, 0.0 if grid is None or name != "pos_embed" else 1e-6, name)
    if grid is not None:
        assert got["pos_embed"].shape == (1, grid * grid + 1, 32)
        return
    path = tmp_path / "dinov2.pt"
    torch.save({"model": sd}, path)
    params, stats = ttc.load_torch_variables(f"torch://{path}")
    assert stats == {} and set(params) == set(ref)
    model = tdinov2.dinov2_micro(5, use_swiglu=swiglu, img_size=IMG)
    model.load_state_dict(params, strict=True)


def test_extract_features_matches_hvt(hvt_flash, tmp_path):
    """The linear probe's and SimpleShot's feature path: seeded HF DINOv2
    weights through ``torch://``, ``use_flash``, a folder of JPEGs."""
    root = write_folder(tmp_path / "fixture")
    path = tmp_path / "dinov2.pt"
    torch.save({"model": dinov2_state_dict(np.random.default_rng(9), False)}, path)
    out = {}
    for lib, cfg_lib, side in ((tfeatures, tconfig, "port"), (jfeatures, jconfig, "hvt")):
        layer = {
            "run_name": "dinov2_features", "seed": 0,
            "model": {"name": "dinov2_micro", "variant": "linear-probe",
                      "pretrained_checkpoint": f"torch://{path}", "args": {"use_flash": True}},
            "machine": {"datasets": {"fix": str(root)}, "save_root": str(tmp_path / side)},
            "train_dataset": {"path": "fix", "crop_size": IMG, "resize_size": 34,
                              "global_batch_size": 4},
            "eval_dataset": {"path": "fix", "crop_size": IMG, "resize_size": 34,
                             "global_batch_size": 4},
            "precision": {"compute_dtype": "float32"}, "loader": {"num_workers": 1},
            "save": {"wandb": False},
        }
        kw = {"device": "cpu"} if side == "port" else {}
        out[side] = [lib.extract_features(cfg_lib.loads(layer), t, "linear-probe", **kw)
                     for t in (True, False)]
    for (g, g_labels), (r, r_labels), n in zip(out["port"], out["hvt"], (20, 8)):
        assert g.dtype == np.float32 and g.shape == r.shape == (n, 64)
        close(g, r, 1e-4, "DINOv2 features")
        np.testing.assert_array_equal(g_labels, r_labels)


@pytest.mark.parametrize("name", ["dinov2_vits14", "dinov2_vitb14", "dinov2_vitl14",
                                  "dinov2_vitg14", "dinov2_micro"])
def test_factory_builds_every_dinov2(name):
    patch = 8 if name == "dinov2_micro" else 14
    factory_checks(name, jdinov2, 2 * patch, 16 if name == "dinov2_micro" else 64)
