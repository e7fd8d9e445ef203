"""Weights carried across: hvt's flax SwinV2, ResNet, ViT, DINOv2, ConvNeXt,
RegNet-Y and EfficientNet trees → the port's models.

The one place where the two layouts differ. A flax ``Dense`` kernel is
(in, out) and an ``nn.Linear`` weight (out, in); a flax ``Conv`` kernel is
HWIO and ``nn.Conv2d``'s OIHW; a flax ``LayerNorm`` or ``BatchNorm`` has
``scale`` where PyTorch has ``weight``, and a BatchNorm's ``batch_stats``
``mean``/``var`` are the port's ``running_mean``/``running_var`` buffers;
WindowAttention's raw params (``qkv_kernel``, ``cpb_w1``/``cpb_b1``/
``cpb_w2``) map onto the port's ``qkv`` and ``cpb_fc*`` Linears; ``ape``'s
``absolute_pos_embed`` has one layout in both, and so has an MoE block's
``moe`` (``router``, ``w1``, ``b1``, ``w2``, ``b2``). The same
SwinV2 tree serves both routes (``fuse`` false or true): hvt's fused path
materialises the identical tree. ViT's and DINOv2's trees (one converter for
both) keep their names; the patch embedding's HWIO kernel becomes the
port's (D, C, p, p) weight, and ``cls_token``, ``pos_embed`` and DINOv2's
``ls1``/``ls2`` keep their layouts. The same tree serves both attention
routes. ConvNeXt's, RegNet-Y's and EfficientNet's port modules carry the
flax names, so one walk of the tree serves the three
(:func:`convnet_state_dict_from_flax`): a 4-D ``kernel`` is a conv (a
depthwise (k, k, 1, C) lands as (C, 1, k, k), a grouped (3, 3, I/g, O) as
(O, I/g, 3, 3)), a 2-D one a Dense, ``scale`` a norm, a bare array (ConvNeXt's
``gamma``) keeps its name and layout, and ``batch_stats`` give the running
statistics.

Under tensor parallelism a rank's model holds shards of the MLP weights
(``parallel.shard_model_``): :func:`shard_state_dict` cuts full entries to
one model rank's shards by hvt's rules (``parallel.TP_RULES``),
:func:`unshard_state_dicts` joins every rank's back, and the loaders below
cut a full tree for a sharded model themselves.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from hvt_torch import parallel


MOE_PARAMS = ("router", "w1", "b1", "w2", "b2")


def _dense(sub, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(sub["kernel"]).T
    if "bias" in sub:
        out[f"{prefix}.bias"] = np.asarray(sub["bias"])


def _norm(sub, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(sub["scale"])
    out[f"{prefix}.bias"] = np.asarray(sub["bias"])


def _block(sub, prefix: str, out: dict) -> None:
    attn = sub["attn"]
    a = f"{prefix}.attn"
    out[f"{a}.qkv.weight"] = np.asarray(attn["qkv_kernel"]).T
    for name in ("q_bias", "v_bias", "logit_scale"):
        out[f"{a}.{name}"] = np.asarray(attn[name])
    out[f"{a}.cpb_fc1.weight"] = np.asarray(attn["cpb_w1"]).T
    out[f"{a}.cpb_fc1.bias"] = np.asarray(attn["cpb_b1"])
    out[f"{a}.cpb_fc2.weight"] = np.asarray(attn["cpb_w2"]).T
    _dense(attn["proj"], f"{a}.proj", out)
    _norm(sub["norm1"], f"{prefix}.norm1", out)
    if "moe" in sub:  # an MoE block: flax's layout in both, (C, E), (E, C, hidden), ...
        for name in MOE_PARAMS:
            out[f"{prefix}.moe.{name}"] = np.asarray(sub["moe"][name])
    else:
        _dense(sub["mlp"]["fc1"], f"{prefix}.mlp.fc1", out)
        _dense(sub["mlp"]["fc2"], f"{prefix}.mlp.fc2", out)
    _norm(sub["norm2"], f"{prefix}.norm2", out)


def swin_state_dict_from_flax(tree: Mapping) -> dict[str, np.ndarray]:
    """Flax SwinTransformerV2 params (nested mappings of arrays, with or
    without the top ``params`` level) → the port's state-dict entries."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "patch_embed":
            out["patch_embed.weight"] = _hwio(sub["kernel"])
            out["patch_embed.bias"] = np.asarray(sub["bias"])
        elif key in ("patch_norm", "norm"):
            _norm(sub, key, out)
        elif key == "absolute_pos_embed":  # (1, H/patch, W/patch, C) in both
            out[key] = np.asarray(sub)
        elif key.endswith("_merge"):
            _dense(sub["reduction"], f"{key}.reduction", out)
            _norm(sub["norm"], f"{key}.norm", out)
        elif key.startswith("stage") and "_block" in key:
            _block(sub, key, out)
        elif key == "head":
            _head(sub, out)
        else:
            raise KeyError(f"flax parameter {key!r} has no counterpart in the port")
    return out


def _head(sub, out: dict) -> None:
    if "kernel" in sub:
        _dense(sub, "head", out)
    else:
        for tier, tsub in sub.items():
            _dense(tsub, f"head.{tier}", out)


def _hwio(kernel) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _batch_norm(params, stats, prefix: str, out: dict) -> None:
    _norm(params, prefix, out)
    if stats is not None:
        out[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
        out[f"{prefix}.running_var"] = np.asarray(stats["var"])


def resnet_state_dict_from_flax(params: Mapping, batch_stats: Mapping | None = None
                                ) -> dict[str, np.ndarray]:
    """Flax ResNet params (and, when given, ``batch_stats``) → the port's
    state-dict entries. Both stem paths load: ``stem/kernel`` (hvt's
    ``stem_s2d``) and ``stem/Conv_0/kernel``, one (7, 7, 3, width) kernel."""
    out: dict[str, np.ndarray] = {}
    for key, sub in params.items():
        stats = None if batch_stats is None else batch_stats.get(key)
        if key == "head":
            _head(sub, out)
        elif key == "stem" or (key.startswith("stage") and "_block" in key):
            convs = ({key: (sub, stats)} if key == "stem" else
                     {f"{key}.{n}": (c, stats and stats[n]) for n, c in sub.items()})
            for prefix, (csub, cstats) in convs.items():
                kernel = csub["kernel"] if "kernel" in csub else csub["Conv_0"]["kernel"]
                out[f"{prefix}.conv.weight"] = _hwio(kernel)
                _batch_norm(csub["BatchNorm_0"], cstats and cstats["BatchNorm_0"], f"{prefix}.bn", out)
        else:
            raise KeyError(f"flax parameter {key!r} has no counterpart in the port")
    return out


def vit_state_dict_from_flax(tree: Mapping) -> dict[str, np.ndarray]:
    """Flax VisionTransformer or Dinov2 params (with or without the top
    ``params`` level) → the port's state-dict entries."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "patch_embed":
            out["patch_embed.weight"] = _hwio(sub["kernel"])
            out["patch_embed.bias"] = np.asarray(sub["bias"])
        elif key in ("cls_token", "pos_embed"):
            out[key] = np.asarray(sub)
        elif key == "norm":
            _norm(sub, key, out)
        elif key.startswith("block"):
            for name in ("norm1", "norm2"):
                _norm(sub[name], f"{key}.{name}", out)
            for name in ("qkv", "proj"):
                _dense(sub["attn"][name], f"{key}.attn.{name}", out)
            for name, dense in sub["mlp"].items():  # fc1/fc2, or SwiGLU's weights_in/_out
                _dense(dense, f"{key}.mlp.{name}", out)
            for name in ("ls1", "ls2"):  # DINOv2's LayerScale
                if name in sub:
                    out[f"{key}.{name}"] = np.asarray(sub[name])
        elif key == "head":
            _head(sub, out)
        else:
            raise KeyError(f"flax parameter {key!r} has no counterpart in the port")
    return out


def convnet_state_dict_from_flax(params: Mapping, batch_stats: Mapping | None = None
                                 ) -> dict[str, np.ndarray]:
    """Flax ConvNeXt, RegNet-Y or EfficientNet params (with or without the
    top ``params`` level) and, when given, ``batch_stats`` → the port's
    state-dict entries."""
    if "params" in params:
        params = params["params"]
    out: dict[str, np.ndarray] = {}

    def walk(tree, prefix: str) -> None:
        for key, sub in tree.items():
            name = f"{prefix}{key}"
            if not isinstance(sub, Mapping):
                out[name] = np.asarray(sub)
            elif "kernel" in sub:
                kernel = np.asarray(sub["kernel"])
                out[f"{name}.weight"] = _hwio(kernel) if kernel.ndim == 4 else kernel.T
                if "bias" in sub:
                    out[f"{name}.bias"] = np.asarray(sub["bias"])
            elif "scale" in sub:
                _norm(sub, name, out)
            elif "mean" in sub:
                out[f"{name}.running_mean"] = np.asarray(sub["mean"])
                out[f"{name}.running_var"] = np.asarray(sub["var"])
            else:
                walk(sub, f"{name}.")

    walk(params, "")
    if batch_stats:
        walk(batch_stats, "")
    return out


def shard_state_dict(state: Mapping, rank: int, size: int) -> dict:
    """Full state-dict entries (arrays or tensors) → model rank ``rank`` of
    ``size``'s: each entry the TP rules match cut to its shard, the rest as
    they are."""
    out = {}
    for name, t in state.items():
        dim = parallel.tp_rule(name)
        out[name] = t if dim is None or size == 1 else parallel.shard(t, dim, rank, size)
    return out


def unshard_state_dicts(shards: Sequence[Mapping]) -> dict:
    """Every model rank's entries, in rank order → the full ones (a
    replicated entry is rank 0's)."""
    out = {}
    for name, t in shards[0].items():
        dim = parallel.tp_rule(name)
        if dim is None or len(shards) == 1:
            out[name] = t
        elif isinstance(t, torch.Tensor):
            out[name] = torch.cat([s[name] for s in shards], dim)
        else:
            out[name] = np.concatenate([s[name] for s in shards], dim)
    return out


def _load(model: torch.nn.Module, state: dict[str, np.ndarray]) -> torch.nn.Module:
    if any(getattr(m, "tp", False) for m in model.modules()):  # a model of shards
        state = shard_state_dict(state, parallel.model_rank(), parallel.model_size())
    ref = model.state_dict()
    tensors = {}
    for name, arr in state.items():
        if name not in ref:
            raise KeyError(f"{name} is not a parameter of the port's model")
        t = torch.as_tensor(np.ascontiguousarray(arr, dtype=np.float32))
        if tuple(t.shape) != tuple(ref[name].shape):
            raise ValueError(f"{name}: flax shape {tuple(t.shape)} vs port {tuple(ref[name].shape)}")
        tensors[name] = t
    model.load_state_dict(tensors, strict=True)
    return model


def swin_params_from_flax(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a flax SwinV2 parameter tree into the port's ``SwinTransformerV2``
    (every parameter must match in name and shape). Returns the model."""
    return _load(model, swin_state_dict_from_flax(tree))


def resnet_params_from_flax(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load flax ResNet ``variables`` ({"params": ..., "batch_stats": ...})
    into the port's ``ResNet``: every parameter and running statistic must
    match in name and shape. Returns the model."""
    return _load(model, resnet_state_dict_from_flax(variables["params"], variables["batch_stats"]))


def vit_params_from_flax(model: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    """Load a flax ViT or DINOv2 parameter tree into the port's
    ``VisionTransformer`` or ``Dinov2`` (every parameter must match in name
    and shape). Returns the model."""
    return _load(model, vit_state_dict_from_flax(tree))


def convnet_params_from_flax(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load flax ConvNeXt, RegNet-Y or EfficientNet ``variables``
    ({"params": ..., and for the two with BatchNorm "batch_stats": ...}) into
    the port's model: every parameter and running statistic must match in
    name and shape. Returns the model."""
    return _load(model, convnet_state_dict_from_flax(variables["params"],
                                                     variables.get("batch_stats")))
