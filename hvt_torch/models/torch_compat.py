"""Torch-format weight files — the port's copy of ``hvt/models/torch_compat.py``.

hvt reads Microsoft-format SwinV2 files (``swin://<path>``, reference
swinv2.py:870-895) and timm-format ResNet files (``torch://<path>``), each a
``.pt`` holding ``{"model": state_dict}``, and writes them back from its
checkpoints. Here the same files map to and from the port's own state-dict
names (:mod:`hvt_torch.models.convert` lists them), tensor for tensor: both
sides are PyTorch, so no layout changes, only names.

* SwinV2: ``patch_embed.proj`` → ``patch_embed``, ``patch_embed.norm`` →
  ``patch_norm``, ``layers.{s}.blocks.{i}`` → ``stage{s}_block{i}`` (its
  ``attn.cpb_mlp.0``/``.2`` → ``attn.cpb_fc1``/``cpb_fc2``),
  ``layers.{s}.downsample`` → ``stage{s}_merge``, ``head.heads.{t}`` →
  ``head.tier{t}``; ``absolute_pos_embed`` (``ape``) is Microsoft's (1, L, C)
  and the port's (1, H, W, C) over a square grid, as hvt reshapes it; the
  derived buffers (:data:`NON_PERSISTENT`) are dropped.
* ResNet: ``conv1``/``bn1`` → ``stem.conv``/``stem.bn``,
  ``layer{s}.{b}.conv{i}``/``bn{i}`` → ``stage{s}_block{b}.conv{i}.conv``/
  ``.bn``, ``downsample.0``/``.1`` → ``downsample.conv``/``.bn``, ``fc`` →
  ``head``; BatchNorm running statistics travel with the weights, and
  ``num_batches_tracked`` (which the port does not keep) is written as 0.

* ViT (``convert_vit_state_dict``): timm (``blocks.{i}.attn.qkv``,
  ``patch_embed.proj``, ``norm``, ``head``) or HF transformers
  (``[vit.]embeddings.*``, ``encoder.layer.{i}.attention.attention.{query,
  key,value}``, ``layernorm_before``/``_after``, ``intermediate``/``output``,
  ``layernorm``, ``classifier``), HF's q, k, v Linears concatenated into the
  fused qkv ([q; k; v], as timm's). DINOv2 (``convert_dinov2_state_dict``):
  HF's layout under ``dinov2.``, LayerScale ``layer_scale{1,2}.lambda1`` →
  ``ls1``/``ls2``, the plain or SwiGLU MLP, and optionally the position
  embedding resized to another patch grid (``resize_pos_embed``).

* ConvNeXt (``convert_convnext_state_dict``): timm (``stem.0``/``.1``,
  ``stages.{s}.downsample.0``/``.1``, ``stages.{s}.blocks.{i}.conv_dw``/
  ``norm``/``mlp.fc{1,2}``/``gamma``, ``head.norm`` or ``norm``,
  ``head.fc``) or HF (``[convnext.]embeddings.patch_embeddings``/
  ``layernorm``, ``encoder.stages.{s}.downsampling_layer.0``/``.1``,
  ``layers.{i}.dwconv``/``layernorm``/``pwconv{1,2}``/
  ``layer_scale_parameter``, ``layernorm``, ``classifier``) → the port's
  ``stem_conv``, ``stem_norm``, ``downsample{s}_norm``/``_conv``,
  ``stage{s}_block{i}.{dwconv,norm,mlp.fc1,mlp.fc2,gamma}``, ``norm``,
  ``head``; no batch statistics.
* EfficientNet (``convert_efficientnet_state_dict``, HF under
  ``efficientnet.``) and RegNet-Y (``convert_regnet_state_dict``, HF under
  ``regnet.``): each BatchNorm's running statistics travel with the weights
  (``num_batches_tracked`` dropped); a ``classifier.heads.{t}`` multitask head
  → ``head.tier{t}``.

Files are read with ``torch.load(..., weights_only=True)``.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import torch

# Buffers that are derived, not learned (reference swinv2.py:887-894).
NON_PERSISTENT = ("relative_position_index", "relative_coords_table", "logit_clamp_max")

_SWIN_URI = re.compile(r"^swin://(.+)$")
_TORCH_URI = re.compile(r"^torch://(.+)$")


def filter_buffers(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v for k, v in state_dict.items() if not any(n in k for n in NON_PERSISTENT)}


def infer_depths(state_dict: Mapping) -> tuple[int, ...]:
    """Stage depths from ``layers.{s}.blocks.{i}.*`` key names."""
    return _counts(state_dict, r"^layers\.(\d+)\.blocks\.(\d+)\.", "layers.*.blocks.*", "Swin")


def infer_resnet_stage_sizes(state_dict: Mapping) -> tuple[int, ...]:
    """Stage sizes from ``layer{s}.{b}.*`` key names."""
    return _counts(state_dict, r"^layer(\d+)\.(\d+)\.", "layer{s}.{b}", "torch ResNet")


def _counts(state_dict, pattern: str, keys: str, family: str) -> tuple[int, ...]:
    counts: dict[int, int] = {}
    pat = re.compile(pattern)
    for key in state_dict:
        m = pat.match(key)
        if m:
            s, i = int(m.group(1)), int(m.group(2))
            counts[s] = max(counts.get(s, 0), i + 1)
    if not counts:
        raise ValueError(f"no {keys} keys: not a {family} state dict?")
    return tuple(counts[s] for s in sorted(counts))


# (Microsoft SwinV2 name, port name) rewrites, applied in order to each key
_SWIN_NAMES = (
    (r"^patch_embed\.proj\.", "patch_embed."),
    (r"^patch_embed\.norm\.", "patch_norm."),
    (r"^layers\.(\d+)\.blocks\.(\d+)\.", r"stage\1_block\2."),
    (r"^layers\.(\d+)\.downsample\.", r"stage\1_merge."),
    (r"\.attn\.cpb_mlp\.0\.", ".attn.cpb_fc1."),
    (r"\.attn\.cpb_mlp\.2\.", ".attn.cpb_fc2."),
    (r"^head\.heads\.(\d+)\.", r"head.tier\1."),
)
_SWIN_EXPORT = (
    (r"^patch_embed\.", "patch_embed.proj."),
    (r"^patch_norm\.", "patch_embed.norm."),
    (r"^stage(\d+)_block(\d+)\.", r"layers.\1.blocks.\2."),
    (r"^stage(\d+)_merge\.", r"layers.\1.downsample."),
    (r"\.attn\.cpb_fc1\.", ".attn.cpb_mlp.0."),
    (r"\.attn\.cpb_fc2\.", ".attn.cpb_mlp.2."),
    (r"^head\.tier(\d+)\.", r"head.heads.\1."),
)
_RESNET_NAMES = (
    (r"^conv1\.", "stem.conv."),
    (r"^bn1\.", "stem.bn."),
    (r"^layer(\d+)\.(\d+)\.conv(\d)\.", r"stage\1_block\2.conv\3.conv."),
    (r"^layer(\d+)\.(\d+)\.bn(\d)\.", r"stage\1_block\2.conv\3.bn."),
    (r"^layer(\d+)\.(\d+)\.downsample\.0\.", r"stage\1_block\2.downsample.conv."),
    (r"^layer(\d+)\.(\d+)\.downsample\.1\.", r"stage\1_block\2.downsample.bn."),
    (r"^fc\.heads\.(\d+)\.", r"head.tier\1."),
    (r"^fc\.", "head."),
)
_RESNET_EXPORT = (
    (r"^stem\.conv\.", "conv1."),
    (r"^stem\.bn\.", "bn1."),
    (r"^stage(\d+)_block(\d+)\.conv(\d)\.conv\.", r"layer\1.\2.conv\3."),
    (r"^stage(\d+)_block(\d+)\.conv(\d)\.bn\.", r"layer\1.\2.bn\3."),
    (r"^stage(\d+)_block(\d+)\.downsample\.conv\.", r"layer\1.\2.downsample.0."),
    (r"^stage(\d+)_block(\d+)\.downsample\.bn\.", r"layer\1.\2.downsample.1."),
    (r"^head\.tier(\d+)\.", r"fc.heads.\1."),
    (r"^head\.", "fc."),
)
_STATS = ("running_mean", "running_var")


def _rename(key: str, rules) -> str:
    for pattern, repl in rules:
        key = re.sub(pattern, repl, key)
    return key


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().cpu()


_APE = "absolute_pos_embed"


def convert_swin_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """Microsoft SwinV2 state dict → the port's SwinTransformerV2 names."""
    infer_depths(state_dict)  # raises on a file that is not a Swin state dict
    out = {_rename(k, _SWIN_NAMES): _tensor(v) for k, v in filter_buffers(state_dict).items()}
    if _APE in out:  # (1, L, C) → (1, side, side, C)
        ape = out[_APE]
        side = int(round(ape.shape[1] ** 0.5))
        out[_APE] = ape.reshape(1, side, side, ape.shape[-1])
    return out


def export_swin_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's SwinV2 parameters → the Microsoft SwinV2 state dict, the
    exact inverse of :func:`convert_swin_state_dict`."""
    out = {_rename(k, _SWIN_EXPORT): _tensor(v).float() for k, v in params.items()}
    if _APE in out:  # (1, H, W, C) → (1, H·W, C)
        out[_APE] = out[_APE].reshape(1, -1, out[_APE].shape[-1])
    return out


def convert_resnet_state_dict(state_dict: Mapping) -> tuple[dict, dict]:
    """timm/torchvision ResNet state dict → (params, batch_stats) in the
    port's ResNet names. The stem is ``stem.conv`` whether or not the model
    was built with hvt's ``stem_s2d`` (the port's stem is one conv either
    way), so no stem layout needs adapting."""
    infer_resnet_stage_sizes(state_dict)
    params, stats = {}, {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        name = _rename(k, _RESNET_NAMES)
        (stats if name.endswith(_STATS) else params)[name] = _tensor(v)
    return params, stats


def export_resnet_state_dict(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """(params, batch_stats) of the port's ResNet → the timm state dict, the
    exact inverse of :func:`convert_resnet_state_dict`; each BatchNorm's
    ``num_batches_tracked`` is written as 0, as hvt writes it."""
    sd = {}
    for k, v in {**params, **batch_stats}.items():
        name = _rename(k, _RESNET_EXPORT)
        sd[name] = _tensor(v).float()
        if name.endswith(".running_var"):
            tracked = name.removesuffix("running_var") + "num_batches_tracked"
            sd[tracked] = torch.zeros((), dtype=torch.int64)
    return sd


def _strip_prefix(sd: dict, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in sd):
        return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    return sd


def _count(sd: Mapping, prefix: str, family: str) -> int:
    pat = re.compile(rf"^{re.escape(prefix)}(\d+)\.")
    idx = [int(m.group(1)) for k in sd if (m := pat.match(k))]
    if not idx:
        raise ValueError(f"no {prefix}* keys: not a {family} state dict?")
    return max(idx) + 1


def _fused_qkv(sd: Mapping, p: str, out: dict, to: str) -> None:
    """HF's separate query/key/value Linears of block prefix ``p`` → ``to``.qkv."""
    for part in ("weight", "bias"):
        out[f"{to}.qkv.{part}"] = torch.cat(
            [sd[f"{p}.attention.attention.{n}.{part}"] for n in ("query", "key", "value")])


def _copy(sd: Mapping, src: str, dst: str, out: dict) -> None:
    for part in ("weight", "bias"):
        out[f"{dst}.{part}"] = sd[f"{src}.{part}"]


def convert_vit_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """timm or HF ViT state dict → the port's VisionTransformer names (hvt's
    ``convert_vit_state_dict``, hvt/models/torch_compat.py:394)."""
    sd = _strip_prefix({k: _tensor(v) for k, v in state_dict.items()}, "vit.")
    out: dict[str, torch.Tensor] = {}
    if any(k.startswith("encoder.layer.") for k in sd):  # HF
        out["cls_token"] = sd["embeddings.cls_token"]
        out["pos_embed"] = sd["embeddings.position_embeddings"]
        _copy(sd, "embeddings.patch_embeddings.projection", "patch_embed", out)
        for i in range(_count(sd, "encoder.layer.", "ViT")):
            p, b = f"encoder.layer.{i}", f"block{i}"
            _copy(sd, f"{p}.layernorm_before", f"{b}.norm1", out)
            _copy(sd, f"{p}.layernorm_after", f"{b}.norm2", out)
            _fused_qkv(sd, p, out, f"{b}.attn")
            _copy(sd, f"{p}.attention.output.dense", f"{b}.attn.proj", out)
            _copy(sd, f"{p}.intermediate.dense", f"{b}.mlp.fc1", out)
            _copy(sd, f"{p}.output.dense", f"{b}.mlp.fc2", out)
        _copy(sd, "layernorm", "norm", out)
        head = "classifier"
    else:  # timm
        out["cls_token"], out["pos_embed"] = sd["cls_token"], sd["pos_embed"]
        _copy(sd, "patch_embed.proj", "patch_embed", out)
        for i in range(_count(sd, "blocks.", "ViT")):
            p, b = f"blocks.{i}", f"block{i}"
            for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                _copy(sd, f"{p}.{name}", f"{b}.{name}", out)
        _copy(sd, "norm", "norm", out)
        head = "head"
    if f"{head}.weight" in sd:
        _copy(sd, head, "head", out)
    return out


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5, jax.image.resize's "bicubic"."""
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) f64 weights of jax.image.resize's bicubic along one axis
    (half-pixel centres, the kernel widened when shrinking (antialias), each
    row normalised; jax/_src/image/scale.py ``compute_weight_mat``)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    w = _keys_cubic((sample[:, None] - torch.arange(n_in, dtype=torch.float64)) / kernel_scale)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """A (1, g²+1, D) position embedding resized bicubically to (1,
    new_grid²+1, D), the class-token slot kept: hvt's ``resize_pos_embed``
    (hvt/models/torch_compat.py:482, the HF/DINOv2 interpolate_pos_encoding
    rule applied at load time)."""
    n = pos.shape[1] - 1
    g = math.isqrt(n)
    if g * g != n:
        raise ValueError(f"pos embed grid {n} is not square")
    if g == new_grid:
        return pos
    w = _resize_weights(g, new_grid)
    grid = pos[0, 1:].reshape(g, g, -1).double()
    grid = torch.einsum("ai,bj,ijd->abd", w, w, grid).to(pos.dtype)
    return torch.cat([pos[:, :1], grid.reshape(1, new_grid * new_grid, -1)], 1)


def convert_dinov2_state_dict(state_dict: Mapping, grid: int | None = None
                              ) -> dict[str, torch.Tensor]:
    """HF DINOv2 state dict → the port's Dinov2 names (hvt's
    ``convert_dinov2_state_dict``, hvt/models/torch_compat.py:511); ``grid``
    resizes the position embedding to another patch grid."""
    sd = _strip_prefix({k: _tensor(v) for k, v in state_dict.items()}, "dinov2.")
    out: dict[str, torch.Tensor] = {"cls_token": sd["embeddings.cls_token"]}
    pos = sd["embeddings.position_embeddings"]
    out["pos_embed"] = pos if grid is None else resize_pos_embed(pos, grid)
    _copy(sd, "embeddings.patch_embeddings.projection", "patch_embed", out)
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        p, b = f"encoder.layer.{i}", f"block{i}"
        _copy(sd, f"{p}.norm1", f"{b}.norm1", out)
        _copy(sd, f"{p}.norm2", f"{b}.norm2", out)
        _fused_qkv(sd, p, out, f"{b}.attn")
        _copy(sd, f"{p}.attention.output.dense", f"{b}.attn.proj", out)
        mlp = ("weights_in", "weights_out") if f"{p}.mlp.weights_in.weight" in sd else ("fc1", "fc2")
        for name in mlp:
            _copy(sd, f"{p}.mlp.{name}", f"{b}.mlp.{name}", out)
        out[f"{b}.ls1"] = sd[f"{p}.layer_scale1.lambda1"]
        out[f"{b}.ls2"] = sd[f"{p}.layer_scale2.lambda1"]
        i += 1
    if i == 0:
        raise ValueError("no encoder.layer.* keys: not a DINOv2 state dict?")
    _copy(sd, "layernorm", "norm", out)
    if "classifier.weight" in sd:
        _copy(sd, "classifier", "head", out)
    return out


def _indices(sd: Mapping, prefix: str) -> list[int]:
    pat = re.compile(rf"^{re.escape(prefix)}(\d+)\.")
    return sorted({int(m.group(1)) for k in sd if (m := pat.match(k))})


def convert_convnext_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """timm or HF ConvNeXt state dict → the port's ConvNeXt names (hvt's
    ``convert_convnext_state_dict``, hvt/models/torch_compat.py:588)."""
    sd = _strip_prefix({k: _tensor(v) for k, v in state_dict.items()}, "convnext.")
    out: dict[str, torch.Tensor] = {}
    hf = any(k.startswith("encoder.stages.") for k in sd)
    if hf:
        _copy(sd, "embeddings.patch_embeddings", "stem_conv", out)
        _copy(sd, "embeddings.layernorm", "stem_norm", out)
        stages, blocks = "encoder.stages.", "layers"
        names = {"dwconv": "dwconv", "layernorm": "norm", "pwconv1": "mlp.fc1",
                 "pwconv2": "mlp.fc2"}
        gamma = "layer_scale_parameter"
    else:
        _copy(sd, "stem.0", "stem_conv", out)
        _copy(sd, "stem.1", "stem_norm", out)
        stages, blocks = "stages.", "blocks"
        names = {"conv_dw": "dwconv", "norm": "norm", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
        gamma = "gamma"
    for s in _indices(sd, stages):
        sp = f"{stages}{s}"
        down = f"{sp}.downsampling_layer" if hf else f"{sp}.downsample"
        if (hf and s > 0) or (not hf and f"{down}.1.weight" in sd):
            _copy(sd, f"{down}.0", f"downsample{s}_norm", out)
            _copy(sd, f"{down}.1", f"downsample{s}_conv", out)
        for i in _indices(sd, f"{sp}.{blocks}."):
            p, b = f"{sp}.{blocks}.{i}", f"stage{s}_block{i}"
            for src, dst in names.items():
                _copy(sd, f"{p}.{src}", f"{b}.{dst}", out)
            out[f"{b}.gamma"] = sd[f"{p}.{gamma}"]
    if hf:
        _copy(sd, "layernorm", "norm", out)
        if "classifier.weight" in sd:
            _copy(sd, "classifier", "head", out)
    else:
        _copy(sd, "head.norm" if "head.norm.weight" in sd else "norm", "norm", out)
        if "head.fc.weight" in sd:
            _copy(sd, "head.fc", "head", out)
    return out


def _batch_norm(sd: Mapping, src: str, dst: str, params: dict, stats: dict) -> None:
    _copy(sd, src, dst, params)
    for name in _STATS:
        stats[f"{dst}.{name}"] = sd[f"{src}.{name}"]


def _classifier(sd: Mapping, linear: str, out: dict) -> None:
    """HF's ``classifier`` Linear (at ``linear``) or a multitask
    ``classifier.heads.{t}`` → ``head`` / ``head.tier{t}``, where present."""
    if f"{linear}.weight" in sd:
        _copy(sd, linear, "head", out)
    t = 0
    while f"classifier.heads.{t}.weight" in sd:
        _copy(sd, f"classifier.heads.{t}", f"head.tier{t}", out)
        t += 1


def convert_efficientnet_state_dict(state_dict: Mapping) -> tuple[dict, dict]:
    """HF EfficientNet state dict → (params, batch_stats) in the port's
    EfficientNet names (hvt's ``convert_efficientnet_state_dict``,
    hvt/models/torch_compat.py:671)."""
    sd = _strip_prefix({k: _tensor(v) for k, v in state_dict.items()}, "efficientnet.")
    params: dict[str, torch.Tensor] = {}
    stats: dict[str, torch.Tensor] = {}
    params["stem_conv.weight"] = sd["embeddings.convolution.weight"]
    _batch_norm(sd, "embeddings.batchnorm", "stem_bn", params, stats)
    i = 0
    while f"encoder.blocks.{i}.depthwise_conv.depthwise_conv.weight" in sd:
        src, b = f"encoder.blocks.{i}", f"block{i}"
        if f"{src}.expansion.expand_conv.weight" in sd:
            params[f"{b}.expand_conv.weight"] = sd[f"{src}.expansion.expand_conv.weight"]
            _batch_norm(sd, f"{src}.expansion.expand_bn", f"{b}.expand_bn", params, stats)
        params[f"{b}.dwconv.weight"] = sd[f"{src}.depthwise_conv.depthwise_conv.weight"]
        _batch_norm(sd, f"{src}.depthwise_conv.depthwise_norm", f"{b}.dw_bn", params, stats)
        _copy(sd, f"{src}.squeeze_excite.reduce", f"{b}.se_reduce", params)
        _copy(sd, f"{src}.squeeze_excite.expand", f"{b}.se_expand", params)
        params[f"{b}.project_conv.weight"] = sd[f"{src}.projection.project_conv.weight"]
        _batch_norm(sd, f"{src}.projection.project_bn", f"{b}.project_bn", params, stats)
        i += 1
    params["top_conv.weight"] = sd["encoder.top_conv.weight"]
    _batch_norm(sd, "encoder.top_bn", "top_bn", params, stats)
    _classifier(sd, "classifier", params)
    return params, stats


def convert_regnet_state_dict(state_dict: Mapping) -> tuple[dict, dict]:
    """HF RegNet-Y state dict → (params, batch_stats) in the port's RegNetY
    names (hvt's ``convert_regnet_state_dict``, hvt/models/torch_compat.py:738):
    the Y layer's ``layer.0``-``layer.3`` are conv1/bn1, the grouped
    conv2/bn2, the squeeze-excite's ``attention.0``/``.2`` and conv3/bn3."""
    sd = _strip_prefix({k: _tensor(v) for k, v in state_dict.items()}, "regnet.")
    params: dict[str, torch.Tensor] = {}
    stats: dict[str, torch.Tensor] = {}
    params["stem_conv.weight"] = sd["embedder.embedder.convolution.weight"]
    _batch_norm(sd, "embedder.embedder.normalization", "stem_bn", params, stats)
    s = 0
    while f"encoder.stages.{s}.layers.0.layer.0.convolution.weight" in sd:
        i = 0
        while f"encoder.stages.{s}.layers.{i}.layer.0.convolution.weight" in sd:
            src, b = f"encoder.stages.{s}.layers.{i}", f"stage{s}_block{i}"
            for n, conv, bn in ((0, "conv1", "bn1"), (1, "conv2", "bn2"), (3, "conv3", "bn3")):
                params[f"{b}.{conv}.weight"] = sd[f"{src}.layer.{n}.convolution.weight"]
                _batch_norm(sd, f"{src}.layer.{n}.normalization", f"{b}.{bn}", params, stats)
            _copy(sd, f"{src}.layer.2.attention.0", f"{b}.se_reduce", params)
            _copy(sd, f"{src}.layer.2.attention.2", f"{b}.se_expand", params)
            if f"{src}.shortcut.convolution.weight" in sd:
                params[f"{b}.sc_conv.weight"] = sd[f"{src}.shortcut.convolution.weight"]
                _batch_norm(sd, f"{src}.shortcut.normalization", f"{b}.sc_bn", params, stats)
            i += 1
        s += 1
    _classifier(sd, "classifier.1", params)
    return params, stats


def save_swin_checkpoint(params: Mapping, path: str) -> int:
    """Write the port's SwinV2 parameters as a reference-format ``.pt``
    (``{"model": state_dict}``); returns the number of tensors written."""
    sd = export_swin_state_dict(params)
    torch.save({"model": sd}, path)
    return len(sd)


def save_resnet_checkpoint(params: Mapping, batch_stats: Mapping, path: str) -> int:
    """Write the port's ResNet variables as a timm-format ``.pt``; returns
    the number of tensors written."""
    sd = export_resnet_state_dict(params, batch_stats)
    torch.save({"model": sd}, path)
    return len(sd)


def load_torch_variables(uri: str) -> tuple[dict, dict]:
    """``torch://<path>`` or ``swin://<path>`` → (params, batch_stats) in the
    port's names. The family comes from the key names, in hvt's order:
    ``layers.*`` is SwinV2 (no batch statistics), ``layer1.*``/``conv1``
    ResNet, LayerScale lambdas or ``dinov2.*`` DINOv2 (before ViT: both
    carry ``cls_token``/``encoder.layer.*``), ``cls_token`` or
    ``[vit.]encoder.layer.*`` ViT, ``[regnet.]embedder.*`` RegNet-Y,
    ``stages.*``/``[convnext.]encoder.stages.*``/``stem.0`` ConvNeXt,
    ``[efficientnet.]encoder.blocks.*`` EfficientNet."""
    m = _TORCH_URI.match(uri) or _SWIN_URI.match(uri)
    if not m:
        raise ValueError(f"uri {uri!r} doesn't match torch://<path> or swin://<path>")
    blob = torch.load(m.group(1), map_location="cpu", weights_only=True)
    sd = blob.get("model", blob.get("state_dict", blob))
    if any(k.startswith("layers.") for k in sd):
        return convert_swin_state_dict(sd), {}
    if any(k.startswith("layer1.") for k in sd) or "conv1.weight" in sd:
        return convert_resnet_state_dict(sd)
    if any("layer_scale1" in k or k.startswith("dinov2.") for k in sd):
        return convert_dinov2_state_dict(sd), {}
    if any("cls_token" in k or k.startswith(("encoder.layer.", "vit.encoder.layer.")) for k in sd):
        return convert_vit_state_dict(sd), {}
    # RegNet before ConvNeXt: both carry encoder.stages.*, only RegNet the embedder stem
    if any(k.startswith(("regnet.", "embedder.")) for k in sd):
        return convert_regnet_state_dict(sd)
    if any(k.startswith(("stages.", "encoder.stages.", "convnext.")) for k in sd) \
            or "stem.0.weight" in sd:
        return convert_convnext_state_dict(sd), {}
    if any(k.startswith(("efficientnet.", "encoder.blocks.", "embeddings.convolution"))
           for k in sd):
        return convert_efficientnet_state_dict(sd)
    raise ValueError(
        f"torch checkpoint {uri!r}: unrecognized family (expected SwinV2 'layers.*', ResNet "
        "'layer{s}.{b}'/'conv1', DINOv2 'layer_scale1', ViT 'cls_token'/'encoder.layer.*', "
        "RegNet 'embedder.*', ConvNeXt 'stages.*', or EfficientNet 'encoder.blocks.*' key names)")
