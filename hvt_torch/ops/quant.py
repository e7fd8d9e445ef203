"""Post-training int8 quantization of the serving forward (w8a8, dynamic or
calibrated) — port of ``hvt/ops/quant.py``.

The scheme is hvt's:

* **weights**: per-output-channel symmetric absmax scales, rounded to int8
  (:func:`quantize_weight`), once a layer a context;
* **activations**: a per-tensor symmetric absmax scale, computed from the
  input at every call (dynamic), or a static scale calibrated by
  :func:`collect_act_scales` (``act_scales``; a layer the dict does not name
  stays dynamic);
* **products**: int8 × int8 → int32 (:mod:`hvt_torch.ops.int8_cuda`: Dense
  layers and 1×1 convs without pads through ``torch._int_mm``, the other
  convolutions through the port's own kernel), then ``f32(acc)·(sx·sw)``,
  ``+ bias`` in f32 and the cast to the layer's dtype.

Quantizing divides (``x / scale``, not a product with the reciprocal), rounds
half to even (``torch.round``, as ``jnp.round``) and clamps to ±127, in f32:
the same int8 values as hvt's.

hvt intercepts every ``nn.Dense`` / ``nn.Conv`` ``__call__`` whose module
path holds no ``skip`` part (``flax.linen.intercept_methods``). The port's
models have no such hook; their product helpers
(:mod:`hvt_torch.models.common`: ``linear``, ``conv_nhwc``, ``se_gate``,
``TransformerMlp``) ask this module whether a context is active and covers
the layer (:func:`dense`, :func:`conv`). A context is entered with ``with
quant.Int8(model, act_scales=..., skip=("head",)):`` (:class:`Int8`) or
``with quant.Calibrate(model):`` (:class:`Calibrate`, full precision, the
inputs' absmax recorded). It keys each ``nn.Linear`` and ``nn.Conv2d`` by
hvt's ``_module_key``, the flax module path (``stage0_block0/attn/proj``):
the port's module names are flax's, and a parent may rename a child
(``flax_names``: ResNet's ``ConvBN`` holds flax's ``Conv_0`` as ``conv``), so
a dict of calibrated scales compares key for key with hvt's. A model may
name modules that keep full precision where hvt's are not flax layer calls
(``int8_full_precision``). The context is thread-local (a ``ContextVar``):
the serving batcher enters it in its own thread.

Which products run int8, per family and route (hvt's layers that reach the
interceptor; the rest are raw-parameter products or kernels' weights):

============================  ===============================================  ===========================================
model, route                  int8                                             full precision
============================  ===============================================  ===========================================
SwinV2, ``fuse: false``       patch embedding, each block's ``attn/proj``,     qkv (a raw ``qkv_kernel`` product), the cpb
                              ``mlp/fc1``, ``mlp/fc2``; PatchMerging's         MLP, the MoE's router and experts, the head
                              ``reduction``
SwinV2, ``fuse: true``        patch embedding, ``reduction``, and ``proj`` /   the fused halves' weights (inside the
                              ``fc1``, ``fc2`` of a half ``fits_vmem`` leaves  kernels), qkv, cpb, MoE, head; hvt also
                              unfused (or an MoE block's ``proj``)             quantizes its fused halves' zero dummies,
                                                                               whose output it drops (scale ``EPS/127``)
ResNet                        every ``ConvBN`` conv (the 7×7 stem too, but     the ``stem_s2d`` stem (a raw ``kernel``),
                              for ``stem_s2d``)                                BlurPool's blur, the head
ViT, DINOv2                   qkv, proj, the MLP (``fc1``/``fc2`` or SwiGLU's  the patch embedding (a raw ``kernel``),
                              ``weights_in``/``weights_out``); ``use_flash``   the attention core (flash kernels or
                              keeps the flash kernels between them             dense), the head
ConvNeXt                      stem and downsample convs, the depthwise 7×7,    LayerNorm, ``gamma``, the head
                              the MLP's Dense layers
EfficientNet                  stem, expand, depthwise, squeeze-excite and      BatchNorm, the head
                              project convs, the top conv
RegNet-Y                      stem, 1×1, grouped 3×3, squeeze-excite and       BatchNorm, the head
                              shortcut convs
============================  ===============================================  ===========================================

Quantization is a serving path: hvt's engine replicates the parameters over
a data-only mesh (hvt/downstream/serve.py:69-86), so a model whose layers
hold ``mesh.model`` shards is never quantized, and :class:`Int8` refuses one.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Mapping, Sequence

import torch
import torch.nn as nn

from hvt_torch.ops import int8_cuda

EPS = 1e-8
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("hvt_int8_context", default=None)


def _over_127(v: torch.Tensor) -> torch.Tensor:
    """v / 127, one f32 division as hvt's. The divisor is a tensor on v's
    device: CUDA divides by a Python number as a product with its
    reciprocal, one ulp off hvt's scale for about one value in twenty."""
    return v / torch.full((), 127.0, device=v.device)


def quantize_weight(w: torch.Tensor, reduce_dims: Sequence[int]):
    """→ (int8 w, f32 per-output-channel scale, kept dims): symmetric absmax
    over ``reduce_dims`` (every dim but the output channels'), hvt's."""
    w = w.detach().float()
    amax = w.abs().amax(dim=tuple(reduce_dims), keepdim=True)
    scale = _over_127(torch.clamp_min(amax, EPS))
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def quantize_act(x: torch.Tensor, scale=None):
    """→ (int8 x, f32 0-d scale): symmetric absmax computed from x, unless a
    static calibrated ``scale`` (a Python float, or its f32 0-d tensor) is
    given."""
    xf = x.float()
    if scale is None:
        scale = _over_127(torch.clamp_min(xf.abs().amax(), EPS))
    elif not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def layer_keys(model: nn.Module, skip: Sequence[str] = ("head",)) -> dict:
    """{module: flax path} of every ``nn.Linear`` and ``nn.Conv2d`` of
    ``model`` that may run int8: no path part holds a ``skip`` string (hvt's
    substring match) and no top-level name is in the model's
    ``int8_full_precision``."""
    keep_fp = set(getattr(model, "int8_full_precision", ()))
    keys = {}

    def walk(module: nn.Module, path: tuple) -> None:
        renames = getattr(module, "flax_names", {})
        for name, child in module.named_children():
            p = path + (renames.get(name, name),)
            if isinstance(child, (nn.Linear, nn.Conv2d)) and p[0] not in keep_fp and not any(
                    s in part for part in p for s in skip):
                keys[child] = "/".join(p)
            walk(child, p)

    walk(model, ())
    return keys


class _Context:
    """A context over one model's layers; entered with ``with``."""

    def __init__(self, model: nn.Module, skip: Sequence[str] = ("head",)):
        self.keys = layer_keys(model, skip)
        self._local = threading.local()  # each thread's tokens, innermost last

    def __enter__(self):
        tokens = self._local.__dict__.setdefault("tokens", [])
        tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._local.tokens.pop())


class Int8(_Context):
    """Every covered layer runs int8 (hvt's ``wrap_int8``): static scales
    for the layers ``act_scales`` names, dynamic for the rest. Each layer's
    weight is quantized once, at its first call in the context; a context
    outlives no update of the weights."""

    def __init__(self, model: nn.Module, act_scales: "Mapping[str, float] | None" = None,
                 skip: Sequence[str] = ("head",)):
        if any(getattr(m, "tp", False) for m in model.modules()):
            raise ValueError("int8 quantization serves a whole model: the model holds "
                             "mesh.model shards (hvt's engine replicates its parameters)")
        super().__init__(model, skip)
        self.act_scales = dict(act_scales or {})
        self._weights: dict = {}
        self._scales: dict = {}  # (key, device) → the static scale as an f32 0-d tensor

    def _weight(self, layer: nn.Module):
        """(int8 weight, (O,) f32 scale) in its product's layout: Linear and
        a plain-product Conv2d (:func:`_is_product`) (O, K), as
        ``int8_linear`` takes it; any other Conv2d HWIO, the conv kernel's."""
        got = self._weights.get(layer)
        if got is None:
            w = layer.weight
            q, s = quantize_weight(w, range(1, w.ndim))
            if w.ndim == 4 and _is_product(layer):  # OIHW (O, C, 1, 1) → (O, C)
                q = q.reshape(q.shape[:2])
            elif w.ndim == 4:  # OIHW → HWIO
                q = q.permute(2, 3, 1, 0).contiguous()
            got = self._weights[layer] = (q, s.reshape(-1))
        return got

    def _static(self, key: str, device):
        """The layer's calibrated scale on ``device`` (made once), or None."""
        if key not in self.act_scales:
            return None
        got = self._scales.get((key, device))
        if got is None:
            got = self._scales[(key, device)] = torch.tensor(
                self.act_scales[key], dtype=torch.float32, device=device)
        return got

    def dense(self, layer: nn.Linear, key: str, x: torch.Tensor) -> torch.Tensor:
        wq, sw = self._weight(layer)
        xq, sx = quantize_act(x, self._static(key, x.device))
        return int8_cuda.int8_linear(xq, wq, sx, sw, layer.bias, x.dtype)

    def conv(self, conv: nn.Conv2d, key: str, x: torch.Tensor) -> torch.Tensor:
        wq, sw = self._weight(conv)
        xq, sx = quantize_act(x, self._static(key, x.device))  # the scale of all of x, as hvt's
        if wq.ndim == 2:  # a plain product on the strided grid
            return int8_cuda.int8_linear(xq[:, ::conv.stride[0], ::conv.stride[1]], wq, sx, sw,
                                         conv.bias, x.dtype)
        ph, pw = conv.padding
        return int8_cuda.int8_conv2d(xq, wq, sx, sw, conv.bias, x.dtype, stride=conv.stride,
                                     pads=(ph, ph, pw, pw), groups=conv.groups)


def _is_product(conv: nn.Conv2d) -> bool:
    """A 1×1 conv with one group and no pads: a plain product (Dense) on the
    strided grid."""
    return conv.kernel_size == (1, 1) and conv.groups == 1 and tuple(conv.padding) == (0, 0)


class Calibrate(_Context):
    """Full precision, each covered layer's input absmax recorded over the
    calls in the context (running max, in f32): hvt's recorder."""

    def __init__(self, model: nn.Module, skip: Sequence[str] = ("head",)):
        super().__init__(model, skip)
        self.absmax: dict[str, float] = {}

    def _record(self, key: str, x: torch.Tensor) -> None:
        seen = float(x.detach().float().abs().amax())
        self.absmax[key] = max(self.absmax.get(key, 0.0), seen)

    def dense(self, layer, key, x):
        self._record(key, x)

    conv = dense

    def scales(self) -> dict[str, float]:
        """{flax path: static scale absmax/127} of every layer recorded."""
        return {k: max(v, EPS) / 127.0 for k, v in self.absmax.items()}


def dense(layer: nn.Linear, x: torch.Tensor) -> "torch.Tensor | None":
    """The int8 output of a Dense layer under the active context, or None
    where the layer stays in full precision (no context, a layer it does
    not cover, or a calibration, which records x)."""
    ctx = _ACTIVE.get()
    key = None if ctx is None else ctx.keys.get(layer)
    return None if key is None else ctx.dense(layer, key, x)


def conv(layer: nn.Conv2d, x: torch.Tensor) -> "torch.Tensor | None":
    """:func:`dense` for a Conv2d on an NHWC ``x``."""
    ctx = _ACTIVE.get()
    key = None if ctx is None else ctx.keys.get(layer)
    return None if key is None else ctx.conv(layer, key, x)


def collect_act_scales(model: nn.Module, forward, batches, *,
                       skip: Sequence[str] = ("head",)) -> dict[str, float]:
    """Calibrate: ``forward(batch)`` in full precision over ``batches`` →
    {flax path: absmax/127} (hvt's ``collect_act_scales``)."""
    cal = Calibrate(model, skip)
    for batch in batches:
        with cal:
            forward(batch)
    return cal.scales()
