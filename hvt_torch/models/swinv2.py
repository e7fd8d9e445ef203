"""SwinV2 in PyTorch — port of ``hvt/models/swinv2.py``.

Same architecture, layouts and parameter tree as hvt (NHWC token grids,
cosine attention with the logit scale clamped at log 100, the continuous
relative position bias MLP, q/v-only qkv bias, cyclic shifts with additive
masks, res-post-norm, patch merging (0,0),(1,0),(0,1),(1,1), a Dense or
multitask head). Module names mirror the flax ones (``stage{s}_block{i}``,
``stage{s}_merge``, ``patch_embed``, ...); weights are in PyTorch's own
layouts, and :mod:`hvt_torch.models.convert` maps a flax tree onto them.

Compute dtype: parameters stay f32; activations run in ``dtype`` (bf16 by
default); the head runs in f32. Blocks are routed as hvt routes them
(``SwinBlock.__call__`` and ``_fused_call``, hvt/models/swinv2.py:195-470),
by the same knobs with hvt's defaults:

* ``fuse=False``: each block's attention goes through hvt's
  ``window_attention_qkv`` on the packed qkv projection: the packed kernel
  (``window_attention_packed``) with ``use_pallas``, else the reference
  (``window_attention_reference``, hvt's XLA route); the projections,
  LayerNorms, MLP and residuals are plain PyTorch.
* ``fuse=True`` (where the window tiles the map), per block:

  - the attention half is fused where ``fits_vmem`` (hvt's, copied in
    :mod:`hvt_torch.ops.fused_halves_cuda`) admits it, and in training only
    with ``fuse_attn_train``. Fused: with ``fuse_nhwc`` and ``fuse_resid``,
    ``attention_half_nhwc`` returning x + s·branch (the cyclic shift folded
    into its gather); with ``fuse_nhwc`` alone, the same kernel returning
    the branch; without ``fuse_nhwc``, ``attention_half`` on the windows
    partitioned from the rolled map, then window_reverse and the un-roll.
    Not fused: ``WindowAttention`` on the partitioned windows, through the
    packed kernel where ``use_pallas`` and not ``fallback_xla``, else the
    reference; then norm1. Outside a fused residual, the residual and drop
    path run in PyTorch.
  - the MLP half is routed as hvt's ``_mlp_half_fused``: ``mlp_half`` where
    the unchunked MLP fits, with its residual fused only where ``fuse_resid``
    and hvt's ``mlp_resid_images_per_block`` allow it (an image's tokens a
    multiple of 8: not SwinV2's 14 x 14 and 7 x 7 stages); where it does not
    fit (SwinV2-B's C = 1024 stage in training), ``mlp_half_chunked`` in K
    chunks, or with ``fuse_mlp_chunked`` false the plain LayerNorm(MLP).

``remat`` runs every ``SwinBlock`` under
:func:`~hvt_torch.models.common.recompute` in training (hvt's ``nn.remat``):
the backward runs each block's forward again, its kernels included. ``ape``
adds hvt's absolute position embedding, a (1, H/patch, W/patch, C)
parameter made at ``img_size`` (the factory passes the train crop), after
``patch_norm``; another input size raises, where hvt fails on the
parameter's shape.

``moe_experts`` > 0 (hvt's Swin-MoE knobs, ``moe_from_stage``, ``moe_every``,
``moe_capacity``, ``moe_aux_weight``) puts :class:`~hvt_torch.ops.moe.MoeMlp`
in the dense MLP's place, under the name ``moe``, in every ``moe_every``-th
block of the stages from ``moe_from_stage``, as hvt picks them
(hvt/models/swinv2.py:671-680). Those blocks take the unfused route
whatever ``fuse`` says (``fuse and not block_moe``, as hvt's): their
attention through the packed kernel, their MLP the MoE layer; the other
blocks keep the fused halves. A training forward leaves each MoE layer's aux
loss for the train step (``moe.moe_aux_loss``).

On CPU tensors every kernel call runs its plain version. Both routes train
(train mode, stochastic depth at hvt's per-block rates ``linspace(0, rate,
depth)``), every kernel through its backward kernel; a fused residual takes
a per-image drop-path scale s drawn as hvt draws it (one mask per half).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch import parallel
from hvt_torch.models.common import (TransformerMlp, conv_nhwc, drop_path, drop_path_scale,
                                      layer_norm, linear, recompute, trunc02_)
from hvt_torch.models.heads import MultitaskHead
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.ops import window_attention as wa
from hvt_torch.ops import window_attention_cuda as wac
from hvt_torch.ops.moe import MoeMlp


# The cached constants are made outside inference mode even when a serving
# forward asks first, so that a later training forward may save them.
@functools.lru_cache(maxsize=None)
def _geometry(window: int, pretrained_window: int, device: str):
    with torch.inference_mode(False):
        coords = torch.as_tensor(wa.relative_coords_table(window, pretrained_window), device=device)
        index = torch.as_tensor(wa.relative_position_index(window), device=device)
    return coords, index


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, window: int, shift: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(wa.shift_attn_mask((h, w), window, shift), device=device)


class WindowAttention(nn.Module):
    """Parameters of hvt's WindowAttention: qkv (3C, C) without bias, q_bias and
    v_bias, logit_scale (H, 1, 1), the cpb MLP (2 → 512 → H) and proj."""

    def __init__(self, dim: int, num_heads: int, pretrained_window: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.pretrained_window = pretrained_window
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)

    def qkv_bias(self) -> torch.Tensor:
        return torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])

    def rel_bias(self, window: int) -> torch.Tensor:
        """(heads, w², w²) f32 continuous position bias for the block's window."""
        coords, index = _geometry(window, self.pretrained_window, str(self.q_bias.device))
        return wa.cpb_bias(self.cpb_fc1.weight, self.cpb_fc1.bias, self.cpb_fc2.weight, coords,
                           index, self.num_heads)

    def forward(self, x, window: int, mask=None, use_pallas: bool = True):
        """x (nW·B, N, C) → (nW·B, N, C); mask (nW, N, N) or None. The
        attention takes the packed kernel with ``use_pallas``, else hvt's
        reference (``window_attention_qkv``)."""
        qkv = F.linear(x, self.qkv.weight.to(x.dtype)) + self.qkv_bias().to(x.dtype)
        out = wa.window_attention_qkv(qkv, self.logit_scale, self.rel_bias(window), mask,
                                      num_heads=self.num_heads, use_pallas=use_pallas)
        return linear(self.proj, out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, pretrained_window: int = 0, fuse: bool = False,
                 drop_path_rate: float = 0.0, fuse_mlp_chunked: bool = True,
                 use_pallas: bool = True, fuse_attn_train: bool = True,
                 fallback_xla: bool = True, fuse_nhwc: bool = True, fuse_resid: bool = True,
                 moe_experts: int = 0, moe_capacity: float = 1.25, moe_aux_weight: float = 0.01):
        super().__init__()
        self.dim, self.num_heads, self.window, self.shift = dim, num_heads, window, shift
        self.fuse, self.fuse_mlp_chunked = fuse, fuse_mlp_chunked
        self.use_pallas, self.fuse_attn_train, self.fallback_xla = use_pallas, fuse_attn_train, fallback_xla
        self.fuse_nhwc, self.fuse_resid = fuse_nhwc, fuse_resid
        self.drop_path_rate = drop_path_rate
        self.attn = WindowAttention(dim, num_heads, pretrained_window)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        # hvt's MoE block holds ``moe`` in the dense MLP's place
        self.mlp = None if moe_experts else TransformerMlp(dim, hidden)
        self.moe = (MoeMlp(dim, moe_experts, hidden, dim, moe_capacity, moe_aux_weight)
                    if moe_experts else None)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, generator: torch.Generator | None = None):
        """x: (B, H, W, C) token grid. In train mode each residual branch
        goes through ``drop_path`` at the block's rate, drawn from
        ``generator``."""
        b, h, w, c = x.shape
        window, shift = self.window, self.shift
        if min(h, w) <= window:  # window covers the map: global attention, no shift
            window, shift = min(h, w), 0
        mask = _shift_mask(h, w, window, shift, str(x.device)) if shift else None
        if self.fuse and h % window == 0 and w % window == 0:
            if self.moe is not None:  # hvt/models/swinv2.py:207-212
                raise ValueError("MoE blocks require the unfused path (set fuse=False for "
                                 "models with moe_experts > 0)")
            return self._mlp_half(self._attention_half(x, window, shift, mask, generator),
                                  generator)
        rate, training = self.drop_path_rate, self.training
        y = self._on_windows(x, window, shift,
                             lambda xw: self.attn(xw, window, mask, self.use_pallas))
        x = x + drop_path(layer_norm(self.norm1, y), rate, training, generator)
        mlp = self.mlp if self.moe is None else self.moe
        return x + drop_path(layer_norm(self.norm2, mlp(x)), rate, training, generator)

    @staticmethod
    def _on_windows(x, window: int, shift: int, fn):
        """``fn`` on the windows of x rolled by -shift, put back in place."""
        b, h, w, c = x.shape
        xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
        y = wa.window_reverse(fn(wa.window_partition(xs, window)), window, h, w)
        return torch.roll(y, (shift, shift), (1, 2)) if shift else y

    def attn_route(self, n: int, training: bool) -> str:
        """The attention half's route on ``fuse=True`` for windows of ``n``
        tokens, as hvt's ``_fused_call`` decides it: "nhwc_resid"
        (``attention_half_nhwc`` with the residual fused), "nhwc" (the same
        kernel, the branch alone), "windows" (``attention_half``), or, where
        hvt does not fuse the half, "packed" (``WindowAttention`` through the
        packed kernel) or "reference" (through hvt's XLA reference)."""
        if (not training or self.fuse_attn_train) and fh.fits_vmem(self.dim, self.num_heads, n,
                                                                   train=training):
            if self.fuse_nhwc:
                return "nhwc_resid" if self.fuse_resid else "nhwc"
            return "windows"
        return "packed" if self.use_pallas and not self.fallback_xla else "reference"

    def mlp_route(self, training: bool) -> int:
        """The MLP half's route on ``fuse=True``: 1 (``mlp_half``), K > 1
        (``mlp_half_chunked``) or 0 (plain), as hvt's ``_mlp_half_fused``."""
        return fh.mlp_route(self.dim, self.mlp.fc1.out_features, training, self.fuse_mlp_chunked)

    def mlp_resid(self, tokens: int, tokens_per_image: int) -> bool:
        """Whether the MLP half fuses its residual (route 1 only), as hvt:
        ``fuse_resid`` and ``mlp_resid_images_per_block`` > 0."""
        return self.fuse_resid and fh.mlp_resid_images_per_block(
            tokens, tokens_per_image, self.dim, self.mlp.fc1.out_features) > 0

    def _scale(self, b: int, generator, device) -> torch.Tensor:
        """A fused residual's per-image drop-path scale s in train mode (one
        draw per half, as hvt's), else ones."""
        if self.training and self.drop_path_rate > 0.0:
            return drop_path_scale(b, self.drop_path_rate, generator, device)
        return torch.ones(b, dtype=torch.float32, device=device)

    def _attention_half(self, x, window: int, shift: int, mask, generator):
        """x + the attention half's branch on ``fuse=True``, by
        :meth:`attn_route`; a residual the kernel does not fuse, and its drop
        path, run here."""
        attn, n1 = self.attn, self.norm1
        route = self.attn_route(window * window, self.training)
        if route in ("packed", "reference"):
            branch = layer_norm(n1, self._on_windows(
                x, window, shift, lambda xw: attn(xw, window, mask, route == "packed")))
        else:
            args = (attn.qkv.weight, attn.qkv_bias(), attn.logit_scale, attn.rel_bias(window), mask,
                    attn.proj.weight, attn.proj.bias, n1.weight, n1.bias)
            if route == "nhwc_resid":
                return fh.attention_half_nhwc(x, *args, window, self.num_heads, shift=shift,
                                              dp=self._scale(x.shape[0], generator, x.device))
            if route == "nhwc":  # the kernel gathers and scatters through the shift
                branch = fh.attention_half_nhwc(x, *args, window, self.num_heads, shift=shift)
            else:
                branch = self._on_windows(
                    x, window, shift, lambda xw: fh.attention_half(xw, *args, self.num_heads))
        return x + drop_path(branch, self.drop_path_rate, self.training, generator)

    def _mlp_half(self, x, generator):
        """x + the MLP half's branch on ``fuse=True``, by :meth:`mlp_route`,
        the residual fused where :meth:`mlp_resid` allows. Under tensor
        parallelism the kernels run on the weights gathered over the model
        group (every model peer computes the whole half on its rows) and the
        plain route is the MLP's own Megatron form."""
        b, h, w, c = x.shape
        mlp = self.mlp
        nchunks = self.mlp_route(self.training)
        w1, b1, w2 = mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight
        if mlp.tp and nchunks > 0:  # the kernels take the full weights, as hvt's re-gather them
            w1, b1 = parallel.gather_from_model(w1, 0), parallel.gather_from_model(b1, 0)
            w2 = parallel.gather_from_model(w2, 1)
        args = (x.reshape(b * h * w, c), w1, b1, w2, mlp.fc2.bias, self.norm2.weight,
                self.norm2.bias)
        if nchunks == 1 and self.mlp_resid(b * h * w, h * w):
            return fh.mlp_half(*args, tpi=h * w,
                               dp=self._scale(b, generator, x.device)).reshape(b, h, w, c)
        if nchunks == 1:
            branch = fh.mlp_half(*args).reshape(b, h, w, c)
        elif nchunks > 1:
            branch = fh.mlp_half_chunked(*args, nchunks).reshape(b, h, w, c)
        else:
            branch = layer_norm(self.norm2, self.mlp(x))
        return x + drop_path(branch, self.drop_path_rate, self.training, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x):
        """(B, H, W, C) → (B, H/2, W/2, 2C); concat order (0,0), (1,0), (0,1), (1,1)."""
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"odd resolution {h}x{w}")
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]], -1)
        return layer_norm(self.norm, linear(self.reduction, x))


class SwinTransformerV2(nn.Module):
    def __init__(
        self,
        num_classes: Union[int, tuple[int, ...]] = 1000,
        patch_size: int = 4,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.1,
        ape: bool = False,
        patch_norm: bool = True,
        pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0),
        dtype: torch.dtype = torch.bfloat16,
        use_pallas: bool = True,
        fuse: bool = False,
        fuse_attn_train: bool = True,
        fallback_xla: bool = True,
        fuse_nhwc: bool = True,
        fuse_mlp_chunked: bool = True,
        fuse_resid: bool = True,
        remat: bool = False,
        pipe: int = 1,
        pipe_microbatches: int = 0,
        pipe_stage: int = -1,
        moe_experts: int = 0,
        moe_from_stage: int = 2,
        moe_every: int = 2,
        moe_capacity: float = 1.25,
        moe_aux_weight: float = 0.01,
        img_size: int = 224,
        seed: int = 0,
    ):
        super().__init__()
        del pipe_microbatches, pipe_stage
        if pipe > 1 and moe_experts:  # hvt/models/swinv2.py:649-655
            raise ValueError("pipe > 1 and moe_experts > 0 are mutually exclusive for now (the "
                             "pipelined trunk's vmapped chains do not carry MoE blocks)")
        if pipe > 1:
            raise NotImplementedError("pipe > 1: pipeline parallelism is ROADMAP queue 1, item 11")
        self.num_classes = num_classes
        self.remat = remat
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.dtype = dtype
        self.fuse = fuse
        self.drop_path_rate = drop_path_rate
        # stochastic-depth rate of each block, rising linearly over depth
        rates = iter(np.linspace(0, drop_path_rate, sum(depths)).tolist())
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None
        # hvt makes it at the first input's token grid; the port at img_size's
        grid = img_size // patch_size
        self.absolute_pos_embed = (nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
                                   if ape else None)
        self.layer_names: list[str] = []
        dim = embed_dim
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                name = f"stage{stage}_block{i}"
                # hvt's MoE blocks: every moe_every-th block of the stages from moe_from_stage
                block_moe = (moe_experts if moe_experts and stage >= moe_from_stage
                             and i % moe_every == moe_every - 1 else 0)
                self.add_module(name, SwinBlock(
                    dim, heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                    mlp_ratio, pretrained_window_sizes[stage], fuse and not block_moe,
                    next(rates), fuse_mlp_chunked, use_pallas, fuse_attn_train, fallback_xla,
                    fuse_nhwc, fuse_resid, block_moe, moe_capacity, moe_aux_weight,
                ))
                self.layer_names.append(name)
            if stage < len(depths) - 1:
                name = f"stage{stage}_merge"
                self.add_module(name, PatchMerging(dim))
                self.layer_names.append(name)
                dim *= 2
        self.num_features = dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        if isinstance(num_classes, tuple):
            self.head = MultitaskHead(dim, num_classes)
        else:
            self.head = nn.Linear(dim, num_classes)
        self.reset_parameters(seed)

    @property
    def no_weight_decay_substrings(self) -> tuple[str, ...]:
        """Parameter-name substrings the optimizer never decays: hvt's
        ("absolute_pos_embed", "cpb_", "logit_scale") in the port's names
        (the cpb MLP is ``cpb_fc1``/``cpb_fc2``)."""
        return ("absolute_pos_embed", "cpb_fc", "logit_scale")

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """hvt's initialisation, drawn from a torch.Generator seeded with
        ``seed``: Dense/conv trunc_normal(0.02) with zero bias, LayerNorm ones
        and zeros, res-post-norm (norm1/norm2) zeros, logit_scale log 10."""
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                trunc02_(module.weight, gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, WindowAttention):
                module.q_bias.zero_()
                module.v_bias.zero_()
                module.logit_scale.fill_(math.log(10.0))
            elif isinstance(module, MoeMlp):
                module.reset_parameters(gen)
        for name in self.layer_names:
            block = getattr(self, name)
            if isinstance(block, SwinBlock):
                for ln in (block.norm1, block.norm2):
                    ln.weight.zero_()
                    ln.bias.zero_()
        if isinstance(self.head, MultitaskHead):
            self.head.reset_parameters(gen)
        if self.absolute_pos_embed is not None:
            trunc02_(self.absolute_pos_embed, gen)

    def cuda_unsupported(self, image_size: int, training: bool = False) -> list[str]:
        """Why the CUDA kernels cannot run this model at ``image_size`` px
        (forward, or forward and backward when ``training``): one line per
        stage with a block they do not take, empty when every block runs.
        Each block is routed as hvt routes it (``SwinBlock.attn_route``,
        ``mlp_route``; an MoE block unfused), and each kernel has its own
        widths; a route without a kernel (hvt's XLA reference, the plain
        LayerNorm(MLP), the MoE layer) takes every shape. The kernels hold
        SwinV2-T's and SwinV2-B's shapes; others are ROADMAP.md queue 2,
        "Kernel coverage"."""
        found = []
        grid = image_size // self.patch_embed.stride[0]
        for stage, depth in enumerate(self.depths):
            whys = [self._block_unsupported(getattr(self, f"stage{stage}_block{i}"), grid,
                                            training) for i in range(depth)]
            why = next((w for w in whys if w), None)
            if why:
                found.append(f"stage {stage + 1} ({why[0]}): {why[1]}")
            grid //= 2
        return found

    @staticmethod
    def _block_unsupported(block: SwinBlock, grid: int, training: bool):
        """(route, why) where the kernels cannot run ``block`` on a
        ``grid`` x ``grid`` map, else None."""
        window = min(grid, block.window)
        n = window * window
        if block.fuse and grid % window == 0:
            route = block.attn_route(n, training)
            if route == "packed":
                why = wac.unsupported(n, block.dim, block.num_heads, training)
            elif route == "reference":
                why = None
            else:  # the NHWC and the windowed kernels take the same shapes
                why = fh.unsupported(block.dim, block.num_heads, n)
            why = why or fh.mlp_unsupported(block.dim, block.mlp.fc1.out_features,
                                            block.mlp_route(training), training)
        else:
            why = (wac.unsupported(n, block.dim, block.num_heads, training)
                   if block.use_pallas else None)
        return (("fused" if block.fuse else "unfused"), why) if why else None

    def forward(self, x, features_only: bool = False, generator: torch.Generator | None = None):
        """x: (B, H, W, 3) normalized image → logits (B, classes) f32, or one
        tensor per tier for a multitask head; ``features_only`` → (B, F) f32.
        ``generator`` draws the stochastic-depth masks in train mode."""
        b = x.shape[0]
        x = conv_nhwc(self.patch_embed, x.to(self.dtype)).contiguous()
        if self.patch_norm is not None:
            x = layer_norm(self.patch_norm, x)
        if self.absolute_pos_embed is not None:
            pos = self.absolute_pos_embed
            if x.shape[1:3] != pos.shape[1:3]:
                raise ValueError(
                    f"ape's position embedding is a {pos.shape[1]}x{pos.shape[2]} "
                    f"token grid ({pos.shape[1] * self.patch_embed.stride[0]} px) and this "
                    f"input's is {x.shape[1]}x{x.shape[2]} ({x.shape[1] * self.patch_embed.stride[0]}"
                    " px); as hvt, the port does not interpolate it")
            x = x + pos.to(x.dtype)
        remat = self.remat and self.training
        for name in self.layer_names:
            layer = getattr(self, name)
            if not isinstance(layer, SwinBlock):
                x = layer(x)
            elif remat:
                x = recompute(layer, x, generator)
            else:
                x = layer(x, generator)
        x = layer_norm(self.norm, x)
        x = x.reshape(b, -1, x.shape[-1]).mean(1).float()  # token average pool
        if features_only:
            return x
        if isinstance(self.head, MultitaskHead):
            return self.head(x)
        return F.linear(x, self.head.weight.float(), self.head.bias.float())


def _variant(embed_dim, depths, num_heads, window_size):
    def build(num_classes, *, blurpool: bool = False, dtype="bfloat16", **kwargs):
        del blurpool  # accepted for factory uniformity; swin has no blurpool
        kwargs.pop("bn_scale_init", None)
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        return SwinTransformerV2(num_classes=num_classes, embed_dim=embed_dim, depths=depths,
                                 num_heads=num_heads, window_size=window_size, dtype=dtype,
                                 **kwargs)

    return build


swinv2_tiny = _variant(96, (2, 2, 6, 2), (3, 6, 12, 24), 7)
swinv2_tiny_window8_256 = _variant(96, (2, 2, 6, 2), (3, 6, 12, 24), 8)
swinv2_tiny_window16_256 = _variant(96, (2, 2, 6, 2), (3, 6, 12, 24), 16)
swinv2_small = _variant(96, (2, 2, 18, 2), (3, 6, 12, 24), 7)
swinv2_base = _variant(128, (2, 2, 18, 2), (4, 8, 16, 32), 7)
swinv2_large = _variant(192, (2, 2, 18, 2), (6, 12, 24, 48), 7)
swinv2_large_window12_192 = _variant(192, (2, 2, 18, 2), (6, 12, 24, 48), 12)
swinv2_micro = _variant(16, (1, 1), (2, 4), 4)  # tests only
swinv2_micro_deep = _variant(16, (2, 4), (2, 4), 4)  # tests only
