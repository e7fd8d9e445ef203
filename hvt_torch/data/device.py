"""Device-side batch preparation — port of ``hvt/data/device.py``.

``DevicePrep.normalize``, the targets (``one_hot``, ``smooth_labels``,
``prepare_targets``), MixUp, CutMix, ColOut and progressive resizing, as
plain PyTorch on the batch's device (hvt writes them as ``jnp`` code inside
its jitted step, outside any Pallas kernel).

Each augmentation is split into *draws* and *apply*. A ``draw_*`` function
takes its random numbers on the batch's device from the caller's
``torch.Generator`` (never a host sync); the apply function is a pure
function of the tensors and the draws, so the tests feed it the draws
hvt's ``jax.random`` code makes and compare pixels. The draws follow hvt's
laws in distribution: λ ~ Beta(α, α), CutMix's centre uniform over the
pixels, ColOut's kept rows and columns a uniform subset of exactly
``h - round(p·h)`` and ``w - round(p·w)`` per image.

Resizing follows ``jax.image.resize(method="linear")``: separable weights
built as ``jax.image.scale_and_translate`` builds them (a triangle kernel
on half-pixel centres, widened by 1/scale when downsampling, so
antialiased), in f32, once per (size, size, device, dtype), applied as two
contractions in the image's dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F


def scale_channel_stats(mean: tuple[float, ...], std: tuple[float, ...]):
    """×255 when stats are given in [0, 1], since batches are uint8 0-255."""
    if all(m < 1 for m in mean):
        mean = tuple(m * 255.0 for m in mean)
    if all(s < 1 for s in std):
        std = tuple(s * 255.0 for s in std)
    return mean, std


@functools.lru_cache(maxsize=16)
def _constant(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """An f32 vector on ``device``, copied there once: a copy from pageable
    host memory at every step would wait for the device's queue."""
    return torch.tensor(values, dtype=torch.float32).to(device)


@dataclasses.dataclass(frozen=True)
class DevicePrep:
    """Normalization constants + compute dtype for on-device prep."""

    mean: tuple[float, ...]
    std: tuple[float, ...]
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_config(cls, data_cfg, precision_cfg) -> "DevicePrep":
        mean, std = scale_channel_stats(tuple(data_cfg.channel_mean), tuple(data_cfg.channel_std))
        return cls(mean=mean, std=std, compute_dtype=getattr(torch, precision_cfg.compute_dtype))

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 NHWC → (x − mean)/std in f32, cast to the compute dtype, on
        the images' device."""
        mean = _constant(self.mean, images.device)
        std = _constant(self.std, images.device)
        return ((images.float() - mean) / std).to(self.compute_dtype)


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).to(dtype)


def smooth_labels(onehot: torch.Tensor, smoothing: float) -> torch.Tensor:
    """(1-s)·onehot + s/n."""
    n = onehot.shape[-1]
    return onehot * (1.0 - smoothing) + smoothing / n


def prepare_targets(labels: torch.Tensor, num_classes: int | tuple[int, ...],
                    smoothing: float = 0.0, dtype=torch.float32):
    """int labels → (smoothed) one-hot (B, C); a multitask tuple of class
    counts gets one per tier, from the (B, tiers) labels, each smoothed on
    its own."""
    if isinstance(num_classes, tuple):
        out = []
        for tier, n in enumerate(num_classes):
            oh = one_hot(labels[:, tier], n, dtype)
            out.append(smooth_labels(oh, smoothing) if smoothing else oh)
        return out
    oh = one_hot(labels, num_classes, dtype)
    return smooth_labels(oh, smoothing) if smoothing else oh


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

BETA_CANDIDATES = 64  # Jöhnk proposals a draw; all rejected: (1/2)^64 at α = 1


def draw_beta(generator: torch.Generator, alpha: float, device) -> torch.Tensor:
    """λ ~ Beta(α, α) as an f32 scalar on ``device``, by Jöhnk's method in
    log space over a fixed number of proposals (the first accepted is
    taken), so the draw needs no host sync and takes a fixed count of
    numbers from ``generator``."""
    u = 1.0 - torch.rand((2, BETA_CANDIDATES), generator=generator, device=device,
                         dtype=torch.float64)  # in (0, 1]
    x, y = torch.log(u) / alpha
    s = torch.logaddexp(x, y)
    first = torch.argmax((s <= 0).to(torch.int32))
    return torch.exp(x - s)[first].to(torch.float32)


def draw_cutmix(generator: torch.Generator, alpha: float, h: int, w: int, device):
    """(λ, cy, cx): λ ~ Beta(α, α), the box centre uniform over the pixels."""
    lam = draw_beta(generator, alpha, device)
    cy = torch.randint(0, h, (), generator=generator, device=device)
    cx = torch.randint(0, w, (), generator=generator, device=device)
    return lam, cy, cx


def colout_keep(h: int, w: int, p_row: float, p_col: float) -> tuple[int, int]:
    """Rows and columns ColOut keeps: ``round(p·n)`` dropped, at least one kept."""
    return max(1, h - int(round(p_row * h))), max(1, w - int(round(p_col * w)))


def draw_colout(generator: torch.Generator, b: int, h: int, w: int, p_row: float,
                p_col: float, device) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """Each image's kept rows (B, keep_h) and columns (B, keep_w), sorted, a
    uniform subset each; None when the rounding drops nothing."""
    keep_h, keep_w = colout_keep(h, w, p_row, p_col)
    if keep_h >= h and keep_w >= w:
        return None

    def keep(n, k):
        order = torch.rand((b, n), generator=generator, device=device).argsort(dim=1)
        return order[:, :k].sort(dim=1).values

    return keep(h, keep_h), keep(w, keep_w)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def mixup(images: torch.Tensor, onehot, lam: torch.Tensor):
    """MixUp with one coefficient and the batch rolled by one; targets per
    tier for multitask (a list)."""
    mixed = (lam.to(images.dtype) * images
             + (1.0 - lam).to(images.dtype) * torch.roll(images, 1, dims=0))

    def mix_target(t):
        return lam * t + (1.0 - lam) * torch.roll(t, 1, dims=0)

    if isinstance(onehot, list):
        return mixed, [mix_target(t) for t in onehot]
    return mixed, mix_target(onehot)


def cutmix(images: torch.Tensor, onehot, lam: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """CutMix: paste a box of the rolled batch (side sqrt(1-λ) of the image's,
    centred at (cy, cx), clipped to the image); targets mix by its area."""
    _, h, w, _ = images.shape
    cut_ratio = torch.sqrt(1.0 - lam)
    cut_h = (cut_ratio * h).to(torch.int32)
    cut_w = (cut_ratio * w).to(torch.int32)
    y0 = torch.clamp(cy - cut_h // 2, 0, h)
    y1 = torch.clamp(cy + cut_h // 2, 0, h)
    x0 = torch.clamp(cx - cut_w // 2, 0, w)
    x1 = torch.clamp(cx + cut_w // 2, 0, w)
    rows = torch.arange(h, device=images.device)[None, :, None, None]
    cols = torch.arange(w, device=images.device)[None, None, :, None]
    box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    mixed = torch.where(box, torch.roll(images, 1, dims=0), images)
    lam_eff = 1.0 - ((y1 - y0) * (x1 - x0)).to(torch.float32) / float(h * w)

    def mix_target(t):
        return lam_eff * t + (1.0 - lam_eff) * torch.roll(t, 1, dims=0)

    if isinstance(onehot, list):
        return mixed, [mix_target(t) for t in onehot]
    return mixed, mix_target(onehot)


def colout(images: torch.Tensor, draws: Optional[tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """ColOut on a uint8 NHWC batch: keep each image's drawn rows and columns,
    resize back to (H, W) linearly, round and clip to uint8."""
    if draws is None:
        return images
    rows, cols = draws
    b, h, w, c = images.shape
    x = torch.gather(images, 1, rows[:, :, None, None].expand(b, rows.shape[1], w, c))
    x = torch.gather(x, 2, cols[:, None, :, None].expand(b, rows.shape[1], cols.shape[1], c))
    x = resize(x.float(), h, w)
    return torch.clamp(torch.round(x), 0, 255).to(images.dtype)


def resized_size(size: int, scale: float) -> int:
    """A side under progressive resizing: scaled, rounded down to a multiple of 8, at least 8."""
    return max(8, (max(1, int(size * scale + 0.5)) // 8) * 8)


def progressive_resize(images: torch.Tensor, scale: float) -> torch.Tensor:
    """Downscale a normalized NHWC batch by ``scale`` (each side through
    :func:`resized_size`); identity at ``scale >= 1``."""
    if scale >= 1.0:
        return images
    _, h, w, _ = images.shape
    return resize(images, resized_size(h, scale), resized_size(w, scale))


@functools.lru_cache(maxsize=64)
def _weights_cpu(in_size: int, out_size: int) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, scale out/in and no translation: (in_size, out_size) f32."""
    scale = out_size / in_size
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0))
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


@functools.lru_cache(maxsize=64)
def _weights(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return _weights_cpu(in_size, out_size).to(device=device, dtype=dtype)


def resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, out_h, out_w, C), "linear")`` of an NHWC
    float batch, in x's dtype. The two contractions go in jax's order (the
    smaller intermediate first, H on a tie), so a bf16 batch rounds where
    hvt's does."""
    _, h, w, _ = x.shape

    def along_h(t):
        return t if out_h == h else torch.einsum(
            "bhwc,hk->bkwc", t, _weights(h, out_h, t.device, t.dtype))

    def along_w(t):
        return t if out_w == w else torch.einsum(
            "bhwc,wk->bhkc", t, _weights(w, out_w, t.device, t.dtype))

    return along_w(along_h(x)) if out_h * w <= h * out_w else along_h(along_w(x))
