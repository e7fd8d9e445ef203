"""Device-side batch preparation — ``DevicePrep.normalize`` and the targets
(``one_hot``, ``smooth_labels``, ``prepare_targets``) of ``hvt/data/device.py``.
MixUp, CutMix, ColOut and progressive resizing are not ported (ROADMAP.md
queue 1, item 4)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def scale_channel_stats(mean: tuple[float, ...], std: tuple[float, ...]):
    """×255 when stats are given in [0, 1], since batches are uint8 0-255."""
    if all(m < 1 for m in mean):
        mean = tuple(m * 255.0 for m in mean)
    if all(s < 1 for s in std):
        std = tuple(s * 255.0 for s in std)
    return mean, std


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
        mean = torch.tensor(self.mean, dtype=torch.float32, device=images.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=images.device)
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
