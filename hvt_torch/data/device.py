"""Device-side batch preparation — ``DevicePrep.normalize`` of ``hvt/data/device.py``."""

from __future__ import annotations

import dataclasses

import torch


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
