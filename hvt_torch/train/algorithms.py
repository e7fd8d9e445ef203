"""Algorithm registry — port of ``hvt/train/algorithms.py``.

Parses every algorithm hvt's configs name (BlurPool, ChannelsLast, EMA,
GradientClipping, ProgressiveResizing, LabelSmoothing, PretrainedBackbone,
MixUp, CutMix, SAM, ColOut, RandAugment, StochasticDepth) into a settings
struct, which the Trainer, the train step and the model factory read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from hvt_torch.train.ema import EmaConfig


@dataclasses.dataclass(frozen=True)
class ProgressiveResizing:
    """Composer's schedule: hold ``initial_scale`` for ``delay_fraction`` of
    training, ramp linearly to 1.0, train at full size for the last
    ``finetune_fraction``; quantized to ``num_buckets`` steps above
    ``initial_scale``, so the step meets a few image sizes only."""

    initial_scale: float = 0.5
    delay_fraction: float = 0.4
    finetune_fraction: float = 0.2
    num_buckets: int = 4

    def scale_at(self, frac_of_training: float) -> float:
        t = frac_of_training
        if t < self.delay_fraction:
            s = self.initial_scale
        elif t > 1.0 - self.finetune_fraction:
            s = 1.0
        else:
            ramp = (t - self.delay_fraction) / max(
                1.0 - self.finetune_fraction - self.delay_fraction, 1e-9)
            s = self.initial_scale + ramp * (1.0 - self.initial_scale)
        width = (1.0 - self.initial_scale) / self.num_buckets
        if width <= 0:
            return 1.0
        k = round((s - self.initial_scale) / width)
        return min(1.0, self.initial_scale + k * width)


@dataclasses.dataclass
class AlgorithmSettings:
    blurpool: bool = False
    channels_last: bool = False  # NHWC is the port's layout already: a no-op
    ema: Optional[EmaConfig] = None
    label_smoothing: float = 0.0
    grad_clip_norm: Optional[float] = None
    progressive: Optional[ProgressiveResizing] = None
    mixup_alpha: Optional[float] = None
    cutmix_alpha: Optional[float] = None
    sam_rho: Optional[float] = None
    sam_interval: int = 1
    stochastic_depth_rate: Optional[float] = None  # read by the model factory
    pretrained_backbone: Optional[tuple[str, bool]] = None  # (checkpoint URI, strict)
    # without device: true, RandAugment/ColOut belong to the folder train
    # transform (hvt_torch.data.loader.build_transform); with it, the train
    # step runs them on the batch: (p_row, p_col), (depth, severity, stratified)
    colout_device: Optional[tuple[float, float]] = None
    randaugment_device: Optional[tuple[int, int, bool]] = None


def parse_algorithms(config) -> AlgorithmSettings:
    s = AlgorithmSettings()
    for algo in config.algorithms:
        cls, args = algo.cls, dict(algo.args)
        if cls == "BlurPool":
            s.blurpool = True
        elif cls == "ChannelsLast":
            s.channels_last = True
        elif cls == "EMA":
            s.ema = EmaConfig.from_args(args)
        elif cls == "LabelSmoothing":
            s.label_smoothing = float(args.get("smoothing", 0.1))
        elif cls == "GradientClipping":
            ctype = args.get("clipping_type", "norm")
            if ctype != "norm":
                raise ValueError(f"unsupported clipping_type {ctype!r}")
            s.grad_clip_norm = float(args.get("clipping_threshold", 1.0))
        elif cls == "ProgressiveResizing":
            s.progressive = ProgressiveResizing(
                initial_scale=float(args.get("initial_scale", 0.5)),
                delay_fraction=float(args.get("delay_fraction", 0.4)),
                finetune_fraction=float(args.get("finetune_fraction", 0.2)),
            )
        elif cls == "MixUp":
            s.mixup_alpha = float(args.get("alpha", 0.2))
        elif cls == "CutMix":
            s.cutmix_alpha = float(args.get("alpha", 1.0))
        elif cls == "SAM":
            s.sam_rho = float(args.get("rho", 0.05))
            s.sam_interval = int(args.get("interval", 1))
        elif cls == "StochasticDepth":
            s.stochastic_depth_rate = float(args.get("drop_rate", 0.1))
        elif cls == "PretrainedBackbone":
            s.pretrained_backbone = (str(args["checkpoint"]), bool(args.get("strict", False)))
        elif cls == "ColOut":
            if bool(args.get("device", False)):
                s.colout_device = (float(args.get("p_row", 0.05)), float(args.get("p_col", 0.05)))
        elif cls == "RandAugment":
            if bool(args.get("device", False)):
                depth = int(args.get("depth", 1))
                if depth > 0:
                    s.randaugment_device = (depth, int(args.get("severity", 9)),
                                            bool(args.get("stratified", True)))
        else:
            raise ValueError(f"unknown algorithm {cls!r}")
    return s

