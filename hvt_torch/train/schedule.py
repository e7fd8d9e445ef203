"""Durations and learning-rate schedules — port of ``hvt/train/schedule.py``.

The Composer time grammar ("36ep", "100ba", "0.5dur"; bare numbers are
batches) and its two schedulers, as step → multiplier-of-the-base-lr
functions. The multiplier stays separate from the lr because the decoupled
optimizers scale weight decay by the multiplier, not by the lr.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable

Schedule = Callable[[int], float]

_DURATION_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ep|ba|dur)\s*$")


@dataclasses.dataclass(frozen=True)
class Duration:
    value: float
    unit: str  # "ep" | "ba" | "dur"

    def to_steps(self, steps_per_epoch: int, total_steps: int | None = None) -> int:
        if self.unit == "ba":
            return int(self.value)
        if self.unit == "ep":
            return int(self.value * steps_per_epoch)
        if self.unit == "dur":
            if total_steps is None:
                raise ValueError("'dur' duration needs total_steps")
            return int(self.value * total_steps)
        raise ValueError(self.unit)


def parse_duration(text: str | int | float) -> Duration:
    """'36ep' → Duration(36, 'ep'); bare numbers mean batches."""
    if isinstance(text, (int, float)):
        return Duration(float(text), "ba")
    m = _DURATION_RE.match(text)
    if not m:
        raise ValueError(f"cannot parse duration {text!r} (want e.g. '36ep', '100ba')")
    return Duration(float(m.group(1)), m.group(2))


def cosine_with_warmup(warmup_steps: int, total_steps: int, alpha_f: float = 0.0) -> Schedule:
    """Linear warmup 0→1 over warmup_steps, then cosine 1→alpha_f over the
    remaining steps (Composer CosineAnnealingWithWarmupScheduler)."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return alpha_f + (1.0 - alpha_f) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def constant_with_warmup(warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        return min(step / max(warmup_steps, 1), 1.0)

    return schedule


def build_multiplier_schedule(scheduler_cfg, steps_per_epoch: int, total_steps: int) -> Schedule:
    """Config → step → multiplier schedule."""
    args = dict(scheduler_cfg.args)
    warmup = parse_duration(args.pop("t_warmup", "8ep")).to_steps(steps_per_epoch, total_steps)
    name = scheduler_cfg.name
    if name in ("CosineAnnealingWithWarmupScheduler", "cosine_with_warmup"):
        return cosine_with_warmup(warmup, total_steps, float(args.pop("alpha_f", 0.0)))
    if name in ("ConstantWithWarmupScheduler", "constant_with_warmup"):
        return constant_with_warmup(warmup)
    raise ValueError(f"unknown scheduler {name!r}")
