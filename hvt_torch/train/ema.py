"""Exponential moving average of the weights — port of ``hvt/train/ema.py``
and the EMA half of ``hvt/train/state.py``, Composer-EMA compatible.

The reference recipe (configs/pretrain/inat21.yaml) sets half_life 100ba and
update_interval 20ba: each update multiplies the average by
decay = 0.5^(interval / half_life) and adds (1 − decay)·weights, over the
parameters and the BatchNorm running statistics. hvt updates on the steps
where the state's step *before* the update is a multiple of the interval
(step 0, 20, 40, ...; hvt/train/step.py:218-231), from copies taken at init.
The step count lives on the host, so the update is a Python ``if`` around one
``torch._foreach_lerp_``: no device branch, no sync. Under tensor
parallelism the copies are taken from the model's shards, so each rank
averages its own (hvt's EMA tree mirrors the parameters' shardings); ZeRO-1
never splits them.
"""

from __future__ import annotations

import dataclasses

import torch

from hvt_torch.train.checkpoint import copy_into
from hvt_torch.train.schedule import parse_duration


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    half_life_steps: int = 100
    update_interval_steps: int = 20

    @classmethod
    def from_args(cls, args: dict) -> "EmaConfig":
        half = parse_duration(args.get("half_life", "100ba"))
        interval = parse_duration(args.get("update_interval", "20ba"))
        if half.unit != "ba" or interval.unit != "ba":
            raise ValueError("EMA half_life/update_interval must be in batches ('ba')")
        return cls(int(half.value), int(interval.value))

    @property
    def decay(self) -> float:
        return 0.5 ** (self.update_interval_steps / self.half_life_steps)


def batch_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's BatchNorm running statistics by state-dict name: hvt's
    ``batch_stats`` collection (empty for a model without BatchNorm)."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


class Ema:
    """Averaged copies of a model's parameters (``params``) and running
    statistics (``batch_stats``), each a {state-dict name: tensor} taken when
    the Ema is made, on the model's device."""

    def __init__(self, cfg: EmaConfig, model: torch.nn.Module):
        self.cfg = cfg
        live_params = dict(model.named_parameters())
        live_stats = batch_stats(model)
        self.params = {n: p.detach().clone() for n, p in live_params.items()}
        self.batch_stats = {n: b.detach().clone() for n, b in live_stats.items()}
        self._live = [p.detach() for p in live_params.values()] + list(live_stats.values())
        self._avg = list(self.params.values()) + list(self.batch_stats.values())
        self.updates = 0

    @torch.no_grad()
    def update(self, step: int) -> bool:
        """e ← decay·e + (1 − decay)·live for every tensor when ``step`` (the
        count of updates before this one) is a multiple of the interval;
        True if it updated."""
        if step % self.cfg.update_interval_steps:
            return False
        torch._foreach_lerp_(self._avg, self._live, 1.0 - self.cfg.decay)
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"params": self.params, "batch_stats": self.batch_stats, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        """Copies into the averaged tensors in place: ``update`` averages into
        the tensors it listed at init, so swapping in new ones would leave it
        averaging into stale copies. Every name and shape must match."""
        copy_into(self.params, state["params"], "EMA params")
        copy_into(self.batch_stats, state["batch_stats"], "EMA batch_stats")
        self.updates = int(state["updates"])
