"""Optimizers with Composer semantics — port of ``hvt/train/optim.py``.

hvt builds optax chains; :class:`Optimizer` is a ``torch.optim.Optimizer``
that repeats their arithmetic step for step (optax's, not torch's defaults):

* ``sgd`` — Nesterov momentum with *coupled* decay (wd·p added to the
  gradient before the momentum trace), as torch.optim.SGD;
* ``adamw`` — decoupled decay scaled by the full lr: p −= lr·(adam + wd·p);
* ``decoupledadamw`` / ``decoupledsgdw`` — Composer's variants, whose decay
  is scaled by the schedule *multiplier*, not the lr: p −= lr·u + wd·mult·p;
* gradient clipping first, as ``optax.clip_by_global_norm``: grads times
  max/‖g‖ when ‖g‖ ≥ max (torch's ``clip_grad_norm_`` divides by ‖g‖ + 1e-6).

The lr of update t (counting from 0) is lr·multiplier(t), so a warmup's
first update does not move the weights, as in optax. Weight decay applies to
a parameter iff it has more than one dimension and its name holds none of
the model's no-decay substrings (hvt's ``decay_mask``). Updates are batched
with ``torch._foreach_*``, allocate one temporary per Adam group (the
denominator) and never synchronise with the host. Clipping scales ``p.grad``
in place, as ``clip_grad_norm_`` does, so after ``step()`` it holds the
clipped gradient.

Under tensor parallelism (:mod:`hvt_torch.parallel`) a sharded parameter's
moments are its shard's, and the global norm counts each sharded
gradient's squares summed over the model group and each replicated one
once. With ``zero`` (ZeRO-1, hvt's ``mesh.zero``: ``tp_shardings(...,
zero=True)``, ``zero_update_shardings`` and ``constrain_tx_updates``,
hvt/parallel.py:340-440) and a data group of more than one rank, every
parameter that the TP rules do not match and that has a dim the data size
divides (``parallel.zero_split``) keeps only its slice of the state: the
update runs elementwise on the slices of the parameter and of the full,
summed gradient, then one all-gather over the data group a bucket puts the
whole parameter back on every rank. ``state_dict`` gathers every moment to
its full tensor and ``load_state_dict`` slices it back, so a checkpoint does
not depend on the grid.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from hvt_torch import parallel
from hvt_torch.train.schedule import Schedule

NAMES = ("sgd", "adamw", "decoupledadamw", "decoupledsgdw")
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adamw / scale_by_adam defaults


def decay_mask(named_params: Iterable[tuple[str, torch.Tensor]],
               no_decay_substrings: Iterable[str] = ()) -> dict[str, bool]:
    """{name: True where weight decay applies}: ndim > 1 and no skip substring."""
    skip = tuple(no_decay_substrings)
    return {name: p.ndim > 1 and not any(s in name for s in skip) for name, p in named_params}


def _bias_correction(decay: float, t: int) -> float:
    """1 − decay^t in f32, as optax computes it (at t = 1, f32's 1 − 0.999
    is 1.3e-5 off the exact 0.001, which moves every Adam update)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


def global_norm(tensors: list[torch.Tensor], sharded: Optional[list[bool]] = None
                ) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over all tensors, in f32. Where ``sharded`` marks a
    tensor as a TP shard its squares are summed over the model group: each
    full tensor counts once."""
    norms = torch._foreach_norm(tensors)
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms).float())
    whole = [n.float() for n, s in zip(norms, sharded) if not s]
    parts = torch.stack([n.float() for n, s in zip(norms, sharded) if s])
    total = parallel.model_all_reduce_(parts.square().sum())
    if whole:
        total = total + torch.stack(whole).square().sum()
    return total.sqrt()


def tp_sharded(params) -> list[bool]:
    """Which of ``params`` are TP shards (``parallel.shard_model_`` marks them)."""
    return [getattr(p, "tp_dim", None) is not None for p in params]


class Optimizer(torch.optim.Optimizer):
    """One of :data:`NAMES` at base ``lr``, with the schedule ``multiplier``
    (step → factor of lr) and optional clipping. ``step()`` returns the
    global norm of the raw gradients, as a tensor on their device."""

    def __init__(self, named_params, name: str, lr: float, weight_decay: float,
                 momentum: float, multiplier: Schedule, *,
                 grad_clip_norm: Optional[float] = None,
                 no_decay_substrings: Iterable[str] = (), zero: bool = False):
        name = name.lower()
        if name not in NAMES:
            raise ValueError(f"unknown optimizer {name!r}")
        named_params = [(n, p) for n, p in named_params if p.requires_grad]
        mask = decay_mask(named_params, no_decay_substrings)
        groups = [{"params": [p for n, p in named_params if mask[n] == decay], "decay": decay}
                  for decay in (True, False)]
        super().__init__([g for g in groups if g["params"]], {})
        self.name, self.lr, self.weight_decay, self.momentum = name, lr, weight_decay, momentum
        self.multiplier = multiplier
        self.grad_clip_norm = grad_clip_norm
        self.count = 0  # updates taken: hvt's state.step (the schedule's step, Adam's t)
        self.data, self.data_rank = parallel.world(), parallel.rank()
        # ZeRO-1: the dim of each parameter's state split over the data group, or None
        self.zero = bool(zero) and self.data > 1
        self.split = {p: parallel.zero_split(n, p.shape, self.data) if self.zero else None
                      for n, p in named_params}
        self.tp_dims = {p: getattr(p, "tp_dim", None) for _, p in named_params}

    def _mine(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t``, a tensor of p's shape, as ZeRO-1 splits
        p's state: dense, a view where the slice is contiguous."""
        dim = self.split[p]
        if dim is None:
            return t
        return parallel.shard(t, dim, self.data_rank, self.data).contiguous()

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("hvt_torch's Optimizer takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads, tp_sharded(params))
        if self.grad_clip_norm is not None:
            limit = self.grad_clip_norm
            torch._foreach_mul_(grads, torch.where(norm < limit, 1.0, limit / norm))
        mult = float(self.multiplier(self.count))
        lr, wd, t = self.lr * mult, self.weight_decay, self.count + 1
        start = 0
        gathers = []  # ZeRO-1: (parameter, its updated slice, dim)
        for group in self.param_groups:
            full = group["params"]
            ps = [self._mine(p.data, p) for p in full]
            gs = [self._mine(g, p) for g, p in zip(grads[start:start + len(full)], full)]
            start += len(full)
            gathers += [(p.data, s, self.split[p]) for p, s in zip(full, ps)
                        if self.split[p] is not None]
            decay = group["decay"] and wd != 0.0
            if self.name in ("adamw", "decoupledadamw"):
                mus = self._state(full, ps, "mu")
                nus = self._state(full, ps, "nu")
                torch._foreach_mul_(mus, _B1)
                torch._foreach_add_(mus, gs, alpha=1.0 - _B1)
                torch._foreach_mul_(nus, _B2)
                torch._foreach_addcmul_(nus, gs, gs, value=1.0 - _B2)
                # (mu/bc1) / (sqrt(nu/bc2) + eps)
                #   = (sqrt(bc2)/bc1) · mu / (sqrt(nu) + eps·sqrt(bc2))
                root_bc2 = math.sqrt(_bias_correction(_B2, t))
                denom = torch._foreach_sqrt(nus)
                torch._foreach_add_(denom, _EPS * root_bc2)
                if decay:  # adamw: p −= lr·wd·p; decoupled: p −= wd·mult·p
                    torch._foreach_mul_(ps, 1.0 - wd * (lr if self.name == "adamw" else mult))
                step_size = lr * root_bc2 / _bias_correction(_B1, t)
                torch._foreach_addcdiv_(ps, mus, denom, value=-step_size)
            else:
                if decay and self.name == "sgd":
                    gs = torch._foreach_add(gs, ps, alpha=wd)
                traces = self._state(full, ps, "trace")
                torch._foreach_mul_(traces, self.momentum)
                torch._foreach_add_(traces, gs)
                upd = traces
                if self.name == "sgd":  # Nesterov: g + momentum·trace
                    upd = torch._foreach_add(gs, traces, alpha=self.momentum)
                if decay and self.name == "decoupledsgdw":
                    torch._foreach_mul_(ps, 1.0 - wd * mult)
                torch._foreach_add_(ps, upd, alpha=-lr)
        parallel.all_gather_slices_(gathers)
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """torch's state dict (mu/nu or the momentum trace per parameter,
        the groups) with ``count``, which sets the lr multiplier, Adam's bias
        corrections and the EMA's interval: a resume without it would restart
        warmup and bias correction at t = 1. Each moment is the full
        tensor: ZeRO-1 slices gathered over the data group and TP shards
        over the model group (every rank of the grid must call it)."""
        out = super().state_dict()
        params = [p for g in self.param_groups for p in g["params"]]
        state = {}
        for index, moments in out["state"].items():
            p = params[index]
            state[index] = {k: self._full(v, p) for k, v in moments.items()}
        return {**out, "state": state, "count": self.count}

    def _full(self, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        dim = self.split[p]
        if dim is not None:
            every = parallel.all_gather(t, parallel.data_group())
            t = every.movedim(0, dim).reshape(*t.shape[:dim], -1, *t.shape[dim + 1:])
        if self.tp_dims[p] is not None:
            t = parallel.gather_full(t, self.tp_dims[p])
        return t

    def load_state_dict(self, state_dict: dict) -> None:
        """A :meth:`state_dict` (full moments, from any grid) sliced to this
        rank's layout."""
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        for p, moments in self.state.items():
            for k, v in moments.items():
                if self.tp_dims[p] is not None:
                    v = parallel.shard(v, self.tp_dims[p], parallel.model_rank(),
                                       parallel.model_size())
                moments[k] = self._mine(v, p).clone()

    def _state(self, params, mine, key: str) -> list[torch.Tensor]:
        """Each parameter's ``key`` moment, made at zero like its slice
        ``mine`` on first use."""
        out = []
        for p, m in zip(params, mine):
            state = self.state[p]
            if key not in state:
                state[key] = torch.zeros_like(m, memory_format=torch.preserve_format)
            out.append(state[key])
        return out

    def state_bytes(self) -> int:
        """Bytes of state the first update allocates on this rank (0 once it
        has): two moments of each parameter's slice for adamw, one trace
        otherwise."""
        if self.state:
            return 0
        slots = 2 if self.name in ("adamw", "decoupledadamw") else 1
        total = 0
        for p, dim in self.split.items():
            total += p.numel() * p.element_size() // (1 if dim is None else self.data)
        return slots * total


def build_optimizer(model: torch.nn.Module, optim_cfg, multiplier: Schedule, *,
                    grad_clip_norm: Optional[float] = None,
                    no_decay_substrings: Iterable[str] = (), zero: bool = False) -> Optimizer:
    """Config → :class:`Optimizer` over the model's parameters."""
    return Optimizer(model.named_parameters(), optim_cfg.name, float(optim_cfg.lr),
                     float(optim_cfg.weight_decay), float(optim_cfg.momentum), multiplier,
                     grad_clip_norm=grad_clip_norm, no_decay_substrings=no_decay_substrings,
                     zero=zero)
