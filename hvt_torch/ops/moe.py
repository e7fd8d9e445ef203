"""Switch-MoE MLP — port of ``hvt/ops/moe.py``.

hvt's ``MoeMlp`` (Swin-MoE's settings: top-1 routing, a static capacity a
group, the Switch load-balancing loss) in PyTorch, with its parameters in
flax's own layout: ``router`` (C, E) in f32, ``w1`` (E, C, hidden), ``b1``
(E, hidden), ``w2`` (E, hidden, out), ``b2`` (E, out). That layout feeds
``torch.bmm`` with no transpose, and it keeps the optimizer's ``ndim > 1``
decay rule equal to hvt's (``b1`` and ``b2`` are 2-D, so both decay).

The forward computes what hvt's does (hvt/ops/moe.py:54-113), in its order
and dtypes: the input (B, ..., C) as groups = images of s tokens; router
logits in f32, softmax, argmax (the first index on ties, as ``jnp.argmax``);
the aux loss ``aux_weight · E · mean_g Σ_e f_e·P_e``; the capacity
``max(1, ceil(s / E · capacity_factor))`` from Python floats, so it follows
the map at every progressive-resizing bucket; each token's slot, its rank
among its image's tokens routed to its expert in raster order (a cumsum),
tokens at slot >= capacity dropped; the gate, the routed probability (0 for
a dropped token); each expert's two products in the compute dtype (x's),
its bias added after each product and the GELU exact; the output, the gate
in the compute dtype times the expert's output (0 for a dropped token).

Dispatch and combine go by index instead of hvt's one-hot einsums over a
(g, s, E, cap) tensor: each kept token is written into its (expert, image,
slot) row of the expert-major (E, g, cap, C) buffer (empty rows are zeros,
as hvt's), and each token's output is gathered back from its row. Each of
hvt's one-hot einsums has a single non-zero term per output element (a
copy, or gate·out), so the index form gives the same values in every dtype,
bf16 included. Every index is made on the device, without a host sync, and
none repeats (a token with no row gets one of its own past the buffer), so
neither backward accumulates into a shared row. The
MoE layer runs no kernel of its own: hvt computes it outside any Pallas
kernel, and the products here are ``torch.bmm``.

The aux loss is returned, not hidden: a training forward keeps its aux loss,
with its graph, on the module (:attr:`MoeMlp.aux`), and
:func:`moe_aux_loss` sums and clears those of a model for the train step (a
Python 0.0 for a model without MoE, as hvt's ``_forward``). A recomputation
under ``common.recompute`` (``remat``) keeps the first forward's (the flag
``recomputing``). An eval forward keeps none.

Expert parallelism (``parallel.TP_RULES`` shards ``w1``, ``b1``, ``w2`` and
``b2`` on dim 0 over the model group; ``parallel.shard_model_`` sets
``tp``), in hvt's layout: the model peers run the same images, so hvt's
``P(model, data)`` on the dispatched buffer is a local slice, not an
all-to-all. Each rank routes all of its images' tokens with the replicated
router, dispatches those whose expert it holds (E / model of them), runs
its experts, ``b2`` inside each gated output, and the model group sums the
combined outputs (:func:`~hvt_torch.parallel.reduce_from_model`). The
tokens fed to the experts and the gate pass through
:func:`~hvt_torch.parallel.copy_to_model`, so their gradients are the
group's sums, and the router's gradient comes out the same on every peer;
the aux loss, from the replicated probabilities, is not summed.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from hvt_torch import parallel


def _trunc02_(w: torch.Tensor, gen: torch.Generator) -> None:
    nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)


class MoeMlp(nn.Module):
    """hvt's ``MoeMlp``: ``num_experts`` two-layer GELU MLPs (C → hidden →
    out), each token routed to one; a drop-in for the transformer MLP on a
    (B, ..., C) input."""

    def __init__(self, dim: int, num_experts: int, hidden: int, out: int | None = None,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01):
        super().__init__()
        out = dim if out is None else out
        self.num_experts, self.capacity_factor, self.aux_weight = (
            num_experts, float(capacity_factor), float(aux_weight))
        self.router = nn.Parameter(torch.zeros(dim, num_experts))
        self.w1 = nn.Parameter(torch.zeros(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w2 = nn.Parameter(torch.zeros(num_experts, hidden, out))
        self.b2 = nn.Parameter(torch.zeros(num_experts, out))
        self.tp = False  # set by parallel.shard_model_: this rank holds a slice of the experts
        self.recomputing = False  # set by common.recompute: keep the first forward's aux
        self.aux: torch.Tensor | None = None  # the last training forward's aux loss
        self.last_aux: torch.Tensor | None = None  # the last one taken, detached
        self.kept: torch.Tensor | None = None  # (g, s) bool: its tokens within capacity

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """hvt's init, drawn from ``gen``: router, w1, w2 trunc_normal(0.02),
        biases zero."""
        for w in (self.router, self.w1, self.w2):
            _trunc02_(w, gen)
        self.b1.zero_()
        self.b2.zero_()

    def capacity(self, tokens: int) -> int:
        """hvt's static per-image capacity of an expert for ``tokens`` tokens."""
        return max(1, int(math.ceil(tokens / self.num_experts * self.capacity_factor)))

    def route(self, tokens: torch.Tensor, expert: torch.Tensor | None = None):
        """(g, s, C) tokens → (probs (g, s, E) f32, expert (g, s), slot (g, s),
        kept (g, s) bool, aux): hvt's routing, and its aux loss weighted.
        ``expert`` (g, s), where given, is taken in place of the argmax (a
        check that holds two computations of one model to one routing)."""
        e = self.num_experts
        probs = torch.softmax(tokens.float() @ self.router, dim=-1)
        if expert is None:
            expert = probs.argmax(-1)  # the first maximum on ties, as jnp.argmax
        onehot = F.one_hot(expert, e).to(torch.float32)
        aux = self.aux_weight * (e * (onehot.mean(1) * probs.mean(1)).sum(-1).mean())
        slot = (onehot.cumsum(1) - 1.0).gather(-1, expert[..., None]).squeeze(-1).long()
        return probs, expert, slot, slot < self.capacity(tokens.shape[1]), aux

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        g, m, s = shape[0], shape[-1], math.prod(shape[1:-1])
        tokens = x.reshape(g, s, m)
        probs, expert, slot, kept, aux = self.route(tokens)
        gate = probs.gather(-1, expert[..., None]).squeeze(-1) * kept  # 0 where dropped
        if self.training and not self.recomputing:
            self.aux, self.kept = aux, kept.detach()

        cdt = x.dtype
        local = self.w1.shape[0]  # the experts this rank holds: all of them without tp
        first = parallel.model_rank() * local if self.tp else 0
        cap = self.capacity(s)
        rows = local * g * cap
        index = torch.arange(g * s, device=x.device)
        mine = kept & (expert >= first) & (expert < first + local)
        # each token's row of the (local experts, g, cap) buffer; the others
        # (dropped, or another rank's expert) each a row of its own past it,
        # so that no index repeats, forward or backward
        row = (((expert - first) * g + index.view(g, s) // s) * cap + slot).reshape(-1)
        dest = torch.where(mine.reshape(-1), row, rows + index)
        flat = tokens.reshape(g * s, m)
        if self.tp:
            flat, gate = parallel.copy_to_model(flat), parallel.copy_to_model(gate)
        expert_in = flat.new_zeros(rows + g * s, m).index_put((dest,), flat)[:rows]
        expert_in = expert_in.view(local, g * cap, m)
        h = torch.bmm(expert_in, self.w1.to(cdt)) + self.b1.to(cdt)[:, None, :]
        y = torch.bmm(F.gelu(h), self.w2.to(cdt)) + self.b2.to(cdt)[:, None, :]
        y = torch.cat([y.reshape(rows, -1), y.new_zeros(g * s, y.shape[-1])])[dest]
        y = y * gate.to(cdt).reshape(-1, 1)
        if self.tp:
            y = parallel.reduce_from_model(y)
        return y.reshape(*shape[:-1], -1).to(x.dtype)

    def dropped_share(self) -> float:
        """The share of the last training forward's tokens over capacity."""
        return float((~self.kept).float().mean()) if self.kept is not None else 0.0


def moe_layers(model: nn.Module) -> list[tuple[str, MoeMlp]]:
    """The model's MoE layers by name, in the order hvt's ``aux_losses``
    collection lists them (its tree's keys, sorted)."""
    return sorted((n, m) for n, m in model.named_modules() if isinstance(m, MoeMlp))


def moe_aux_loss(model: nn.Module):
    """The sum of the aux losses the model's MoE layers kept in their last
    training forward, each cleared; a Python 0.0 when there is none (a
    model without MoE, or an eval forward), so that the step adds nothing
    to its graph, as hvt's ``_forward`` sums its ``aux_losses``."""
    total = 0.0
    for _, layer in moe_layers(model):
        if layer.aux is not None:
            total = total + layer.aux
            layer.last_aux, layer.aux = layer.aux.detach(), None
    return total
