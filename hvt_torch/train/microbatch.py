"""``grad_accum: "auto"`` — port of ``hvt/train/microbatch.py``.

hvt lowers candidate train steps and reads XLA's compile-time memory
analysis, doubling the microbatch count until the step fits the device. The
port measures instead: ``measure(accum)`` is the peak device memory of the
step's gradient pass as the step runs it (every microbatch of the batch, the
gradients summed across them and, with SAM, the parameter copy and the second
pass), plus the optimizer state the first update will allocate, and an
out-of-memory error in the probe reads as "does not fit". :func:`choose_grad_accum`, the doubling itself, is hvt's
own, copied. On the CPU no limit is known, and it resolves to 1, as hvt's
does without one.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import torch

log = logging.getLogger(__name__)


def choose_grad_accum(
    measure: Callable[[int], Optional[float]],
    batch_size: int,
    limit_bytes: Optional[int],
    *,
    headroom: float = 0.92,
    max_accum: Optional[int] = None,
) -> int:
    """Smallest power-of-two accumulation whose step fits in memory (hvt's
    ``choose_grad_accum``, hvt/train/microbatch.py:63).

    measure(accum) returns the candidate step's byte requirement (or None
    when unknowable). Candidates must divide batch_size; max_accum defaults
    to batch_size itself.
    """
    if limit_bytes is None:
        log.info("grad_accum auto: no device memory limit reported; using 1")
        return 1
    budget = headroom * limit_bytes
    cap = max_accum or batch_size
    accum = 1
    while True:
        need = measure(accum)
        if need is None:
            log.info("grad_accum auto: no memory analysis available; using %d", accum)
            return accum
        if need <= budget:
            log.info(
                "grad_accum auto: %d microbatches (%.2f GiB of %.2f GiB budget)",
                accum, need / 2**30, budget / 2**30,
            )
            return accum
        nxt = accum * 2
        while nxt <= cap and batch_size % nxt:
            nxt *= 2
        if nxt > cap:
            raise MemoryError(
                f"train step needs {need / 2**30:.2f} GiB per device even at "
                f"grad_accum={accum} (budget {budget / 2**30:.2f} GiB); "
                "reduce global_batch_size or the model size"
            )
        log.info(
            "grad_accum auto: %d microbatches need %.2f GiB > %.2f GiB budget; "
            "trying %d", accum, need / 2**30, budget / 2**30, nxt,
        )
        accum = nxt


def device_bytes_limit(device: torch.device) -> Optional[int]:
    """The card's total memory (``torch.cuda.mem_get_info``), or None off the
    card."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def optimizer_state_bytes(optimizer) -> int:
    """Bytes of state the optimizer's first update will allocate on this
    rank, beyond what it holds already: two f32 moments per parameter (its
    TP shard, its ZeRO-1 slice) for adamw, one momentum trace otherwise
    (``Optimizer.state_bytes``)."""
    return optimizer.state_bytes()


def probe_step(model: torch.nn.Module, run: Callable[[], None]) -> None:
    """``run()``, a forward and backward of ``model`` in train mode, done so
    that it leaves the model as it found it: parameters' gradients, buffers
    (BatchNorm running statistics) and the training flag. ``run`` draws from
    its own generator and puts back any parameter it moves (SAM)."""
    training = model.training
    buffers = {name: b.detach().clone() for name, b in model.named_buffers()}
    grads = {name: p.grad for name, p in model.named_parameters()}
    try:
        for p in model.parameters():
            p.grad = None  # backward() would accumulate into a held gradient in place
        model.train()
        run()
    finally:
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(buffers[name])
        for name, p in model.named_parameters():
            p.grad = grads[name]
        model.train(training)


def probe_peak_bytes(model, run, device: torch.device) -> float:
    """Peak device memory of :func:`probe_step` of ``run``; inf where the
    card runs out of memory."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        probe_step(model, run)
        torch.cuda.synchronize(device)
        return float(torch.cuda.max_memory_allocated(device))
    except torch.cuda.OutOfMemoryError:
        return math.inf
    finally:
        torch.cuda.empty_cache()
