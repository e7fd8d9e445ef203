"""Device choice for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """None → the current CUDA device, and an error when there is none: an
    entry point never drifts to the CPU on its own. Pass ``device="cpu"`` to
    run there (the plain versions of the kernels)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: hvt_torch runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
