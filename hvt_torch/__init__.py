"""hvt_torch — the PyTorch/CUDA port of hvt for NVIDIA Hopper (H100).

A second package beside the JAX reference ``hvt/``: it imports torch and
nothing of jax or hvt. Module names mirror hvt's. Every Pallas kernel on a
ported path is a hand-written CUDA kernel for sm_90a (``hvt_torch/ops/csrc``)
with a plain PyTorch version beside it; a CPU tensor takes the plain version,
a CUDA tensor the kernel.
"""
