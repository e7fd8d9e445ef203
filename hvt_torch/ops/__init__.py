"""Ops of the port: plain window-attention helpers, the Switch-MoE layer
(``moe``, plain PyTorch as hvt's) and the CUDA kernels' wrappers (``*_cuda``
modules; sources in ``csrc/``, built by ``_build``)."""
