"""Ops of the port: plain window-attention helpers and the CUDA kernels'
wrappers (``*_cuda`` modules; sources in ``csrc/``, built by ``_build``)."""
