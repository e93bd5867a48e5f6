"""Kernel stack of the port: plain oracles (``ref``), the hand-written CUDA
kernels (``distance``, ``update``, ``fused_step``, built by ``build``) and
their dispatch (``ops``)."""
