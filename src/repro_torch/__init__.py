"""Big-means on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that mirrors its layout module for
module.  The JAX package is the reference: every ported function is held
against its counterpart by the ``tests/test_torch_*.py`` parity tests.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro``.  Its entry points (``api.fit``, ``api.evaluate``,
``api.serve``, ``core.big_means``, ``core.big_means_batched``,
``engine.incore.sequential``, ``engine.incore.batched_local``) run on the
CUDA device unless the caller passes ``device="cpu"``; the CPU runs the
kernels' plain PyTorch versions.
The four hand-written CUDA kernels of the sequential and batched paths
live in ``kernels/csrc`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`).
"""
