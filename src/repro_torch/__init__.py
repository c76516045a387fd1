"""PyTorch + CUDA port of ``repro``, the ifunc remote-function-injection
system, for one NVIDIA H100.

The layout follows ``repro`` module for module (``core/``, ``transport/``,
``kernels/``); the hand-written CUDA kernels live in ``csrc/``.  The
package imports ``torch``, ``numpy`` and the standard library only —
nothing of ``jax`` and nothing of ``repro``.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
