"""Hand-written CUDA kernels (sources in ``../csrc``), each beside its plain
PyTorch version: ``ring_poll`` and ``ifunc_vm``."""
