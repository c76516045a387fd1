"""Hand-written CUDA kernels (sources in ``../csrc``), each beside its plain
PyTorch version: ``ring_poll``, ``agg_ring_poll`` and ``ifunc_vm`` for the
device lanes, ``flash_fwd`` and ``ssd_scan`` for the model stack."""
