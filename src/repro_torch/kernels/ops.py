"""Public wrappers over the kernels, taking host arrays or tensors.

They run on ``device`` — the card unless the caller asks for the CPU — and
return tensors on it.  On the card the hand-written CUDA kernels run; on
the CPU their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codegen import UVM_TILE, UvmProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.ifunc_vm import ifunc_vm
from repro_torch.kernels.ring_poll import ring_poll


def uvm_execute(prog: UvmProgram, payload_tiles, externals, *,
                device="cuda") -> torch.Tensor:
    """Run ``prog`` over ``payload_tiles`` [n, T, T] with ``externals``, one
    [T, T] array per program symbol; returns [n, T, T] f32 on ``device``."""
    dev = resolve_device(device)
    if len(externals) != len(prog.symbols):
        raise ValueError(f"program needs {len(prog.symbols)} externals "
                         f"({prog.symbols}), got {len(externals)}")
    ext = (torch.stack([torch.as_tensor(e, dtype=torch.float32, device=dev)
                        for e in externals]) if len(externals)
           else torch.zeros(0, UVM_TILE, UVM_TILE, device=dev))
    payload = torch.as_tensor(payload_tiles, dtype=torch.float32, device=dev)
    return ifunc_vm(prog, payload.contiguous(), ext)


def mailbox_poll(slots, *, device="cuda") -> torch.Tensor:
    """Validate device mailbox slots -> int32 status per slot.  ``slots``
    holds uint32 words (a numpy array) or their int32 bit patterns (a
    tensor)."""
    dev = resolve_device(device)
    if isinstance(slots, np.ndarray):
        slots = torch.from_numpy(
            np.ascontiguousarray(slots, np.uint32).view(np.int32))
    return ring_poll(slots.to(dev).contiguous())
