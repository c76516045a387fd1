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
from repro_torch.kernels.ssd_scan import ssd_scan


def uvm_execute(prog: UvmProgram, payload_tiles, externals, *,
                device="cuda") -> torch.Tensor:
    """Run ``prog`` over ``payload_tiles`` [n, T, T] with ``externals``, one
    [T, T] array per program symbol; returns [n, T, T] f32 on ``device``.
    A contiguous f32 tensor already on ``device`` (a resident weight) is
    used where it lies: a single external is viewed as the table, never
    copied."""
    dev = resolve_device(device)
    if len(externals) != len(prog.symbols):
        raise ValueError(f"program needs {len(prog.symbols)} externals "
                         f"({prog.symbols}), got {len(externals)}")
    ext = [torch.as_tensor(e, dtype=torch.float32, device=dev).contiguous()
           for e in externals]
    ext = (ext[0].unsqueeze(0) if len(ext) == 1 else torch.stack(ext)
           if ext else torch.zeros(0, UVM_TILE, UVM_TILE, device=dev))
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


def ssd_scan_op(x, la, Bm, Cm, *, device="cuda") -> torch.Tensor:
    """[BH,nc,Q,hd] chunked SSD (the kernel path of ``models/ssm.py``) on
    f32 copies of host arrays or tensors; ``Bm`` and ``Cm`` are
    [G,nc,Q,ds] with G dividing BH (G = BH, or one group per batch row)."""
    dev = resolve_device(device)
    return ssd_scan(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in (x, la, Bm, Cm)))
