"""State carried across from the JAX package, as plain numpy arrays.

These functions take and give numpy arrays, never objects of the JAX
package, so this module imports nothing of it: a caller holding a
reference program, external table or mailbox hands over its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codegen import UVM_TILE, UvmProgram
from repro_torch.device import resolve_device


def uvm_program_from_arrays(opcode, dst, a, b, imm, n_ext: int,
                            symbols=()) -> UvmProgram:
    """A μVM program from its five instruction arrays (``[P]`` each)."""
    arrs = [np.asarray(x, np.int32).copy() for x in (opcode, dst, a, b)]
    return UvmProgram(*arrs, np.asarray(imm, np.float32).copy(),
                      n_ext=int(n_ext), symbols=tuple(symbols))


def externals_from_numpy(ext, device="cuda") -> torch.Tensor:
    """The device GOT ``[n_shards, n_ext, T, T]`` float32 on ``device``."""
    ext = np.asarray(ext, np.float32)
    if ext.ndim != 4 or ext.shape[2:] != (UVM_TILE, UVM_TILE):
        raise ValueError(f"externals must be [n_shards, n_ext, {UVM_TILE}, "
                         f"{UVM_TILE}], got {ext.shape}")
    return torch.from_numpy(np.ascontiguousarray(ext)).to(
        resolve_device(device))


def mailbox_from_numpy(mb_u32, device="cuda") -> torch.Tensor:
    """A uint32 mailbox array as the int32 tensor of the same bits."""
    mb = np.ascontiguousarray(mb_u32)
    if mb.dtype != np.uint32:
        raise TypeError(f"mailbox words must be uint32, got {mb.dtype}")
    return torch.from_numpy(mb.view(np.int32).copy()).to(
        resolve_device(device))


def mailbox_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`mailbox_from_numpy`: the int32 tensor's bits as a
    uint32 array on the host."""
    if t.dtype != torch.int32:
        raise TypeError(f"mailbox tensor must be int32, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32).copy()
