"""State carried across from the JAX package, as plain numpy arrays.

These functions take and give numpy arrays, never objects of the JAX
package, so this module imports nothing of it: a caller holding a
reference program, external table, mailbox, parameter dict or cache hands
over its arrays.  bfloat16 arrays (numpy's ``ml_dtypes`` type, which
``torch.from_numpy`` does not read) cross as their 16-bit patterns.
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


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array as a tensor of the same type (bfloat16 included) on
    ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_numpy(cfg, flat: dict, device="cuda") -> dict:
    """The reference's flat parameter dict (``s{slot}_{name}`` keys, numpy
    arrays) as the port's tensors on ``device``, each in its own type.  The
    names and shapes must be those of ``param_specs(cfg)``."""
    from repro_torch.models.transformer import param_specs

    specs = param_specs(cfg)
    if set(flat) != set(specs):
        raise KeyError(f"parameter names differ from param_specs: missing "
                       f"{sorted(set(specs) - set(flat))}, extra "
                       f"{sorted(set(flat) - set(specs))}")
    out = {}
    for name, (shape, _) in specs.items():
        t = tensor_from_numpy(flat[name], device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"parameter {name}: shape {tuple(t.shape)}, "
                             f"want {tuple(shape)}")
        out[name] = t
    return out


def cache_from_numpy(cache: dict, device="cuda") -> dict:
    """A cache dict of numpy arrays as tensors on ``device``."""
    return {k: tensor_from_numpy(v, device) for k, v in cache.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A cache dict of tensors as numpy arrays (bfloat16 widened to
    float32, which holds every bfloat16 value exactly)."""
    out = {}
    for k, t in cache.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[k] = t.numpy().copy()
    return out
