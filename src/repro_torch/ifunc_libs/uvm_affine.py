"""μVM ifunc: y = relu(x @ W) over 128x128 payload tiles.

Device-tier code kind (``IFUNC_KIND = "uvm"``): the frame carries the
assembled μVM program; a device-mesh target runs it through the
``ifunc_vm`` kernel with W bound from the target's external table (the
device GOT).
"""

import numpy as np
import torch

from repro_torch.core.codegen import assemble

IFUNC_KIND = "uvm"

UVM_PROGRAM = assemble([
    ("loadp", 0),            # r0 <- payload tile
    ("loade", 1, 0),         # r1 <- external 0 ("W", resident on target)
    ("matmul", 2, 0, 1),
    ("relu", 2, 2),
    ("store", 0, 2),
], symbols=("W",))


def uvm_affine_main(payload, payload_size, target_args):
    """Host-side execution (targets normally link the shipped program
    instead of calling this).  Runs where ``target_args["device"]`` says,
    the card by default."""
    from repro_torch.kernels import ops as K

    tiles = np.frombuffer(payload, np.float32).reshape(-1, 128, 128)
    ext = [np.asarray(target_args["externals"]["W"], np.float32)]
    out = K.uvm_execute(UVM_PROGRAM, tiles, ext,
                        device=target_args.get("device", "cuda"))
    target_args["result"] = out
    return out


def _host_f32(source_args) -> np.ndarray:
    """The tiles as a contiguous f32 numpy array.  A tensor (on any
    device: a μVM stage's result on the card, forwarded by the flow
    layer) is copied to the host once; the bytes are those
    ``np.asarray(value, np.float32)`` gives."""
    if isinstance(source_args, torch.Tensor):
        return source_args.detach().to("cpu", torch.float32).contiguous() \
            .numpy()
    return np.ascontiguousarray(np.asarray(source_args, np.float32))


def uvm_affine_payload_get_max_size(source_args, source_args_size):
    if isinstance(source_args, torch.Tensor):
        return source_args.numel() * 4          # no copy to size it
    return np.asarray(source_args, np.float32).nbytes


def uvm_affine_payload_init(payload, payload_size, source_args,
                            source_args_size):
    raw = _host_f32(source_args)
    n = raw.nbytes
    payload[:n] = memoryview(raw).cast("B")
    return n
