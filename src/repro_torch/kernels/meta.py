"""Kernel launches on ``meta`` tensors: what a dry run sees of a kernel.

``launch/dryrun.py`` runs the model on ``meta`` tensors (shapes and types,
no storage).  There each kernel's entry point allocates what its CUDA
launch allocates (outputs and scratch, as empty meta tensors) and, in
place of the launch, calls :func:`launch`: the operator
``repro_torch::meta_launch``, which computes nothing and takes the
operations the kernel would do.  Its FLOP formula hands that number to
``torch.utils.flop_counter.FlopCounterMode``, which cannot see inside a
kernel launched through ``ctypes``.  The operator takes meta tensors
only: a CUDA operand launches the kernel, a CPU one runs the plain
version, and neither reaches it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula


@torch.library.custom_op("repro_torch::meta_launch", mutates_args=())
def _meta_launch(kernel: str, operands: list[torch.Tensor],
                 flops: int) -> None:
    raise RuntimeError(f"{kernel}: meta_launch takes meta tensors only")


@_meta_launch.register_fake
def _(kernel, operands, flops):
    return None


@register_flop_formula(torch.ops.repro_torch.meta_launch)
def _meta_launch_flops(kernel, operands, flops, *args, **kwargs) -> int:
    return flops


def launch(kernel: str, operands, flops: int) -> None:
    """Stands for one launch of ``kernel`` on meta ``operands`` (inputs,
    outputs and scratch), which does ``flops`` operations."""
    if any(t.device.type != "meta" for t in operands):
        raise ValueError(f"{kernel}: a meta launch takes meta tensors only")
    torch.ops.repro_torch.meta_launch(kernel, list(operands), int(flops))


def causal_pairs(S: int, window: int) -> int:
    """The (q, k) pairs a causal mask keeps in one row of heads: with a
    window W < S, the first W rows' triangle, then W keys a row."""
    W = window if 0 < window < S else S
    return W * (W + 1) // 2 + (S - W) * W
