"""Mesh construction — the reference's ``repro.launch.mesh`` in PyTorch.

Importing this module starts no process group.  ``make_host_mesh``
initialises a one-rank group itself when none exists (NCCL on the card,
gloo on the CPU, over an in-process ``HashStore``, so it needs no port);
a multi-rank run initialises its group before calling it.
"""

from __future__ import annotations

import datetime

import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import make_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_one_rank_group(device="cuda", timeout_s: float = 300.0) -> None:
    """A one-rank default process group: NCCL for the card, gloo for the
    CPU.  ``destroy_process_group`` tears it down."""
    dev = resolve_device(device)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=timeout_s))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh, (16, 16) ("data", "model") or
    (2, 16, 16) ("pod", "data", "model"), over an initialised group of
    256 or 512 ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    want = 1
    for n in shape:
        want *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != want:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'pod'} mesh "
                         f"{shape} needs {want} ranks; the process group has "
                         f"{have}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(device="cuda"):
    """A (world size, 1) ("data", "model") mesh over the default group,
    initialising a one-rank group first if none exists."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_one_rank_group(dev)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                     device=dev)
