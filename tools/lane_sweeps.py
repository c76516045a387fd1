#!/usr/bin/env python3
"""Time the device lanes' sweeps of one checkout of the port on one card,
the same way whatever the checkout's sweep does inside:

    python3 tools/lane_sweeps.py [CHECKOUT]     # default: this repository

For each lane, at ``chip_smoke.py``'s full width (singleton 8 shards x 64
slots x 2 tiles; aggregate 8 x 4 slots x K = 64 one-tile records), a
``uvm_affine`` sweep built by the checkout's ``make_sweep`` /
``make_agg_sweep`` over two rings: every slot READY ("full"), and one
READY slot a shard, as one deposit of 8 lands them ("path").  The ring is
restored from a pristine copy before each call, outside the timed
window, since a sweep may clear it in place.  Printed per case: the
device time of all the kernels of one sweep under ``torch.profiler``,
the kernels a sweep and their names, and the median CUDA-event time of
one call.  Comparing two checkouts means running both in one chip call:
the host and the card's power limit differ from call to call.
"""

import json
import pathlib
import statistics
import subprocess
import sys

T, SHARDS = 128, 8
LANES = {"ring": (64, 2, 0), "agg": (4, 1, 64)}   # slots a shard, tiles, K
ITERS = 20


def main():
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.device_mailbox import (make_agg_sweep, make_sweep,
                                                 pack_agg_word_frame,
                                                 pack_word_frame)
    from repro_torch.ifunc_libs.uvm_affine import UVM_PROGRAM
    from repro_torch.kernels.ring_poll import HDR_WORDS

    if not torch.cuda.is_available():
        sys.exit("lane_sweeps: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ext = torch.from_numpy((rng.standard_normal((SHARDS, 1, T, T)) * 0.05)
                           .astype(np.float32)).to(dev)
    rows = []
    for lane, (slots, nt, k) in LANES.items():
        if k:
            W = HDR_WORDS + 2 * k + k * nt * T * T + 1
            frames = [pack_agg_word_frame(
                list(rng.standard_normal((k, nt * T * T)).astype(np.float32)),
                [0] * k, k, nt * T * T, W) for _ in range(SHARDS * slots)]
            sweep = make_agg_sweep(UVM_PROGRAM, k, nt)
        else:
            W = HDR_WORDS + nt * T * T + 1
            frames = [pack_word_frame(
                rng.standard_normal(nt * T * T).astype(np.float32), W)
                for _ in range(SHARDS * slots)]
            sweep = make_sweep(UVM_PROGRAM, nt)
        full = torch.from_numpy(np.stack(frames).view(np.int32)).to(dev)
        full = full.view(SHARDS, slots, W)
        for case in ("full", "path"):
            pristine = full if case == "full" else torch.zeros_like(full)
            pristine[:, 0] = full[:, 0]
            ring = pristine.clone()
            sweep(ring, ext)
            pairs = []
            for _ in range(ITERS):
                ring.copy_(pristine)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                sweep(ring, ext)
                b.record()
                pairs.append((a, b))
            torch.cuda.synchronize()
            event_ms = statistics.median(a.elapsed_time(b) for a, b in pairs)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    ring.copy_(pristine)
                    sweep(ring, ext)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == DeviceType.CUDA and not
                       e.name.startswith(("Memcpy", "Memset", "Activity"))]
            names = sorted({e.name.replace("(anonymous namespace)::", "")
                            .removeprefix("void ").split("(")[0][:48]
                            for e in kernels})
            rows.append({
                "tree": root.name, "lane": lane, "case": case,
                "ready_slots": SHARDS * (slots if case == "full" else 1),
                "slots": SHARDS * slots,
                "device_ms": sum(e.device_time_total for e in kernels)
                / ITERS / 1e3,
                "kernels_a_sweep": len(kernels) / ITERS,
                "event_ms": event_ms, "kernel_names": names})
            print(f"{root.name} {lane} {case}: {rows[-1]['device_ms']:.4f} "
                  f"ms device, {rows[-1]['kernels_a_sweep']:g} kernels a "
                  f"sweep, events {event_ms:.4f} ms; {names}", flush=True)
        del full, pristine, ring
    print(smi)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
