#!/usr/bin/env python3
"""Count the kernel records torch.profiler loses on one card, once the
traces that ``chip_smoke.py`` takes before its model timings are done:

    python3 tools/profiler_loss.py [TRACES]     # default 40

Runs ``chip_smoke.py``'s phases 1-9 and 18 in its order, then takes
TRACES traces of ten ``ssd_scan`` calls at phase 11's shape ([48, 16,
256, 64], ds 128, B and C per row: four ``ssd_`` kernels a call) and
TRACES of twenty bf16 ``flash_fwd`` calls at [15, 4,096, 64], each as
``chip_smoke.device_ms`` takes one (CUDA activity only, a warm-up call
before); then as many again, each opening with one fill kernel on a
one-element tensor and a synchronize, to see whether the record lost is
the trace's first.  Prints one JSON line: per kernel and variant, the
traces that held every record, some of them and none, the records lost
in all, the fill records seen, and the median time a call two ways: the
records summed over the calls, and ``device_ms``'s mean a record times
its launches a call; then the card's ``nvidia-smi`` name and power
limit.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    traces = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from repro_torch.kernels.flash_attn import flash_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    C.phase_build(torch, smi)
    errs = C.phase_kernels(np, torch, dev)
    agg_err = C.phase_agg_kernel(np, torch, dev)
    C.phase_example(np, torch, dev)
    counts, rates, d = C.phase_full(np, torch, dev)
    C.phase_timings(np, torch, dev, d, counts, rates, errs)
    C.phase_breakdown(np, torch, d, d.src_ctx.handles["uvm_affine"], rates)
    del d
    C.phase_agg_example(np, torch, dev)
    agg_counts, agg_rates, d = C.phase_agg_full(np, torch, dev)
    C.phase_agg_timings(np, torch, dev, d, agg_counts, agg_rates, agg_err)
    del d
    C.phase_host_target(np, torch, dev)

    rng = np.random.default_rng(50)
    BH, S, hd, _ = C.FLASH_SHAPES[2]
    q, k, v = C.flash_inputs(np, torch, dev, rng, BH, S, hd, torch.bfloat16)
    x, la, Bm, Cm = C.ssd_inputs(np, torch, dev, rng, *C.SSD_SHAPES[1])
    cases = {"ssd_": (lambda: ssd_scan(x, la, Bm, Cm), 10, 4),
             "flash_fwd_wgmma_kernel": (
                 lambda: flash_fwd(q, k, v, scale=hd ** -0.5), 20, 1)}
    lead = torch.zeros(1, device=dev)
    out = {}
    for kernel, (fn, iters, per_call) in cases.items():
        want = iters * per_call
        for variant in ("plain", "after_fill"):
            seen, fills, summed, est = [], [], [], []
            for _ in range(traces):
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    if variant == "after_fill":
                        lead.fill_(1.0)
                        torch.cuda.synchronize()
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
                recs = [e for e in prof.events()
                        if e.device_type == DeviceType.CUDA]
                mine = [e for e in recs if kernel in e.name]
                by_name = {}
                for e in mine:
                    by_name.setdefault(e.name, []).append(
                        e.device_time_total)
                seen.append(len(mine))
                fills.append(sum("fill" in e.name.lower() for e in recs))
                summed.append(sum(e.device_time_total for e in mine)
                              / iters / 1e3)
                est.append(sum(statistics.fmean(t)
                               * max(1, round(len(t) / iters))
                               for t in by_name.values()) / 1e3
                           if by_name else None)
            good = [x for x in est if x is not None]
            out[f"{kernel} {variant}"] = {
                "records_a_trace": want, "traces": traces,
                "whole": sum(n == want for n in seen),
                "some": sum(0 < n < want for n in seen),
                "none": sum(n == 0 for n in seen),
                "lost": sum(want - n for n in seen),
                "fill_records": sum(fills) if variant == "after_fill"
                else None,
                "median_ms_sum_over_calls": statistics.median(summed),
                "median_ms_device_ms": statistics.median(good)
                if good else None}
    print(json.dumps({"card": smi, "after": "chip_smoke phases 1-9, 18",
                      "kernels": out,
                      "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main()
