#!/usr/bin/env python3
"""Run the host-bound phases of one checkout's ``chip_smoke.py`` on one
card: the singleton device lane at full width (phase 4), the host target
(18), the Dispatcher's host lanes (19) and result futures (20), each
logging its rates as the whole script does:

    python3 tools/host_phases.py [CHECKOUT]     # default: this repository

Comparing two checkouts means running both in one chip call, in turns
(parent, change, change, parent), each in its own process: the host and
the card's power limit differ from call to call.
"""

import pathlib
import subprocess
import sys
import time


def main():
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1])
    sys.path[:0] = [str(root), str(root / "src")]
    import numpy as np
    import torch

    import chip_smoke as C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    C.phase_build(torch, smi)
    t0 = time.perf_counter()
    _, _, d = C.phase_full(np, torch, dev)
    del d
    host = C.phase_host_target(np, torch, dev)
    mp = C.phase_multi_peer(np, torch, dev, host["rate"])
    C.phase_futures(np, torch, dev, mp["rates"], smi)
    print(f"host phases of {root} on {smi}: {time.perf_counter() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
