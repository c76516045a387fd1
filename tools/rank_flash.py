#!/usr/bin/env python3
"""Time the flash kernels at the per-rank shapes of ``chip_smoke.py``'s
phase 27 (b) on one card:

    python3 tools/rank_flash.py [CHECKOUT]     # default: this repository

The train cells' shapes (``dryrun_train_flash_shapes``: one rank's rows
of a microbatch times its tile of the q heads over ``model``) take the
forward and both backward kernels in bf16, the prefill cells' shapes
(``dryrun_prefill_flash_shapes``) the forward alone, each through
``chip_smoke``'s ``flash_times`` / ``bwd_times``: device ms by
``torch.profiler``, wrapper ms by CUDA events, the plain version, the
bound and ``scaled_dot_product_attention``.  Ends with one JSON line of
every shape's record and the card's ``nvidia-smi`` name and power limit.
"""

import json
import pathlib
import subprocess
import sys


def main():
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as CS

    if not torch.cuda.is_available():
        sys.exit("rank_flash: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    CS.phase_build(torch, smi)
    rng = np.random.default_rng(39)
    out = {"smi": smi, "train": [], "prefill": []}
    for shape in dict.fromkeys(CS.dryrun_train_flash_shapes()):
        out["train"].append({"fwd": CS.flash_times(np, torch, dev, rng, shape),
                             **CS.bwd_times(np, torch, dev, rng, shape)})
    for shape in CS.dryrun_prefill_flash_shapes():
        out["prefill"].append(CS.flash_times(np, torch, dev, rng, shape))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
