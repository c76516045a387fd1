#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the script (non-zero exit, no result line):

1. environment: torch/CUDA versions, the card's name and power limit; the
   CUDA kernels build from ``src/repro_torch/csrc`` with nvcc for sm_90a;
2. every kernel of the main path against its plain PyTorch version on the
   card, at the main path's shapes: ``ring_poll`` bit-exact over a ring
   mixing every status, ``ifunc_vm`` on fixed programs (2e-5) and seeded
   random programs using every opcode (5e-4 on finite entries);
3. the example's shape end to end (8 shards x 2 slots x 2 tiles, shift 1)
   through ``Dispatcher`` -> ``DeviceMeshFabric``, held against
   relu(x @ W) of the neighbour's payload;
4. full width: 8 shards x 64 slots x 2 tiles of 128x128 f32 (512
   ``uvm_affine`` frames of 128 KiB, a 64 MiB mailbox) for 3 generations,
   then one corrupt frame (REJECTED) and one put whose generation lands
   before its trailer (IN_PROGRESS, then OK);
5. timings: each kernel by CUDA events beside its plain version, its
   bound and, where one exists, a PyTorch library call; the path's
   frames/s.
6. where a generation's time goes: host timers around the channel's put
   and the mailbox's publish and sweep in one more generation, and the
   card's busy time under torch.profiler in another.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's ``nvidia-smi`` name and power limit; before that the ``kernels``
JSON line.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

T, NT, SHARDS = 128, 2, 8          # tile, tiles per frame, shards
SLOTS_FULL, GENERATIONS = 64, 3    # full width: 8 x 64 slots, 3 generations
TOL_FIXED, TOL_RANDOM = 2e-5, 5e-4
TOL_PATH = dict(rtol=1e-4, atol=1e-5)

# Published peaks (NVIDIA data sheets; dense, no sparsity): device-memory
# bytes/s and FP32 FLOP/s outside the tensor cores.
PEAKS = [("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]

FIXED_PROGRAMS = {
    "affine_relu": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1), ("loade", 3, 1),
         ("add", 2, 2, 3), ("relu", 2, 2), ("store", 0, 2)], ("W", "b")),
    "gelu_scale": (
        [("loadp", 0), ("gelu", 1, 0), ("scale", 1, 1, 0, 0.25),
         ("store", 0, 1)], ()),
    "double_matmul": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1),
         ("matmul", 3, 2, 1), ("sub", 3, 3, 0), ("store", 0, 3)], ("W",)),
    "fma_chain": (
        [("loadp", 0), ("copy", 1, 0), ("fma", 1, 0, 0), ("tanh", 1, 1),
         ("addi", 1, 1, 0, 0.5), ("store", 0, 1)], ()),
}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters, repeats=5):
    """Median over ``repeats`` of the mean CUDA-event time of ``iters``
    back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def card_peaks(name):
    for key, bw, fp32 in PEAKS:
        if key in name:
            return bw, fp32
    raise SmokeError(f"no published peaks for card {name!r}")


def uvm_flops(prog, n_tiles):
    """FP32 operations the program performs on ``n_tiles`` tiles: 2T^3 per
    matmul, 2T^2 per fma, T^2 per other arithmetic op (loads, stores,
    copies, zeroing and halt compute nothing)."""
    from repro_torch.core.codegen import OPS

    inv = {v: k for k, v in OPS.items()}
    per_tile = 0
    for op in prog.opcode:
        name = inv[int(op)]
        if name == "matmul":
            per_tile += 2 * T ** 3
        elif name == "fma":
            per_tile += 2 * T * T
        elif name not in ("halt", "loadp", "loade", "store", "copy", "zero"):
            per_tile += T * T
    return per_tile * n_tiles


def random_program(rng, must, n_ops=12):
    """``loadp``, then the ops in ``must`` and random ones to ``n_ops`` in a
    shuffled order, each reading registers already written (``loade`` a
    random external), then a matmul with dst == a on the last register
    written, which is stored."""
    from repro_torch.core.codegen import OPS, assemble

    names = sorted(OPS)
    ops = list(must) + [names[int(i)] for i in
                        rng.integers(0, len(names), n_ops - len(must))]
    live, last = [0], 0
    instrs = [("loadp", 0)]
    for op in (ops[int(i)] for i in rng.permutation(len(ops))):
        a, b = (live[int(i)] for i in rng.integers(0, len(live), 2))
        d = int(rng.integers(0, 8))
        if op == "loade":
            a = int(rng.integers(0, 8))
        instrs.append((op, d, a, b, float(rng.uniform(-1.5, 1.5))))
        if op not in ("halt", "store"):
            live.append(d)
            last = d
    instrs += [("matmul", last, last, live[int(rng.integers(0, len(live)))]),
               ("store", 0, last)]
    return assemble(instrs, symbols=tuple(f"e{i}" for i in range(8)))


def conditioned(torch, prog, pay, ext, tol):
    """Whether float32 rounding alone keeps ``prog`` within a tenth of
    ``tol`` of its float64 result on ``pay``: only then does a
    disagreement between the kernel and the plain version, which sum in
    different orders, say something about the kernel."""
    from repro_torch.kernels.ifunc_vm import ifunc_vm_plain

    f32 = ifunc_vm_plain(prog, pay, ext)
    f64 = ifunc_vm_plain(prog, pay.double(), ext.double())
    fin = torch.isfinite(f64) & torch.isfinite(f32)
    err = (f32.double() - f64).abs()[fin]
    return bool((err <= 0.1 * tol * (1 + f64.abs()[fin])).all())


def phase_build(torch, smi):
    from repro_torch.kernels import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {smi}")
    out, secs = _build.build_all()
    log(f"built {len(_build.sources())} CUDA sources in {secs:.1f} s "
        f"into {out.relative_to(ROOT)}")
    for src in _build.sources():
        for line in (out / f"{src.stem}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src.stem}: {line.strip()}")


def make_ring(np, rng, n, W):
    """A uint32 ring of ``n`` slots mixing every status, and the status
    each slot must get."""
    from repro_torch.kernels.ring_poll import (BAD, EMPTY, HDR_WORDS,
                                               INFLIGHT, MAGIC, READY,
                                               TRAILER)

    ring = rng.integers(0, 2 ** 32, size=(n, W), dtype=np.uint32)
    want = np.zeros(n, np.int32)
    for i in range(n):
        kind = i % 8
        fw = int(rng.integers(0, W - HDR_WORDS))       # in bounds
        hdr = [MAGIC, fw, 3, int(rng.integers(0, 2 ** 32))]
        if kind == 0:                                  # all zero
            ring[i] = 0
            want[i] = EMPTY
            continue
        if kind == 1:                                  # magic 0, garbage
            ring[i, 0] = 0
            want[i] = EMPTY
            continue
        if kind == 6:                                  # fw past the slot,
            hdr[1] = 0xFFFFFFF0                        # negative as int32
        if kind == 7:
            hdr[1] = W - HDR_WORDS                     # one word too long
        chk = hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]
        if kind == 4:
            hdr[0] = MAGIC ^ 0x100                     # bad magic
        if kind == 5:
            chk ^= 1                                   # bad check word
        ring[i, :HDR_WORDS] = hdr + [chk]
        if kind in (4, 5, 6, 7):
            want[i] = BAD
        elif kind == 2:
            ring[i, HDR_WORDS + fw] = TRAILER
            want[i] = READY
        else:                                          # kind 3: no trailer
            ring[i, HDR_WORDS + fw] = 0
            want[i] = INFLIGHT
    return ring, want


def phase_kernels(np, torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.convert import mailbox_from_numpy
    from repro_torch.core.codegen import OPS, assemble
    from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain
    from repro_torch.kernels.ring_poll import (HDR_WORDS, ring_poll,
                                               ring_poll_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still enabled")
    rng = np.random.default_rng(0)
    n_slots = SHARDS * SLOTS_FULL
    W = HDR_WORDS + NT * T * T + 1
    ring_np, want = make_ring(np, rng, n_slots, W)
    ring = mailbox_from_numpy(ring_np, dev)
    got = ring_poll(ring)
    plain = ring_poll_plain(ring)
    torch.cuda.synchronize()
    rp_err = float((got - plain).abs().max().item())
    check(torch.equal(got, plain), "ring_poll kernel != plain version")
    check(np.array_equal(got.cpu().numpy(), want),
          "ring_poll kernel != the statuses the ring was built with")
    log(f"ring_poll: {n_slots} slots x {W} words bit-exact vs plain "
        f"(statuses {np.bincount(want, minlength=4).tolist()})")

    n_tiles = SHARDS * SLOTS_FULL * NT
    pay = torch.from_numpy(rng.standard_normal((n_tiles, T, T))
                           .astype(np.float32)).to(dev)
    errs = {}
    for name, (instrs, symbols) in sorted(FIXED_PROGRAMS.items()):
        prog = assemble(instrs, symbols=symbols)
        ext = torch.from_numpy(
            (rng.standard_normal((SHARDS, max(len(symbols), 1), T, T)) * 0.1)
            .astype(np.float32)).to(dev)
        out, ref = ifunc_vm(prog, pay, ext), ifunc_vm_plain(prog, pay, ext)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        check(torch.allclose(out, ref, rtol=TOL_FIXED, atol=TOL_FIXED),
              f"ifunc_vm {name}: max |err| {err:.3g} over {TOL_FIXED}")
        errs[name] = err
    log(f"ifunc_vm fixed programs, {n_tiles} tiles, max |err| vs plain: "
        + ", ".join(f"{k}={v:.3g}" for k, v in errs.items()))

    # seeded random programs, every opcode among them; a candidate enters
    # only if it is well conditioned on these inputs (see conditioned)
    ext8 = torch.from_numpy((rng.standard_normal((SHARDS, 8, T, T)) * 0.1)
                            .astype(np.float32)).to(dev)
    half = pay * 0.5
    names = list(np.random.default_rng(1).permutation(sorted(OPS)))
    n_prog, seed, worst, rejected = 8, 1000, 0.0, 0
    seen = set()
    for i in range(n_prog):
        must = names[i * len(names) // n_prog:(i + 1) * len(names) // n_prog]
        while True:
            seed += 1
            check(seed < 1400, "no well-conditioned random program found")
            prog = random_program(np.random.default_rng(seed), must)
            if conditioned(torch, prog, half, ext8, TOL_RANDOM):
                break
            rejected += 1
        seen.update(int(o) for o in prog.opcode)
        out = ifunc_vm(prog, half, ext8)
        ref = ifunc_vm_plain(prog, half, ext8)
        torch.cuda.synchronize()
        fin = torch.isfinite(ref)
        check(torch.equal(fin, torch.isfinite(out)),
              f"ifunc_vm random program {seed}: finite entries differ")
        diff = (out[fin] - ref[fin]).abs()
        check(bool((diff <= TOL_RANDOM * (1 + ref[fin].abs())).all()),
              f"ifunc_vm random program {seed}: max |err| "
              f"{diff.max().item():.3g} over {TOL_RANDOM}")
        worst = max(worst, diff.max().item() if diff.numel() else 0.0)
    check(seen == set(OPS.values()),
          f"random programs miss opcodes {set(OPS.values()) - seen}")
    log(f"ifunc_vm {n_prog} random programs (every opcode among them, each "
        f"ending in a matmul with dst == a; {rejected} ill-conditioned "
        f"candidates skipped), max |err| on finite entries {worst:.3g}")
    return {"ring_poll": rp_err, "ifunc_vm": max(max(errs.values()), worst)}


def build_path(np, torch, dev, n_slots, flush_threshold=8):
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       ProgressEngine)

    src = Context("host-source")
    handle = register_ifunc(src, "uvm_affine")
    rng = np.random.default_rng(n_slots)
    Ws = (rng.standard_normal((SHARDS, T, T)) * 0.05).astype(np.float32)
    d = Dispatcher(src, ProgressEngine(flush_threshold=flush_threshold,
                                       inflight_window="trailer"))
    d.add_peer("gpu-mesh", DeviceMeshFabric(SHARDS, shift=1, device=dev),
               None, n_slots=n_slots, slot_size=(NT * T * T + 64) * 4,
               prog=deserialize_uvm(handle.lib.code), n_tiles=NT,
               externals=Ws[:, None])
    return d, handle, torch.from_numpy(Ws).to(dev), rng


def expected(torch, pays, Ws, n_slots, dev):
    """relu(x @ W) where frame k, staged at (k % S, k // S), lands one shard
    along: result (s, j) holds frame 8j + (s-1) % 8 run against W[s]."""
    x = torch.from_numpy(pays).to(dev)                    # [n, NT, T, T]
    want = []
    for s in range(SHARDS):
        for j in range(n_slots):
            k = SHARDS * j + (s - 1) % SHARDS
            want.append(torch.relu(x[k] @ Ws[s]))
    return want


def check_results(torch, got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} results, want "
                                 f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == (NT, T, T) and bool(torch.isfinite(g).all()),
              f"{what}: result {i} shape {tuple(g.shape)} or not finite")
        check(torch.allclose(g, w, **TOL_PATH),
              f"{what}: result {i} max |err| "
              f"{(g - w).abs().max().item():.3g}")


def reset_counts():
    from repro_torch.kernels.ifunc_vm import ifunc_vm
    from repro_torch.kernels.ring_poll import ring_poll

    ring_poll.launches = ifunc_vm.launches = 0


def read_counts():
    from repro_torch.kernels.ifunc_vm import ifunc_vm
    from repro_torch.kernels.ring_poll import ring_poll

    return {"ring_poll": ring_poll.launches, "ifunc_vm": ifunc_vm.launches}


def phase_example(np, torch, dev):
    d, h, Ws, rng = build_path(np, torch, dev, n_slots=2)
    pays = rng.standard_normal((SHARDS, NT, T, T)).astype(np.float32)
    reset_counts()
    send_generation(d, h, pays)
    counts = read_counts()
    check(min(counts.values()) > 0, f"example: kernels not launched {counts}")
    got = d.peers["gpu-mesh"].target_args["results"]
    check_results(torch, got, expected(torch, pays, Ws, 1, dev), "example")
    log(f"example shape {SHARDS} shards x 2 slots x {NT} tiles: {SHARDS} "
        f"frames match relu(x[(d-1) % 8] @ W[d]); launches {counts}")


def phase_full(np, torch, dev):
    """The main path at full width; returns (launch counts, timings)."""
    from repro_torch.core import ifunc_msg_create

    d, h, Ws, rng = build_path(np, torch, dev, n_slots=SLOTS_FULL)
    peer = d.peers["gpu-mesh"]
    mb = peer.rings[0].mailbox
    n = SHARDS * SLOTS_FULL
    gens = [rng.standard_normal((n, NT, T, T)).astype(np.float32)
            for _ in range(GENERATIONS)]
    torch.cuda.synchronize()
    reset_counts()
    rates = []
    for g, pays in enumerate(gens):
        send_s, drain_s, create_s = send_generation(d, h, pays)
        rates.append((send_s, drain_s, create_s))
        res = peer.target_args["results"][g * n:(g + 1) * n]
        check_results(torch, res, expected(torch, pays, Ws, SLOTS_FULL, dev),
                      f"generation {g}")
        log(f"generation {g}: {n} frames, send {send_s:.4f} s (of which "
            f"ifunc_msg_create {create_s:.4f} s), drain {drain_s:.4f} s, "
            f"{n / (send_s + drain_s):.1f} frames/s")
    counts = read_counts()
    check(min(counts.values()) > 0, f"main path: kernels not launched "
                                    f"{counts}")
    check(peer.credits == n, f"credits {peer.credits} after drain, want {n}")
    check(int(mb._mb.abs().sum().item()) == 0, "mailbox not cleared")

    # one corrupt frame: its check word flipped while staged
    n_res = len(peer.target_args["results"])
    x = rng.standard_normal((NT, T, T)).astype(np.float32)
    check(d.send("gpu-mesh", ifunc_msg_create(h, x)), "send refused")
    shard, idx = mb.slot_coords(peer.rings[0].tail - 1)
    mb._staged[shard, idx, 4] ^= 1
    d.drain()
    check(peer.stats["rejected"] == 1, "corrupt frame not REJECTED")
    check(len(peer.target_args["results"]) == n_res,
          "corrupt frame produced a result")

    # one put whose generation lands before its trailer: IN_PROGRESS, then
    # the flush writes the trailer in place and the frame runs
    check(d.send("gpu-mesh", ifunc_msg_create(h, x)), "send refused")
    mb.publish()
    polls0 = peer.stats["inflight_polls"]
    check(d.poll() == 0, "partial put consumed before its trailer")
    check(peer.stats["inflight_polls"] == polls0 + 1, "no IN_PROGRESS poll")
    check(d.drain() == 1, "partial put not delivered after flush")
    shard, idx = mb.slot_coords(peer.rings[0].tail - 1)
    want = torch.relu(torch.from_numpy(x).to(dev)
                      @ Ws[(shard + 1) % SHARDS])
    check(torch.allclose(peer.target_args["results"][-1], want, **TOL_PATH),
          "partial put result wrong")
    log(f"corrupt frame -> REJECTED; partial put -> IN_PROGRESS then OK; "
        f"main-path launches {counts}")
    return counts, rates, d


def phase_timings(np, torch, dev, d, counts, rates, errs):
    from repro_torch.convert import mailbox_from_numpy
    from repro_torch.core.device_mailbox import (make_deposit, make_sweep,
                                                 pack_word_frame)
    from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain
    from repro_torch.kernels.ring_poll import (HDR_WORDS, ring_poll,
                                               ring_poll_plain)

    name = torch.cuda.get_device_name(0)
    bw, fp32 = card_peaks(name)
    rng = np.random.default_rng(7)
    peer = d.peers["gpu-mesh"]
    mb = peer.rings[0].mailbox
    prog = mb.prog
    n_slots = SHARDS * SLOTS_FULL
    n_tiles = n_slots * NT
    W = HDR_WORDS + NT * T * T + 1

    # a full ring of READY frames, as the main path's sweep sees it
    words = np.stack([pack_word_frame(
        rng.standard_normal(NT * T * T).astype(np.float32), W)
        for _ in range(n_slots)]).reshape(SHARDS, SLOTS_FULL, W)
    ring = mailbox_from_numpy(words, dev)
    flat = ring.reshape(n_slots, W)
    rp_ms = cuda_ms(torch, lambda: ring_poll(flat), 200)
    rp_plain = cuda_ms(torch, lambda: ring_poll_plain(flat), 50)
    rp_bytes = n_slots * (HDR_WORDS + 1) * 4 + n_slots * 4
    rp_bound = rp_bytes / bw * 1e3

    pay = ring[:, :, HDR_WORDS:HDR_WORDS + NT * T * T].contiguous() \
        .view(torch.float32).reshape(n_tiles, T, T)
    ext = mb.externals
    out, ref = ifunc_vm(prog, pay, ext), ifunc_vm_plain(prog, pay, ext)
    vm_err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=TOL_FIXED, atol=TOL_FIXED),
          f"ifunc_vm uvm_affine max |err| {vm_err:.3g}")
    vm_ms = cuda_ms(torch, lambda: ifunc_vm(prog, pay, ext), 20)
    vm_plain = cuda_ms(torch, lambda: ifunc_vm_plain(prog, pay, ext), 10)
    x4 = pay.view(SHARDS, n_tiles // SHARDS, T, T)
    w4 = ext[:, 0][:, None]
    lib = torch.relu(torch.matmul(x4, w4)).reshape(n_tiles, T, T)
    check(torch.allclose(out, lib, rtol=1e-4, atol=1e-5),
          "library yardstick disagrees with the kernel")
    vm_lib = cuda_ms(torch, lambda: torch.relu(torch.matmul(x4, w4)), 20)
    vm_flops = uvm_flops(prog, n_tiles)
    vm_bytes = (pay.numel() + out.numel() + ext.numel()) * 4
    vm_bound_ops = vm_flops / fp32 * 1e3
    vm_bound_bytes = vm_bytes / bw * 1e3
    vm_bound = max(vm_bound_ops, vm_bound_bytes)

    # the sweep and the deposit around the kernels, same ring
    sweep = make_sweep(prog, NT)
    sw_ms = cuda_ms(torch, lambda: sweep(ring, ext), 20)
    deposit = make_deposit(SHARDS)
    dp_ms = cuda_ms(torch, lambda: deposit(ring, ring, 1), 20)
    h2d_ms = cuda_ms(torch, lambda: torch.from_numpy(
        words.view(np.int32)).to(dev), 5)

    kernels = [
        {"name": "ring_poll", "route": "cuda",
         "source": "src/repro_torch/csrc/ring_poll.cu",
         "replaces": "src/repro/kernels/ring_poll.py:54",
         "launches": counts["ring_poll"], "max_abs_err": errs["ring_poll"],
         "ms": rp_ms, "plain_ms": rp_plain, "bound_ms": rp_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "ifunc_vm", "route": "cuda",
         "source": "src/repro_torch/csrc/ifunc_vm.cu",
         "replaces": "src/repro/kernels/ifunc_vm.py:94",
         "launches": counts["ifunc_vm"],
         "max_abs_err": max(vm_err, errs["ifunc_vm"]),
         "ms": vm_ms, "plain_ms": vm_plain, "bound_ms": vm_bound,
         "bound_by": ("operations" if vm_bound_ops >= vm_bound_bytes
                      else "bytes"),
         "library_ms": vm_lib},
    ]
    log(f"ring_poll {n_slots} slots: {rp_ms:.4f} ms (plain {rp_plain:.4f}, "
        f"bound {rp_bound:.3g} ms by {rp_bytes} B)")
    log(f"ifunc_vm uvm_affine {n_tiles} tiles: {vm_ms:.4f} ms (plain "
        f"{vm_plain:.4f}, torch.relu(torch.matmul) {vm_lib:.4f}, bound "
        f"{vm_bound:.4f} ms: {vm_flops / 1e9:.3f} GFLOP -> "
        f"{vm_bound_ops:.4f} ms, {vm_bytes / 2 ** 20:.0f} MiB -> "
        f"{vm_bound_bytes:.4f} ms); {vm_flops / vm_ms / 1e9:.2f} TFLOP/s")
    log(f"sweep (ring_poll + body copy + ifunc_vm + mask + clear) "
        f"{sw_ms:.4f} ms; deposit {dp_ms:.4f} ms; staged generation H2D "
        f"{h2d_ms:.4f} ms ({words.nbytes / 2 ** 20:.0f} MiB)")
    tot = sum(s + dr for s, dr, _ in rates)
    log(f"path: {n_slots * len(rates)} frames in {tot:.3f} s = "
        f"{n_slots * len(rates) / tot:.1f} frames/s through Dispatcher.drain")
    return kernels


def send_generation(d, h, pays):
    """Send one generation of frames and drain it, ending in a
    synchronize; returns the host seconds of (send, drain, of which
    ifunc_msg_create)."""
    import torch
    from repro_torch.core import ifunc_msg_create

    create = 0.0
    t0 = time.perf_counter()
    for p in pays:
        c0 = time.perf_counter()
        msg = ifunc_msg_create(h, p)
        create += time.perf_counter() - c0
        check(d.send("gpu-mesh", msg), "send refused")
    t1 = time.perf_counter()
    got = d.drain()
    torch.cuda.synchronize()
    check(got == len(pays), f"drained {got} of {len(pays)} frames")
    return t1 - t0, time.perf_counter() - t1, create


def phase_breakdown(np, torch, d, h, rates):
    """Where a generation's time goes, from two more generations of the
    main path: one with host timers around the channel's put and the
    mailbox's publish and sweep (a traced run, apart from the untraced
    ones phase 4 reports), one under torch.profiler for the card's busy
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    peer = d.peers["gpu-mesh"]
    lanes = {"put": peer.rings[0].channel, "publish": peer.rings[0].mailbox,
             "sweep": peer.rings[0].mailbox}
    spent = dict.fromkeys(lanes, 0.0)

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    rng = np.random.default_rng(11)
    n = SHARDS * SLOTS_FULL
    for key, obj in lanes.items():
        setattr(obj, key, timed(key, getattr(obj, key)))
    try:
        send_s, drain_s, create = send_generation(
            d, h, rng.standard_normal((n, NT, T, T)).astype(np.float32))
    finally:
        for key, obj in lanes.items():
            delattr(obj, key)               # back to the class's method
    total = send_s + drain_s
    wall = statistics.median(a + b for a, b, _ in rates)
    log(f"host breakdown of one traced generation: ifunc_msg_create "
        f"{create:.4f} s, put (transcode + stage) {spent['put']:.4f} s, "
        f"publish (H2D + deposit) {spent['publish']:.4f} s, sweep "
        f"{spent['sweep']:.4f} s, the rest (dispatcher, engine, slab "
        f"copies) {total - create - sum(spent.values()):.4f} s; total "
        f"{total:.4f} s (untraced median {wall:.4f} s)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        send_generation(
            d, h, rng.standard_normal((n, NT, T, T)).astype(np.float32))
    # device-side records only: the CPU-side op that launched a copy or a
    # kernel carries the same device time again; "Activity Buffer
    # Request" is the profiler's own
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not events:
        log("card busy time: not measured (torch.profiler recorded no "
            "device time)")
        return
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    copy_s = sum(e.device_time_total for e in copies) / 1e6
    kern_s = sum(e.device_time_total for e in events) / 1e6 - copy_s
    by_name = {}
    for e in events:
        if e not in copies:
            by_name[e.name[:48]] = (by_name.get(e.name[:48], 0.0)
                                    + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"card per generation (torch.profiler, {len(events)} device "
        f"records): kernels {kern_s:.4f} s, so the SMs sit idle "
        f"{1 - kern_s / wall:.4f} of the untraced {wall:.4f} s; copies "
        f"{copy_s:.4f} s ({len(copies)}); most kernel time: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in top))


def main():
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        raise SmokeError("src/repro_torch not found beside chip_smoke.py: "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this script runs only on "
                         "a GPU")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    phase_build(torch, smi)
    errs = phase_kernels(np, torch, dev)
    phase_example(np, torch, dev)
    counts, rates, d = phase_full(np, torch, dev)
    kernels = phase_timings(np, torch, dev, d, counts, rates, errs)
    phase_breakdown(np, torch, d, d.src_ctx.handles["uvm_affine"], rates)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
