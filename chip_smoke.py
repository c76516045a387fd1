#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the script (non-zero exit, no result line):

1. environment: torch/CUDA versions, the card's name and power limit; the
   CUDA kernels build from ``src/repro_torch/csrc`` with nvcc for sm_90a,
   each kernel's ptxas registers and spills logged (the tensor-core
   ``*_wgmma_kernel``s must not spill);
2. every kernel of both paths against its plain PyTorch version on the
   card, at the paths' shapes: ``ring_poll`` bit-exact over a ring mixing
   every status, ``agg_ring_poll`` bit-exact over aggregate rings mixing
   every container and sub status (K = 4 and 64, a high-bit bound hash
   and bound 0), ``ifunc_vm`` on fixed programs (2e-5) and seeded random
   programs using every opcode (5e-4 on finite entries), each logged with
   the variant its plan takes; both variants (``ifunc_vm_smem_kernel``,
   ``ifunc_vm_global_kernel``) must have run; the fused sweeps
   (``ring_sweep_*_kernel`` over a singleton ring of every status at 512
   slots x 2 tiles, both plan variants; ``agg_sweep_*_kernel`` over the
   aggregate rings above) against their plain versions: statuses, sub
   statuses and the cleared ring bit for bit, the outputs that ran bit
   for bit equal to ``ifunc_vm_slots`` and within 2e-5 of the plain
   version, +0.0 elsewhere, INFLIGHT and EMPTY slots untouched;
3. the singleton lane at the example's shape (8 shards x 2 slots x 2
   tiles, shift 1) through ``Dispatcher`` -> ``DeviceMeshFabric``, held
   against relu(x @ W) of the neighbour's payload; the lane launches the
   fused ``ring_sweep`` and no standalone poll or ``ifunc_vm`` kernel;
4. the singleton lane at full width: 8 shards x 64 slots x 2 tiles of
   128x128 f32 (512 ``uvm_affine`` frames of 128 KiB, a 64 MiB mailbox)
   for 3 generations, each logging its sweeps and the READY slots of each,
   then one corrupt frame (REJECTED) and one put whose generation lands
   before its trailer (IN_PROGRESS, then OK);
5. singleton timings: the fused sweep over a full ring of READY frames
   and at the path's occupancy (8 READY slots of 512, one a shard), the
   ring restored before each call outside the timed window, its device
   time by its name under torch.profiler (exactly one kernel a sweep),
   its CUDA-event time, the plain sweep's and its bound; the standalone
   ``ring_poll`` and ``ifunc_vm`` (by the name of the variant
   ``uvm_affine`` takes, reading the ring's bodies in place) beside their
   wrappers, plain versions, bounds and, where one exists, a PyTorch
   library call; the path's frames/s;
6. where a singleton generation's time goes: host timers around the
   channel's put and the mailbox's publish and sweep in one more
   generation, and the card's busy time under torch.profiler in another;
7. the aggregate lane's five behaviours (8 shards, shift 1, K = 4): a
   batch executes; a NACKed sub-record is rebuilt alone; a poisoned one
   errors with its siblings unharmed; a corrupt container is rejected
   whole and the lane reused; a singleton on the agg-bound lane runs;
   the lane launches the fused ``agg_sweep`` alone;
8. the aggregate lane at full width: 8 shards x 4 slots, K = 64 sub-records
   of one 128x128 tile each (2,048 coalesced ``uvm_affine`` records, 32
   containers, 4 deposits per generation, a 134 MB mailbox) for 3
   generations, every result held against relu(x @ W), the sweeps of each
   generation and their READY containers logged;
9. aggregate timings as in phase 5: the fused sweep over full READY
   containers and at the path's occupancy (8 READY containers of 32),
   the standalone ``agg_ring_poll`` and ``ifunc_vm`` at the sweep's
   shapes, the lane's sub-records/s split into send and drain, host
   timers over one more generation as in phase 6, and the SMs' idle
   share over another.
10. the model stack's kernels against their plain versions at the shapes
    the serving and training paths launch: ``flash_fwd`` on [15, S, 64]
    for S in {200, 512, 4096}, [4, 512, 128] with window 256, and the
    training shapes [30, 2,048, 64] (phase 17's microbatch) and
    [30, 1,024, 64] (phase 16's batch), f32 (the FMA kernel) and bf16
    (the wgmma kernel); ``ssd_scan`` on [48, nc, Q, 64], ds 128, for
    (nc, Q) in {(1, 200), (16, 256)}, B and C per row (G = 48) and shared
    by the 48 heads (G = 1, the model's layout at batch 1), the grouped
    call equal bit for bit to the same B and C broadcast to every row;
11. model kernel timings at the path's largest shapes as in phase 5, with
    ``scaled_dot_product_attention`` as flash's library yardstick: the bf16
    forward timed by its own profiler name (``flash_fwd_wgmma_kernel``),
    its TFLOP/s, share of the bound and ratio to SDPA's forward;
    ``ssd_scan`` at [48, 16, 256, 64], ds 128, in both layouts of phase
    10, its four ``ssd_`` kernels' device times summed per call, each
    layout beside its own bound (C B^T counted once per group);
12. model parity in f32 at the full published width of SmolLM-360M and
    Mamba-2 780M: the kernel path's prefill logits and cache against the
    plain path's on 4 prompts of 256 tokens, and teacher forcing (prefill
    240 tokens through the kernels, decode 16, each step against the
    plain path's train logits);
13. serving in bf16, each model at full width: a ``ContinuousBatcher``
    with 4 slots and cache_len 2,048 answers 4 requests (prompts of
    1,024, 512, 256 and 200 tokens, 32 new tokens each), the model's
    kernel launched once per layer in each prefill and never in decode;
    decode tokens/s, the SMs' idle share over the phase, prefill tokens/s
    at batch 1 and 4,096 tokens, and that prefill's five longest device
    kernels under torch.profiler;
14. the flash backward kernels (``flash_bwd_dq``, ``flash_bwd_dkv``)
    against ``flash_bwd_plain`` on the card at the forward's shapes of
    phase 10, the training shapes included, f32 and bf16 (bf16 through
    ``flash_bwd_dq_wgmma_kernel`` and ``flash_bwd_dkv_wgmma_kernel``);
15. backward timings at [15, 4,096, 64] bf16 as in phase 11, each kernel
    by its profiler name (``flash_bwd_dq_wgmma_kernel``,
    ``flash_bwd_dkv_wgmma_kernel``), with the
    backward of ``scaled_dot_product_attention`` as the library yardstick
    of both kernels together, each kernel's ratio to it logged;
16. training parity in f32 at the full width of SmolLM-360M: one
    ``make_train_step``'s loss and gradients (batch 2 x 1,024 tokens)
    through the flash kernels against the naive path's, every parameter
    with a finite non-zero gradient; Mamba-2 780M with ``ssd_impl=
    "kernel"`` refuses a gradient;
17. training in bf16 at full width, the training path: SmolLM-360M with
    ``attn_impl="flash"``, ``remat="block"``, AdamW with f32 state, batch
    4 x 2,048 tokens in 2 microbatches from ``data.Loader``; 2 warm-up and
    8 timed steps (step time, tokens/s, peak memory, the launches per
    step asserted), the SMs' idle share in a traced step with each flash
    kernel's time a launch, then 10 steps on one batch whose loss must
    fall;
18. the bare ifunc API on a host target over the emulated RDMA fabric:
    the paper's quickstart (``rle_insert``, PYBC, linked and run on the
    host: the record decoded, links=1 executed=1) and the AM baseline's
    eager and rendezvous (100,000 B) sends; then on a ``device="cuda"``
    target, a ring of 512 slots of one ``uvm_affine`` frame each (2 tiles,
    128 KiB of payload, a 66 MiB region) with W resident on the card,
    3 generations sent, flushed and drained by ``ring_mailbox(ring).sweep``
    (one ``ifunc_vm`` launch a frame, every result against relu(x @ W),
    links == 1), one frame of 128 tiles (8 MiB) also against
    ``ifunc_vm_plain``, a SLIM frame after an eviction (NACK_UNCACHED),
    a corrupt code section (REJECTED), the FULL resend (OK), a withheld
    trailer (IN_PROGRESS, then OK after flush), a FLAG_AGG container
    of 64 one-tile records (64 launches, every record OK with no error)
    and an HLO frame traced on the CPU (run on the card, equal to the
    CPU's result);
    the phase's launches must be ``ifunc_vm``'s alone, one a frame; then
    frames/s, host timers over the poll, ``run_uvm`` and ``clear_frame``
    in one more generation, the SMs' idle share and
    ``ifunc_vm_smem_kernel``'s device time a frame in another, and the
    128-tile frame's H2D and kernel times;
19. the Dispatcher's host lanes beside the device lane, the port's
    ``examples/multi_peer.py`` at the lanes' width: one source
    ``Dispatcher`` (``Obs(trace=True)``, coalescing up to 64 records)
    over ``rdma_a`` and ``rdma_b`` (``RdmaFabric``) and ``csd``
    (``LoopbackFabric``), each 512 slots of phase 18's size on a
    ``device="cuda"`` target with W resident, and ``gpu`` (phase 4's
    mailbox, shift 0); 3 generations of 512 two-tile ``uvm_affine``
    payloads to each peer (the first to each host peer FULL, the rest
    SLIM; ``rdma_b``'s link cache invalidated halfway through generation
    1, its 256 NACKs resent FULL in ring order), every result within
    rtol 1e-4, atol 1e-5 of relu(x @ W); 4,096 ``counter_bump`` records
    to each host peer in containers of 64; the example's MULTI_PEER_OK,
    AGG_OK and OBS_OK gates; ``ifunc_vm_smem_kernel`` launched once a
    host μVM frame and ``ring_sweep_smem_kernel`` once a device sweep,
    nothing else counted, every plain version refusing to run; the
    ``examples/offload_compress.py`` hot swap.  Then, outside the
    counted run: frames/s per generation, per peer kind (one host peer
    in turns with the bare API of phase 18) and in total; one host
    generation under ``Obs`` with tracing, counters only and off, in
    turns; ``deliver_us``, ``sweep_us`` and ``exec_us`` at p50 and p99;
    the SMs' idle share over one traced generation.
20. result futures over the reply path: a ``TaskRuntime``
    (``ProgressEngine(8, "trailer")``, ``Obs(trace=True)``, coalescing up
    to 64 records) over ``rdma`` (``RdmaFabric``) and ``csd``
    (``LoopbackFabric``), each phase 18's 512 slots on a ``device="cuda"``
    target with W resident and a reply ring of the same geometry, and
    ``gpu`` (phase 4's mailbox, shift 0, no reply ring); 3 generations of
    512 two-tile ``uvm_affine`` futures to each through
    ``TaskRuntime.submit``, every ``Future.result()`` within rtol 1e-4,
    atol 1e-5 of relu(x @ W), none pending, no orphan reply; 4,096
    ``task_sum`` records to each host peer through ``submit_many`` in
    FLAG_AGG containers answered by FLAG_AGG|FLAG_REPLY ones, every 64th
    poisoned and raising ``RemoteExecutionError`` alone; one generation of
    2,048 futures on the aggregate device lane at phase 8's shape; launches
    counted across those three: ``ifunc_vm_smem_kernel`` once a host μVM
    future, ``ring_sweep_smem_kernel`` and ``agg_sweep_smem_kernel`` once a
    device sweep, nothing else, every plain version refusing; then a
    wedged ``csd``: ``fail_inflight`` fails every outstanding future with
    ``TransportError`` and its recorder dump names their corr ids, and
    ``drain(deadline=0.5)`` fails the futures older than the deadline and
    spares younger ones; no span left open.  Then futures/s per generation
    and of each peer alone beside phase 19's frames/s of the same kind,
    ``task.reply_us``, ``exec_us`` and ``sweep_us`` at p50 and p99, host
    timers over the reply's D2H and pack and over the reply drain and
    decode, and the SMs' idle share over a traced generation.

The phases run in the order 1-9, 18, 19, 20, 10-11, 14-17, 12-13: every
profiler session of the timings and the traced step comes before the
serving phase's long traces, after which the profiler recorded no device
time in a run on the H100.  A trace that comes back without the records of the
kernel it times is logged and taken again, three traces at most.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's ``nvidia-smi`` name and power limit; before that the ``kernels``
JSON line, one entry per TPU kernel.  The ``ring_poll`` and
``agg_ring_poll`` entries describe the fused sweeps that now poll on the
lanes (their ``standalone_*`` keys the poll kernels alone; ``ring_poll``
counts phase 19's device sweeps too); ``ifunc_vm`` counts the sweeps it
runs inside, ``host_launches`` its launches on the host target of phase
18 (``host_ms`` the device time of one there),
``dispatcher_launches`` its launches on phase 19's host peers and
``future_launches`` those on phase 20's; ``ring_poll`` and
``agg_ring_poll`` count phase 20's device sweeps too.
"""

import contextlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

T, NT, SHARDS = 128, 2, 8          # tile, tiles per frame, shards
SLOTS_FULL, GENERATIONS = 64, 3    # full width: 8 x 64 slots, 3 generations
AGG_K, AGG_SLOTS = 64, 4           # aggregate lane: K subs x 4 slots a shard
AGG_SUB_BYTES = 128 << 10          # max_sub_bytes: a 64 KiB tile coalesces
TOL_FIXED, TOL_RANDOM = 2e-5, 5e-4
TOL_PATH = dict(rtol=1e-4, atol=1e-5)
# the host target (phase 18): a ring of 512 one-frame slots, 3
# generations, one 128-tile (8 MiB) frame, a K = 64 aggregate container,
# and the AM baseline's rendezvous size
HOST_SLOTS, HOST_GENS, HOST_BIG, HOST_AGG_K = 512, 3, 128, 64
HOST_AM_RNDV = 100_000
# the Dispatcher's host lanes (phase 19): rdma_a and rdma_b (RDMA) and csd
# (loopback) of 512 phase-18 slots each beside the device peer at phase
# 4's width; 3 generations of 512 two-tile payloads to each peer, rdma_b's
# link cache invalidated halfway through generation 1; then 4,096
# counter_bump records to each host peer in containers of up to 64
MP_HOSTS = (("rdma_a", "rdma"), ("rdma_b", "rdma"), ("csd", "loopback"))
MP_SLOTS, MP_GENS, MP_EVICT_GEN, MP_BURST, MP_AGG = 512, 3, 1, 4096, 64
MP_TURNS = 5                       # timed generations of each arm, in turns
# the reply path (phase 20): rdma (RDMA) and csd (loopback) of 512
# phase-18 slots each with a reply ring of the same geometry, beside the
# device peer at phase 4's width; 3 generations of 512 two-tile μVM futures
# to each; 4,096 task_sum records to each host peer in containers of up to
# 64, every 64th poisoned; one generation of the aggregate device lane's
# futures at phase 8's shape; drain(deadline=0.5) on a wedged csd
FT_HOSTS = (("rdma", "rdma"), ("csd", "loopback"))
FT_GENS, FT_BURST, FT_POISON, FT_TURNS, FT_DEADLINE = 3, 4096, 64, 3, 0.5

# Published peaks (NVIDIA data sheets; dense, no sparsity): device-memory
# bytes/s, FP32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s.
PEAKS = [("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100", 3.35e12, 67e12, 989e12)]

# the model stack: each model's published config with its kernel selected,
# and the plain path it is held against
MODELS = {"smollm_360m": ({"attn_impl": "flash"}, {"attn_impl": "naive"}),
          "mamba2_780m": ({"ssd_impl": "kernel"}, {"ssd_impl": "xla"})}
SERVE_PROMPTS, SERVE_NEW, SERVE_SLOTS, SERVE_CACHE = (1024, 512, 256, 200), \
    32, 4, 2048
PARITY_B, PARITY_S, PARITY_PREFILL = 4, 256, 240
PREFILL_S = 4096
# the kernels' shapes on the serving path: flash [BH, S, hd, window] (15
# SmolLM heads at prompts of 200 and 512 and the 4,096-token prefill; the
# reference's head_dim-128 test shape with a window) and ssd_scan
# [BH, nc, Q, hd, ds] (48 Mamba-2 heads at a 200-token prompt and at 4,096)
FLASH_SHAPES = ((15, 200, 64, 0), (15, 512, 64, 0), (15, 4096, 64, 0),
                (4, 512, 128, 256))
SSD_SHAPES = ((48, 1, 200, 64, 128), (48, 16, 256, 64, 128))
# f32 kernel vs plain: summation order only.  bf16 flash: O rounded to
# bf16 by the kernel (2^-8 relative), against f32 on the same inputs.
TOL_FLASH = dict(rtol=1e-4, atol=1e-4)
TOL_FLASH_BF16 = dict(rtol=8e-3, atol=8e-3)
TOL_SSD = dict(rtol=3e-4, atol=3e-4)          # the reference's own
# f32 model parity at full width: 5x the reference's reduced-model 2e-4
# for 16-24x its depth and width; teacher forcing at tests/test_models.py's
# 0.05
TOL_MODEL = dict(rtol=1e-3, atol=1e-3)
TOL_TEACHER = 0.05
# the backward kernels: f32 within the reference's gradient tolerance
# (tests/test_kernels.py); bf16 rounds dQ, dK, dV to bf16 (2^-9
# relative), held against f32 on the same inputs as the forward is
TOL_FLASH_BWD = dict(rtol=2e-4, atol=2e-4)
TOL_FLASH_BWD_BF16 = dict(rtol=8e-3, atol=8e-3)
# the SDPA backward against the kernels in bf16: two bf16 forwards (O
# and LSE of each) feed two backwards; relative L2 of dQ, dK, dV
TOL_SDPA_BWD = 1e-2
# training: f32 parity at full width (2 x 1,024 tokens, one microbatch),
# flash against naive: the loss to 1e-5 relative, each gradient leaf to
# 1e-3 relative L2 (summation order over 32 layers); bf16 training at
# 4 x 2,048 tokens in 2 microbatches, 2 warm-up + 8 timed steps, then 10
# steps on one batch
TRAIN_PARITY = (2, 1024)
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-3
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 2048, 2
TRAIN_WARM, TRAIN_TIMED, TRAIN_FIT = 2, 8, 10

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
    # five tiles live at once (r1-r4 and r6, read before any write): the
    # global-scratch variant, with r6 zeroed
    "wide_fma_zeroed": (
        [("loadp", 0), ("tanh", 1, 0), ("muli", 2, 0, 0, 0.5), ("relu", 3, 0),
         ("gelu", 4, 0), ("fma", 6, 3, 4), ("add", 5, 1, 2),
         ("mul", 7, 5, 6), ("loade", 1, 0), ("matmul", 7, 7, 1),
         ("store", 0, 7)], ("W",)),
}


#: every kernel the repository's CUDA sources define, by name, as the
#: build's ptxas reports list them (filled by phase 1)
KERNEL_NAMES: set = set()


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


def device_ms(torch, fn, kernel, iters=50, traces=3):
    """The device time per call (ms) under torch.profiler of the kernels
    whose names hold ``kernel`` over ``iters`` calls of ``fn`` after a
    warm-up call: for each such name, its mean record times its launches
    a call (its records over ``iters``, rounded), summed.  On the card
    torch.profiler drops a trace's first device record in most traces,
    and now and then more (``tools/profiler_loss.py``), so each trace
    opens with a one-element fill to lose, and a lost record is not read
    as time not spent.  None when none of ``traces`` traces holds such a
    record: a trace without one is logged and taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead.fill_(1.0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in recs:
            if kernel in e.name:
                by_name.setdefault(e.name, []).append(e.device_time_total)
        if by_name:
            return sum(statistics.fmean(t) * max(1, round(len(t) / iters))
                       for t in by_name.values()) / 1e3
        log(f"torch.profiler trace {attempt} of {traces} of {kernel} "
            f"({iters} calls): {len(recs)} device records, names "
            f"{sorted({e.name[:60] for e in recs})[:5]}"
            + ("; tracing again" if attempt < traces else ""))
    return None


def kernel_times(torch, fn, kernel, iters, require=False):
    """(device ms, wrapper ms) per call: the time of the kernels whose
    names hold ``kernel`` where the profiler sees them, else the CUDA-event
    time of the wrapper, and the latter.  ``require``: fail unless the
    profiler sees such a kernel."""
    wrapper = cuda_ms(torch, fn, iters)
    dev = device_ms(torch, fn, kernel, iters)
    check(dev is not None or not require,
          f"torch.profiler recorded no device time for {kernel} in three "
          f"traces")
    if dev is None:
        log(f"{kernel}: device time not measured (torch.profiler recorded "
            f"none); ms is the wrapper's")
    return (wrapper if dev is None else dev), wrapper


def restored_ms(torch, fn, ring, pristine, iters):
    """Median CUDA-event time (ms) of one ``fn()`` with ``ring`` restored
    from ``pristine`` before each call, outside the timed window: a sweep
    clears the ring in place, so a sweep timed twice on one ring would
    find it empty."""
    ring.copy_(pristine)
    fn()
    pairs = []
    for _ in range(iters):
        ring.copy_(pristine)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def sweep_times(torch, sweep, ring, pristine, ext, kernel, iters):
    """(device ms, event ms) of one ``sweep(ring, ext)``, the ring restored
    before each call: the device time of the kernel named ``kernel`` under
    torch.profiler, and the median CUDA-event time.  Fails unless every
    sweep launched exactly one kernel by the launch counters (the fused
    sweep's, and no other counted kernel) and the profiler sees exactly
    one kernel a sweep, that one (the restore is a device-to-device copy,
    not a kernel).  torch.profiler can lose a kernel's record on a busy
    host: a trace that holds fewer records than sweeps and nothing but
    the fused kernel is logged and taken again, at most three times; a
    kernel of any other name fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ev = restored_ms(torch, lambda: sweep(ring, ext), ring, pristine, iters)
    counters = _counted()
    lane = "agg_sweep" if kernel.startswith("agg") else "ring_sweep"
    for attempt in range(1, 4):
        before = {k: f.launches for k, f in counters.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                ring.copy_(pristine)
                sweep(ring, ext)
            torch.cuda.synchronize()
        moved = {k: f.launches - before[k] for k, f in counters.items()
                 if f.launches != before[k]}
        check(moved == {lane: iters},
              f"{iters} sweeps launched {moved}, not {iters} of {lane}")
        recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset", "Activity"))]
        mine = [e.device_time_total for e in recs if kernel in e.name]
        what = (f"{len(recs)} kernels in {iters} sweeps, {len(mine)} of them "
                f"{kernel}: {sorted({e.name[:60] for e in recs})[:5]}")
        check(len(mine) == len(recs) <= iters, what)
        if len(recs) == iters:
            return sum(mine) / iters / 1e3, ev
        log(f"torch.profiler trace {attempt} of {iters} sweeps lost "
            f"{iters - len(recs)} kernel records ({what}); tracing again")
    raise SmokeError(f"{what}, in three traces")


def sweep_bound(n_slots, hdr_words, ready_tiles, n_tiles, cleared_words,
                ext, flops, bw, fp32):
    """(bound ms, by, bytes, FLOP) of a fused sweep: the header and
    trailer words of every slot read and its statuses written, the READY
    payloads read, every output tile written, the consumed slots' words
    written and the external tables read, at ``bw``; the program's FLOP
    on the READY tiles at ``fp32``."""
    nbytes = (n_slots * hdr_words * 4 + ready_tiles * T * T * 4
              + n_tiles * T * T * 4 + cleared_words * 4 + ext.numel() * 4)
    by_bytes, by_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops
            else "operations", nbytes, flops)


def card_peaks(name):
    """(bytes/s, FP32 FLOP/s, bf16 FLOP/s) of the card."""
    for key, *peaks in PEAKS:
        if key in name:
            return peaks
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
        kernel = ""
        for line in (out / f"{src.stem}.log").read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?_Z\w*?([a-z][a-z_]*_kernel)(?:I(\w*?)EE)?",
                          line)
            if m:                        # the kernel and its template args
                kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                KERNEL_NAMES.add(m.group(1))
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src.stem} {kernel}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            check(not (spill and "wgmma" in kernel and spill.group(1, 2)
                       != ("0", "0")),
                  f"{kernel} spills registers: {line.strip()}")


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


def make_sweep_ring(np, rng, n, W, nt):
    """A uint32 singleton ring of ``n`` slots of ``nt`` body tiles with
    finite bodies, cycling through EMPTY (zeros, garbage behind magic 0),
    READY, a short READY frame (its trailer inside the first body tile),
    INFLIGHT and BAD (check word, fw = 0xFFFFFFF0, bad magic)."""
    from repro_torch.core.device_mailbox import pack_word_frame

    ring = np.zeros((n, W), np.uint32)
    for i in range(n):
        kind = i % 8
        pay = rng.standard_normal(nt * T * T).astype(np.float32)
        if kind == 1:
            ring[i] = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
            ring[i, 0] = 0
        elif kind == 3:
            ring[i] = pack_word_frame(pay[:T * T // 2 + 3], W)
        elif kind >= 2:
            ring[i] = pack_word_frame(pay, W, corrupt=kind == 5,
                                      no_trailer=kind == 4)
        if kind == 6:
            ring[i, 1] = 0xFFFFFFF0
            ring[i, 4] = ring[i, 0] ^ ring[i, 1] ^ ring[i, 2] ^ ring[i, 3]
        if kind == 7:
            ring[i, 0] ^= 0x100
    return ring


def check_fused_sweep(torch, prog, pristine, ext, what, agg_k=0, bound=0,
                      per_sub=NT):
    """The fused sweep against its plain version on two copies of
    ``pristine`` and against ``ifunc_vm_slots`` on a third: statuses (and
    sub statuses) and the cleared ring bit for bit, the outputs of the
    tiles that ran bit for bit equal to ifunc_vm_slots and within
    TOL_FIXED of the plain version, +0.0 elsewhere, INFLIGHT and EMPTY
    slots untouched.  Returns (max |err| against plain, statuses)."""
    from repro_torch.kernels.ifunc_vm import (ifunc_vm_agg_sweep,
                                              ifunc_vm_slots, ifunc_vm_sweep,
                                              ifunc_vm_sweep_plain)
    from repro_torch.kernels.ring_poll import HDR_WORDS

    a, b = pristine.clone(), pristine.clone()
    off = HDR_WORDS + 2 * agg_k
    per_slot = max(agg_k, 1) * per_sub
    if agg_k:
        got = ifunc_vm_agg_sweep(prog, a, agg_k, off, per_slot, ext, bound)
    else:
        got = ifunc_vm_sweep(prog, a, off, per_slot, ext)
    want = ifunc_vm_sweep_plain(prog, b, off, per_slot, ext, agg_k=agg_k,
                                bound_hash=bound)
    slots = ifunc_vm_slots(prog, pristine, off, per_slot, ext)
    torch.cuda.synchronize()
    for g, w in zip(got[:-1], want[:-1]):
        check(torch.equal(g, w), f"{what}: statuses != plain")
    check(torch.equal(a, b), f"{what}: cleared ring != plain")
    run = (got[-2] == 1).reshape(-1).repeat_interleave(per_sub)
    out, ref = got[-1], want[-1]
    check(torch.equal(out[run].view(torch.int32),
                      slots[run].view(torch.int32)),
          f"{what}: outputs != ifunc_vm_slots bit for bit")
    err = (out[run] - ref[run]).abs().max().item() if run.any() else 0.0
    check(torch.allclose(out[run], ref[run], rtol=TOL_FIXED, atol=TOL_FIXED),
          f"{what}: max |err| {err:.3g} vs plain over {TOL_FIXED}")
    check(not out[~run].view(torch.int32).any(), f"{what}: masked != +0.0")
    kept = (got[0] == 0) | (got[0] == 2)
    check(torch.equal(a[kept], pristine[kept]) and not a[~kept].any(),
          f"{what}: INFLIGHT/EMPTY touched or a consumed slot left dirty")
    return err, got[0]


def phase_kernels(np, torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.convert import mailbox_from_numpy
    from repro_torch.core.codegen import OPS, assemble
    from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain, vm_plan
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

    # the fused singleton sweep at the lane's shape, both plan variants
    from repro_torch.ifunc_libs.uvm_affine import UVM_PROGRAM
    from repro_torch.kernels.ifunc_vm import sweep_kernel

    sw_ring = mailbox_from_numpy(make_sweep_ring(np, rng, n_slots, W, NT), dev)
    sw_err, sw_seen = 0.0, set()
    for prog, n_ext in ((UVM_PROGRAM, 1),
                        (assemble(*FIXED_PROGRAMS["wide_fma_zeroed"]), 1)):
        ext = torch.from_numpy((rng.standard_normal((SHARDS, n_ext, T, T))
                                * 0.1).astype(np.float32)).to(dev)
        e, st = check_fused_sweep(torch, prog, sw_ring, ext,
                                  sweep_kernel(prog))
        sw_err = max(sw_err, e)
        sw_seen.add(sweep_kernel(prog))
    check(sw_seen == {"ring_sweep_smem_kernel", "ring_sweep_global_kernel"},
          f"fused singleton sweep: not both variants {sw_seen}")
    log(f"ring_sweep: {n_slots} slots x {NT} tiles (statuses "
        f"{torch.bincount(st, minlength=4).tolist()}) equal to the plain "
        f"sweep bit for bit (statuses, cleared ring), outputs equal to "
        f"ifunc_vm_slots bit for bit, max |err| vs plain {sw_err:.3g}, "
        f"masked +0.0; variants {sorted(sw_seen)}")
    del sw_ring

    n_tiles = SHARDS * SLOTS_FULL * NT
    pay = torch.from_numpy(rng.standard_normal((n_tiles, T, T))
                           .astype(np.float32)).to(dev)
    errs, variants = {}, {}
    for name, (instrs, symbols) in sorted(FIXED_PROGRAMS.items()):
        prog = assemble(instrs, symbols=symbols)
        plan = vm_plan(prog)
        variants.setdefault(plan.kernel, []).append(name)
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
        plan = vm_plan(prog)
        variants.setdefault(plan.kernel, []).append(f"random {seed} "
                                                    f"({plan.n_tiles} tiles)")
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
    for kernel, progs in sorted(variants.items()):
        log(f"  {kernel}: {', '.join(progs)}")
    check(set(variants) == {"ifunc_vm_smem_kernel", "ifunc_vm_global_kernel"},
          f"ifunc_vm: not both variants launched: {variants}")
    return {"ring_poll": rp_err, "ring_sweep": sw_err,
            "ifunc_vm": max(max(errs.values()), worst)}


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


def _counted():
    from repro_torch.kernels.agg_poll import agg_ring_poll
    from repro_torch.kernels.flash_attn import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_fwd)
    from repro_torch.kernels.ifunc_vm import (ifunc_vm, ifunc_vm_agg_sweep,
                                              ifunc_vm_sweep)
    from repro_torch.kernels.ring_poll import ring_poll
    from repro_torch.kernels.ssd_scan import ssd_scan

    return {"ring_poll": ring_poll, "agg_ring_poll": agg_ring_poll,
            "ifunc_vm": ifunc_vm, "ring_sweep": ifunc_vm_sweep,
            "agg_sweep": ifunc_vm_agg_sweep, "flash_fwd": flash_fwd,
            "ssd_scan": ssd_scan, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv}


def lane_launches_ok(counts, lane):
    """Whether a lane's run launched its fused sweep and none of the
    standalone poll or ifunc_vm kernels, nor the other lane's sweep."""
    other = "agg_sweep" if lane == "ring_sweep" else "ring_sweep"
    return (counts[lane] > 0 and counts[other] == 0 and counts["ring_poll"]
            == counts["agg_ring_poll"] == counts["ifunc_vm"] == 0)


def sweep_log(mb, run):
    """``run()`` with the mailbox's sweeps watched: returns (the READY
    slots of each sweep that launched, run's result)."""
    from repro_torch.core.api import Status

    counter = _counted()["agg_sweep" if mb.agg_k else "ring_sweep"]
    ready = []

    def sweep(*a, **k):
        before = counter.launches
        statuses = type(mb).sweep(mb, *a, **k)
        if counter.launches > before:
            ready.append(sum(1 for st in statuses if st == Status.OK))
        return statuses

    mb.sweep = sweep
    try:
        out = run()
    finally:
        del mb.sweep
    return ready, out


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _counted().items()}


def phase_example(np, torch, dev):
    d, h, Ws, rng = build_path(np, torch, dev, n_slots=2)
    pays = rng.standard_normal((SHARDS, NT, T, T)).astype(np.float32)
    reset_counts()
    send_generation(d, h, pays)
    counts = read_counts()
    check(lane_launches_ok(counts, "ring_sweep"),
          f"example: kernels not launched as the lane needs {counts}")
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
        ready, (send_s, drain_s, create_s) = sweep_log(
            mb, lambda: send_generation(d, h, pays))
        rates.append((send_s, drain_s, create_s))
        res = peer.target_args["results"][g * n:(g + 1) * n]
        check_results(torch, res, expected(torch, pays, Ws, SLOTS_FULL, dev),
                      f"generation {g}")
        log(f"generation {g}: {n} frames, send {send_s:.4f} s (of which "
            f"ifunc_msg_create {create_s:.4f} s), drain {drain_s:.4f} s, "
            f"{n / (send_s + drain_s):.1f} frames/s; {len(ready)} sweeps "
            f"of {n} slots, READY in each: {ready}")
    counts = read_counts()
    check(lane_launches_ok(counts, "ring_sweep"),
          f"main path: kernels not launched as the lane needs {counts}")
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
                                                 pack_word_frame, sweep_plain)
    from repro_torch.kernels.ifunc_vm import (ifunc_vm_plain, ifunc_vm_slots,
                                              slot_tiles, sweep_kernel,
                                              vm_plan)
    from repro_torch.kernels.ring_poll import (HDR_WORDS, READY, ring_poll,
                                               ring_poll_plain)

    name = torch.cuda.get_device_name(0)
    bw, fp32, _ = card_peaks(name)
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
    rp_ms, rp_wrap = kernel_times(torch, lambda: ring_poll(flat),
                                  "ring_poll_kernel", 200)
    rp_plain = cuda_ms(torch, lambda: ring_poll_plain(flat), 50)
    rp_bytes = n_slots * (HDR_WORDS + 1) * 4 + n_slots * 4
    rp_bound = rp_bytes / bw * 1e3

    # ifunc_vm as the sweep calls it: the tiles read in place in the ring
    pay = slot_tiles(flat, HDR_WORDS, NT)
    ext = mb.externals
    vm = vm_plan(prog).kernel
    out = ifunc_vm_slots(prog, flat, HDR_WORDS, NT, ext)
    ref = ifunc_vm_plain(prog, pay, ext)
    vm_err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=TOL_FIXED, atol=TOL_FIXED),
          f"ifunc_vm uvm_affine max |err| {vm_err:.3g}")
    vm_ms, vm_wrap = kernel_times(
        torch, lambda: ifunc_vm_slots(prog, flat, HDR_WORDS, NT, ext), vm, 20,
        require=True)
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

    # the fused sweep: a full ring of READY frames, and the path's
    # occupancy (one deposit of 8 frames, one a shard, into 512 slots)
    sweep = make_sweep(prog, NT)
    kernel = sweep_kernel(prog)
    full = ring.clone()
    sw = {}
    for case, n_ready in (("full", n_slots), ("path", SHARDS)):
        pristine = full if case == "full" else torch.zeros_like(ring)
        pristine[:, 0] = full[:, 0]
        ring.copy_(pristine)
        st, _, _ = sweep(ring, ext)
        check(int((st == READY).sum()) == n_ready and not ring.any(),
              f"sweep {case}: {int((st == READY).sum())} READY of "
              f"{n_ready}, or the ring not cleared")
        ms, ev = sweep_times(torch, sweep, ring, pristine, ext, kernel, 20)
        plain = restored_ms(torch, lambda: sweep_plain(prog, ring, ext, NT),
                            ring, pristine, 5)
        # status words: 5 header words and the trailer, 1 status
        bound, by, nb, fl = sweep_bound(
            n_slots, HDR_WORDS + 2, n_ready * NT, n_tiles, n_ready * W, ext,
            uvm_flops(prog, n_ready * NT), bw, fp32)
        sw[case] = (ms, ev, plain, bound, by)
        log(f"sweep ({kernel}, one launch) {case} ring, {n_ready} READY of "
            f"{n_slots} slots: {ms:.4f} ms on the card (events {ev:.4f}, "
            f"plain sweep {plain:.4f}); bound {bound:.4f} ms by {by} "
            f"({nb / 2 ** 20:.1f} MiB, {fl / 1e9:.3f} GFLOP), "
            f"{bound / ms:.3f} of it")
    ring.copy_(full)
    deposit = make_deposit(SHARDS)
    dp_ms = cuda_ms(torch, lambda: deposit(ring, ring, 1), 20)
    h2d_ms = cuda_ms(torch, lambda: torch.from_numpy(
        words.view(np.int32)).to(dev), 5)

    sw_ms, sw_ev, sw_plain, sw_bound, sw_by = sw["full"]
    kernels = [
        {"name": "ring_poll", "route": "cuda",
         "source": "src/repro_torch/csrc/ifunc_vm.cu",
         "kernel": kernel, "poll": "src/repro_torch/csrc/mailbox_poll.cuh",
         "replaces": "src/repro/kernels/ring_poll.py:54",
         "launches": counts["ring_sweep"], "launches_a_sweep": 1,
         "max_abs_err": max(errs["ring_poll"], errs["ring_sweep"]),
         "ms": sw_ms, "wrapper_ms": sw_ev, "path_ms": sw["path"][0],
         "path_bound_ms": sw["path"][3], "plain_ms": sw_plain,
         "bound_ms": sw_bound, "bound_by": sw_by, "library_ms": None,
         "standalone_ms": rp_ms, "standalone_wrapper_ms": rp_wrap,
         "standalone_plain_ms": rp_plain, "standalone_bound_ms": rp_bound},
        {"name": "ifunc_vm", "route": "cuda",
         "source": "src/repro_torch/csrc/ifunc_vm.cu",
         "replaces": "src/repro/kernels/ifunc_vm.py:94",
         "launches": counts["ring_sweep"],
         "runs_inside": "ring_sweep_*_kernel and agg_sweep_*_kernel: the "
                        "lanes launch no ifunc_vm_*_kernel of their own",
         "standalone_launches": counts["ifunc_vm"],
         "max_abs_err": max(vm_err, errs["ifunc_vm"]),
         "ms": vm_ms, "wrapper_ms": vm_wrap, "plain_ms": vm_plain,
         "bound_ms": vm_bound,
         "bound_by": ("operations" if vm_bound_ops >= vm_bound_bytes
                      else "bytes"),
         "library_ms": vm_lib},
    ]
    log(f"ring_poll {n_slots} slots: {rp_ms:.4f} ms on the card (wrapper "
        f"{rp_wrap:.4f}, plain {rp_plain:.4f}, bound {rp_bound:.3g} ms by "
        f"{rp_bytes} B)")
    log(f"ifunc_vm uvm_affine {n_tiles} tiles in place ({vm}): {vm_ms:.4f} "
        f"ms on the card (wrapper {vm_wrap:.4f}, plain "
        f"{vm_plain:.4f}, torch.relu(torch.matmul) {vm_lib:.4f}, bound "
        f"{vm_bound:.4f} ms: {vm_flops / 1e9:.3f} GFLOP -> "
        f"{vm_bound_ops:.4f} ms, {vm_bytes / 2 ** 20:.0f} MiB -> "
        f"{vm_bound_bytes:.4f} ms); {vm_flops / vm_ms / 1e9:.2f} TFLOP/s, "
        f"{vm_bound / vm_ms:.3f} of the bound, {vm_ms / vm_lib:.2f}x "
        f"torch.relu(torch.matmul)")
    log(f"standalone ring_poll_kernel {rp_ms:.4f} ms beside the sweep's "
        f"{sw_ms:.4f}; deposit {dp_ms:.4f} ms; staged generation H2D "
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


def traced_lane(d, run):
    """``run()`` with host timers around the lane's channel put and its
    mailbox's publish and sweep; returns (seconds in each, its result)."""
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

    for key, obj in lanes.items():
        setattr(obj, key, timed(key, getattr(obj, key)))
    try:
        out = run()
    finally:
        for key, obj in lanes.items():
            delattr(obj, key)               # back to the class's method
    return spent, out


def phase_breakdown(np, torch, d, h, rates):
    """Where a generation's time goes, from two more generations of the
    main path: one with host timers around the channel's put and the
    mailbox's publish and sweep (a traced run, apart from the untraced
    ones phase 4 reports), one under torch.profiler for the card's busy
    time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    n = SHARDS * SLOTS_FULL
    spent, (send_s, drain_s, create) = traced_lane(d, lambda: send_generation(
        d, h, rng.standard_normal((n, NT, T, T)).astype(np.float32)))
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
    log_card_busy(prof, wall, "card per generation")


def log_card_busy(prof, wall, what, kernels=()):
    """Log the card's busy time in a torch.profiler trace of one
    generation against the untraced ``wall`` seconds of one, and the time
    and launches of each kernel whose name holds one of ``kernels``;
    returns the SMs' idle share, None when the trace holds no device time.
    Device-side records only: the CPU-side op that launched a copy or a
    kernel carries the same device time again; "Activity Buffer Request"
    is the profiler's own."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not events:
        log(f"{what}: card busy time not measured (torch.profiler recorded "
            f"no device time)")
        return None
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    copy_s = sum(e.device_time_total for e in copies) / 1e6
    kern_s = sum(e.device_time_total for e in events) / 1e6 - copy_s
    by_name = {}
    for e in events:
        if e not in copies:
            by_name[e.name[:48]] = (by_name.get(e.name[:48], 0.0)
                                    + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    idle = 1 - kern_s / wall
    log(f"{what} (torch.profiler, {len(events)} device records): kernels "
        f"{kern_s:.4f} s, so the SMs sit idle {idle:.4f} of the untraced "
        f"{wall:.4f} s; copies {copy_s:.4f} s ({len(copies)}); most kernel "
        f"time: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    for kernel in kernels:
        mine = [e.device_time_total / 1e3 for e in events if kernel in e.name]
        if mine:
            log(f"  {kernel}: {sum(mine):.2f} ms in {len(mine)} launches, "
                f"{sum(mine) / len(mine):.4f} ms each")
    return idle


def make_agg_ring(np, rng, n, k, body_words, bound):
    """A uint32 ring of ``n`` aggregate slots cycling through every
    container and sub state, and the container status each must get:
    empty (zeros, and garbage behind magic 0); READY with every sub READY,
    with mixed hashes (NACKs, high-bit hashes), with a poisoned sub, with
    garbage in its unoccupied descriptors; a corrupt container, a withheld
    trailer, n_subs = 0xFFFFFFFF and K + 1 (negative and one past K), and
    a bad magic (BAD or INFLIGHT)."""
    from repro_torch.core.device_mailbox import pack_agg_word_frame
    from repro_torch.kernels.agg_poll import AGG_MAGIC
    from repro_torch.kernels.ring_poll import (BAD, EMPTY, HDR_WORDS,
                                               INFLIGHT, READY)

    W = HDR_WORDS + 2 * k + k * body_words + 1
    pay = [rng.standard_normal(body_words).astype(np.float32)
           for _ in range(k)]
    b = bound or 0xC0FFEE01              # the hash a matching sub carries
    other = 0x9000ABCD if bound == 0x8000ABCD else 0x8000ABCD

    def pack(m, hashes=None, **kw):
        return pack_agg_word_frame(pay[:m], hashes or [b] * m, k, body_words,
                                   W, **kw)

    ring = np.zeros((n, W), np.uint32)
    want = np.zeros(n, np.int32)
    for i in range(n):
        kind = i % 12
        m = 1 + int(rng.integers(0, k))                # occupied subs
        if kind == 0:
            want[i] = EMPTY
        elif kind == 1:                                # magic 0, garbage
            ring[i] = rng.integers(0, 2 ** 32, W, dtype=np.uint32)
            ring[i, 0] = 0
            want[i] = EMPTY
        elif kind in (2, 11):
            ring[i] = pack(k if kind == 11 else m)
            want[i] = READY
        elif kind == 3:                                # NACKs, high bits
            ring[i] = pack(m, [int(h) for h in rng.choice(
                [b, other, 0xFFFFFFFF], m)])
            want[i] = READY
        elif kind == 4:
            ring[i] = pack(m, corrupt_sub=int(rng.integers(0, m)))
            want[i] = READY
        elif kind == 5:
            ring[i] = pack(m, corrupt=True)
            want[i] = BAD
        elif kind == 6:
            ring[i] = pack(m, no_trailer=True)
            want[i] = INFLIGHT
        elif kind in (7, 8):                           # n_subs out of bounds
            n_subs = 0xFFFFFFFF if kind == 7 else k + 1
            ring[i] = pack(m)
            ring[i, 1] = n_subs
            ring[i, 4] = AGG_MAGIC ^ n_subs ^ 3
            want[i] = BAD
        elif kind == 9:
            ring[i] = pack(m)
            ring[i, 0] ^= 0x100                        # bad magic
            want[i] = BAD
        else:                                          # kind 10
            ring[i] = pack(m)
            ring[i, HDR_WORDS + 2 * m:HDR_WORDS + 2 * k] = rng.integers(
                0, 2 ** 32, 2 * (k - m), dtype=np.uint32)
            want[i] = READY
    return ring, want


def phase_agg_kernel(np, torch, dev):
    """``agg_ring_poll`` against its plain version, bit-exact, on mixed
    rings of the aggregate path's 32 slots at K = 4 and K = 64, with a
    high-bit bound hash and with bound 0, and the fused aggregate sweep
    against its plain version on the same rings; returns the largest
    |diff| of the poll and the sweep's largest |err| against plain."""
    from repro_torch.convert import mailbox_from_numpy
    from repro_torch.kernels.agg_poll import agg_ring_poll, agg_ring_poll_plain
    from repro_torch.kernels.ring_poll import HDR_WORDS

    from repro_torch.ifunc_libs.uvm_affine import UVM_PROGRAM

    rng = np.random.default_rng(4)
    n = SHARDS * AGG_SLOTS
    worst, sweep_err = 0, 0.0
    for k in (4, AGG_K):
        for bound in (0x8000ABCD, 0):
            ring_np, want = make_agg_ring(np, rng, n, k, T * T, bound)
            mb = mailbox_from_numpy(ring_np, dev)
            hdr, tr = mb[:, :HDR_WORDS + 2 * k], mb[:, -1:]
            st, sub = agg_ring_poll(hdr, tr, bound)
            st_p, sub_p = agg_ring_poll_plain(hdr, tr, bound)
            torch.cuda.synchronize()
            worst = max(worst, int((st - st_p).abs().max().item()),
                        int((sub - sub_p).abs().max().item()))
            check(torch.equal(st, st_p) and torch.equal(sub, sub_p),
                  f"agg_ring_poll K={k} bound={bound:#x}: kernel != plain")
            check(np.array_equal(st.cpu().numpy(), want),
                  f"agg_ring_poll K={k}: statuses != the ring's")
            subs = np.bincount(sub.cpu().numpy().reshape(-1), minlength=5)
            log(f"agg_ring_poll K={k} bound={bound:#x}: {n} slots x "
                f"{mb.shape[1]} words bit-exact vs plain (containers "
                f"{np.bincount(want, minlength=4).tolist()}, subs "
                f"EMPTY/READY/BAD/NACK {subs[[0, 1, 3, 4]].tolist()})")
            ext = torch.from_numpy((rng.standard_normal((SHARDS, 1, T, T))
                                    * 0.1).astype(np.float32)).to(dev)
            e, _ = check_fused_sweep(torch, UVM_PROGRAM, mb, ext,
                                     f"agg_sweep K={k} bound={bound:#x}",
                                     agg_k=k, bound=bound, per_sub=1)
            sweep_err = max(sweep_err, e)
            log(f"agg_sweep K={k} bound={bound:#x}: equal to the plain sweep "
                f"bit for bit (statuses, subs, cleared ring), outputs equal "
                f"to ifunc_vm_slots bit for bit, max |err| vs plain {e:.3g}")
    return worst, sweep_err


def build_agg_path(np, torch, dev, n_slots, agg_k, seed,
                   flush_threshold=8):
    """A coalescing Dispatcher with one agg-bound lane on
    DeviceMeshFabric(8, shift=1) running uvm_affine, W[s] on shard s; a
    reply router filing (value, is_err) by corr id."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       ProgressEngine)

    src = Context("host-source")
    handle = register_ifunc(src, "uvm_affine")
    rng = np.random.default_rng(seed)
    Ws = (rng.standard_normal((SHARDS, T, T)) * 0.05).astype(np.float32)
    d = Dispatcher(src, ProgressEngine(flush_threshold=flush_threshold,
                                       inflight_window="trailer"))
    d.set_coalescing(True, max_subs=agg_k, max_sub_bytes=AGG_SUB_BYTES)
    d.add_peer("gpu-mesh", DeviceMeshFabric(SHARDS, shift=1, device=dev),
               None, n_slots=n_slots,
               slot_size=agg_k * (T * T * 4 + 128) + 4096,
               prog=deserialize_uvm(handle.lib.code), n_tiles=1,
               externals=Ws[:, None], agg_k=agg_k,
               prog_name=handle.lib.name)
    replies = {}
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.__setitem__(corr, (value, is_err))
    return d, handle, torch.from_numpy(Ws).to(dev), rng, replies


def agg_want(torch, dev, pays, Ws, first_tail, agg_k):
    """relu(x @ W) for records sent in containers of ``agg_k`` from
    produce index ``first_tail`` on: a container staged at shard s lands
    on shard s + 1."""
    x = torch.from_numpy(pays).to(dev)                    # [n, 1, T, T]
    tails = first_tail + torch.arange(len(pays), device=dev) // agg_k
    landed = (tails % SHARDS + 1) % SHARDS
    return torch.relu(torch.matmul(x[:, 0], Ws[landed]))[:, None]


def phase_agg_example(np, torch, dev):
    """The reference's five device-aggregate behaviours on the card."""
    from repro_torch.core import ifunc_msg_create
    from repro_torch.kernels.agg_poll import SUB_SALT
    from repro_torch.kernels.ring_poll import HDR_WORDS

    k = 4
    reset_counts()

    def fresh(seed):
        d, h, Ws, rng, replies = build_agg_path(np, torch, dev, 2, k, seed)
        xs = rng.standard_normal((3, 1, T, T)).astype(np.float32)
        return d, h, Ws, replies, d.peers["gpu-mesh"], xs

    def close(got, want, what):
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and torch.allclose(got, want, **TOL_PATH),
              f"agg example, {what}: max |err| "
              f"{(got - want).abs().max().item():.3g}")

    # 1. K coalesced sends: ONE container, ONE sweep, every result right
    d, h, Ws, _, peer, xs = fresh(1)
    check(d.send_ifunc_many("gpu-mesh", h, list(xs)) == 3, "batch refused")
    check((peer.stats["agg_sent"], peer.stats["agg_subs"]) == (1, 3),
          f"batch: not one container of 3 {peer.stats}")
    check(d.drain() == 3, "batch: not 3 delivered")
    res = peer.target_args["results"]
    check(len(res) == 3, f"batch: {len(res)} results")
    close(torch.stack(res), agg_want(torch, dev, xs, Ws, 0, k), "batch")

    # 2. a hash-mismatched sub NACKs alone: only it is rebuilt FULL
    d, h, Ws, replies, peer, xs = fresh(2)
    mb = peer.rings[0].mailbox
    check(d.send_ifunc_many("gpu-mesh", h, list(xs), corr_ids=[1, 2, 3])
          == 3, "nack: refused")
    mb._staged[0, 0, HDR_WORDS + 2] = 0x1234
    mb._staged[0, 0, HDR_WORDS + 3] = 0x1234 ^ SUB_SALT
    check(d.drain() == 3, "nack: not 3 delivered")
    check((peer.stats["nacks"], peer.stats["resent"]) == (1, 1),
          f"nack: {peer.stats}")
    check(len(peer.target_args["results"]) == 3 and sorted(replies) ==
          [1, 2, 3] and not any(e for _, e in replies.values()),
          "nack: siblings replayed or a result lost")
    close(replies[1][0], agg_want(torch, dev, xs[:1], Ws, 0, k)[0], "nack 1")
    close(replies[2][0], agg_want(torch, dev, xs[1:2], Ws, 1, k)[0],
          "nack rebuilt")
    close(replies[3][0], agg_want(torch, dev, xs[2:], Ws, 0, k)[0], "nack 3")

    # 3. a poisoned sub errors, its siblings unharmed
    d, h, Ws, replies, peer, xs = fresh(3)
    mb = peer.rings[0].mailbox
    check(d.send_ifunc_many("gpu-mesh", h, list(xs),
                            corr_ids=[11, 12, 13]) == 3, "poison: refused")
    mb._staged[0, 0, HDR_WORDS + 3] ^= 1
    d.drain()
    check(sorted(replies) == [11, 12, 13] and replies[12][1]
          and "poisoned" in str(replies[12][0]),
          f"poison: replies {sorted(replies)}")
    check(not replies[11][1] and not replies[13][1], "poison: sibling hurt")
    want = agg_want(torch, dev, xs, Ws, 0, k)
    close(replies[11][0], want[0], "poison sibling 11")
    close(replies[13][0], want[2], "poison sibling 13")
    check(peer.stats["rejected"] == 1
          and len(peer.target_args["results"]) == 2, "poison: counts")

    # 4. a corrupt container is rejected whole; the lane then runs again
    d, h, Ws, replies, peer, xs = fresh(4)
    mb = peer.rings[0].mailbox
    check(d.send_ifunc_many("gpu-mesh", h, list(xs),
                            corr_ids=[21, 22, 23]) == 3, "corrupt: refused")
    mb._staged[0, 0, 4] ^= 1
    d.drain()
    check(peer.stats["rejected"] == 1 and not peer.target_args.get(
        "results") and sorted(replies) == [21, 22, 23]
          and all(e for _, e in replies.values()),
          f"corrupt: not rejected whole {peer.stats}")
    check(int(mb._mb.abs().sum().item()) == 0, "corrupt: slot not cleared")
    check(d.send_ifunc_many("gpu-mesh", h, list(xs[:2])) == 2 and
          d.drain() == 2, "corrupt: lane not reusable")
    close(torch.stack(peer.target_args["results"]),
          agg_want(torch, dev, xs[:2], Ws, 1, k), "after corrupt")

    # 5. a singleton on the agg-bound lane: a 1-sub container
    d, h, Ws, replies, peer, xs = fresh(5)
    check(d.send("gpu-mesh", ifunc_msg_create(h, xs[0], corr_id=77)),
          "singleton refused")
    check(d.drain() == 1 and list(replies) == [77] and not replies[77][1],
          "singleton: not delivered")
    close(replies[77][0], agg_want(torch, dev, xs[:1], Ws, 0, k)[0],
          "singleton")
    counts = read_counts()
    check(lane_launches_ok(counts, "agg_sweep"),
          f"agg example launches {counts}")
    log(f"agg example (8 shards, shift 1, K={k}): batch, NACK rebuilt "
        f"alone, poisoned sub, corrupt container then reuse, singleton — "
        f"all hold; launches {counts}")


def send_agg_generation(d, h, pays, corr_ids):
    """Send one generation through ``send_ifunc_many`` and drain it,
    ending in a synchronize; returns the host seconds of (send, drain)."""
    import torch

    t0 = time.perf_counter()
    got = d.send_ifunc_many("gpu-mesh", h, list(pays), corr_ids=corr_ids)
    t1 = time.perf_counter()
    check(got == len(pays), f"accepted {got} of {len(pays)} records")
    done = d.drain()
    torch.cuda.synchronize()
    check(done == len(pays), f"drained {done} of {len(pays)} records")
    return t1 - t0, time.perf_counter() - t1


def phase_agg_full(np, torch, dev):
    """The aggregate lane at full width; returns (launch counts, per
    generation (send, drain) seconds, the dispatcher)."""
    d, h, Ws, rng, replies = build_agg_path(np, torch, dev, AGG_SLOTS, AGG_K,
                                            seed=6)
    peer = d.peers["gpu-mesh"]
    mb = peer.rings[0].mailbox
    n_cont = SHARDS * AGG_SLOTS
    n = n_cont * AGG_K
    gens = [rng.standard_normal((n, 1, T, T)).astype(np.float32)
            for _ in range(GENERATIONS)]
    torch.cuda.synchronize()
    reset_counts()
    rates = []
    for g, pays in enumerate(gens):
        before = read_counts()
        corr = list(range(g * n + 1, (g + 1) * n + 1))
        ready, (send_s, drain_s) = sweep_log(
            mb, lambda: send_agg_generation(d, h, pays, corr))
        now = read_counts()
        delta = {key: now[key] - before[key] for key in now}
        check(lane_launches_ok(delta, "agg_sweep"),
              f"generation {g}: launches {delta}")
        got = [replies.pop(c) for c in corr]
        check(not any(e for _, e in got), f"generation {g}: error replies")
        vals = torch.stack([v for v, _ in got])
        want = agg_want(torch, dev, pays, Ws, g * n_cont, AGG_K)
        check(vals.shape == want.shape and bool(torch.isfinite(vals).all())
              and torch.allclose(vals, want, **TOL_PATH),
              f"generation {g}: max |err| "
              f"{(vals - want).abs().max().item():.3g}")
        rates.append((send_s, drain_s))
        log(f"agg generation {g}: {n} records in {n_cont} containers, "
            f"send {send_s:.4f} s, drain {drain_s:.4f} s, "
            f"{n / (send_s + drain_s):.1f} sub-records/s; {len(ready)} "
            f"sweeps of {n_cont} slots, READY containers in each: {ready}; "
            f"launches {delta}")
    counts = read_counts()
    st = peer.stats
    check(len(peer.target_args["results"]) == GENERATIONS * n,
          "results lost")
    check((st["agg_sent"], st["agg_subs"], st["nacks"], st["rejected"])
          == (GENERATIONS * n_cont, GENERATIONS * n, 0, 0),
          f"agg full width stats {st}")
    check(peer.credits == n_cont and int(mb._mb.abs().sum().item()) == 0,
          "agg full width: credits not back or mailbox not cleared")
    log(f"agg full width: {GENERATIONS} generations x {n} records, every "
        f"result within rtol {TOL_PATH['rtol']}, atol {TOL_PATH['atol']}; "
        f"mailbox {SHARDS} x {AGG_SLOTS} x {mb.slot_words} int32 "
        f"({mb._mb.numel() * 4 / 1e6:.1f} MB); launches {counts}")
    return counts, rates, d


def phase_agg_timings(np, torch, dev, d, counts, rates, err):
    """The fused aggregate sweep, ``agg_ring_poll`` and ``ifunc_vm`` at the
    aggregate sweep's shapes, the lane's rates and the card's idle share;
    ``err`` is (the poll's, the sweep's) largest |err| of phase 2.
    Returns the ``agg_ring_poll`` kernels-line entry, ifunc_vm's largest
    |err| and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import mailbox_from_numpy
    from repro_torch.core.device_mailbox import (agg_sweep_plain,
                                                 make_agg_sweep,
                                                 pack_agg_word_frame)
    from repro_torch.kernels.agg_poll import (SUB_READY, agg_ring_poll,
                                              agg_ring_poll_plain)
    from repro_torch.kernels.ifunc_vm import (ifunc_vm_plain, ifunc_vm_slots,
                                              slot_tiles, sweep_kernel,
                                              vm_plan)
    from repro_torch.kernels.ring_poll import HDR_WORDS, READY

    bw, fp32, _ = card_peaks(torch.cuda.get_device_name(0))
    peer = d.peers["gpu-mesh"]
    mb = peer.rings[0].mailbox
    prog, ext, bound = mb.prog, mb.externals, mb.bound_hash
    k, body, W = AGG_K, T * T, mb.slot_words
    n_slots = SHARDS * AGG_SLOTS
    n_tiles = n_slots * k
    hw = HDR_WORDS + 2 * k
    rng = np.random.default_rng(12)
    n = n_tiles                             # records per generation

    # one traced generation with host timers, one under torch.profiler,
    # right after the untraced ones and before the timings' allocations
    h = d.src_ctx.handles["uvm_affine"]
    wall = statistics.median(s + dr for s, dr in rates)
    corr = iter(range(10 ** 6, 10 ** 7))
    spent, (send_s, drain_s) = traced_lane(d, lambda: send_agg_generation(
        d, h, rng.standard_normal((n, 1, T, T)).astype(np.float32),
        [next(corr) for _ in range(n)]))
    total = send_s + drain_s
    log(f"host breakdown of one traced agg generation: put (parse + "
        f"transcode + stage) {spent['put']:.4f} s, publish (H2D + deposit) "
        f"{spent['publish']:.4f} s, sweep {spent['sweep']:.4f} s, the rest "
        f"(payload packing in send_ifunc_many, dispatcher, engine, "
        f"completion) {total - sum(spent.values()):.4f} s; total "
        f"{total:.4f} s (untraced median {wall:.4f} s)")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        send_agg_generation(
            d, h, rng.standard_normal((n, 1, T, T)).astype(np.float32),
            [next(corr) for _ in range(n)])
    idle = log_card_busy(prof, wall, "card per agg generation")

    # a ring of full READY containers, as the path's sweep sees it
    words = np.stack([pack_agg_word_frame(
        list(rng.standard_normal((k, body)).astype(np.float32)), [bound] * k,
        k, body, W) for _ in range(n_slots)])
    ring = mailbox_from_numpy(words, dev).reshape(SHARDS, AGG_SLOTS, W)
    flat = ring.reshape(n_slots, W)
    hdr, tr = flat[:, :hw], flat[:, -1:]
    ap_ms, ap_wrap = kernel_times(
        torch, lambda: agg_ring_poll(hdr, tr, bound), "agg_poll_kernel", 200)
    ap_plain = cuda_ms(torch, lambda: agg_ring_poll_plain(hdr, tr, bound), 50)
    ap_bytes = n_slots * ((hw + 1) * 4 + (1 + k) * 4)
    ap_bound = ap_bytes / bw * 1e3

    tiles = slot_tiles(flat, hw, k)
    vm = vm_plan(prog).kernel
    out = ifunc_vm_slots(prog, flat, hw, k, ext)
    ref = ifunc_vm_plain(prog, tiles, ext)
    vm_err = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, rtol=TOL_FIXED, atol=TOL_FIXED),
          f"ifunc_vm {n_tiles} tiles max |err| {vm_err:.3g}")
    vm_ms, vm_wrap = kernel_times(
        torch, lambda: ifunc_vm_slots(prog, flat, hw, k, ext), vm, 10,
        require=True)
    vm_plain = cuda_ms(torch, lambda: ifunc_vm_plain(prog, tiles, ext), 5)
    x4 = tiles.view(SHARDS, n_tiles // SHARDS, T, T)
    w4 = ext[:, 0][:, None]
    vm_lib = cuda_ms(torch, lambda: torch.relu(torch.matmul(x4, w4)), 10)
    vm_flops = uvm_flops(prog, n_tiles)
    vm_bound = max(vm_flops / fp32,
                   (tiles.numel() + out.numel() + ext.numel()) * 4 / bw) * 1e3
    del out, ref

    # the fused sweep: a ring of full READY containers, and the path's
    # occupancy (one deposit of 8 containers, one a shard, into 32 slots)
    sweep = make_agg_sweep(prog, k, 1, bound_hash=bound)
    kernel = sweep_kernel(prog, k)
    full = ring.clone()
    sw = {}
    for case, n_ready in (("full", n_slots), ("path", SHARDS)):
        pristine = full if case == "full" else torch.zeros_like(ring)
        pristine[:, 0] = full[:, 0]
        ring.copy_(pristine)
        st, sub, _, _ = sweep(ring, ext)
        check(int((st == READY).sum()) == n_ready
              and int((sub == SUB_READY).sum()) == n_ready * k
              and not ring.any(),
              f"agg sweep {case}: {int((st == READY).sum())} READY of "
              f"{n_ready}, or the ring not cleared")
        del st, sub
        ms, ev = sweep_times(torch, sweep, ring, pristine, ext, kernel, 10)
        plain = restored_ms(
            torch, lambda: agg_sweep_plain(prog, ring, ext, k, 1,
                                           bound_hash=bound),
            ring, pristine, 3)
        # status words: the header block and the trailer, 1 + K statuses
        bound_ms, by, nb, fl = sweep_bound(
            n_slots, hw + 2 + k, n_ready * k, n_tiles, n_ready * W, ext,
            uvm_flops(prog, n_ready * k), bw, fp32)
        sw[case] = (ms, ev, plain, bound_ms, by)
        log(f"agg sweep ({kernel}, one launch) {case} ring, {n_ready} READY "
            f"containers of {n_slots} x K={k}: {ms:.4f} ms on the card "
            f"(events {ev:.4f}, plain sweep {plain:.4f}); bound "
            f"{bound_ms:.4f} ms by {by} ({nb / 2 ** 20:.1f} MiB, "
            f"{fl / 1e9:.3f} GFLOP), {bound_ms / ms:.3f} of it")
    sw_ms, sw_ev, sw_plain, sw_bound, sw_by = sw["full"]

    send = sum(s for s, _ in rates)
    drain = sum(dr for _, dr in rates)
    log(f"agg_ring_poll {n_slots} slots x K={k}: {ap_ms:.5f} ms on the card "
        f"(wrapper {ap_wrap:.4f}, plain {ap_plain:.4f}, bound "
        f"{ap_bound:.3g} ms by {ap_bytes} B)")
    log(f"ifunc_vm uvm_affine {n_tiles} tiles in place ({vm}): {vm_ms:.4f} "
        f"ms on the card (wrapper {vm_wrap:.4f}, plain {vm_plain:.4f}, "
        f"torch.relu(torch.matmul) {vm_lib:.4f}, bound {vm_bound:.4f} ms; "
        f"{vm_flops / vm_ms / 1e9:.2f} TFLOP/s, {vm_bound / vm_ms:.3f} of the "
        f"bound, {vm_ms / vm_lib:.2f}x torch.relu(torch.matmul)); "
        f"standalone agg_poll_kernel {ap_ms:.5f} ms beside the sweep's "
        f"{sw_ms:.4f}")
    log(f"agg path: {n * len(rates)} sub-records in {send + drain:.3f} s = "
        f"{n * len(rates) / (send + drain):.1f} sub-records/s (send "
        f"{send:.3f} s = {n * len(rates) / send:.1f}/s, drain {drain:.3f} s "
        f"= {n * len(rates) / drain:.1f}/s)")

    entry = {"name": "agg_ring_poll", "route": "cuda",
             "source": "src/repro_torch/csrc/ifunc_vm.cu",
             "kernel": kernel, "poll": "src/repro_torch/csrc/mailbox_poll.cuh",
             "replaces": "src/repro/kernels/agg_poll.py:92",
             "launches": counts["agg_sweep"], "launches_a_sweep": 1,
             "max_abs_err": max(err), "ms": sw_ms, "wrapper_ms": sw_ev,
             "path_ms": sw["path"][0], "path_bound_ms": sw["path"][3],
             "plain_ms": sw_plain, "bound_ms": sw_bound, "bound_by": sw_by,
             "library_ms": None, "standalone_ms": ap_ms,
             "standalone_wrapper_ms": ap_wrap,
             "standalone_plain_ms": ap_plain,
             "standalone_bound_ms": ap_bound}
    return entry, max(vm_err, 0.0), idle

# ------------------------------------------------------------ host target


def phase_host_quickstart():
    """The paper's Listing 1.4 on the port (``rle_insert``, PYBC, linked
    and run on the host) and the AM baseline's eager and rendezvous
    sends."""
    from repro_torch.core import (AmContext, AmEndpoint, Context, Status,
                                  ifunc_msg_create, ifunc_msg_free,
                                  ifunc_msg_send_nbix, poll_ifunc,
                                  register_ifunc)

    source, target = Context("source"), Context("target")
    region = target.nic.mem_map(1 << 20)
    ep = source.nic.connect(target.nic)
    record = b"aaaaabbbbbccccc" * 100
    msg = ifunc_msg_create(register_ifunc(source, "rle_insert"), record)
    nbytes = msg.nbytes
    ifunc_msg_send_nbix(ep, msg, region.base, region.rkey)
    ifunc_msg_free(msg)
    db = {"db": []}
    check(poll_ifunc(target, region.view(), None, db) == Status.OK,
          "quickstart frame not executed")
    check(db["db"] == [record], "quickstart record not decoded")
    check((target.stats["links"], target.stats["executed"]) == (1, 1),
          f"quickstart stats {target.stats}")

    a, b = AmContext("a"), AmContext("b")
    seen = []
    b.register(3, lambda p, n, t: seen.append(n))
    am = AmEndpoint(a, b)
    am.send(3, b"small")
    am.send(3, b"L" * HOST_AM_RNDV)
    am.flush()
    check(b.progress() == 2 and seen == [5, HOST_AM_RNDV],
          f"AM eager + rendezvous: {seen}")
    log(f"quickstart: {nbytes} B frame for a {len(record)} B record, "
        f"decoded; links={target.stats['links']} "
        f"executed={target.stats['executed']}; AM eager 5 B and rendezvous "
        f"{HOST_AM_RNDV} B both executed")


def send_host_generation(ep, ring, h, pays):
    """Put one frame a slot into ``ring`` through the endpoint's raw
    channel, then flush."""
    from repro_torch.core import ifunc_msg_create, ifunc_msg_send_nbix
    from repro_torch.transport import endpoint_channel

    for p in pays:
        ifunc_msg_send_nbix(ep, ifunc_msg_create(h, p),
                            ring.slot_addr(ring.tail), ring.region.rkey)
        ring.tail += 1
    endpoint_channel(ep).flush()


def host_generation(torch, ep, ring, h, tgt, targs, pays):
    """One generation sent and drained by ``ring_mailbox(ring).sweep``,
    ending in a synchronize; returns (send s, drain s, results)."""
    from repro_torch.core import Status
    from repro_torch.transport import ring_mailbox

    targs["results"] = []
    t0 = time.perf_counter()
    send_host_generation(ep, ring, h, pays)
    t1 = time.perf_counter()
    sts = ring_mailbox(ring).sweep(tgt, targs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(sts == [Status.OK] * len(pays),
          f"host sweep: {[s.name for s in sts[:4]]}... of {len(pays)}")
    return t1 - t0, t2 - t1, targs["results"]


def check_host_results(torch, got, x, W, what):
    want = torch.relu(torch.from_numpy(x).to(W.device) @ W)
    check(len(got) == len(want), f"{what}: {len(got)} results of "
                                 f"{len(want)}")
    got = torch.stack(got)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: results {tuple(got.shape)} or not finite")
    check(torch.allclose(got, want, **TOL_PATH),
          f"{what}: max |err| {(got - want).abs().max().item():.3g}")


def host_hlo_frame(torch, tgt, region, ch):
    """An HLO frame, a ``torch.export`` program traced on CPU tensors,
    polled on the card target: it is moved there at link time, runs there
    and its result equals the CPU's (integers below 2 ** 24: exact in f32
    whatever the order of the sum)."""
    from repro_torch.core import CodeKind, Status, poll_ifunc
    from repro_torch.core import codegen as CG
    from repro_torch.core import frame as F

    def affine_sum(x):
        return (x.to(torch.float32) * 3 - 7).sum()

    payload = bytes(range(256)) * 16
    code = CG.serialize_hlo(affine_sum, (torch.zeros(len(payload),
                                                     dtype=torch.uint8),))
    ch.put_raw(F.pack_frame("hlo_affine_sum", code, payload, CodeKind.HLO),
               region.base, region.rkey)
    targs = {}
    st = poll_ifunc(tgt, region.view(), None, targs)
    check(st == Status.OK, f"HLO frame {st.name}: {tgt.stats}")
    got = targs["result"]
    want = affine_sum(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
          f"HLO frame: {got} on {got.device}, want {want}")
    log(f"HLO frame ({len(code)} B torch.export program traced on the CPU, "
        f"{len(payload)} B payload): OK on {got.device}, {float(got)} equal "
        f"to the CPU's")


def phase_host_target(np, torch, dev):
    """Phase 18: the bare API on a host target over the emulated RDMA
    fabric, μVM frames through ``ifunc_vm`` on the card.  Returns the
    ``ifunc_vm`` launches of the phase's path, the kernel's device ms a
    frame, and its largest |err| against the plain version."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (Context, RingBuffer, Status,
                                  ifunc_msg_create, ifunc_msg_send_nbix,
                                  ifunc_msg_to_full, poll_ifunc,
                                  register_ifunc)
    from repro_torch.core import frame as F
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.kernels.ifunc_vm import (ifunc_vm, ifunc_vm_plain,
                                              vm_plan)
    from repro_torch.transport import endpoint_channel, ring_mailbox

    phase_host_quickstart()
    name = torch.cuda.get_device_name(0)
    src, tgt = Context("host-source"), Context("host-target", device=dev)
    h = register_ifunc(src, "uvm_affine")
    prog = deserialize_uvm(h.lib.code)
    kernel = vm_plan(prog).kernel
    frame_len = ifunc_msg_create(h, np.zeros((NT, T, T), np.float32)).nbytes
    slot = (frame_len + 4095) & ~4095
    ring = RingBuffer(tgt.nic.mem_map(HOST_SLOTS * slot), slot)
    mb = ring_mailbox(ring)
    ep = src.nic.connect(tgt.nic)
    ch = endpoint_channel(ep)
    rng = np.random.default_rng(18)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(dev)
    targs = {"externals": {"W": W}}       # resident: never copied a frame
    log(f"host target: {HOST_SLOTS} slots of {slot} B ({frame_len} B "
        f"frames, {NT} tiles) in a {HOST_SLOTS * slot / 2 ** 20:.1f} MiB "
        f"region; W resident on {name}")

    # -- the path: 3 generations, one 128-tile frame, the behaviours and
    #    a K = 64 container, every ifunc_vm launch counted
    torch.cuda.synchronize()
    reset_counts()
    polled = 0
    rates = []
    for g in range(HOST_GENS):
        pays = rng.standard_normal((HOST_SLOTS, NT, T, T)).astype(np.float32)
        send_s, drain_s, res = host_generation(torch, ep, ring, h, tgt, targs,
                                               pays)
        check_host_results(torch, res, pays, W, f"host generation {g}")
        polled += HOST_SLOTS
        rates.append((send_s, drain_s))
        log(f"host generation {g}: {HOST_SLOTS} frames, send {send_s:.4f} s, "
            f"sweep {drain_s:.4f} s, {HOST_SLOTS / (send_s + drain_s):.1f} "
            f"frames/s")
    check(tgt.stats["links"] == 1, f"links {tgt.stats['links']}, want 1")
    check(ifunc_vm.launches == polled,
          f"{ifunc_vm.launches} ifunc_vm launches for {polled} frames")

    big = rng.standard_normal((HOST_BIG, T, T)).astype(np.float32)
    msg = ifunc_msg_create(h, big)
    one = tgt.nic.mem_map((msg.nbytes + 4095) & ~4095)
    ifunc_msg_send_nbix(ep, msg, one.base, one.rkey)
    ch.flush()
    t0 = time.perf_counter()
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.OK,
          "128-tile frame not executed")
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    polled += 1
    big_out = targs["result"]
    check_host_results(torch, [big_out], big[None], W, "128-tile frame")
    tiles = torch.from_numpy(big).to(dev)
    err = (big_out - ifunc_vm_plain(prog, tiles, W[None])).abs().max().item()
    check(err <= TOL_FIXED, f"128-tile frame vs ifunc_vm_plain: {err:.3g}")
    log(f"one frame of {HOST_BIG} tiles ({msg.nbytes / 2 ** 20:.2f} MiB): "
        f"{big_s * 1e3:.3f} ms polled, ending in a synchronize; max |err| "
        f"{err:.3g} against ifunc_vm_plain")

    # a SLIM frame after an eviction NACKs, a corrupt code section is
    # REJECTED, the FULL resend runs
    x1 = rng.standard_normal((1, T, T)).astype(np.float32)
    check(tgt.link_cache.evict("uvm_affine", h.digest), "nothing to evict")
    slim = ifunc_msg_create(h, x1, slim=True)
    ifunc_msg_send_nbix(ep, slim, one.base, one.rkey)
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.NACK_UNCACHED
          and tgt.stats["nacks"] == 1 and not any(one.buf[:slim.nbytes]),
          f"SLIM after eviction: {tgt.stats}")
    full = ifunc_msg_to_full(slim)
    bad = bytearray(full.frame)
    bad[F.HEADER_LEN + 20] ^= 0x10
    ch.put_raw(bad, one.base, one.rkey)
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.REJECTED
          and "digest mismatch" in tgt.stats["last_reject"]
          and not any(one.buf[:len(bad)]), f"corrupt code: {tgt.stats}")
    ifunc_msg_send_nbix(ep, full, one.base, one.rkey)
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.OK
          and tgt.stats["links"] == 2, f"FULL resend: {tgt.stats}")
    polled += 1
    check_host_results(torch, [targs["result"]], x1[None], W, "FULL resend")

    # a put whose trailer is withheld: IN_PROGRESS, then OK after flush
    spins, tgt.max_trailer_spins = tgt.max_trailer_spins, 64
    msg = ifunc_msg_create(h, x1)
    ifunc_msg_send_nbix(ep, msg, one.base, one.rkey,
                        deliver_bytes=msg.nbytes - F.TRAILER_LEN)
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.IN_PROGRESS,
          "withheld trailer not IN_PROGRESS")
    ch.flush()
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.OK,
          "withheld trailer not OK after flush")
    tgt.max_trailer_spins = spins
    polled += 1
    check_host_results(torch, [targs["result"]], x1[None], W, "flushed put")

    # a FLAG_AGG container of K one-tile records: one launch each
    xs = rng.standard_normal((HOST_AGG_K, T, T)).astype(np.float32)
    subs = [F.AggSub("uvm_affine", F.CodeKind.UVM, h.digest, 1000 + i,
                     xs[i].tobytes()) for i in range(HOST_AGG_K)]
    buf = bytearray(F.agg_frame_len(subs))
    ch.put_raw(buf[:F.seal_agg_frame(buf, subs, kind=F.CodeKind.UVM)],
               one.base, one.rkey)
    before = ifunc_vm.launches
    check(poll_ifunc(tgt, one.view(), None, targs) == Status.OK,
          "agg container not consumed")
    recs = tgt.last_agg_results
    check(len(recs) == HOST_AGG_K and ifunc_vm.launches - before
          == HOST_AGG_K, f"agg: {len(recs)} records, "
                         f"{ifunc_vm.launches - before} launches")
    bad_recs = [(r.corr_id, r.status.name, repr(r.error)) for r in recs
                if r.status != Status.OK or r.error is not None]
    check(not bad_recs, f"agg records failed: {bad_recs[:4]}")
    check([r.corr_id for r in recs] == [1000 + i for i in range(HOST_AGG_K)],
          "agg corr ids out of order")
    check_host_results(torch, [r.value[0] for r in recs], xs, W, "agg")
    polled += HOST_AGG_K
    host_hlo_frame(torch, tgt, one, ch)
    counts = read_counts()
    check(counts["ifunc_vm"] == polled and all(
        v == 0 for k, v in counts.items() if k != "ifunc_vm"),
        f"host path launched {counts}, want {polled} ifunc_vm and nothing "
        f"else")
    log(f"host behaviours: SLIM after evict -> NACK_UNCACHED, corrupt code "
        f"-> REJECTED, FULL resend -> OK (links {tgt.stats['links']}); "
        f"withheld trailer -> IN_PROGRESS, flush -> OK; FLAG_AGG K="
        f"{HOST_AGG_K} -> {HOST_AGG_K} records OK, {HOST_AGG_K} launches; "
        f"path launches {counts}; stats {tgt.stats}")

    # -- timings, outside the counted run
    wall = statistics.median(s + d for s, d in rates)
    n_all = HOST_SLOTS * HOST_GENS
    tot = sum(s + d for s, d in rates)
    log(f"host path on {name}: {n_all} frames in {tot:.3f} s = "
        f"{n_all / tot:.1f} frames/s (median generation {wall:.4f} s = "
        f"{HOST_SLOTS / wall:.1f} frames/s, send {sum(s for s, _ in rates):.3f}"
        f" s, sweep {sum(d for _, d in rates):.3f} s)")

    # host timers: the linked run_uvm and clear_frame, the rest of the
    # sweep is the poll (header, policy, trailer, cache lookup)
    key = ("uvm_affine", h.digest)
    run_uvm = tgt.link_cache.entries[key]
    clear = F.clear_frame
    spent = {"run_uvm": 0.0, "clear_frame": 0.0}

    def timed(what, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[what] += time.perf_counter() - t
        return wrapper

    tgt.link_cache.entries[key] = timed("run_uvm", run_uvm)
    F.clear_frame = timed("clear_frame", clear)
    try:
        pays = rng.standard_normal((HOST_SLOTS, NT, T, T)).astype(np.float32)
        send_s, drain_s, res = host_generation(torch, ep, ring, h, tgt, targs,
                                               pays)
    finally:
        tgt.link_cache.entries[key] = run_uvm
        F.clear_frame = clear
    check_host_results(torch, res, pays, W, "timed host generation")
    poll_s = drain_s - spent["run_uvm"] - spent["clear_frame"]
    log(f"host breakdown of one timed generation ({HOST_SLOTS} frames): send "
        f"(create + put + flush) {send_s:.4f} s; sweep {drain_s:.4f} s = "
        f"poll (header, policy, trailer, cache lookup, sweep loop) "
        f"{poll_s:.4f} s + run_uvm (copy out, H2D, launch) "
        f"{spent['run_uvm']:.4f} s + clear_frame {spent['clear_frame']:.4f} "
        f"s; per frame {drain_s / HOST_SLOTS * 1e6:.1f} us = "
        f"{poll_s / HOST_SLOTS * 1e6:.1f} + "
        f"{spent['run_uvm'] / HOST_SLOTS * 1e6:.1f} + "
        f"{spent['clear_frame'] / HOST_SLOTS * 1e6:.1f} us")

    pays = rng.standard_normal((HOST_SLOTS, NT, T, T)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, res = host_generation(torch, ep, ring, h, tgt, targs, pays)
    check_host_results(torch, res, pays, W, "traced host generation")
    idle = log_card_busy(prof, wall, "card per host generation", (kernel,))
    from torch.autograd import DeviceType

    mine = [e.device_time_total / 1e3 for e in prof.events()
            if e.device_type == DeviceType.CUDA and kernel in e.name]
    frame_ms = sum(mine) / len(mine) if mine else None
    log(f"{kernel}: {len(mine)} device records in a traced generation of "
        f"{HOST_SLOTS} frames"
        + ("" if mine else ": device time not measured"))

    # the 128-tile frame's parts: its pageable H2D and its kernel
    h2d_ms = cuda_ms(torch, lambda: torch.from_numpy(big).to(dev), 5)
    big_ms = device_ms(torch, lambda: ifunc_vm(prog, tiles, W[None]), kernel,
                       10)
    log(f"128-tile frame parts: pageable H2D {h2d_ms:.4f} ms "
        f"({big.nbytes / 2 ** 20:.0f} MiB), {kernel} "
        + ("not measured" if big_ms is None else f"{big_ms:.4f} ms")
        + f", of {big_s * 1e3:.3f} ms polled; {kernel} a {NT}-tile frame "
        + ("not measured" if frame_ms is None else f"{frame_ms:.4f} ms")
        + (f"; SMs idle {idle:.4f} of a generation" if idle is not None
           else ""))
    return {"launches": polled, "ms": frame_ms, "err": err,
            "rate": HOST_SLOTS / wall}


# ------------------------------------------------ the Dispatcher's host lanes


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class no_plain:
    """Within the block, every plain version of a kernel raises: a lane
    that fell back to one on the card fails the phase instead of passing
    slowly."""

    def __enter__(self):
        import importlib

        self.saved = []
        for name in ("kernels.ifunc_vm", "kernels.ring_poll",
                     "kernels.agg_poll", "core.device_mailbox"):
            mod = importlib.import_module(f"repro_torch.{name}")
            for attr in dir(mod):
                if attr.endswith("_plain") and callable(getattr(mod, attr)):
                    self.saved.append((mod, attr, getattr(mod, attr)))
                    setattr(mod, attr, self._refuse(f"{name}.{attr}"))
        return self

    @staticmethod
    def _refuse(what):
        def plain(*a, **k):
            raise SmokeError(f"{what} ran on the card's path")
        return plain

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def multi_peer_dispatcher(np, torch, dev, obs, *, shards, dev_slots,
                          host_slots, seed):
    """Phase 19's topology, the port's ``examples/multi_peer.py``: one
    source ``Dispatcher`` (flush threshold 8, trailers withheld until
    flush, coalescing on with up to ``MP_AGG`` records a container) over
    ``rdma_a`` and ``rdma_b`` (``RdmaFabric``) and ``csd``
    (``LoopbackFabric``), each a ``device=dev`` target of ``host_slots``
    slots of phase 18's size with W resident on ``dev``, and ``gpu``, a
    ``DeviceMeshFabric(shards, shift=0)`` of ``dev_slots`` slots a shard
    of two tiles, W broadcast on ``dev``.  Returns (dispatcher,
    ``uvm_affine`` handle, W, rng)."""
    from repro_torch.core import Context, ifunc_msg_create, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       LoopbackFabric, ProgressEngine,
                                       RdmaFabric)

    source = Context("source")
    h = register_ifunc(source, "uvm_affine")
    rng = np.random.default_rng(seed)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(dev)
    d = Dispatcher(source, ProgressEngine(flush_threshold=8,
                                          inflight_window="trailer"),
                   obs=obs)
    d.set_coalescing(True, max_subs=MP_AGG)
    frame_len = ifunc_msg_create(h, np.zeros((NT, T, T), np.float32)).nbytes
    slot = (frame_len + 4095) & ~4095
    for name, kind in MP_HOSTS:
        fabric = RdmaFabric() if kind == "rdma" else LoopbackFabric()
        d.add_peer(name, fabric, Context(name, link_mode="remote",
                                         device=dev),
                   n_slots=host_slots, slot_size=slot,
                   target_args={"externals": {"W": W}, "results": []})
    d.add_peer("gpu", DeviceMeshFabric(shards, shift=0, device=dev), None,
               n_slots=dev_slots, slot_size=(NT * T * T + 64) * 4,
               prog=deserialize_uvm(h.lib.code), n_tiles=NT,
               externals=W.expand(shards, 1, T, T))
    return d, h, W, rng


def mp_generation(torch, dev, d, h, peers, pays, evict=None):
    """Send one payload after another to each of ``peers`` through
    ``send_ifunc``, retrying on backpressure through ``drain`` as
    ``examples/multi_peer.py`` does, then drain; ends in a synchronize.
    ``evict`` = (peer, i): before payload i, drain and invalidate
    ``uvm_affine`` in that peer's link cache.  Returns (send s, drain s,
    backpressure retries)."""
    retries = 0
    t0 = time.perf_counter()
    for i, p in enumerate(pays):
        if evict is not None and i == evict[1]:
            d.drain()
            d.peers[evict[0]].target_ctx.link_cache.invalidate("uvm_affine")
        for peer in peers:
            while not d.send_ifunc(peer, h, p):
                retries += 1
                d.drain()
    t1 = time.perf_counter()
    d.drain()
    sync(torch, dev)
    return t1 - t0, time.perf_counter() - t1, retries


def match_results(torch, got, want, what):
    """Hold results that may come back in another order (device shards
    sweep shard by shard) against ``want``: pair each with the nearest
    expected one by its row sums, require a permutation, then each pair
    within TOL_PATH."""
    check(len(got) == len(want), f"{what}: {len(got)} results, want "
                                 f"{len(want)}")
    g = torch.stack(got)
    check(g.shape == want.shape and bool(torch.isfinite(g).all()),
          f"{what}: results {tuple(g.shape)} or not finite")
    perm = torch.cdist(g.sum(-1).flatten(1), want.sum(-1).flatten(1)).argmin(1)
    check(torch.unique(perm).numel() == len(got),
          f"{what}: results do not pair one to one with the payloads")
    check(torch.allclose(g, want[perm], **TOL_PATH),
          f"{what}: max |err| {(g - want[perm]).abs().max().item():.3g}")


def mp_check(torch, d, peers, pays, W, what):
    """The results of one generation at each of ``peers`` against
    relu(x @ W): host peers in send order (their rings keep it, resends
    included), the device peer matched as the example matches.  Clears
    the results."""
    want = torch.relu(torch.from_numpy(pays).to(W.device) @ W)
    for name in peers:
        peer = d.peers[name]
        got = peer.target_args["results"]
        if peer.fabric.kind == "device":
            match_results(torch, got, want, f"{what} {name}")
            peer.rings[0].mailbox.results.clear()
        else:
            check_host_results(torch, got, pays, W, f"{what} {name}")
        got.clear()


def mp_burst(d, hosts, burst):
    """Act two: a ``counter_bump`` warm-up (FULL, PYBC, run on the host)
    to each host peer, then ``burst`` records to each through
    ``send_ifunc_many``; returns the records a container carried."""
    from repro_torch.core import register_ifunc

    h = register_ifunc(d.src_ctx, "counter_bump")
    for name in hosts:
        check(d.send_ifunc(name, h, b"warm"), f"{name}: warm-up refused")
    d.drain()
    before = {n: dict(d.peers[n].stats) for n in hosts}
    pays = [bytes([i & 0x7F]) * 8 for i in range(burst)]
    for name in hosts:
        sent = d.send_ifunc_many(name, h, pays)
        check(sent == burst, f"{name}: {sent} of {burst} burst records "
                             f"accepted")
    d.drain()
    frames = subs = 0
    for name in hosts:
        s, b = d.peers[name].stats, before[name]
        count = d.peers[name].target_args.get("count", 0)
        check(count == burst + 1, f"{name}: count {count}, want "
                                  f"{burst + 1}")
        frames += s["agg_sent"] - b["agg_sent"]
        subs += s["agg_subs"] - b["agg_subs"]
    return subs / max(frames, 1), frames, subs


def multi_peer_gates(d, obs, trace_path):
    """The example's gates (``examples/multi_peer.py:153-211``): no
    rejects, unrecovered NACKs, undrained resends, unflushed puts or
    coalesced records left; real aggregation; spans recorded with none
    left open; the registry's ``peer.*.sent`` equal to the peer stats; a
    non-empty ``deliver_us`` and flight recorder.  Prints MULTI_PEER_OK,
    AGG_OK and OBS_OK, or fails the phase with every failure named."""
    failures = []
    agg_frames = agg_subs = 0
    for name, peer in d.peers.items():
        s = peer.stats
        if s["rejected"]:
            failures.append(f"{name}: {s['rejected']} rejected frames")
        if s["nack_lost"]:
            failures.append(f"{name}: {s['nack_lost']} unrecoverable NACKs")
        if s["nacks"] > s["resent"]:
            failures.append(f"{name}: {s['nacks']} NACKs but only "
                            f"{s['resent']} FULL retransmits")
        if peer.resend:
            failures.append(f"{name}: {len(peer.resend)} retransmits "
                            f"undrained")
        leftover = sum(len(q.subs) for q in peer.coalesce.values())
        if leftover:
            failures.append(f"{name}: {leftover} coalesced records undrained")
        agg_frames += s["agg_sent"]
        agg_subs += s["agg_subs"]
    if d.engine.outstanding():
        failures.append(f"{d.engine.outstanding()} puts never flushed")
    if agg_frames == 0 or agg_subs / agg_frames < 2.0:
        failures.append(f"no real aggregation: {agg_subs} records in "
                        f"{agg_frames} containers")
    snap = obs.snapshot()
    doc = obs.tracer.export_chrome(trace_path)
    spans = obs.tracer.spans()
    if not spans:
        failures.append("obs: no spans recorded with tracing on")
    if obs.tracer.open_count():
        failures.append(f"obs: {obs.tracer.open_count()} orphan spans: "
                        f"{[s.name for s in obs.tracer.open_spans()][:8]}")
    sent_metric = sum(v for k, v in snap["counters"].items()
                      if k.startswith("peer.") and k.endswith(".sent"))
    sent_stats = sum(p.stats["sent"] for p in d.peers.values())
    if sent_metric != sent_stats:
        failures.append(f"obs: registry sees {sent_metric} sends, peer "
                        f"stats say {sent_stats}")
    if obs.rtt_hist.count == 0:
        failures.append("obs: deliver_us histogram empty after a fan-out")
    if len(obs.recorder) == 0:
        failures.append("obs: flight recorder empty after transport traffic")
    check(not failures, "MULTI_PEER_FAILED:" + "; ".join(failures))
    log(f"aggregate occupancy: {agg_subs} records / {agg_frames} containers "
        f"= {agg_subs / agg_frames:.1f} per frame; trace: "
        f"{len(doc['traceEvents'])} events ({len(spans)} spans, "
        f"{len(obs.tracer.spans(cat='wire'))} wire), metrics: "
        f"{len(snap['counters'])} counters")
    for line in ("MULTI_PEER_OK", "AGG_OK", "OBS_OK"):
        log(line)


def hist_quantiles(obs, before):
    """p50 and p99 (the upper bounds of their power-of-two buckets, in
    µs) and count of each latency histogram since the snapshot
    ``before``."""
    from repro_torch.obs import Histogram, delta

    out = {}
    for name, snap in delta(obs.snapshot(), before)["histograms"].items():
        h = Histogram.from_snapshot(name, snap)
        if h.count:
            out[name] = (h.quantile(0.5), h.quantile(0.99), h.count)
    return out


def multi_peer_path(np, torch, dev, trace_dir, *, shards=SHARDS,
                    dev_slots=SLOTS_FULL, host_slots=MP_SLOTS,
                    gens=MP_GENS, burst=MP_BURST, seed=19):
    """Phase 19's counted run: act one (``gens`` generations of
    ``shards * dev_slots`` two-tile payloads to each of the four peers,
    the first frame to each host peer FULL and the rest SLIM, ``rdma_b``'s
    link cache invalidated halfway through generation ``MP_EVICT_GEN``),
    act two (``mp_burst``) and the gates, with every launch counted (on
    the card, where every plain version refuses to run).  Returns
    (dispatcher, handle, W, rng, a dict of what the run showed)."""
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.kernels.ifunc_vm import sweep_kernel, vm_plan
    from repro_torch.obs import Obs

    obs = Obs("multi_peer", trace=True)
    d, h, W, rng = multi_peer_dispatcher(
        np, torch, dev, obs, shards=shards, dev_slots=dev_slots,
        host_slots=host_slots, seed=seed)
    prog = deserialize_uvm(h.lib.code)
    n = shards * dev_slots
    hosts = [name for name, _ in MP_HOSTS]
    peers = hosts + ["gpu"]
    mb = d.peers["gpu"].rings[0].mailbox
    sweeps = []                       # launches moved by each device sweep

    def counted_sweep(*a, **k):
        before = _counted()["ring_sweep"].launches
        ran = mb._deposited > 0
        out = type(mb).sweep(mb, *a, **k)
        if ran:
            sweeps.append(_counted()["ring_sweep"].launches - before)
        return out

    mb.sweep = counted_sweep
    sync(torch, dev)
    reset_counts()
    gen_s = []
    try:
        with no_plain() if dev.type == "cuda" else contextlib.nullcontext():
            snap0 = obs.snapshot()
            for g in range(gens):
                pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
                if g == 0:
                    # the first frame to each host peer ships FULL; its
                    # confirmed delivery turns the rest SLIM
                    a = mp_generation(torch, dev, d, h, peers, pays[:1])
                    b = mp_generation(torch, dev, d, h, peers, pays[1:])
                    send_s, drain_s, retries = (a[0] + b[0], a[1] + b[1],
                                                a[2] + b[2])
                else:
                    evict = ("rdma_b", n // 2) if g == MP_EVICT_GEN else None
                    send_s, drain_s, retries = mp_generation(
                        torch, dev, d, h, peers, pays, evict=evict)
                mp_check(torch, d, peers, pays, W, f"generation {g}")
                gen_s.append(send_s + drain_s)
                log(f"multi-peer generation {g}: {len(peers)} x {n} frames, "
                    f"send {send_s:.4f} s, drain {drain_s:.4f} s, "
                    f"{len(peers) * n / (send_s + drain_s):.1f} frames/s, "
                    f"{retries} backpressure retries")
            act_one = hist_quantiles(obs, snap0)
            snap1 = obs.snapshot()
            occupancy, containers, records = mp_burst(d, hosts, burst)
            act_two = hist_quantiles(obs, snap1)
            counts = read_counts()
    finally:
        del mb.sweep
    for name in hosts:
        s = d.peers[name].stats
        nacks = n // 2 if name == "rdma_b" else 0
        check((s["nacks"], s["resent"], s["nack_lost"]) == (nacks, nacks, 0),
              f"{name}: nacks {s['nacks']}, resent {s['resent']}, "
              f"nack_lost {s['nack_lost']}; want {nacks}, {nacks}, 0")
        # act one: gens x n uvm_affine frames, one FULL; act two: the
        # FULL warm-up and burst // MP_AGG containers, all SLIM
        check(s["slim_sent"] == gens * n - 1 + burst // MP_AGG
              and s["sent"] == gens * n + nacks + 1 + burst // MP_AGG,
              f"{name}: sent {s['sent']}, slim {s['slim_sent']}")
    s = d.peers["gpu"].stats
    check(s["slim_sent"] == s["sent"] == s["delivered"] == gens * n,
          f"gpu: {s}")
    host_frames = gens * n * len(hosts)
    res = {"counts": counts, "sweeps": len(sweeps), "host_frames":
           host_frames, "gen_s": gen_s, "act_one": act_one,
           "act_two": act_two, "occupancy": occupancy}
    log(f"act two: {burst} counter_bump records to each of {len(hosts)} "
        f"host peers in {containers} containers ({occupancy:.1f} records "
        f"a container); rdma_b: {n // 2} NACKs after the eviction, "
        f"{n // 2} FULL resends in ring order, nack_lost 0")
    if dev.type == "cuda":
        check(vm_plan(prog).kernel == "ifunc_vm_smem_kernel"
              and sweep_kernel(prog) == "ring_sweep_smem_kernel",
              f"uvm_affine takes {vm_plan(prog).kernel} and "
              f"{sweep_kernel(prog)}")
        check(counts["ifunc_vm"] == host_frames,
              f"{counts['ifunc_vm']} ifunc_vm launches for {host_frames} "
              f"host μVM frames polled")
        check(sweeps and set(sweeps) == {1}
              and counts["ring_sweep"] == len(sweeps),
              f"{counts['ring_sweep']} ring_sweep launches in "
              f"{len(sweeps)} device sweeps ({sorted(set(sweeps))} each)")
        check(all(v == 0 for k, v in counts.items()
                  if k not in ("ifunc_vm", "ring_sweep")),
              f"phase 19 launched {counts}, want ifunc_vm and ring_sweep "
              f"alone")
        log(f"multi-peer launches {counts}: ifunc_vm_smem_kernel once for "
            f"each of {host_frames} host μVM frames (resends included), "
            f"ring_sweep_smem_kernel once in each of {len(sweeps)} device "
            f"sweeps; no plain version ran")
    d.print_stats()
    multi_peer_gates(d, obs, pathlib.Path(trace_dir) / "multi_peer.json")
    return d, h, W, rng, res


def offload_compress(tmp):
    """The port's ``examples/offload_compress.py``: ``rle_insert`` (the
    port's own library, copied to ``tmp``) through a ``Dispatcher`` over
    ``RdmaFabric`` into one storage context; then the copy is edited (a v2
    codec under the same name) and a fresh ingest node sends the rest —
    linked anew at the storage context, which never restarts."""
    import shutil

    import repro_torch
    from repro_torch.core import Context, ifunc_msg_create, register_ifunc
    from repro_torch.transport import Dispatcher, ProgressEngine, RdmaFabric

    stage = pathlib.Path(tmp)
    shutil.copy(pathlib.Path(repro_torch.__file__).parent / "ifunc_libs"
                / "rle_insert.py", stage / "rle_insert.py")
    storage = Context("storage", lib_dir=stage, link_mode="remote")
    db = {"db": []}
    records = [bytes([i % 7]) * 400 for i in range(64)]

    def ingest(name, recs):
        d = Dispatcher(Context(name, lib_dir=stage),
                       ProgressEngine(flush_threshold=4))
        d.add_peer("storage", RdmaFabric(), storage, n_slots=8,
                   slot_size=8 << 10, target_args=db)
        h = register_ifunc(d.src_ctx, "rle_insert")
        for r in recs:
            while not d.send("storage", ifunc_msg_create(h, r)):
                d.drain()
        d.drain()
        return d

    t0 = time.perf_counter()
    ingest("ingest", records[:32])
    v1_links = storage.stats["links"]
    v2 = (stage / "rle_insert.py").read_text().replace(
        'target_args["db"].append(record)',
        'target_args["db"].append(record)\n    target_args["v2_count"] = '
        'target_args.get("v2_count", 0) + 1')
    check(v2 != (stage / "rle_insert.py").read_text(), "v2 edit missed")
    (stage / "rle_insert.py").write_text(v2)
    s = ingest("ingest2", records[32:]).per_peer_stats()["storage"]
    check(db["db"] == records and db.get("v2_count") == 32
          and (v1_links, storage.stats["links"]) == (1, 2),
          f"hot swap: {len(db['db'])} records, v2_count "
          f"{db.get('v2_count')}, links {v1_links} -> "
          f"{storage.stats['links']}")
    log(f"offload_compress: v2 codec hot-swapped under the same name: "
        f"{db['v2_count']} records via v2, 1 new link event, "
        f"{time.perf_counter() - t0:.3f} s, storage never restarted "
        f"(v2 ring: sent={s['sent']} backpressure={s['backpressure']})")
    return db


def phase_multi_peer(np, torch, dev, host_rate):
    """Phase 19: the Dispatcher's host lanes beside the device lane
    (``multi_peer_path`` at full width and ``offload_compress``), then,
    outside the counted run: frames/s per generation, per peer kind and
    in total beside phase 18's bare-API rate; one host generation under
    each obs mode; deliver_us, sweep_us and exec_us at p50 and p99; the
    SMs' idle share over one traced generation.  Returns the phase's
    ``ifunc_vm`` launches, device sweeps and each peer kind's frames/s
    alone."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Context, RingBuffer, register_ifunc

    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        d, h, W, rng, res = multi_peer_path(np, torch, dev, tmp)
        offload_compress(tmp)
    obs = d.obs
    n = SHARDS * SLOTS_FULL
    hosts = [p for p, _ in MP_HOSTS]
    total = len(d.peers) * n * len(res["gen_s"]) / sum(res["gen_s"])
    log(f"multi-peer on {name}: {total:.1f} frames/s over the counted "
        f"generations (4 peers x {n} frames each), generations "
        f"{[round(s, 4) for s in res['gen_s']]} s; phase 18's bare API "
        f"{host_rate:.1f} frames/s on one host target")
    for act, q in (("act one", res["act_one"]), ("act two", res["act_two"])):
        log(f"latency, {act} (µs, p50/p99 as power-of-two bucket bounds, "
            f"count): " + "; ".join(f"{k} {v[0]}/{v[1]} ({v[2]})"
                                   for k, v in sorted(q.items())))

    # frames/s per peer kind through the Dispatcher, each alone, in turns
    # with phase 18's bare API on a ring of the same slots: the
    # difference is the Dispatcher's own cost
    def gen(peers):
        pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
        send_s, drain_s, _ = mp_generation(torch, dev, d, h, peers, pays)
        mp_check(torch, d, peers, pays, W, f"timed {'+'.join(peers)}")
        return send_s + drain_s

    src, tgt = Context("bare-source"), Context("bare-target", device=dev)
    hb = register_ifunc(src, "uvm_affine")
    slot = d.peers["rdma_a"].rings[0].mailbox.slot_size
    ring = RingBuffer(tgt.nic.mem_map(n * slot), slot)
    ep = src.nic.connect(tgt.nic)
    targs = {"externals": {"W": W}}

    def bare():
        pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
        send_s, drain_s, got = host_generation(torch, ep, ring, hb, tgt,
                                               targs, pays)
        check_host_results(torch, got, pays, W, "bare API generation")
        return send_s + drain_s

    runs = {"bare": bare, "rdma": lambda: gen(["rdma_a"]),
            "loopback": lambda: gen(["csd"])}
    spent = {k: [] for k in runs}
    order = list(runs)
    for r in range(MP_TURNS):
        for k in order[r % 3:] + order[:r % 3]:
            spent[k].append(runs[k]())
    per = {k: statistics.median(v) / n * 1e6 for k, v in spent.items()}
    log(f"one host peer, {MP_TURNS} generations of {n} frames each in "
        f"turns (median): " + "; ".join(
            f"{k} {1e6 / us:.1f} frames/s ({us:.1f} µs a frame)"
            for k, us in per.items())
        + f"; the Dispatcher adds {per['rdma'] - per['bare']:.1f} µs a "
          f"frame on RDMA, {per['loopback'] - per['bare']:.1f} on loopback")
    wall = None
    alone = {k: 1e6 / per[k] for k in ("rdma", "loopback")}
    for label, peers in (("device", ["gpu"]), ("hosts", hosts),
                         ("all", hosts + ["gpu"])):
        wall = gen(peers)
        if label == "device":
            alone["device"] = n / wall
        log(f"  {label}: {len(peers)} x {n} frames in {wall:.4f} s, "
            f"{len(peers) * n / wall:.1f} frames/s")

    # the cost of obs: one host generation in each mode, in turns
    modes = {"trace": (True, True), "counters": (True, False),
             "off": (False, False)}
    spent = {m: [] for m in modes}
    order = list(modes)
    for r in range(MP_TURNS):
        for m in order[r % 3:] + order[:r % 3]:
            obs.enabled = modes[m][0]
            obs.set_tracing(modes[m][1])
            spent[m].append(gen(hosts))
    obs.enabled = True
    obs.set_tracing(True)
    off = statistics.median(spent["off"])
    log(f"obs cost over one host generation ({len(hosts)} x {n} frames, "
        f"median of {MP_TURNS}): "
        + "; ".join(f"{m} {statistics.median(v):.4f} s "
                    f"({statistics.median(v) / off:.3f}x off; "
                    f"{min(v):.4f}-{max(v):.4f})"
                    for m, v in spent.items()))

    # the SMs' idle share over one traced generation to all four peers,
    # against the untraced one above
    pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mp_generation(torch, dev, d, h, hosts + ["gpu"], pays)
    mp_check(torch, d, hosts + ["gpu"], pays, W, "traced generation")
    log_card_busy(prof, wall, "card per multi-peer generation",
                  ("ifunc_vm_smem_kernel", "ring_sweep_smem_kernel"))
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    ours = {m.group(1) for nm in names
            for m in re.finditer(r"(\w+_kernel)\b", nm)
            if m.group(1) in KERNEL_NAMES}
    # a subset: torch.profiler may lose a record, or a trace's all
    check(ours <= {"ifunc_vm_smem_kernel", "ring_sweep_smem_kernel"},
          f"the traced generation ran the repository's kernels {ours}")
    theirs = {nm[:40] for nm in names if not any(k in nm for k in ours)}
    log(f"kernels in the traced generation: the repository's {sorted(ours)}; "
        f"PyTorch's (the deposit's roll and where, copies): {sorted(theirs)}")
    return {"launches": res["counts"]["ifunc_vm"], "sweeps": res["sweeps"],
            "rates": alone}


def futures_runtime(np, torch, dev, obs, *, shards, dev_slots, host_slots,
                    seed):
    """Phase 20's topology: a ``TaskRuntime`` over one ``Dispatcher``
    (``ProgressEngine(8, "trailer")``, ``obs``, coalescing up to
    ``MP_AGG`` records) with ``rdma`` (``RdmaFabric``) and ``csd``
    (``LoopbackFabric``), each a ``device=dev`` target of ``host_slots``
    slots of phase 18's size with W resident on ``dev`` and a reply ring
    of the same geometry, and ``gpu``, ``DeviceMeshFabric(shards,
    shift=0)`` of ``dev_slots`` two-tile slots a shard with no reply ring.
    Returns (runtime, ``uvm_affine`` handle, W, rng)."""
    from repro_torch.core import Context, ifunc_msg_create, register_ifunc
    from repro_torch.core import frame as F
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.tasks import TaskRuntime, wire
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       LoopbackFabric, ProgressEngine,
                                       RdmaFabric)

    source = Context("source")
    h = register_ifunc(source, "uvm_affine")
    rng = np.random.default_rng(seed)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(dev)
    d = Dispatcher(source, ProgressEngine(flush_threshold=8,
                                          inflight_window="trailer"),
                   obs=obs)
    rt = TaskRuntime(source, d, coalesce=True, agg_max_subs=MP_AGG,
                     default_timeout=120.0)
    zeros = np.zeros((NT, T, T), np.float32)
    slot = (ifunc_msg_create(h, zeros).nbytes + 4095) & ~4095
    reply = F.HEADER_LEN + len(wire.encode(zeros)) + F.TRAILER_LEN
    check(reply <= slot, f"a {NT}-tile reply ({reply} B) exceeds a reply "
                         f"slot of {slot} B")
    for name, kind in FT_HOSTS:
        fabric = RdmaFabric() if kind == "rdma" else LoopbackFabric()
        rt.add_peer(name, fabric, Context(name, link_mode="remote",
                                          device=dev),
                    n_slots=host_slots, slot_size=slot,
                    target_args={"externals": {"W": W}, "results": []})
    rt.add_peer("gpu", DeviceMeshFabric(shards, shift=0, device=dev), None,
                n_slots=dev_slots, slot_size=(NT * T * T + 64) * 4,
                prog=deserialize_uvm(h.lib.code), n_tiles=NT,
                externals=W.expand(shards, 1, T, T))
    return rt, h, W, rng


def ft_generation(torch, dev, rt, h, peers, pays):
    """Submit one payload after another to each of ``peers`` through
    ``TaskRuntime.submit`` (which waits for credits by driving progress),
    then drain; ends in a synchronize.  Returns (submit s, drain s,
    {peer: futures})."""
    futs = {p: [] for p in peers}
    t0 = time.perf_counter()
    for x in pays:
        for peer in peers:
            futs[peer].append(rt.submit(peer, h, x))
    t1 = time.perf_counter()
    rt.drain()
    sync(torch, dev)
    return t1 - t0, time.perf_counter() - t1, futs


def ft_check(np, torch, rt, futs, pays, W, what):
    """Every future of one generation resolved, its value within TOL_PATH
    of relu(x @ W): numpy arrays decoded from reply frames on host peers,
    the sweep's tensors on the card on the device peer.  Clears the
    targets' results."""
    want = torch.relu(torch.from_numpy(pays).to(W.device) @ W)
    for name, fs in futs.items():
        peer = rt.dispatcher.peers[name]
        undone = [f for f in fs if not f.done()]
        check(not undone, f"{what} {name}: {len(undone)} futures unresolved")
        errs = [f.exception(0) for f in fs if f.exception(0) is not None]
        check(not errs, f"{what} {name}: {len(errs)} futures failed: "
                        f"{errs[:2]}")
        vals = [f.result(0) for f in fs]
        got = (torch.stack(vals) if peer.fabric.kind == "device"
               else torch.from_numpy(np.stack(vals)).to(W.device))
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{what} {name}: results {tuple(got.shape)} or not finite")
        check(torch.allclose(got, want, **TOL_PATH),
              f"{what} {name}: max |err| "
              f"{(got - want).abs().max().item():.3g}")
        peer.target_args.get("results", []).clear()
        if peer.fabric.kind == "device":
            peer.rings[0].mailbox.results.clear()


def ft_burst(rt, hosts, burst, poison):
    """``task_sum`` (PYBC, run on the host) to each host peer: a FULL
    warm-up future, then ``burst`` records through ``submit_many``, every
    ``poison``-th poisoned.  Requests ride FLAG_AGG containers and the
    replies FLAG_AGG|FLAG_REPLY ones: each good future holds its payload's
    sum, each poisoned one raises ``RemoteExecutionError`` naming the
    poison, its siblings unharmed.  Returns (request containers, reply
    containers, poisoned futures)."""
    from repro_torch.core import register_ifunc
    from repro_torch.tasks import RemoteExecutionError

    h = register_ifunc(rt.ctx, "task_sum")
    for name in hosts:
        check(rt.submit(name, h, b"warm").result(60) == sum(b"warm"),
              f"{name}: task_sum warm-up")
    pays = [bytes([255, i & 0x7F]) if i % poison == poison - 1
            else bytes((i * 7 + j) % 200 + 1 for j in range(8))
            for i in range(burst)]
    before = {n: dict(rt.dispatcher.peers[n].stats) for n in hosts}
    futs = {name: rt.submit_many(name, h, pays) for name in hosts}
    rt.drain()
    sent = replies = poisoned = 0
    for name in hosts:
        for i, f in enumerate(futs[name]):
            check(f.done(), f"{name}: burst future {i} unresolved")
            exc = f.exception(0)
            if i % poison == poison - 1:
                check(isinstance(exc, RemoteExecutionError)
                      and "poisoned" in str(exc),
                      f"{name}: poisoned record {i} gave {exc!r}")
                poisoned += 1
            else:
                check(exc is None and f.result(0) == sum(pays[i]),
                      f"{name}: record {i} gave {exc or f.result(0)!r}, "
                      f"want {sum(pays[i])}")
        s, b = rt.dispatcher.peers[name].stats, before[name]
        sent += s["agg_sent"] - b["agg_sent"]
        replies += s["agg_replies"] - b["agg_replies"]
        check(s["agg_replies"] > b["agg_replies"]
              and s["replies"] - b["replies"] == burst,
              f"{name}: {s['replies'] - b['replies']} replies in "
              f"{s['agg_replies'] - b['agg_replies']} reply containers for "
              f"{burst} records")
    return sent, replies, poisoned


def ft_agg_device(np, torch, dev, W, *, shards, slots, k, seed):
    """The aggregate device lane at phase 8's shape under a ``TaskRuntime``
    of its own (tiles coalesce only under a raised ``max_sub_bytes``):
    ``DeviceMeshFabric(shards, shift=0)``, ``slots`` containers a shard of
    ``k`` one-tile records; one generation of ``shards * slots * k``
    futures through ``submit_many``, each within TOL_PATH of relu(x @ W)."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.tasks import TaskRuntime
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       ProgressEngine)

    source = Context("agg-source")
    h = register_ifunc(source, "uvm_affine")
    d = Dispatcher(source, ProgressEngine(flush_threshold=8,
                                          inflight_window="trailer"))
    rt = TaskRuntime(source, d, default_timeout=120.0)
    d.set_coalescing(True, max_subs=k, max_sub_bytes=AGG_SUB_BYTES)
    rt.add_peer("gpu-agg", DeviceMeshFabric(shards, shift=0, device=dev),
                None, n_slots=slots, slot_size=k * (T * T * 4 + 128) + 4096,
                prog=deserialize_uvm(h.lib.code), n_tiles=1,
                externals=W.expand(shards, 1, T, T), agg_k=k,
                prog_name=h.lib.name)
    mb = d.peers["gpu-agg"].rings[0].mailbox
    n = shards * slots * k
    pays = np.random.default_rng(seed).standard_normal(
        (n, 1, T, T)).astype(np.float32)
    t0 = time.perf_counter()
    ready, futs = sweep_log(mb, lambda: (
        rt.submit_many("gpu-agg", h, list(pays)), rt.drain())[0])
    sync(torch, dev)
    secs = time.perf_counter() - t0
    check(all(f.done() and f.exception(0) is None for f in futs),
          f"agg device futures: {sum(not f.done() for f in futs)} "
          f"unresolved, {sum(f.exception(0) is not None for f in futs)} "
          f"failed")
    got = torch.stack([f.result(0) for f in futs])
    want = torch.relu(torch.from_numpy(pays).to(dev) @ W)
    check(got.shape == want.shape and bool(torch.isfinite(got).all())
          and torch.allclose(got, want, **TOL_PATH),
          f"agg device futures: max |err| "
          f"{(got - want).abs().max().item():.3g}")
    st = d.peers["gpu-agg"].stats
    check((st["agg_sent"], st["agg_subs"], rt.pending())
          == (shards * slots, n, 0), f"agg device futures: {st}")
    log(f"aggregate device lane: {n} futures in {shards * slots} containers "
        f"of {k}, {secs:.4f} s ({n / secs:.1f} futures/s); {len(ready)} "
        f"sweeps, READY containers in each: {ready}")


def ft_liveness(torch, rt, h, pays, W):
    """A wedged ``csd`` (its ``Mailbox.sweep`` a no-op): ``fail_inflight``
    resolves every outstanding future with ``TransportError`` and the
    flight recorder's dump names each dead corr id; then
    ``drain(deadline=FT_DEADLINE)`` fails the futures in flight for the
    whole deadline and leaves alone those submitted halfway through it.
    Unwedged, the young futures resolve within TOL_PATH of relu(x @ W)
    and the dead requests' late replies count as orphans.  Returns the
    futures failed."""
    import io

    from repro_torch.tasks import TaskState
    from repro_torch.transport import TransportError

    d = rt.dispatcher
    mb = d.peers["csd"].rings[0].mailbox
    orphans0 = rt.stats["orphan_replies"]
    mb.sweep = lambda *a, **k: []                     # csd stops consuming
    young, t_start = [], [None]

    def wedged_but_submitting(*a, **k):
        # halfway through the drain, submit futures the deadline must spare
        if (not young and t_start[0] is not None
                and time.monotonic() - t_start[0] >= FT_DEADLINE / 2):
            young.extend(rt.submit("csd", h, x)
                         for x in pays[:max(1, len(pays) // 2)])
        return []

    try:
        dead = [rt.submit("csd", h, x) for x in pays]
        rt.flush()
        dump = io.StringIO()
        with contextlib.redirect_stderr(dump):
            failed = d.fail_inflight("csd wedged", peers={"csd"})
        check(failed == len(dead) and all(
            f.state is TaskState.ERROR
            and isinstance(f.exception(0), TransportError) for f in dead),
            f"fail_inflight: {failed} failed of {len(dead)}")
        text = dump.getvalue()
        missing = [f.corr_id for f in dead if f"corr={f.corr_id}" not in text]
        check("flight recorder dump (fail_inflight: csd wedged)" in text
              and not missing, f"the recorder dump misses corr ids {missing}")
        old = [rt.submit("csd", h, x) for x in pays]
        mb.sweep = wedged_but_submitting
        t0 = time.monotonic()
        t_start[0] = t0
        timed_out = d.stats["timed_out"]
        with contextlib.redirect_stderr(io.StringIO()):
            rt.drain(deadline=FT_DEADLINE)
        waited = time.monotonic() - t0
        check(d.stats["timed_out"] - timed_out == len(old) and all(
            isinstance(f.exception(0), TransportError)
            and "drain deadline" in str(f.exception(0)) for f in old),
            f"drain(deadline={FT_DEADLINE}): old futures "
            f"{[f.state.name for f in old]}")
        check(young and not any(f.done() for f in young),
              f"drain(deadline={FT_DEADLINE}) touched the young futures: "
              f"{[f.state.name for f in young]}")
    finally:
        del mb.sweep
    rt.drain()                                        # csd consumes again
    for f, x in zip(young, pays):
        check(f.done() and f.exception(0) is None and torch.allclose(
            torch.from_numpy(f.result(0)).to(W.device),
            torch.relu(torch.from_numpy(x).to(W.device) @ W), **TOL_PATH),
            f"young future after the wedge: {f!r}")
    orphans = rt.stats["orphan_replies"] - orphans0
    check(orphans == 2 * len(pays),
          f"{orphans} orphan replies, want {2 * len(pays)} (the dead "
          f"requests' late replies)")
    log(f"liveness: csd wedged; fail_inflight failed {failed} futures with "
        f"TransportError, the recorder dump naming each corr id; "
        f"drain(deadline={FT_DEADLINE}) returned after {waited:.3f} s, "
        f"failing {len(old)} old futures and sparing {len(young)} younger; "
        f"unwedged, those resolved and {orphans} late replies were dropped "
        f"as orphans")
    return failed + len(old)


def futures_path(np, torch, dev, *, shards=SHARDS, dev_slots=SLOTS_FULL,
                 host_slots=MP_SLOTS, gens=FT_GENS, burst=FT_BURST,
                 agg_slots=AGG_SLOTS, agg_k=AGG_K, live=8, seed=20):
    """Phase 20's counted run: ``gens`` generations of ``shards *
    dev_slots`` two-tile μVM futures to each of ``rdma``, ``csd`` and
    ``gpu`` through ``TaskRuntime.submit`` (the first to each host peer
    FULL, alone), the coalesced ``task_sum`` burst, one generation of
    aggregate device-lane futures, with every launch counted (on the card,
    where every plain version refuses to run); then the liveness checks
    with ``live`` futures a batch.
    Returns (runtime, handle, W, rng, a dict of what the run showed)."""
    from repro_torch.obs import Obs

    obs = Obs("futures", trace=True)
    rt, h, W, rng = futures_runtime(np, torch, dev, obs, shards=shards,
                                    dev_slots=dev_slots,
                                    host_slots=host_slots, seed=seed)
    d = rt.dispatcher
    n = shards * dev_slots
    hosts = [name for name, _ in FT_HOSTS]
    peers = hosts + ["gpu"]
    mb = d.peers["gpu"].rings[0].mailbox
    sweeps = []

    def counted_sweep(*a, **k):
        before = _counted()["ring_sweep"].launches
        ran = mb._deposited > 0
        out = type(mb).sweep(mb, *a, **k)
        if ran:
            sweeps.append(_counted()["ring_sweep"].launches - before)
        return out

    mb.sweep = counted_sweep
    sync(torch, dev)
    reset_counts()
    gen_s = []
    try:
        snap0 = obs.snapshot()
        for g in range(gens):
            pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
            if g == 0:
                # the first frame to each host peer ships FULL; its
                # confirmed delivery turns the rest SLIM
                a = ft_generation(torch, dev, rt, h, peers, pays[:1])
                b = ft_generation(torch, dev, rt, h, peers, pays[1:])
                futs = {p: a[2][p] + b[2][p] for p in peers}
                submit_s, drain_s = a[0] + b[0], a[1] + b[1]
            else:
                submit_s, drain_s, futs = ft_generation(torch, dev, rt, h,
                                                        peers, pays)
            ft_check(np, torch, rt, futs, pays, W, f"generation {g}")
            gen_s.append(submit_s + drain_s)
            log(f"futures generation {g}: {len(peers)} x {n} μVM futures, "
                f"submit {submit_s:.4f} s, drain {drain_s:.4f} s, "
                f"{len(peers) * n / (submit_s + drain_s):.1f} futures/s")
        check(rt.pending() == 0 and rt.stats["orphan_replies"] == 0,
              f"after the μVM futures: {rt.pending()} pending, "
              f"{rt.stats['orphan_replies']} orphan replies")
        lat = hist_quantiles(obs, snap0)
        after_uvm = read_counts()
        containers, reply_containers, poisoned = ft_burst(
            rt, hosts, burst, FT_POISON)
        after_burst = read_counts()
        ft_agg_device(np, torch, dev, W, shards=shards, slots=agg_slots,
                      k=agg_k, seed=seed + 1)
        counts = read_counts()
    finally:
        del mb.sweep
    agg_sweeps = counts["agg_sweep"]
    host_futures = gens * n * len(hosts)
    log(f"coalesced replies: {burst} task_sum records to each of "
        f"{len(hosts)} host peers in {containers} request containers, "
        f"answered by {reply_containers} FLAG_AGG|FLAG_REPLY containers; "
        f"{poisoned} poisoned records raised RemoteExecutionError, their "
        f"siblings unharmed")
    check(after_burst == after_uvm,
          f"the PYBC burst launched kernels: {after_uvm} -> {after_burst}")
    failed = ft_liveness(torch, rt, h, rng.standard_normal(
        (live, NT, T, T)).astype(np.float32), W)
    check(obs.tracer.open_count() == 0,
          f"obs: {obs.tracer.open_count()} spans left open: "
          f"{[s.name for s in obs.tracer.open_spans()][:8]}")
    res = {"counts": counts, "sweeps": len(sweeps), "agg_sweeps": agg_sweeps,
           "host_futures": host_futures, "gen_s": gen_s, "lat": lat,
           "failed": failed}
    if dev.type == "cuda":
        check(counts["ifunc_vm"] == host_futures,
              f"{counts['ifunc_vm']} ifunc_vm launches for {host_futures} "
              f"host μVM futures")
        check(sweeps and set(sweeps) == {1}
              and counts["ring_sweep"] == len(sweeps),
              f"{counts['ring_sweep']} ring_sweep launches in "
              f"{len(sweeps)} device sweeps ({sorted(set(sweeps))} each)")
        check(agg_sweeps > 0 and all(
            v == 0 for k, v in counts.items()
            if k not in ("ifunc_vm", "ring_sweep", "agg_sweep")),
            f"phase 20 launched {counts}, want ifunc_vm, ring_sweep and "
            f"agg_sweep alone")
        log(f"futures launches {counts}: ifunc_vm_smem_kernel once for "
            f"each of {host_futures} host μVM futures, "
            f"ring_sweep_smem_kernel once in each of {len(sweeps)} device "
            f"sweeps, agg_sweep_smem_kernel in {agg_sweeps}; no plain "
            f"version ran")
    d.print_stats()
    return rt, h, W, rng, res


def phase_futures(np, torch, dev, mp_rates, smi):
    """Phase 20: result futures over the reply path (``futures_path`` at
    full width, with every plain version refusing), then: futures/s of
    each peer alone beside phase 19's frames/s of the same kind,
    ``task.reply_us``, ``exec_us`` and ``sweep_us`` at p50 and p99, host
    timers over the reply's encode (D2H and pack) and drain (and decode)
    in one more generation, and the SMs' idle share over a traced one.
    Every rate is logged with ``smi``, the card's name and power limit.
    Returns the phase's ``ifunc_vm`` launches and device sweeps of both
    lanes."""
    import repro_torch.tasks.wire as wire
    from torch.profiler import ProfilerActivity, profile

    with no_plain():
        rt, h, W, rng, res = futures_path(np, torch, dev)
        d = rt.dispatcher
        n = SHARDS * SLOTS_FULL
        hosts = [p for p, _ in FT_HOSTS]
        total = 3 * n * len(res["gen_s"]) / sum(res["gen_s"])
        log(f"futures on {smi}: {total:.1f} futures/s over the counted "
            f"generations (3 peers x {n} each), generations "
            f"{[round(s, 4) for s in res['gen_s']]} s")
        log(f"latency, the μVM futures on {smi} (µs, p50/p99 as "
            "power-of-two bucket bounds, count): " + "; ".join(
                f"{k} {v[0]}/{v[1]} ({v[2]})"
                for k, v in sorted(res["lat"].items())))

        def gen(peers):
            pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
            submit_s, drain_s, futs = ft_generation(torch, dev, rt, h,
                                                    peers, pays)
            ft_check(np, torch, rt, futs, pays, W,
                     f"timed {'+'.join(peers)}")
            return submit_s + drain_s

        # each peer alone, in turns: futures/s beside phase 19's frames/s
        # of the same kind (the reply path's cost a frame)
        kinds = {"rdma": "rdma", "csd": "loopback", "gpu": "device"}
        spent = {p: [] for p in kinds}
        order = list(kinds)
        for r in range(FT_TURNS):
            for p in order[r % 3:] + order[:r % 3]:
                spent[p].append(gen([p]))
        for p, kind in kinds.items():
            us = statistics.median(spent[p]) / n * 1e6
            log(f"  {p} alone ({kind}), median of {FT_TURNS}: "
                f"{1e6 / us:.1f} futures/s ({us:.1f} µs a future), "
                f"{1e6 / us / mp_rates[kind]:.3f}x phase 19's "
                f"{mp_rates[kind]:.1f} frames/s, "
                f"{us - 1e6 / mp_rates[kind]:+.1f} µs a frame ({smi})")
        wall = gen(hosts + ["gpu"])
        log(f"  all three: {3 * n} futures in {wall:.4f} s, "
            f"{3 * n / wall:.1f} futures/s ({smi})")

        # host timers over one more generation to the host peers: the
        # submit, the reply's encode (the result's D2H, then the NPY pack)
        # and post (pack_reply_into and the put, the encode inside it), and
        # the source's drain of its reply rings with the decode inside it
        spent = {"submit": [], "d2h": [], "encode": [], "post": [],
                 "drain": [], "decode": []}

        def timed(key, fn):
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[key].append(time.perf_counter() - t)
            return wrapped

        saved = (wire._tensor_to_numpy, wire.encode, wire.decode)
        wire._tensor_to_numpy = timed("d2h", saved[0])
        wire.encode = timed("encode", saved[1])
        wire.decode = timed("decode", saved[2])
        d._drain_replies = timed("drain", d._drain_replies)
        d._post_reply = timed("post", d._post_reply)
        rt.submit = timed("submit", rt.submit)
        try:
            host_wall = gen(hosts)
        finally:
            wire._tensor_to_numpy, wire.encode, wire.decode = saved
            del d._drain_replies, d._post_reply, rt.submit
        replies = len(spent["encode"])
        check(replies == len(hosts) * n and len(spent["decode"]) == replies,
              f"timed generation: {replies} encodes, "
              f"{len(spent['decode'])} decodes for {len(hosts) * n} futures")
        per = {k: sum(v) / replies * 1e6 for k, v in spent.items()}
        log(f"reply path on the host, one generation of {len(hosts)} x {n} "
            f"μVM futures ({host_wall:.4f} s, "
            f"{host_wall / replies * 1e6:.1f} µs a future), per future: "
            f"submit {per['submit']:.1f} µs; D2H {per['d2h']:.1f} µs, NPY "
            f"pack {per['encode'] - per['d2h']:.1f} µs, reply frame and put "
            f"{per['post'] - per['encode']:.1f} µs; drain "
            f"{per['drain'] - per['decode']:.1f} µs and decode "
            f"{per['decode']:.1f} µs ({len(spent['drain'])} drains; {smi})")

        # the SMs' idle share over one traced generation to all three
        pays = rng.standard_normal((n, NT, T, T)).astype(np.float32)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, futs = ft_generation(torch, dev, rt, h, hosts + ["gpu"],
                                       pays)
        ft_check(np, torch, rt, futs, pays, W, "traced generation")
        log_card_busy(prof, wall, f"{smi} per futures generation",
                      ("ifunc_vm_smem_kernel", "ring_sweep_smem_kernel"))
    check(rt.pending() == 0, f"{rt.pending()} futures left pending")
    return {"launches": res["counts"]["ifunc_vm"], "sweeps": res["sweeps"],
            "agg_sweeps": res["agg_sweeps"]}


# ------------------------------------------------------------ model stack


def model_config(arch, impl, **kw):
    from repro_torch.configs import get_config

    return get_config(arch).with_(**impl, **kw)


def flash_inputs(np, torch, dev, rng, BH, S, hd, dtype):
    return [torch.from_numpy(rng.standard_normal((BH, S, hd))
                             .astype(np.float32)).to(dev, dtype)
            for _ in range(3)]


def ssd_inputs(np, torch, dev, rng, BH, nc, Q, hd, ds):
    """x, la, B, C as the reference's kernel test draws them."""
    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return (t(rng.standard_normal((BH, nc, Q, hd))),
            t(-np.abs(rng.standard_normal((BH, nc, Q))) * 0.2),
            t(rng.standard_normal((BH, nc, Q, ds)) * 0.2),
            t(rng.standard_normal((BH, nc, Q, ds)) * 0.2))


def ssd_layouts(Bm, Cm):
    """``ssd_scan``'s two layouts of B and C [BH, nc, Q, ds]: per row
    (G = BH) and the model's at batch 1 (G = 1, the first row's shared by
    all); each as (G, B and C of G groups, B and C broadcast to BH rows)."""
    BH = Bm.shape[0]
    b1, c1 = Bm[:1].contiguous(), Cm[:1].contiguous()
    return ((BH, Bm, Cm, Bm, Cm),
            (1, b1, c1, b1.expand_as(Bm).contiguous(),
             c1.expand_as(Cm).contiguous()))


def ssd_work(BH, G, nc, Q, hd, ds):
    """(FLOP, bytes) ``ssd_scan`` must do: C B^T's lower triangle once per
    group, the score-x product's lower triangle and the two state products
    per row; x, la, B and C read once and y written once, f32."""
    P = Q * (Q + 1) // 2                           # lower-triangle pairs
    flops = nc * G * 2 * P * ds + BH * nc * (2 * P * hd + 4 * Q * hd * ds)
    return flops, (2 * BH * nc * Q * hd + BH * nc * Q + 2 * G * nc * Q * ds) * 4


def train_flash_shapes():
    """flash's [BH, S, hd, window] on the training path: SmolLM-360M's
    heads over one microbatch of phase 17 and over phase 16's batch."""
    cfg = model_config("smollm_360m", MODELS["smollm_360m"][0])
    h, hd = cfg.num_heads, cfg.head_dim
    return ((TRAIN_B // TRAIN_MB * h, TRAIN_S, hd, 0),
            (TRAIN_PARITY[0] * h, TRAIN_PARITY[1], hd, 0))


def phase_model_kernels(np, torch, dev):
    """``flash_fwd`` and ``ssd_scan`` against their plain versions at the
    shapes the serving and training paths give them; returns the largest
    |diff| of each."""
    from repro_torch.kernels.flash_attn import flash_fwd, flash_fwd_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    rng = np.random.default_rng(20)
    errs = {"flash_fwd": 0.0, "ssd_scan": 0.0}
    for BH, S, hd, window in FLASH_SHAPES + train_flash_shapes():
        scale = 1.0 / float(np.sqrt(hd))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(np, torch, dev, rng, BH, S, hd, dtype)
            o, lse = flash_fwd(q, k, v, scale=scale, window=window)
            o_p, lse_p = flash_fwd_plain(q.float(), k.float(), v.float(),
                                         scale=scale, window=window)
            torch.cuda.synchronize()
            tol = TOL_FLASH if dtype == torch.float32 else TOL_FLASH_BF16
            eo = (o.float() - o_p).abs().max().item()
            el = (lse - lse_p).abs().max().item()
            check(o.dtype == dtype and lse.dtype == torch.float32
                  and bool(torch.isfinite(o).all())
                  and torch.allclose(o.float(), o_p, **tol)
                  and torch.allclose(lse, lse_p, **TOL_FLASH),
                  f"flash_fwd [{BH}, {S}, {hd}] window {window} {dtype}: "
                  f"max |err| O {eo:.3g}, LSE {el:.3g}")
            errs["flash_fwd"] = max(errs["flash_fwd"], eo, el)
            log(f"flash_fwd [{BH}, {S}, {hd}] window {window} "
                f"{str(dtype)[6:]}: max |err| vs plain (f32) O {eo:.3g}, "
                f"LSE {el:.3g} (tolerance O {tol['atol']}, LSE "
                f"{TOL_FLASH['atol']})")
            del q, k, v, o, lse, o_p, lse_p
    for BH, nc, Q, hd, ds in SSD_SHAPES:
        x, la, Bm, Cm = ssd_inputs(np, torch, dev, rng, BH, nc, Q, hd, ds)
        for G, Bg, Cg, Bb, Cb in ssd_layouts(Bm, Cm):
            y, y_p = ssd_scan(x, la, Bg, Cg), ssd_scan_plain(x, la, Bb, Cb)
            same = torch.equal(y, ssd_scan(x, la, Bb, Cb))
            torch.cuda.synchronize()
            err = (y - y_p).abs().max().item()
            what = f"ssd_scan [{BH}, {nc}, {Q}, {hd}] ds {ds} G {G} f32"
            check(bool(torch.isfinite(y).all())
                  and torch.allclose(y, y_p, **TOL_SSD),
                  f"{what}: max |err| {err:.3g}")
            check(same, f"{what}: B and C in groups differ from the same "
                        f"broadcast to every row")
            errs["ssd_scan"] = max(errs["ssd_scan"], err)
            log(f"{what}: max |err| vs plain {err:.3g} (tolerance "
                f"{TOL_SSD['atol']}); equal bit for bit to B and C "
                f"broadcast to {BH} rows")
            del y, y_p, Bb, Cb
    torch.cuda.empty_cache()
    return errs


def phase_model_parity(np, torch, dev):
    """Both models at full width in f32: the kernel path's prefill logits
    and cache against the plain path's, and teacher forcing."""
    from repro_torch.models import transformer as MT
    from repro_torch.train import serve as SRV

    for i, (arch, (kern, plain)) in enumerate(MODELS.items()):
        cfg = model_config(arch, kern, dtype="float32", param_dtype="float32")
        cfg_p = cfg.with_(**plain)
        params = MT.init_params(
            cfg, torch.Generator(device=dev).manual_seed(100 + i), dev)
        rng = np.random.default_rng(30 + i)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (PARITY_B, PARITY_S))).to(dev)
        lk, ck, _ = MT.forward(params, {"tokens": toks}, cfg, mode="prefill")
        lp, cp, _ = MT.forward(params, {"tokens": toks}, cfg_p,
                               mode="prefill")
        torch.cuda.synchronize()
        check(lk.shape == (PARITY_B, PARITY_S, cfg.vocab_size)
              and bool(torch.isfinite(lk).all()) and set(ck) == set(cp),
              f"{arch} f32 prefill: shape {tuple(lk.shape)} or not finite")
        errs = {"logits": (lk - lp).abs().max().item()}
        ok = torch.allclose(lk, lp, **TOL_MODEL)
        for key in cp:
            errs[key] = (ck[key].float() - cp[key].float()).abs().max().item()
            ok = ok and torch.allclose(ck[key].float(), cp[key].float(),
                                       **TOL_MODEL)
        check(ok, f"{arch} f32 prefill, kernel path vs plain path: max "
                  f"|err| {errs} over {TOL_MODEL}")
        del lk, ck, lp, cp
        lt, _, _ = MT.forward(params, {"tokens": toks}, cfg_p, mode="train")
        cache, last = SRV.make_prefill_step(cfg)(
            params, {"tokens": toks[:, :PARITY_PREFILL]})
        tf = [(last[:, 0] - lt[:, PARITY_PREFILL - 1]).abs().max().item()]
        cache = SRV.pad_cache_to(cache, MT.cache_shapes(cfg, PARITY_B,
                                                        PARITY_S))
        decode = SRV.make_decode_step(cfg)
        for t in range(PARITY_PREFILL, PARITY_S):
            cache, lg = decode(params, cache, toks[:, t:t + 1], t)
            tf.append((lg[:, 0] - lt[:, t]).abs().max().item())
        check(max(tf) < TOL_TEACHER,
              f"{arch} teacher forcing: max |err| {max(tf):.3g} over "
              f"{TOL_TEACHER}")
        n_par = sum(v.numel() for v in params.values())
        log(f"{arch} f32 full width ({n_par / 1e6:.1f} M params, "
            f"{cfg.num_layers} layers): prefill of {PARITY_B} x {PARITY_S} "
            f"tokens through the kernels vs the plain path ("
            f"{ {**plain} }): max |err| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tolerance {TOL_MODEL['atol']}); teacher forcing, prefill "
            f"{PARITY_PREFILL} then decode {PARITY_S - PARITY_PREFILL} vs "
            f"train logits: max |err| {max(tf):.3g} (tolerance "
            f"{TOL_TEACHER})")
        del params, lt, cache, last
        torch.cuda.empty_cache()


def serve_requests(torch, cfg, params, prompts, dev, kernel):
    """Admit every prompt into a free slot of a fresh ContinuousBatcher
    (prefill, greedy first token, install), then tick until all have
    finished.  Checks that ``kernel`` launched once per layer in each
    prefill, no counted kernel launched otherwise, and that every logit
    was finite.  Returns (requests, prefill s, decode s, tokens emitted by
    the ticks, ticks, wall s)."""
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.train import serve as SRV

    b = ContinuousBatcher(cfg, params, SERVE_SLOTS, SERVE_CACHE, device=dev)
    finite = []
    inner = b._decode

    def decode(*a):
        cache, logits = inner(*a)
        finite.append(bool(torch.isfinite(logits).all()))
        return cache, logits

    b._decode = decode
    prefill = SRV.jit_prefill_step(cfg)
    reqs = [Request(i, p, SERVE_NEW) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_s = 0.0
    for req in reqs:
        before = read_counts()
        c0 = time.perf_counter()
        cache1, last = prefill(params, {"tokens": torch.from_numpy(
            req.prompt[None]).to(dev)})
        first = int(torch.argmax(last[0, -1]))
        finite.append(bool(torch.isfinite(last).all()))
        b.install(b.free_slots()[0], cache1, len(req.prompt), first, req)
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - c0
        now = read_counts()
        delta = {key: now[key] - before[key] for key in now}
        want = {key: (cfg.num_layers if key == kernel else 0) for key in now}
        check(delta == want, f"{cfg.name} prefill of {len(req.prompt)}: "
                             f"launches {delta}, want {want}")
        del cache1, last
    decode_s, emitted, ticks, done = 0.0, 0, 0, []
    while len(done) < len(reqs):
        before = read_counts()
        c0 = time.perf_counter()
        n, fin = b.tick()                   # ends in a device-to-host copy
        decode_s += time.perf_counter() - c0
        check(read_counts() == before, f"{cfg.name}: a kernel launched in "
                                       f"decode tick {ticks}")
        emitted, done, ticks = emitted + n, done + fin, ticks + 1
        check(ticks <= SERVE_NEW, f"{cfg.name}: requests not finished "
                                  f"after {ticks} ticks")
    wall = time.perf_counter() - t0
    check(all(finite), f"{cfg.name}: non-finite logits while serving")
    check(all(len(r.out) == SERVE_NEW for r in reqs),
          f"{cfg.name}: token counts {[len(r.out) for r in reqs]}")
    return reqs, prefill_s, decode_s, emitted, ticks, wall


def phase_serving(np, torch, dev):
    """Each model in bf16 at full width serves 4 requests through a
    ContinuousBatcher — the main path; then the same under torch.profiler
    for the SMs' idle share, and prefill tokens/s at batch 1 and 4,096
    tokens.  Returns {kernel: launches on the main path}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as MT
    from repro_torch.train import serve as SRV

    launches = {}
    for i, (arch, (kern, _)) in enumerate(MODELS.items()):
        cfg = model_config(arch, kern)
        kernel = "flash_fwd" if "attn_impl" in kern else "ssd_scan"
        params = MT.init_params(
            cfg, torch.Generator(device=dev).manual_seed(200 + i), dev)
        rng = np.random.default_rng(40 + i)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_PROMPTS]
        prefill = SRV.jit_prefill_step(cfg)
        prefill(params, {"tokens": torch.from_numpy(prompts[-1][None])
                         .to(dev)})                            # warm-up
        torch.cuda.synchronize()

        reset_counts()
        reqs, prefill_s, decode_s, emitted, ticks, wall = serve_requests(
            torch, cfg, params, prompts, dev, kernel)
        counts = read_counts()
        launches[kernel] = counts[kernel]
        check(counts[kernel] == cfg.num_layers * len(prompts),
              f"{arch}: {kernel} launched {counts[kernel]} times in the "
              f"serving run, want {cfg.num_layers} x {len(prompts)}")
        log(f"{arch} bf16 serving, {SERVE_SLOTS} slots, cache_len "
            f"{SERVE_CACHE}: {len(reqs)} requests (prompts {SERVE_PROMPTS}) "
            f"x {SERVE_NEW} tokens in {wall:.3f} s; prefills {prefill_s:.3f} "
            f"s, {ticks} decode ticks {decode_s:.3f} s = "
            f"{emitted / decode_s:.1f} decode tokens/s; {kernel} "
            f"{cfg.num_layers} launches per prefill, none in decode; "
            f"launches {counts}; first tokens "
            f"{[r.out[:4] for r in reqs]}")

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            reqs2, *_ = serve_requests(torch, cfg, params, prompts, dev,
                                       kernel)
        log_card_busy(prof, wall, f"{arch} card over the serving phase")
        log(f"{arch}: traced serving run's tokens "
            f"{'equal' if [r.out for r in reqs2] == [r.out for r in reqs] else 'differ from'} "
            f"the untraced run's")

        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, PREFILL_S))).to(dev)
        times = []
        for rep in range(4):                # one warm-up, 3 timed
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            cache, last = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            if rep:
                times.append(time.perf_counter() - c0)
            check(bool(torch.isfinite(last).all()),
                  f"{arch}: prefill of {PREFILL_S} not finite")
            del cache, last
        med = statistics.median(times)
        log(f"{arch} bf16 prefill at batch 1, {PREFILL_S} tokens: "
            f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s "
            f"= {PREFILL_S / med:.1f} tokens/s")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cache, last = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
        log_card_busy(prof, med, f"{arch} prefill of {PREFILL_S} tokens, "
                                 f"its longest device kernels",
                      ("flash_fwd" if kernel == "flash_fwd" else "ssd_",))
        del params, toks, cache, last
        torch.cuda.empty_cache()
    return launches


def phase_model_timings(np, torch, dev, errs):
    """``flash_fwd`` and ``ssd_scan`` at the path's largest shapes: device
    time, wrapper time, plain version, bound, library; returns their
    kernels-line entries, whose ``launches`` the serving phase fills."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attn import flash_fwd, flash_fwd_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    bw, fp32, bf16 = card_peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(50)
    BH, S, hd, _ = FLASH_SHAPES[2]
    scale = 1.0 / float(np.sqrt(hd))
    q, k, v = flash_inputs(np, torch, dev, rng, BH, S, hd, torch.bfloat16)
    fl_ms, fl_wrap = kernel_times(
        torch, lambda: flash_fwd(q, k, v, scale=scale),
        "flash_fwd_wgmma_kernel", 20, require=True)
    fl_plain = cuda_ms(torch, lambda: flash_fwd_plain(q, k, v, scale=scale),
                       3, repeats=3)
    o = flash_fwd(q, k, v, scale=scale)[0]
    # [1, BH, S, hd]: the 4-D layout PyTorch's fused attention backends take
    q4, k4, v4 = q[None], k[None], v[None]
    lib = sdpa(q4, k4, v4, is_causal=True, scale=scale)[0]
    check(torch.allclose(o.float(), lib.float(), **TOL_FLASH_BF16),
          "scaled_dot_product_attention disagrees with the kernel")
    fl_lib = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True,
                                         scale=scale), 20)
    fl_flops = 4 * BH * hd * S * (S + 1) / 2        # QK^T and PV, causal
    fl_bytes = 4 * BH * S * hd * 2 + BH * S * 4     # q, k, v, O; LSE
    fl_b_ops, fl_b_bytes = fl_flops / bf16 * 1e3, fl_bytes / bw * 1e3
    del q, k, v, o, lib, q4, k4, v4

    BHs, nc, Q, hd_s, ds = SSD_SHAPES[1]
    x, la, Bm, Cm = ssd_inputs(np, torch, dev, rng, BHs, nc, Q, hd_s, ds)
    ss = {}                         # G -> (ms, wrapper, plain, FLOP, bytes)
    for G, Bg, Cg, Bb, Cb in ssd_layouts(Bm, Cm):
        ms, wrap = kernel_times(torch, lambda: ssd_scan(x, la, Bg, Cg),
                                "ssd_", 10, require=True)
        plain = cuda_ms(torch, lambda: ssd_scan_plain(x, la, Bg, Cg), 3,
                        repeats=3)
        ss[G] = (ms, wrap, plain, *ssd_work(BHs, G, nc, Q, hd_s, ds))
        del Bg, Cg, Bb, Cb
    del x, la, Bm, Cm
    torch.cuda.empty_cache()

    per_prefill = {("flash_fwd" if "attn_impl" in kern else "ssd_scan"):
                   model_config(arch, kern).num_layers
                   for arch, (kern, _) in MODELS.items()}
    log(f"flash_fwd [{BH}, {S}, {hd}] bf16: {fl_ms:.4f} ms on the card "
        f"(wrapper {fl_wrap:.4f}, plain {fl_plain:.4f}, "
        f"scaled_dot_product_attention {fl_lib:.4f}, bound "
        f"{max(fl_b_ops, fl_b_bytes):.4f} ms: {fl_flops:.3g} FLOP at bf16 "
        f"-> {fl_b_ops:.4f} ms, {fl_bytes / 1e6:.1f} MB -> "
        f"{fl_b_bytes:.4f} ms); {fl_flops / fl_ms / 1e9:.2f} TFLOP/s, "
        f"{max(fl_b_ops, fl_b_bytes) / fl_ms:.3f} of the bound, "
        f"{fl_ms / fl_lib:.2f}x scaled_dot_product_attention's forward; "
        f"{per_prefill['flash_fwd']} launches per SmolLM prefill")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for G, (ms, wrap, plain, flops, nbytes) in ss.items():
        b_ops, b_bytes = flops / fp32 * 1e3, nbytes / bw * 1e3
        scratch = G * nc * Q * Q * 4 + BHs * nc * (ds * hd_s + Q) * 4
        log(f"ssd_scan [{BHs}, {nc}, {Q}, {hd_s}] ds {ds} f32, B and C in "
            f"{G} group(s) ({'per row' if G == BHs else 'the model layout'}"
            f"): {ms:.4f} ms on the card, its four ssd_ kernels summed "
            f"(wrapper {wrap:.4f}, plain {plain:.4f}, bound "
            f"{max(b_ops, b_bytes):.4f} ms: {flops:.3g} FLOP at FP32 -> "
            f"{b_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {b_bytes:.4f} ms; "
            f"scratch of C B^T, states and cum {scratch / 1e6:.1f} MB "
            f"written and read besides); {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{max(b_ops, b_bytes) / ms:.3f} of the bound, "
            f"{plain / ms:.2f}x faster than plain; grids of {BHs * nc} "
            f"chunk blocks on the card's {sms} SMs")
    log(f"ssd_scan: {per_prefill['ssd_scan']} calls per Mamba-2 prefill, "
        f"four launches each")
    (ss_ms, ss_wrap, ss_plain, f1, n1), row = ss[1], ss[BHs]
    ss_b_ops, ss_b_bytes = f1 / fp32 * 1e3, n1 / bw * 1e3
    return [
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn.py:81",
         "launches": None, "max_abs_err": errs["flash_fwd"],
         "ms": fl_ms, "wrapper_ms": fl_wrap, "plain_ms": fl_plain,
         "bound_ms": max(fl_b_ops, fl_b_bytes),
         "bound_by": "operations" if fl_b_ops >= fl_b_bytes else "bytes",
         "library_ms": fl_lib},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:81",
         "launches": None, "max_abs_err": errs["ssd_scan"],
         "ms": ss_ms, "wrapper_ms": ss_wrap, "plain_ms": ss_plain,
         "bound_ms": max(ss_b_ops, ss_b_bytes),
         "bound_by": "operations" if ss_b_ops >= ss_b_bytes else "bytes",
         "library_ms": None, "groups": 1,
         "per_row_ms": row[0], "per_row_wrapper_ms": row[1],
         "per_row_plain_ms": row[2],
         "per_row_bound_ms": max(row[3] / fp32, row[4] / bw) * 1e3},
    ]


# ------------------------------------------------------------- training


def flash_bwd_inputs(np, torch, dev, rng, BH, S, hd, window, dtype):
    """q, k, v, dO in ``dtype`` and the kernel forward's O and LSE."""
    from repro_torch.kernels.flash_attn import flash_fwd

    q, k, v, do = [torch.from_numpy(rng.standard_normal((BH, S, hd))
                                    .astype(np.float32)).to(dev, dtype)
                   for _ in range(4)]
    o, lse = flash_fwd(q, k, v, scale=1.0 / float(np.sqrt(hd)), window=window)
    return q, k, v, do, o, lse


def phase_bwd_kernels(np, torch, dev):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` against ``flash_bwd_plain``
    at the forward's shapes, the training path's included; returns the
    largest |diff| of each."""
    from repro_torch.kernels.flash_attn import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_bwd_plain, flash_delta)

    rng = np.random.default_rng(70)
    errs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for BH, S, hd, window in FLASH_SHAPES + train_flash_shapes():
        scale = 1.0 / float(np.sqrt(hd))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, o, lse = flash_bwd_inputs(np, torch, dev, rng, BH, S,
                                                   hd, window, dtype)
            delta = flash_delta(o, do)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, scale=scale,
                              window=window)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale,
                                   window=window)
            want = flash_bwd_plain(q.float(), k.float(), v.float(), o.float(),
                                   lse, do.float(), scale=scale, window=window)
            torch.cuda.synchronize()
            tol = TOL_FLASH_BWD if dtype == torch.float32 else TOL_FLASH_BWD_BF16
            got = {"dQ": dq, "dK": dk, "dV": dv}
            e = {n: (g.float() - w).abs().max().item()
                 for (n, g), w in zip(got.items(), want)}
            check(all(g.dtype == dtype and bool(torch.isfinite(g).all())
                      and torch.allclose(g.float(), w, **tol)
                      for g, w in zip(got.values(), want)),
                  f"flash backward [{BH}, {S}, {hd}] window {window} {dtype}: "
                  f"max |err| {e} over {tol}")
            errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dQ"])
            errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e["dK"],
                                        e["dV"])
            log(f"flash_bwd_dq / flash_bwd_dkv [{BH}, {S}, {hd}] window "
                f"{window} {str(dtype)[6:]}: max |err| vs plain (f32) "
                + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
                + f" (tolerance {tol['atol']})")
            del q, k, v, do, o, lse, delta, dq, dk, dv, want, got
    torch.cuda.empty_cache()
    return errs


def phase_bwd_timings(np, torch, dev, errs):
    """Both backward kernels at [15, 4,096, 64] bf16: device time, wrapper
    time, plain version, bound, and the SDPA backward; returns their
    kernels-line entries, whose ``launches`` the training phase fills."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attn import (flash_bwd, flash_bwd_dkv,
                                                flash_bwd_dkv_plain,
                                                flash_bwd_dq,
                                                flash_bwd_dq_plain,
                                                flash_delta)

    bw, _, bf16 = card_peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(80)
    BH, S, hd, _ = FLASH_SHAPES[2]
    scale = 1.0 / float(np.sqrt(hd))
    q, k, v, do, o, lse = flash_bwd_inputs(np, torch, dev, rng, BH, S, hd, 0,
                                           torch.bfloat16)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    dq_ms, dq_wrap = kernel_times(
        torch, lambda: flash_bwd_dq(*args, scale=scale),
        "flash_bwd_dq_wgmma_kernel", 10, require=True)
    dkv_ms, dkv_wrap = kernel_times(
        torch, lambda: flash_bwd_dkv(*args, scale=scale),
        "flash_bwd_dkv_wgmma_kernel", 10, require=True)
    dq_plain = cuda_ms(torch, lambda: flash_bwd_dq_plain(*args, scale=scale),
                       2, repeats=3)
    dkv_plain = cuda_ms(torch, lambda: flash_bwd_dkv_plain(*args, scale=scale),
                        2, repeats=3)
    whole = cuda_ms(torch, lambda: flash_bwd(q, k, v, o, lse, do, scale=scale),
                    10)
    # the library: [1, BH, S, hd], the layout of PyTorch's fused backends;
    # its own forward, then the backward alone, timed as one call
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(q4, k4, v4, is_causal=True, scale=scale)
    do4 = do[None]
    lib = torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
    ours = flash_bwd(q, k, v, o, lse, do, scale=scale)
    rel = [rel_l2(torch, a, b[0]) for a, b in zip(ours, lib)]
    check(max(rel) < TOL_SDPA_BWD, f"the SDPA backward disagrees with the "
                                   f"kernels: relative L2 {rel}")
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (q4, k4, v4), do4, retain_graph=True), 10)
    del q4, k4, v4, out, lib, ours

    pairs = BH * S * (S + 1) / 2                   # causal (q, k) pairs
    t_bytes = BH * S * hd * 2
    row_bytes = BH * S * 4
    dq_flops, dkv_flops = 3 * 2 * hd * pairs, 4 * 2 * hd * pairs
    dq_bytes = 4 * t_bytes + 2 * row_bytes + t_bytes      # q,k,v,dO,lse,delta->dQ
    dkv_bytes = 4 * t_bytes + 2 * row_bytes + 2 * t_bytes  # ... -> dK, dV
    entries = []
    for name, ms, wrap, plain, flops, nbytes in (
            ("flash_bwd_dq", dq_ms, dq_wrap, dq_plain, dq_flops, dq_bytes),
            ("flash_bwd_dkv", dkv_ms, dkv_wrap, dkv_plain, dkv_flops,
             dkv_bytes)):
        b_ops, b_bytes = flops / bf16 * 1e3, nbytes / bw * 1e3
        log(f"{name} [{BH}, {S}, {hd}] bf16: {ms:.4f} ms on the card "
            f"(wrapper {wrap:.4f}, plain {plain:.4f}, bound "
            f"{max(b_ops, b_bytes):.4f} ms: {flops:.3g} FLOP at bf16 -> "
            f"{b_ops:.4f} ms, {nbytes / 1e6:.1f} MB -> {b_bytes:.4f} ms); "
            f"{flops / ms / 1e9:.2f} TFLOP/s, "
            f"{max(b_ops, b_bytes) / ms:.3f} of the bound, {ms / lib_ms:.2f}x "
            f"scaled_dot_product_attention's whole backward")
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
            "replaces": ("src/repro/kernels/flash_attn.py:183"
                         if name == "flash_bwd_dq"
                         else "src/repro/kernels/flash_attn.py:200"),
            "launches": None, "max_abs_err": errs[name], "ms": ms,
            "wrapper_ms": wrap, "plain_ms": plain,
            "bound_ms": max(b_ops, b_bytes),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "library_ms": lib_ms})
    log(f"flash backward [{BH}, {S}, {hd}] bf16, both kernels and delta "
        f"through flash_bwd: {whole:.4f} ms; scaled_dot_product_attention's "
        f"backward {lib_ms:.4f} ms (relative L2 against the kernels: dQ "
        f"{rel[0]:.3g}, dK {rel[1]:.3g}, dV {rel[2]:.3g})")
    del q, k, v, do, o, lse, delta, args
    torch.cuda.empty_cache()
    return entries


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.clamp(torch.linalg.vector_norm(b.float()), min=1e-30))


def phase_train_parity(np, torch, dev):
    """SmolLM-360M at full width in f32: one train step's loss and
    gradients through the flash kernels against the naive path's; then
    Mamba-2 780M's kernel path refuses a gradient."""
    from repro_torch.kernels.ssd_scan import SsdScanGradError
    from repro_torch.models import transformer as MT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = model_config("smollm_360m", {"attn_impl": "flash"},
                       dtype="float32", param_dtype="float32", remat="none")
    params = MT.init_params(cfg, torch.Generator(device=dev).manual_seed(300),
                            dev)
    rng = np.random.default_rng(60)
    B, S = TRAIN_PARITY
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, OptConfig())
    reset_counts()
    loss_f, _, g_f = step.grads(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    n = cfg.num_layers
    check(counts["flash_fwd"] == n and counts["flash_bwd_dq"] == n
          and counts["flash_bwd_dkv"] == n,
          f"f32 flash train step: launches {counts}, want {n} of each flash "
          f"kernel")
    loss_n, _, g_n = make_train_step(
        cfg.with_(attn_impl="naive"), OptConfig()).grads(params, batch)
    check(set(g_f) == set(g_n) == set(params),
          f"gradient leaves {sorted(g_f)} vs {sorted(params)}")
    dl = abs(float(loss_f) - float(loss_n)) / abs(float(loss_n))
    check(dl < TOL_TRAIN_LOSS, f"f32 loss flash {float(loss_f)} vs naive "
                               f"{float(loss_n)}: {dl:.3g} relative")
    errs = {}
    for key, g in g_f.items():
        fin = bool(torch.isfinite(g).all())
        nz = float(g.abs().max()) > 0
        errs[key] = rel_l2(torch, g, g_n[key])
        check(fin and nz and errs[key] < TOL_TRAIN_GRAD,
              f"f32 gradient {key}: finite {fin}, non-zero {nz}, relative "
              f"L2 vs naive {errs[key]:.3g} (tolerance {TOL_TRAIN_GRAD})")
    named = {k: errs[k] for k in errs if k.endswith(("_wq", "_wk", "_wv"))}
    check(len(named) == 3, f"no wq/wk/wv among {sorted(errs)}")
    state, m = step({"params": params, "opt": step.init_opt(params),
                     "step": 0}, batch)
    check(abs(float(m["loss"]) - float(loss_f)) <= 1e-6 * abs(float(loss_f))
          and all(bool(torch.isfinite(t).all())
                  for t in state["params"].values()),
          f"f32 AdamW step: loss {float(m['loss'])} vs {float(loss_f)}")
    log(f"smollm_360m f32 full width, train step on {B} x {S} tokens "
        f"(remat none): loss flash {float(loss_f):.6f} vs naive "
        f"{float(loss_n):.6f} ({dl:.3g} relative, tolerance "
        f"{TOL_TRAIN_LOSS}); gradients relative L2 vs naive, max "
        f"{max(errs.values()):.3g} over {len(errs)} leaves (tolerance "
        f"{TOL_TRAIN_GRAD}): " + ", ".join(f"{k} {v:.3g}"
                                           for k, v in named.items())
        + f"; every leaf finite and non-zero; launches {counts}; grad norm "
        f"{float(m['grad_norm']):.4f}")
    del params, g_f, g_n, state, batch
    torch.cuda.empty_cache()

    cfg = model_config("mamba2_780m", {"ssd_impl": "kernel"})
    params = MT.init_params(cfg, torch.Generator(device=dev).manual_seed(301),
                            dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))
                            .astype(np.int32)).to(dev)
    step = make_train_step(cfg, OptConfig())
    reset_counts()
    try:
        step.grads(params, {"tokens": toks, "labels": toks})
    except SsdScanGradError as e:
        log(f"mamba2_780m ssd_impl='kernel' with a gradient refuses: {e}; "
            f"launches {read_counts()}")
    else:
        raise SmokeError("ssd_scan took a gradient")
    check(read_counts()["ssd_scan"] == 0, "ssd_scan launched in the refusal")
    del params
    torch.cuda.empty_cache()


def phase_training(np, torch, dev):
    """SmolLM-360M bf16 training at full width through the flash kernels —
    the training path; returns {kernel: launches in the 8 timed steps}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import Loader, TokenDataset
    from repro_torch.models import transformer as MT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = model_config("smollm_360m", {"attn_impl": "flash"}, remat="block")
    opt = OptConfig(lr=1e-3, schedule="constant", warmup_steps=1,
                    state_dtype="float32")
    step = make_train_step(cfg, opt, microbatches=TRAIN_MB)
    params = MT.init_params(cfg, torch.Generator(device=dev).manual_seed(400),
                            dev)
    state = {"params": params, "opt": step.init_opt(params), "step": 0}
    del params
    loader = Loader(TokenDataset(cfg.vocab_size, seed=7), shard_id=0,
                    n_shards=1, batch_per_shard=TRAIN_B, seq_len=TRAIN_S)
    n = cfg.num_layers
    per_step = {"flash_fwd": n * 2 * TRAIN_MB, "flash_bwd_dq": n * TRAIN_MB,
                "flash_bwd_dkv": n * TRAIN_MB}

    def batch_on_card():
        _, b = next(loader)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    def one_step(state, batch):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = read_counts()
        delta = {k: now[k] - before[k] for k in now}
        want = {k: per_step.get(k, 0) for k in now}
        check(delta == want, f"train step launches {delta}, want {want}")
        check(np.isfinite(float(m["loss"])), f"loss {float(m['loss'])}")
        return state, m, dt

    try:
        for _ in range(TRAIN_WARM):
            state, m, _ = one_step(state, batch_on_card())
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times, losses = [], []
        for _ in range(TRAIN_TIMED):
            state, m, dt = one_step(state, batch_on_card())
            times.append(dt)
            losses.append(float(m["loss"]))
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        med = statistics.median(times)
        tokens = TRAIN_B * TRAIN_S
        log(f"smollm_360m bf16 training, batch {TRAIN_B} x {TRAIN_S} in "
            f"{TRAIN_MB} microbatches, remat block, AdamW f32 state: "
            f"{TRAIN_TIMED} steps of " + ", ".join(f"{t:.4f}" for t in times)
            + f" s, median {med:.4f} s = {tokens / med:.1f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB; losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; launches per step {per_step}, in the timed steps "
            f"{launches}")
        batch = batch_on_card()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m, dt = one_step(state, batch)
        log_card_busy(prof, med, "smollm_360m card over a traced train step",
                      ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                       "flash_bwd_dkv_wgmma_kernel"))
        log(f"traced step {dt:.4f} s (untraced median {med:.4f} s)")
        fit = []
        for _ in range(TRAIN_FIT):
            state, m, _ = one_step(state, batch)
            fit.append(float(m["loss"]))
        check(fit[-1] < fit[0], f"loss on one batch did not fall: {fit}")
        log(f"{TRAIN_FIT} steps on one batch: loss "
            + ", ".join(f"{x:.4f}" for x in fit))
    finally:
        loader.close()
    del state, batch
    torch.cuda.empty_cache()
    return launches


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
    agg_err = phase_agg_kernel(np, torch, dev)       # (poll, sweep)
    phase_example(np, torch, dev)
    counts, rates, d = phase_full(np, torch, dev)
    kernels = phase_timings(np, torch, dev, d, counts, rates, errs)
    phase_breakdown(np, torch, d, d.src_ctx.handles["uvm_affine"], rates)
    del d
    phase_agg_example(np, torch, dev)
    agg_counts, agg_rates, d = phase_agg_full(np, torch, dev)
    agg_entry, vm_err, _ = phase_agg_timings(np, torch, dev, d, agg_counts,
                                             agg_rates, agg_err)
    vm = kernels[1]           # ifunc_vm runs inside both lanes' sweeps
    vm["launches"] += agg_counts["agg_sweep"]
    vm["standalone_launches"] += agg_counts["ifunc_vm"]
    vm["max_abs_err"] = max(vm["max_abs_err"], vm_err)
    kernels.append(agg_entry)
    del d
    host = phase_host_target(np, torch, dev)
    vm["host_launches"] = host["launches"]
    vm["host_ms"] = host["ms"]
    vm["max_abs_err"] = max(vm["max_abs_err"], host["err"])
    mp = phase_multi_peer(np, torch, dev, host["rate"])
    vm["dispatcher_launches"] = mp["launches"]
    vm["launches"] += mp["sweeps"]        # it runs inside those sweeps
    kernels[0]["launches"] += mp["sweeps"]
    ft = phase_futures(np, torch, dev, mp["rates"], smi)
    vm["future_launches"] = ft["launches"]
    vm["launches"] += ft["sweeps"] + ft["agg_sweeps"]
    kernels[0]["launches"] += ft["sweeps"]
    kernels[2]["launches"] += ft["agg_sweeps"]
    model_errs = phase_model_kernels(np, torch, dev)
    bwd_errs = phase_bwd_kernels(np, torch, dev)
    # timed, and a train step traced, before the serving phase's long
    # traces, after which the profiler recorded no device time in a run on
    # the H100
    model_entries = phase_model_timings(np, torch, dev, model_errs)
    bwd_entries = phase_bwd_timings(np, torch, dev, bwd_errs)
    phase_train_parity(np, torch, dev)
    train_launches = phase_training(np, torch, dev)
    for entry in bwd_entries:
        entry["launches"] = train_launches[entry["name"]]
    phase_model_parity(np, torch, dev)
    launches = phase_serving(np, torch, dev)
    for entry in model_entries:
        entry["launches"] = launches[entry["name"]]
    kernels += model_entries + bwd_entries
    check(all(e["launches"] > 0 for e in kernels),
          f"kernels not launched on their paths: "
          f"{[e['name'] for e in kernels if not e['launches']]}")
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
