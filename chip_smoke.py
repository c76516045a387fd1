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
    for S in {200, 512, 4096}, [4, 512, 128] with window 256, every
    training shape of phases 16 and 17 (``train_flash_shapes``: each
    model's microbatch and parity batch, e.g. [64, 2,048, 96] and
    [64, 2,048, 128]), every prefill shape of phase 13
    (``flash_fwd_shapes``: heads x positions x head_dim of each served
    model at its prompts and at 4,096, e.g. RecurrentGemma's [10, S, 256]
    with window 2,048, InternLM2's [16, S, 128], Qwen1.5's [20, S, 128],
    MiniCPM's [36, S, 64], Phi-3-Vision's [32, 577 + S, 96]),
    [32, 512, 96] and every per-rank shape of phase 27 (b)'s
    ``prefill_32k`` pod cells (``dryrun_prefill_flash_shapes``: 2 rows
    of 32,768 positions a rank times its q heads, e.g. Qwen1.5-4B's [4,
    32,768, 128] with 2 of its 20 heads (a padded tile over 16),
    Qwen3-30B-A3B's [4, 32,768, 128] with 2 of 32; the plain version a
    batch-head at a time; in bf16 alone, the type those cells run), f32
    (the FMA kernel) and bf16 (the wgmma kernel); ``ssd_scan`` on [48, nc, Q, 64], ds 128, for
    (nc, Q) in {(1, 200), (16, 256)}, B and C per row (G = 48) and shared
    by the 48 heads (G = 1, the model's layout at batch 1), the grouped
    call equal bit for bit to the same B and C broadcast to every row;
11. model kernel timings at the path's largest shapes as in phase 5, with
    ``scaled_dot_product_attention`` as flash's library yardstick: the bf16
    forward timed by its own profiler name (``flash_fwd_wgmma_kernel``),
    its TFLOP/s, share of the bound and ratio to SDPA's forward, at
    [15, 4,096, 64] and at the other head dims' largest shapes, [10,
    4,096, 256] with window 2,048 (beside SDPA causal without the window
    and SDPA with the window as a boolean mask), [32, 4,096, 96] and
    [20, 4,096, 128], and at MiniCPM-2B's [36, 4,096, 64];
    ``ssd_scan`` at [48, 16, 256, 64], ds 128, in both layouts of phase
    10, its four ``ssd_`` kernels' device times summed per call, each
    layout beside its own bound (C B^T counted once per group);
12. model parity in f32 at the full published width and at most 8
    layers (``PARITY_LAYERS``; phase 13 serves them at published depth)
    of SmolLM-360M, Mamba-2 780M, RecurrentGemma-2B, Phi-3-Vision (tokens
    only), InternLM2-1.8B, Qwen1.5-4B, MiniCPM-2B and MusicGen-large, and
    of Qwen3-30B-A3B at 4 of its 48 layers: the kernel path's prefill logits
    and cache against the plain path's on 4 prompts of 256 tokens, and
    teacher forcing (prefill 240 tokens through the kernels, decode 16,
    each step against the plain path's train logits; for the MoE at a
    capacity factor of E / k, where no token copy is dropped in any mode,
    and at the published 1.25 the kernel path's prefill and decode logits
    against the plain path's, which drops the same copies);
13. serving in bf16 at published width and depth, ``SERVE_MODELS``:
    SmolLM-360M, Mamba-2 780M, RecurrentGemma-2B, Qwen3-30B-A3B (all 48
    layers), InternLM2-1.8B, Qwen1.5-4B, MiniCPM-2B, MusicGen-large and
    Phi-3-Vision (its token path after a seeded prefix of 577 image
    embeddings): a ``ContinuousBatcher`` with 4 slots and cache_len
    2,048 answers 4 requests (prompts of 1,024, 512, 256 and 200 tokens;
    Phi-3-Vision's fill 1,792, 1,280, 1,024 and 768 positions with the
    prefix; 16 new tokens each), the model's kernel launched once per
    attention (or SSD) layer in each prefill (8 of RecurrentGemma's 26)
    and never in decode; decode tokens/s, the SMs' idle share over the
    phase (a traced run whose tokens must equal the untraced run's),
    prefill positions/s at batch 1 and 4,096 positions, that prefill's
    five longest device kernels under torch.profiler, and the peak
    memory after ``init_params`` and over the model's run (each model's
    parameters freed before the next is drawn);
14. the flash backward kernels (``flash_bwd_dq``, ``flash_bwd_dkv``) on
    the card, f32 and bf16 (bf16 through ``flash_bwd_dq_wgmma_kernel``
    and ``flash_bwd_dkv_wgmma_kernel``), at ``FLASH_SHAPES``, every
    training shape (head_dim 64, 96, 128 and 256: RecurrentGemma's
    microbatch [10, 4,096, 256] with window 2,048, Phi-3-Vision's
    [64, 2,048, 96], Qwen3's [64, 2,048, 128], InternLM2's [32, 2,048,
    128] (KV repeated), Qwen1.5's [40, 2,048, 128], MiniCPM's [72, 2,048,
    64], MusicGen's [64, 2,048, 64]) and ragged and one-position shapes
    at 96 and 256, each shape's inputs drawn from its own seed: f32
    against ``flash_bwd_plain`` (2e-4); bf16 against its bf16 twin
    ``flash_bwd_plain_bf16`` (P and dS rounded where the kernels round
    them; rtol 4e-3, atol 6e-3, and 1e-3 relative L2 against the twin
    rounded to bf16) and against ``flash_bwd_plain`` in f32 (1e-2
    relative L2); phase 15 holds its [20, 4,096, 128] to SDPA's
    backward;
15. backward timings in bf16 as in phase 11, each kernel by its profiler
    name, at [15, 4,096, 64] and at phase 11's [10, 4,096, 256] with
    window 2,048, [32, 4,096, 96] and [20, 4,096, 128], with the
    backward of ``scaled_dot_product_attention`` (causal; at 256 also
    with the window as a boolean mask) as the library yardstick of both
    kernels together, each kernel's ratio to it logged;
16. training parity in f32 at full width, ``PARITY_MODELS``: one
    ``make_train_step``'s loss and gradients through the flash kernels
    against the naive path's, every parameter with a finite non-zero
    gradient, for SmolLM-360M (2 x 1,024), RecurrentGemma-2B at two
    super-blocks (1 x 4,096, so that the window masks), Phi-3-Vision at
    4 layers (1 x 2,048 with its 577 image positions), Qwen3-30B-A3B
    at 4 layers (2 x 1,024, capacity factor E / k) and InternLM2-1.8B,
    Qwen1.5-4B, MiniCPM-2B and MusicGen-large at 4 layers (2 x 2,048,
    phase 17's microbatch), the peak memory of each logged; Mamba-2 780M
    with ``ssd_impl="kernel"`` refuses a gradient;
17. training in bf16 at full width, the training path, ``TRAIN_MODELS``:
    ``attn_impl="flash"``, ``remat="block"``, AdamW with f32 state
    donated to the step, batches from ``data.Loader`` in 2 microbatches:
    SmolLM-360M (4 x 2,048), RecurrentGemma-2B at its published width
    and depth (26 layers, 2 x 4,096), Qwen3-30B-A3B at 4 layers, and at
    published width and depth
    Phi-3-Vision (32 layers), InternLM2-1.8B, Qwen1.5-4B, MiniCPM-2B,
    MusicGen-large and Mamba-2 780M (``ssd_impl="xla"``, no kernel: its
    ``ssd_scan`` has no gradient) (4 x 2,048 each); 1 warm-up, 3 timed
    and 5 one-batch steps each; for each, step time, tokens/s, peak memory
    beside the estimate of the same step on meta tensors under
    ``launch/dryrun.py``'s ``LiveBytes`` and the card's name and power
    limit, the flash launches of every step asserted (each attention
    layer's forward twice under block remat and each backward kernel
    once, a microbatch; none for Mamba-2, and no ``ssd_scan``), the SMs'
    idle share in a traced step with each flash kernel's time a launch,
    and a loss that falls on one batch;
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

21. placement and the graph workload, the port's
    ``examples/graph_analysis.py`` without ``--kill-peer``: (a) single-
    source shortest paths over a 128-vertex graph (seed 7, 2,927 edges) in
    4 CSR shards on ``rdma_a`` and ``rdma_b`` (``RdmaFabric``) and ``csd``
    (``LoopbackFabric``, shard 3 replicated at the source), each 8 slots
    of 64 KiB on a ``device="cuda"`` target, under a ``TaskRuntime`` over
    ``ProgressEngine(8, "trailer")``, with ``DataDirectory`` and
    ``PlacementEngine(steal_depth=3)`` deciding migrate, fetch or local
    for each shard's relax every round; each round first sends the
    frontier indicator tile as ``graph_degree`` μVM futures to the 8
    shards of ``gpu`` (phase 4's mailbox of 8 x 64 slots, 128 KiB each,
    shift 0, the adjacency column-sharded into its externals); at round
    2, six ``counter_bump`` frames congest shard 0's owner and
    ``rebalance`` moves the shard.  Three whole runs, each from a fresh
    runtime and directory, pass the example's gates (``graph_gates``:
    ``dist`` within rtol 1e-5, atol 1e-5 of Bellman-Ford, all three
    decisions taken, the shard moved, no orphan or pending future, every
    device future's counts exactly ``f_ind @ A_dev[d, 0]``) and print
    GRAPH_OK; each logs rounds/s, degree futures/s, the decisions, moves
    and the SMs' idle share (traced with device activity only); launches
    ``ring_sweep_smem_kernel`` once a device sweep and nothing else.
    (b) ``fig_graph`` at ``bench_ifunc.py``'s settings: µs a relax task
    migrated, fetched and local at 1,024, 8,192 and 65,536-edge shards,
    the median of 3, migrate under fetch at the largest.  (c) one
    ``graph_degree`` future to a host target on the card: one
    ``ifunc_vm_smem_kernel`` launch, its result equal to the device
    lane's for the same frontier and shard.

22. streamed large payloads (frame v2.5): (a) ``uvm_affine`` streams of
    128 and 1,024 tiles (8 MiB and 64 MiB, the target's
    ``max_stream_bytes``) by ``send_stream`` at ``set_streaming``'s
    defaults (256 KiB chunks, window 4) to an ``RdmaFabric`` peer on a
    ``device="cuda"`` target with W resident, raw and under ``quant8``:
    each one stream of ``ceil(bytes / chunk)`` chunks and one
    ``ifunc_vm`` launch, nothing else launched; raw results bit for bit
    ``uvm_execute``'s on the same tiles, quant8 results within rtol 1e-4,
    atol 1e-5 of ``ifunc_vm_plain`` over the assembled tiles, the
    assembly within the codec's bound of the payload (chunk 0 exact); no
    receive state left; seconds, GB/s and host timers a stream, the
    kernel's device time at each size and the SMs' idle share over one
    traced stream.  (b) ``examples/storage_pipeline.py`` Act 4 without the
    flow engine: 8 MiB of runs through ``send_ifunc``'s auto-route in 128
    chunks of 64 KiB under ``rle``, reduced by ``host_aggregate`` on
    arrival; the example's gates and STREAM_OK.  (c) a striped peer (2
    rings of phase 19's 512 slots x 132 KiB) taking 2 x 512 two-tile
    frames with one ``counter_bump`` NACK and resend: results in send
    order, one ``ifunc_vm`` launch a frame, frames/s beside phase 19's one
    RDMA peer.  (d) ``fig_stream`` as ``bench_ifunc.py`` defines it (the
    ``stream``, ``sf``, ``sf_full`` and ``am`` cells at 64 KiB to 16 MiB,
    µs a message, min of chunks), logged with the reference's orderings,
    not gated.  (a) to (c) run under ``no_plain``.

23. the flow layer (``repro_torch.flow``), every node's context on the
    card: (a) ``examples/storage_pipeline.py`` Acts 1-3 at the example's
    settings (seed 11; ``csd`` on ``LoopbackFabric``, ``dpu_a``,
    ``dpu_b`` and ``agg`` on ``RdmaFabric``, slots of 256 KiB): 6 ETL
    chains ``csd_decompress`` -> ``dpu_filter`` at the cheaper DPU ->
    ``host_aggregate``, ``dpu_a`` congested at batch 3, each result
    against numpy, both DPUs picked, SLIM forwards; the scatter/gather
    edge count against the direct count; the short-circuit naming
    ``graph_count@dpu_a`` with ``agg`` never run; nothing pending or
    orphaned (FLOW_OK).  (b) Act 4 through the engine's origin
    dispatcher (STREAM_OK), then OBS_OK: a ``flow`` span for each stage
    run on that peer's actor, one ``chain`` span a flow, none open, a
    ``chunk:`` span a chunk, the Chrome export to a temporary directory.
    (c) the ETL at full size: 32 batches of 49,152 records (about 55,000
    expanded), slots of 512 KiB, ``dpu_a`` congested at batch 16: chains/s,
    records/s, host timers by step and the SMs' idle share; (a) to (c)
    launch no kernel.  (d) 512 two-hop ``uvm_affine`` chains (the cheaper
    DPU, then ``agg``), one 2-tile payload each, each node's seeded W on
    the card, ``dpu_a`` congested halfway: ``ifunc_vm_smem_kernel``
    launched twice a chain and nothing else, both DPUs used, each result
    within rtol 1e-4, atol 1e-5 of ``ifunc_vm_plain`` stage by stage;
    chains/s, µs a chain, host timers, then 64 chains timed and 64 traced
    for the kernel's device time a hop and the SMs' idle share.  (a) to (d) run
    under ``no_plain``.  (e) ``fig_flow`` as ``bench_ifunc.py`` defines it
    (3 and 5 ``flow_xform`` stages, 32 KiB, 40 iterations, RDMA and
    loopback alternating) through ``FlowEngine`` and ``TaskRuntime``: the
    chain under the round-trips at both stage counts.

24. the runtime (``repro_torch.runtime``): (a) the port's
    ``examples/train_driver.py`` at phase 17's full width (SmolLM-360M,
    bf16, AdamW with f32 state, 4 x 2,048 tokens in 2 microbatches, the
    same seeded weights): 12 steps with a ``WorkerAgent`` polled between
    them and a ``PodController`` (both on card contexts) injecting
    ``ctl_set_lr`` (0.5) after step 6 and ``ctl_checkpoint`` after steps
    6 and 12, saved asynchronously by ``CheckpointManager(keep=1)`` under
    ``build/`` (the disk's free space checked first, the directory
    removed after); each step's flash launches equal phase 17's,
    ``lr_scale`` 0.5, only step 12 kept, its restore (sha256 verified)
    from a meta template equal to the live state bit for bit, and one
    more step from the restored and from the live state equal bit for bit
    (loss and every leaf); logged: the state's bytes by ``param_specs``,
    each save's host copy, write and GB/s, the restore and verify times,
    the step times alone and beside a write, and the SMs' idle share over
    the traced loop.  (b) ``examples/graph_analysis.py --kill-peer``
    (``graph_workload(kill=True)``): an ``ElasticController`` riding
    ``Dispatcher.pollers`` heartbeats the host peers under a 0.2 s
    deadline; ``rdma_b`` dies with a relax in flight once its cache is
    warm, the deadline inside ``poll`` fires the recovery, a round later
    it is re-admitted with the warm manifest; ELASTIC_OK, ``dist`` against
    Bellman-Ford, the device futures exact, ``ring_sweep`` once a device
    sweep and nothing else; the time from the kill to the recovery.  (c)
    ``fig_elastic`` at ``bench_ifunc.py``'s settings on card contexts:
    recovery within [0.8, 3.0] of the 20, 50 and 100 ms deadlines (best of
    3) and ``hb_overhead`` over 1,024 messages at most 0.02
    (``check_bench.py``'s bounds).

25. the disaggregated serving fleet (``repro_torch.serving``),
    ``examples/serving_fabric.py`` at SmolLM-360M's width (bf16, flash,
    seeded weights): (a) the single ``Server`` and a 2 prefill + 2 decode
    ``ServingFabric`` (``streamed_fabric``: 1 MiB KV chunks, 4 in
    flight), 4 slots and cache 2,048 each, on 8 requests of distinct
    prompt lengths (1,024 to 64) and budgets 8 / 16 / 32: the fleet's
    tokens equal the host's token for token, 8 streams landed, no
    buffered install, a decode batch at unequal positions, ``flash_fwd``
    launched 32 times a host prefill and a fleet prefill group and nothing
    else; logged, from both runs' obs traces: requests/s, decoded tokens/s
    over the run and over the decode ticks' time, each slab's bytes,
    chunks, open-to-acked s and GB/s, each request's enqueue to install,
    the prefill D2H, rounds; and the SMs' idle share over the fleet again
    under torch.profiler.  (b) 4 prompts of 512 through one
    prefill peer as one [4, 512] forward: each row's slab entries and
    first-token logits within relative L2 1e-2 of its own [1, 512]
    prefill; tokens equal to the host's logged.  (c) decode peers
    advertising quant8: every request completes, quant8 negotiated, no
    buffered install; wire bytes against (a)'s.  (d) ``python -m
    repro_torch.launch.serve`` on the card in both modes, exit 0 and
    neither jax nor the JAX package loaded in the child.

26. sharded training through ``repro_torch.launch.train`` on a one-rank
    NCCL group and its (1, 1) ("data", "model") mesh (set up and torn
    down by the phase): (a) SmolLM-360M at phase 17's settings (bf16,
    flash, block remat, AdamW with f32 state, 4 x 2,048 in 2
    microbatches), 8 steps with checkpoints after 4 and 8 (under
    ``build/``, removed after), then a second launcher resumed from step
    4 (``restore(placements=)``) for 4 more: every state leaf a DTensor
    with the rules' placements, the first run's losses and final state
    bit for bit those of ``make_train_step`` applied directly to the same
    seeded state and batches, the resumed losses and state bit for bit
    the first run's, phase 17's flash launches a step; the step time,
    tokens/s and peak memory logged beside phase 17's, and the SMs' idle
    share over one more traced sharded step.  (b) Qwen3-30B-A3B at 4 of
    48 layers (phase 17's width), one forward and backward under the mesh
    (the MoE's ``a2a`` path: ``all_to_all`` over the one-rank group) and
    one without: loss and every gradient equal in value.

27. the dry run (``repro_torch.launch.dryrun``): (a) all 80 (arch x
    shape x mesh) cells at ``baseline`` on meta tensors, in 6 worker
    processes with the card hidden, while (b) runs: no cell an error,
    ``long_500k`` skipped exactly outside the ``ssm`` and ``hybrid``
    families (the reference's set), a table of each cell's argument and
    temp GiB, ``fits``, FLOP and seconds.  (b) ``flash_fwd`` in bf16 on
    [1, 32,768, hd] for hd 64, 96, 128 and 256 (window 2,048) and
    ``ssd_scan`` on [48, 128, 256, 64], ds 128, G 1 and on the pod rank's
    [6, 128, 256, 64], G 2 (its 2 rows x 3 of the 48 heads) against their
    plain versions, the latter also timed; then for each arch the first
    ``prefill_32k`` cell (``pod``: 2 x 32,768 a rank; ``multipod``: 1 x
    32,768) whose estimate leaves a tenth of the card free, run on the
    card by ``run_cell(execute=True)`` at published width and depth with
    ``flash`` (``ssdk`` for Mamba-2), the rank's shards of the weights
    gathered a layer at a time, its ``model`` group splitting the heads
    and vocabulary (in padded tiles where ``model`` does not divide them)
    and the MLPs, the MoE on its expert-parallel path (the rank's 1/16 of
    the experts a layer, its ``all_to_all`` moving nothing), its cache
    cut to its block of the slots: all ten must run, every run's cache
    and logits finite and of their shards' shapes, ``kernel_layers``
    launches of its kernel and nothing else, flash at a shape phase 10
    holds, its measured peak within [0.90, 1.10] of the estimate; each
    run's estimate, peak, ratio, wall time and launches logged.  Then
    two ``train_4k`` cells of the pod under ``dp_fsdp+flash``, each one
    rank's step of 1 x 4,096 with its 1/256 of the state, kept sharded
    (a layer's weights gathered at a time, the gradients reduced to the
    blocks, AdamW on the blocks): Qwen3-30B-A3B at all 48 layers (its
    MoE on the expert-parallel path: 8 of its 128 experts a layer) and
    Qwen1.5-4B, each with its measured peak within [0.90, 1.10] of the
    estimate, ``train_launches_per_step`` launches of each flash kernel
    (forward twice a layer for the remat, dQ and dK/dV once) and nothing
    else, a finite loss, and state and metrics of their shards' shapes;
    likewise under ``baseline+flash`` Qwen3, InternLM2-1.8B,
    RecurrentGemma-2B (26 layers, its RG-LRU blocks split over ``model``:
    160 of the 2,560 channels a rank; 1 of its 10 heads) and MiniCPM-2B
    (40 layers, 3 of its 36 heads and 7,673 of its 122,753 words a rank,
    padded tiles over 16: flash at [48, 4,096, 64]) and Llama-4 Maverick
    (48 layers, 3 of its 40 heads, 12,628 of its 202,048 words and 8 of
    its 128 experts a layer a rank: flash at [48, 4,096, 128]), each
    cross-entropy within 0.1 of ln(the rank's words) + sigma^2 D / 2.
    Then one rank's ``decode_32k`` pod step of Qwen1.5-4B, of
    Qwen3-30B-A3B at all 48 layers, of RecurrentGemma-2B, of Mamba-2
    780M and of Llama-4 Maverick under ``baseline`` (``DRYRUN_DECODE``;
    the MoEs on their ``psum`` path): 8 rows and its 2,048 of
    the cache's 32,768 slots a layer (sequence-parallel attention), the
    RG-LRU's and SSD's states the rank's block of the channels or heads,
    every slot valid and the token at position 32,767, its cache and
    logits finite and of their shards' shapes, no kernel launched, its
    measured peak within [0.90, 1.10] of the estimate.  (c)
    ``fig5_cached``'s scenario: ``bench_hot`` through the port's
    ``Dispatcher`` to a host peer, one FULL then 64 SLIM invocations:
    links 1, 64 SLIM, 65 invocations, the 256 KiB code section on the wire
    once; host µs an invocation, FULL and SLIM.

The phases run in the order 1-9, 10, 14, 11, 15-17, 26, 12-13, 18-25, 27: every
profiler session that must find a kernel by name (phases 5, 9, 11, 15)
comes before the long traces of phases 13, 24 and 25 (up to 180,000
device records each), after which torch.profiler lost whole traces on
the H100.  A trace that comes back without the records of the kernel it
times is logged and taken again, five traces at most.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's ``nvidia-smi`` name and power limit; before that the ``kernels``
JSON line, one entry per TPU kernel.  The ``ring_poll`` and
``agg_ring_poll`` entries describe the fused sweeps that now poll on the
lanes (their ``standalone_*`` keys the poll kernels alone; ``ring_poll``
counts phase 19's device sweeps too); ``ifunc_vm`` counts the sweeps it
runs inside, ``host_launches`` its launches on the host target of phase
18 (``host_ms`` the device time of one there),
``dispatcher_launches`` its launches on phase 19's host peers and
``future_launches`` those on phase 20's, ``graph_host_launches`` phase
21's host ``graph_degree`` future, ``stream_launches`` phase 22's (one a
μVM stream, one a striped frame), ``flow_launches`` phase 23's (two a μVM
chain); ``ring_poll`` and ``agg_ring_poll``
count phase 20's device sweeps too, and ``ring_poll`` and ``ifunc_vm``
phase 21's and phase 24 (b)'s (``elastic_launches``, also in
``launches``); the three flash entries' ``driver_launches`` are their
launches in phase 24 (a)'s 12 steps, their ``launcher_launches`` those
in phase 26 (a)'s first 8 launcher steps, and ``flash_fwd``'s
``fabric_launches`` its launches in phase 25 (a)'s fleet run; the
``flash_fwd`` and ``ssd_scan`` entries' ``dryrun_launches`` are their
launches in phase 27 (b)'s prefill runs, and the three flash entries'
``dryrun_train_launches`` theirs in (b)'s train cells, all added to
``launches``; ``flash_fwd``'s ``dryrun_shapes`` lists the per-rank
shapes of (b)'s prefill cells, which phase 10 holds.
``flash_fwd``'s ``launches`` sum phase 13's eight flash models (a layer
a prefill: SmolLM-360M 32, RecurrentGemma-2B 8, Qwen3-30B-A3B 48,
InternLM2-1.8B 24, Qwen1.5-4B 40, MiniCPM-2B 40, MusicGen-large 48,
Phi-3-Vision 32; 1,088 in all) and its ``head_dims`` hold phase 11's
times at head_dim 256, 96 and 128 (``wide_64``: MiniCPM-2B's [36, 4,096,
64]), each with its bound and SDPA's (``library_window_mask_ms``: SDPA
given the window as a boolean mask); the backward entries' ``head_dims``
hold phase 15's at 256, 96 and 128, their ``max_abs_err`` phase 14's
largest against the plain version (a bf16 result against its bf16 twin)
and ``max_abs_err_bf16_vs_f32`` a bf16 result's against the f32 plain.
"""

import contextlib
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib

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
# placement and the graph workload (phase 21), examples/graph_analysis.py:
# 128 vertices (one μVM tile holds the device-tier adjacency), seed 7, 4
# CSR shards owned by rdma_a, rdma_b, csd, csd (shard 3 replicated at the
# source), host peers of 8 slots x 64 KiB, ProgressEngine(8, "trailer"),
# steal_depth 3, 6 counter_bump frames at the owner of shard 0 in round 2;
# the device lane at phase 4's width (8 shards x 64 slots of 128 KiB), one
# frontier tile to each shard a round; three whole runs
GRAPH_V, GRAPH_SHARDS, GRAPH_SEED, GRAPH_SRC = 128, 4, 7, 0
GRAPH_HOSTS = (("rdma_a", "rdma"), ("rdma_b", "rdma"), ("csd", "loopback"))
GRAPH_OWNERS = {0: "rdma_a", 1: "rdma_b", 2: "csd", 3: "csd"}
GRAPH_SLOTS, GRAPH_SLOT, GRAPH_DEV_SLOT = 8, 64 << 10, 128 << 10
GRAPH_CONGEST, GRAPH_BURST, GRAPH_RUNS, GRAPH_MAX_ROUNDS = 2, 6, 3, 64
# ``--kill-peer``: shard 1's owner dies mid-run under a 0.2 s deadline
GRAPH_KILL, GRAPH_DEADLINE = "rdma_b", 0.2
# phase 24: the train driver's steps and checkpoint interval (steps 6 and
# 12 checkpointed, keep=1); fig_elastic's deadlines (bench_ifunc.py's)
DRIVER_STEPS, DRIVER_CKPT = 12, 6
FIG_ELASTIC_DEADLINES = (20, 50, 100)
TOL_GRAPH = dict(rtol=1e-5, atol=1e-5)        # the example's, vs Bellman-Ford
# benchmarks/bench_ifunc.py::bench_graph_placement ("fig_graph"): CSR
# shards of constant out-degree 16, a 16-vertex frontier, seed 3, 60
# tasks a way, the median of 3 repeats
FIG_EDGES, FIG_DEG, FIG_SEED, FIG_ITERS, FIG_REPEATS = \
    (1024, 8192, 65536), 16, 3, 60, 3
# streamed large payloads (phase 22): uvm_affine streams of 128 and 1,024
# tiles (8 MiB, and 64 MiB: Context.max_stream_bytes) at set_streaming's
# defaults (256 KiB chunks, window 4), raw and under quant8; the bulk
# ingest of examples/storage_pipeline.py Act 4 (4,096 seeded u32 values x
# 512, 64 KiB chunks, window 4, rle, 8 slots of 256 KiB); a striped peer
# of 2 rings x phase 19's 512 slots of 132 KiB taking 2 x 512 two-tile
# frames; fig_stream at bench_ifunc.py's sizes, 32 messages a cell
STREAM_TILES, STREAM_CODECS = (128, 1024), ("raw", "quant8")
STREAM_CHUNK, STREAM_WINDOW = 256 << 10, 4
BULK_VALUES, BULK_REPEAT, BULK_CHUNK = 4096, 512, 64 << 10
BULK_SLOTS, BULK_SLOT = 8, 256 << 10
STRIPE_SLOTS, STRIPE_SLOT = 512, 132 << 10
FIG_STREAM_SIZES = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
FIG_STREAM_ITERS = 32
# the flow layer (phase 23), examples/storage_pipeline.py at its own
# settings: csd (loopback), dpu_a, dpu_b and agg (RDMA), slots of 256 KiB,
# rng seed 11; Act 1 six batches of 2,048 records (runs of 1-8) kept at
# >= 3e9, dpu_a congested at batch 3 by 6 counter_bump frames; Act 2
# 4,000 edges over 96 vertices in 3 CSR shards, w >= 0.75; Act 4 the bulk
# ingest above through the origin's dispatcher.  The full-size ETL: 32
# batches of 49,152 records, 512 KiB slots, dpu_a congested at batch 16.
# The μVM chain: 512 two-tile chains dpu_a|dpu_b -> agg, 256 KiB slots,
# dpu_a congested halfway.  fig_flow at bench_ifunc.py's settings
FLOW_NODES = (("csd", "loopback"), ("dpu_a", "rdma"), ("dpu_b", "rdma"),
              ("agg", "rdma"))
FLOW_SEED, FLOW_THRESHOLD, FLOW_SLOT = 11, 3_000_000_000, 256 << 10
FLOW_BATCHES, FLOW_CONGEST, FLOW_RECORDS, FLOW_BURST = 6, 3, 2048, 6
FLOW_V, FLOW_SHARDS, FLOW_EDGES, FLOW_WMIN = 96, 3, 4000, 0.75
ETL_BATCHES, ETL_CONGEST, ETL_RECORDS, ETL_SLOT = 32, 16, 49_152, 512 << 10
CHAIN_NODES, CHAIN_N, CHAIN_SLOT, CHAIN_TRACED = \
    ("dpu_a", "dpu_b", "agg"), 512, 256 << 10, 64
FIG_FLOW_STAGES, FIG_FLOW_BYTES, FIG_FLOW_ITERS, FIG_FLOW_SLOT = \
    (3, 5), 32 << 10, 40, 128 << 10

# Published peaks (NVIDIA data sheets; dense, no sparsity): device-memory
# bytes/s, FP32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s.
PEAKS = [("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100", 3.35e12, 67e12, 989e12)]

# the model stack: each model's published config with its kernel selected,
# and the plain path it is held against.  Phase 12 holds these in f32 at
# full width and at most PARITY_LAYERS layers (the script's time limit;
# phase 13 serves them at published depth): Qwen3-30B-A3B at 4 of its 48
# layers, since its 30.5 B parameters are 114 GiB in f32
FLASH, NAIVE = {"attn_impl": "flash"}, {"attn_impl": "naive"}
MODELS = {"smollm_360m": (FLASH, NAIVE),
          "mamba2_780m": ({"ssd_impl": "kernel"}, {"ssd_impl": "xla"}),
          "recurrentgemma_2b": (FLASH, NAIVE),
          "qwen3_moe_30b_a3b": ({**FLASH, "num_layers": 4}, NAIVE),
          "phi3_vision_4_2b": (FLASH, NAIVE),
          "internlm2_1_8b": (FLASH, NAIVE),
          "qwen1_5_4b": (FLASH, NAIVE),
          "minicpm_2b": (FLASH, NAIVE),
          "musicgen_large": (FLASH, NAIVE)}
# the models phase 13 serves in bf16, each at its published width and
# depth with its kernel selected: Qwen3-30B-A3B at all 48 layers (56.87 GiB
# of bf16 parameters), Phi-3-Vision's token path after a seeded prefix of
# its 577 image embeddings
SERVE_MODELS = {"smollm_360m": FLASH, "mamba2_780m": {"ssd_impl": "kernel"},
                "recurrentgemma_2b": FLASH, "qwen3_moe_30b_a3b": FLASH,
                "internlm2_1_8b": FLASH, "qwen1_5_4b": FLASH,
                "minicpm_2b": FLASH, "musicgen_large": FLASH,
                "phi3_vision_4_2b": FLASH}
SERVE_PROMPTS, SERVE_NEW, SERVE_SLOTS, SERVE_CACHE = (1024, 512, 256, 200), \
    16, 4, 2048
# a model with a prefix of external embeddings serves prompts that fill
# these positions with it (Phi-3-Vision: 577 + 1,215 ... 577 + 191): the
# flash path takes a sequence longer than its block (256) only in whole
# blocks, as the reference's does
SERVE_EXT_POSITIONS = (1792, 1280, 1024, 768)
PARITY_B, PARITY_S, PARITY_PREFILL = 4, 256, 240
PARITY_LAYERS = 8
PREFILL_S = 4096
# the kernels' shapes on the serving path: flash [BH, S, hd, window] (15
# SmolLM heads at prompts of 200 and 512 and the 4,096-token prefill; the
# reference's head_dim-128 test shape with a window) and ssd_scan
# [BH, nc, Q, hd, ds] (48 Mamba-2 heads at a 200-token prompt and at 4,096)
FLASH_SHAPES = ((15, 200, 64, 0), (15, 512, 64, 0), (15, 4096, 64, 0),
                (4, 512, 128, 256))
# the forward alone besides (phase 10 adds every shape of phase 13's
# prefills, flash_fwd_shapes, and of the training path, train_flash_shapes):
# Phi-3-Vision's 32 heads at head_dim 96, whose token path phase 12 holds
# in f32; phases 11 and 15 time head_dim 256 (RecurrentGemma's 10 heads,
# MQA repeated, with its window of 2,048) and 96 at the 4,096-token prefill
RG_FLASH_SHAPE = (10, PREFILL_S, 256, 2048)
PHI3_FLASH_SHAPE = (32, PREFILL_S, 96, 0)
PHI3_FLASH_SHAPES = ((32, 512, 96, 0), PHI3_FLASH_SHAPE)
# phase 11 also times head_dim 128 at Qwen1.5-4B's 20 heads and 64 at
# MiniCPM-2B's 36, both at the 4,096-token prefill
WIDE_FLASH_SHAPES = ((20, PREFILL_S, 128, 0), (36, PREFILL_S, 64, 0))
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
# a bf16 backward against its plain twin ``flash_bwd_plain_bf16`` (P and dS
# rounded to bf16 where the kernels round them, f32 sums): elementwise
# against the twin's f32 outputs, at most half a bf16 step of the output
# (under 2^-8 relative) and, where the kernel's P or dS rounds the other
# way from the twin's, one step of that operand (the largest seen: 4.9e-3
# beyond rtol 4e-3, dK at [32, 2,048, 128]); relative L2 against the twin
# rounded to bf16 as the kernels round their outputs (at most 2.7e-4
# seen).  A relative L2's denominator is at least that of a tensor of
# ``TOL_FLASH_BWD``'s atol, so that an output that is zero (dQ and dK at
# S = 1) is held absolutely.
TOL_FLASH_BWD_EMUL = dict(rtol=4e-3, atol=6e-3)
TOL_FLASH_BWD_EMUL_L2 = 1e-3
# the SDPA backward against the kernels in bf16: two bf16 forwards (O
# and LSE of each) feed two backwards; relative L2 of dQ, dK, dV
TOL_SDPA_BWD = 1e-2
# training.  Phase 16 holds each model of PARITY_MODELS in f32 at full
# width, one microbatch, flash against naive: the loss to 1e-5 relative,
# each gradient leaf to 1e-3 relative L2 (summation order over up to 32
# layers).  arch -> (config overrides, batch, positions a row):
# RecurrentGemma-2B at two super-blocks (4 RG-LRU, 2 attn_local) over
# 4,096 positions, so that its window of 2,048 masks; Phi-3-Vision at 4
# layers with its 577 image positions inside 2,048; Qwen3-30B-A3B at 4 of
# 48 layers, at capacity factor E / k (no_drop), where flash and naive
# route and drop alike; InternLM2-1.8B, Qwen1.5-4B, MiniCPM-2B and
# MusicGen-large at 4 layers over phase 17's microbatch of 2 x 2,048 (so
# their flash shapes are the training path's; Qwen1.5-4B's 151,936-row
# embedding and head alone are 3.1 GB in f32).
PARITY_MODELS = {
    "smollm_360m": ({}, 2, 1024),
    "recurrentgemma_2b": ({"num_layers": 6}, 1, 4096),
    "phi3_vision_4_2b": ({"num_layers": 4}, 1, 2048),
    "qwen3_moe_30b_a3b": ({"num_layers": 4}, 2, 1024),
    "internlm2_1_8b": ({"num_layers": 4}, 2, 2048),
    "qwen1_5_4b": ({"num_layers": 4}, 2, 2048),
    "minicpm_2b": ({"num_layers": 4}, 2, 2048),
    "musicgen_large": ({"num_layers": 4}, 2, 2048),
}
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-3
# Phase 17 trains each model of TRAIN_MODELS in bf16 at full width
# (remat block, AdamW with f32 state, the state donated to the step):
# arch -> (config overrides, batch, positions a row, microbatches,
# (warm-up, timed, one-batch) steps).  At published width and depth:
# RecurrentGemma-2B (26 layers, 2.89 B parameters), Phi-3-Vision (32
# layers, its 577 image positions inside each row of 2,048),
# InternLM2-1.8B, Qwen1.5-4B, MiniCPM-2B, MusicGen-large and Mamba-2 780M
# (through ``ssd_impl="xla"``, the reference's training path: ``ssd_scan``
# has no gradient); Qwen3-30B-A3B at 4 of its 48 layers, as in phase 16
# (its state at 48 layers is about 455 GiB).
TRAIN_MODELS = {
    "smollm_360m": ({}, 4, 2048, 2, (1, 3, 5)),
    "recurrentgemma_2b": ({}, 2, 4096, 2, (1, 3, 5)),
    "qwen3_moe_30b_a3b": ({"num_layers": 4}, 4, 2048, 2, (1, 3, 5)),
    "phi3_vision_4_2b": ({}, 4, 2048, 2, (1, 3, 5)),
    "internlm2_1_8b": ({}, 4, 2048, 2, (1, 3, 5)),
    "qwen1_5_4b": ({}, 4, 2048, 2, (1, 3, 5)),
    "minicpm_2b": ({}, 4, 2048, 2, (1, 3, 5)),
    "musicgen_large": ({}, 4, 2048, 2, (1, 3, 5)),
    "mamba2_780m": ({"ssd_impl": "xla"}, 4, 2048, 2, (1, 3, 5)),
}
TRAIN_B, TRAIN_S, TRAIN_MB = TRAIN_MODELS["smollm_360m"][1:4]
# each model's measured peak over its timed steps / the estimate of the
# same step on meta tensors, computed by TRAIN_META_WORKERS processes
# (the card hidden) while the card trains the models before it
TRAIN_PEAK_RATIO = (0.90, 1.10)
TRAIN_META_WORKERS = 3
TRAIN_STATS = {}   # arch -> phase 17's (median step s, idle share)
# the backward's ragged and one-position shapes at head_dim 96 and 256 (the
# training shapes are whole tiles): S = 200 and 130 with a window narrower
# than a tile, S = 2,100 with RecurrentGemma's 2,048, S = 1
BWD_EDGE_SHAPES = ((3, 200, 96, 0), (2, 130, 96, 17), (1, 1, 96, 0),
                   (3, 200, 256, 0), (2, 130, 256, 17), (2, 2100, 256, 2048),
                   (1, 1, 256, 0))
# the disaggregated serving fleet (phase 25): examples/serving_fabric.py's
# 2 prefill + 2 decode peers at SmolLM-360M's published width (bf16, flash,
# seeded weights); 8 prompts of distinct lengths, so every prefill group is
# one sequence, the host's [1, S] (384 is not a multiple of the flash
# block of 256, so 240 stands in), budgets 8 / 16 / 32 in turn; 4 slots and
# cache 2,048 on the host and on each decode peer; KV slabs (80 KiB a
# token) streamed in 1 MiB chunks, 4 in flight; (b) 4 prompts of 512, one
# [4, 512] forward, 8 tokens each
FLEET_PROMPTS = (1024, 768, 512, 256, 240, 200, 128, 64)
FLEET_NEW = (8, 16, 32)
FLEET_SLOTS, FLEET_CACHE = 4, 2048
FLEET_CHUNK, FLEET_WINDOW = 1 << 20, 4
FLEET_GROUP = (4, 512, 8)
# (b): each row of the [4, 512] bf16 prefill against its own [1, 512]
# prefill, every slab entry and the first-token logits by relative L2, at
# the port's bound for two bf16 forwards of one function (TOL_SDPA_BWD)
TOL_FLEET_GROUP = TOL_SDPA_BWD

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


def device_ms(torch, fn, kernel, iters=50, traces=5):
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
          f"torch.profiler recorded no device time for {kernel} in five "
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


@contextlib.contextmanager
def counted_sweeps(mb):
    """Within the block, a list (yielded) of the ``ring_sweep`` launches
    each of the singleton mailbox ``mb``'s sweeps made, for every sweep
    that found a deposit."""
    sweeps = []

    def sweep(*a, **k):
        before = _counted()["ring_sweep"].launches
        ran = mb._deposited > 0
        out = type(mb).sweep(mb, *a, **k)
        if ran:
            sweeps.append(_counted()["ring_sweep"].launches - before)
        return out

    mb.sweep = sweep
    try:
        yield sweeps
    finally:
        del mb.sweep


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


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


def log_card_busy(prof, wall, what, kernels=(), wall_is="untraced"):
    """Log the card's busy time in a torch.profiler trace of one
    generation against the ``wall_is`` ``wall`` seconds of one, and the time
    and launches of each kernel whose name holds one of ``kernels``;
    returns the SMs' idle share, None when the trace holds no device time.
    Device-side records only: the CPU-side op that launched a copy or a
    kernel carries the same device time again; "Activity Buffer Request"
    is the profiler's own.  The records are read from the profiler's raw
    results (``prof.profiler.kineto_results``), each record's device time
    its duration, as ``FunctionEvent.device_time_total`` gives it (0 for
    an asynchronous one): ``prof.events()`` would first build the event
    tree of every CPU-side op, 40-110 s for a traced serving run of
    70,000-230,000 device records on the H100."""
    import torch
    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.name().startswith("Activity Buffer")]
    if not events:
        log(f"{what}: card busy time not measured (torch.profiler recorded "
            f"no device time)")
        return None
    copy_us, kern_us, n_copies, by_name, names = 0.0, 0.0, 0, {}, {}
    mine = {kernel: [] for kernel in kernels}
    for e in events:
        if e.is_async() or e.start_thread_id() != e.end_thread_id():
            us = 0.0
        else:
            us = e.duration_ns() / 1e3
        raw = e.name()
        if raw.startswith(("Memcpy", "Memset")):
            copy_us += us
            n_copies += 1
            continue
        kern_us += us
        if raw not in names:
            names[raw] = torch._C._demangle(raw)
        name = names[raw]
        by_name[name[:48]] = by_name.get(name[:48], 0.0) + us / 1e3
        for kernel in kernels:
            if kernel in name:
                mine[kernel].append(us / 1e3)
    copy_s, kern_s = copy_us / 1e6, kern_us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    idle = 1 - kern_s / wall
    log(f"{what} (torch.profiler, {len(events)} device records): kernels "
        f"{kern_s:.4f} s, so the SMs sit idle {idle:.4f} of the {wall_is} "
        f"{wall:.4f} s; copies {copy_s:.4f} s ({n_copies}); most kernel "
        f"time: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    for kernel, ms in mine.items():
        if ms:
            log(f"  {kernel}: {sum(ms):.2f} ms in {len(ms)} launches, "
                f"{sum(ms) / len(ms):.4f} ms each")
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
    sync(torch, dev)
    reset_counts()
    gen_s = []
    with counted_sweeps(mb) as sweeps:
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
    sync(torch, dev)
    reset_counts()
    gen_s = []
    with counted_sweeps(mb) as sweeps:
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


# ------------------------------------------------------------ placement


def graph_edges(np):
    """``examples/graph_analysis.py``'s weighted digraph, (u, v, w) in its
    order: a random arborescence (every vertex reachable from vertex 0),
    2,500 edges whose sources lie in shard 0's range (the dense hot
    region) and 300 with sources elsewhere."""
    V, span = GRAPH_V, GRAPH_V // GRAPH_SHARDS
    rng = np.random.default_rng(GRAPH_SEED)
    edges = []
    for v in range(1, V):
        u = int(rng.integers(0, v))
        edges.append((u, v, float(rng.uniform(0.1, 1.0))))
    for lo, hi, n in ((0, span, 2500), (span, V, 300)):
        for _ in range(n):
            u = int(rng.integers(lo, hi))
            v = int(rng.integers(0, V))
            edges.append((u, v, float(rng.uniform(0.1, 1.0))))
    return edges


def bellman_ford(np, edges):
    """The example's reference distances from ``GRAPH_SRC``, in f32."""
    ref = np.full(GRAPH_V, np.inf, np.float32)
    ref[GRAPH_SRC] = 0.0
    for _ in range(GRAPH_V):
        changed = False
        for u, v, w in edges:
            if ref[u] + w < ref[v]:
                ref[v] = ref[u] + w
                changed = True
        if not changed:
            break
    return ref


def graph_workload(np, torch, dev, *, shards=SHARDS, dev_slots=SLOTS_FULL,
                   lib_dir=None, kill=False):
    """The port's ``examples/graph_analysis.py``: single-source shortest paths from ``GRAPH_SRC`` by relax rounds over
    the example's 4 CSR shards on ``rdma_a``, ``rdma_b`` (``RdmaFabric``)
    and ``csd`` (``LoopbackFabric``), shard 3 replicated at the source.
    Each round sends the frontier indicator tile to each of the ``shards``
    shards of ``gpu`` (``DeviceMeshFabric(shards, shift=0)``, ``dev_slots``
    slots a shard, the adjacency column-sharded into its externals) as
    ``graph_degree`` μVM futures, keyed by the shard ``slot_coords`` gives
    the next send; at round ``GRAPH_CONGEST``, ``GRAPH_BURST``
    ``counter_bump`` frames congest the owner of shard 0 and
    ``PlacementEngine.rebalance`` moves a shard; then each shard's relax
    goes where ``decide`` says (``graph_relax`` migrated to the owner,
    ``graph_fetch`` then a local relax, or a local relax on a replica) and
    the updates are min-merged.  ``shards=0`` runs it with no device peer.
    The PYBC verbs load from ``lib_dir`` (the port's library by default).

    ``kill=True`` is the example's ``--kill-peer``: an
    ``ElasticController`` (riding ``Dispatcher.pollers``) heartbeats the
    host peers under a ``GRAPH_DEADLINE`` deadline with a
    ``FaultInjector``; once ``GRAPH_KILL``'s cache is warm and it holds a
    relax of the round, one more relax goes to it and it dies; after
    the deadline one ``progress`` fires the recovery inside the poll
    (failed relaxes re-run locally, shards reassigned and reseeded by an
    ``on_death`` callback); a round later it is re-admitted with the warm
    manifest and takes shard 1 back; after the rounds a relax to it
    carries the re-admission generation.  Every launch is counted over
    the rounds, the counts zeroed just before them.  Returns a dict of
    what the run showed."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.core import frame as FR
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.runtime import ElasticController, FleetState
    from repro_torch.tasks import (DataDirectory, Decision, LOCAL_SITE,
                                   PlacementEngine, TaskRuntime)
    from repro_torch.tasks.future import TaskTimeout
    from repro_torch.tasks.graph import (decode_updates, local_relax,
                                         pack_csr_shard)
    from repro_torch.transport import (DeviceMeshFabric, Dispatcher,
                                       FaultInjector, LoopbackFabric,
                                       ProgressEngine, RdmaFabric,
                                       TransportError)

    V, span = GRAPH_V, GRAPH_V // GRAPH_SHARDS
    edges = graph_edges(np)
    by_src = {s: [] for s in range(GRAPH_SHARDS)}
    for u, v, w in edges:
        by_src[u // span].append((u, v, w))
    shard_bytes = {s: pack_csr_shard(s * span, span, es)
                   for s, es in by_src.items()}
    A = np.zeros((V, V), np.float32)           # adjacency indicator
    for u, v, _ in edges:
        A[u, v] = 1.0

    source = Context("source", device=dev)
    d = Dispatcher(source, ProgressEngine(flush_threshold=8,
                                          inflight_window="trailer"))
    rt = TaskRuntime(source, d, default_timeout=120.0)
    relax_h = register_ifunc(source, "graph_relax", lib_dir)
    fetch_h = register_ifunc(source, "graph_fetch", lib_dir)
    degree_h = register_ifunc(source, "graph_degree")
    bump_h = register_ifunc(source, "counter_bump", lib_dir)
    hosts = [name for name, _ in GRAPH_HOSTS]
    stores, fabrics, ctxs = {}, {}, {}
    for name, kind in GRAPH_HOSTS:
        stores[name] = {"shards": {}}
        fabrics[name] = RdmaFabric() if kind == "rdma" else LoopbackFabric()
        ctxs[name] = Context(name, link_mode="remote", device=dev)
        rt.add_peer(name, fabrics[name], ctxs[name],
                    n_slots=GRAPH_SLOTS, slot_size=GRAPH_SLOT,
                    target_args=stores[name])
    A_dev = np.zeros((shards, 1, T, T), np.float32)
    for s in range(shards):                    # shard s owns these columns
        cols = slice(s * (V // shards), (s + 1) * (V // shards))
        A_dev[s, 0, :, cols] = A[:, cols]
    if shards:
        rt.add_peer("gpu", DeviceMeshFabric(shards, shift=0, device=dev),
                    None, n_slots=dev_slots, slot_size=GRAPH_DEV_SLOT,
                    prog=deserialize_uvm(degree_h.lib.code), n_tiles=1,
                    externals=torch.from_numpy(A_dev).to(dev))
    directory = DataDirectory()
    for s, owner in GRAPH_OWNERS.items():
        directory.register(s, owner, len(shard_bytes[s]))
        stores[owner]["shards"][s] = shard_bytes[s]
    directory.add_replica(3, LOCAL_SITE)
    local_shards = {3: shard_bytes[3]}
    engine = PlacementEngine(directory, d, steal_depth=3)
    el = None
    if kill:
        # hb_beat ifuncs on a control ring per host peer, stepped from
        # inside every Dispatcher.poll: the rounds never call the
        # controller directly
        fleet = FleetState(hosts, heartbeat_deadline=GRAPH_DEADLINE)
        injector = FaultInjector()
        ec = ElasticController(rt, fleet, placement=engine,
                               injector=injector, lib_dir=lib_dir)
        for name in hosts:
            ec.watch(name, fabrics[name], ctxs[name])
        el = {"ec": ec, "killed": None, "readmitted": None, "recovered": 0,
              "recovered_at": []}

        def reseed_shards(dead):
            # ownership already moved (deterministic round-robin); the
            # source re-ships its canonical shard bytes to each new owner
            for sid in directory.shards:
                owner = directory.owner(sid)
                if owner in stores and sid not in stores[owner]["shards"]:
                    stores[owner]["shards"][sid] = shard_bytes[sid]
        ec.on_death.append(reseed_shards)
        ec.on_death.append(
            lambda dead: el["recovered_at"].append(time.perf_counter()))

    if shards:
        lane = d.peers["gpu"].rings[0]
        mb = lane.mailbox
    dist = np.full(V, np.inf, np.float32)
    dist[GRAPH_SRC] = 0.0
    frontier = {GRAPH_SRC: 0.0}
    decisions = {"migrate": 0, "fetch": 0, "local": 0}
    placements, degrees, hot_log, moves, congestion = [], [], [], [], None
    rounds = 0
    sync(torch, dev)
    reset_counts()
    with (counted_sweeps(mb) if shards
          else contextlib.nullcontext([])) as sweeps:
        t0 = time.perf_counter()
        while frontier and rounds < GRAPH_MAX_ROUNDS:
            rounds += 1
            if kill and el["killed"] and not el["readmitted"]:
                # a round after the death the restarted peer rejoins with
                # a fresh context, a generation fence and the one-frame
                # warm manifest, and takes shard 1 back
                fabrics[GRAPH_KILL] = RdmaFabric()
                ctxs[GRAPH_KILL] = Context(GRAPH_KILL, link_mode="remote",
                                           device=dev)
                stores[GRAPH_KILL] = {"shards": {}}
                re_peer = ec.readmit(GRAPH_KILL, fabrics[GRAPH_KILL],
                                     ctxs[GRAPH_KILL],
                                     target_args=stores[GRAPH_KILL],
                                     n_slots=GRAPH_SLOTS,
                                     slot_size=GRAPH_SLOT)
                el["fence_gen"] = re_peer.fence
                check(re_peer.fence == fleet.generation > 0,
                      f"re-admission fence {re_peer.fence}, fleet "
                      f"generation {fleet.generation}")
                directory.move(1, GRAPH_KILL)
                stores[GRAPH_KILL]["shards"][1] = shard_bytes[1]
                el["readmitted"] = rounds
                el["manifest"] = list(ec.members[GRAPH_KILL].manifest)
            # 1) device tier: frontier-expansion counts of each column shard
            f_ind = np.zeros(V, np.float32)
            for v in frontier:
                f_ind[v] = 1.0
            hot = {}
            if shards:
                tile = np.broadcast_to(f_ind, (T, T)).reshape(1, T, T).copy()
                futs = []
                for _ in range(shards):
                    futs.append((mb.slot_coords(lane.tail)[0],
                                 rt.submit("gpu", degree_h, tile)))
                got = [(s, f.result().cpu().numpy()) for s, f in futs]
                expansion = sum(c[0, 0] for _, c in got)
                hot = {s: float(expansion[s * span:(s + 1) * span].sum())
                       for s in range(GRAPH_SHARDS)}
                degrees.append((f_ind, got))
            hot_log.append(hot)
            # 2) congestion: unconsumed background frames pile up at the
            #    dense shard's owner, and its queue depth diverges
            if rounds == GRAPH_CONGEST:
                owner = directory.owner(0)
                for _ in range(GRAPH_BURST):
                    d.send_ifunc(owner, bump_h, b"bg")
                depth = engine.queue_depth(owner)
                moved = engine.rebalance(eligible=hosts)
                for sid, frm, to in moved:
                    shipped = rt.submit(frm, fetch_h, {"sid": sid}).result()
                    stores[to]["shards"][sid] = bytes(shipped)
                    moves.append((sid, frm, to))
                congestion = (rounds, owner, depth, moved)
            # 3) placement of each shard's relax: migrate / fetch / local
            by_shard = {s: [] for s in range(GRAPH_SHARDS)}
            for v, dv in frontier.items():
                by_shard[v // span].append((v, float(dv)))
            futs, placed = [], []
            for sid, fr in by_shard.items():
                if not fr:
                    continue
                p = engine.decide(sid, relax_h, arg_bytes=8 + 8 * len(fr))
                decisions[p.decision.value] += 1
                placed.append((p.decision.value, sid, p.peer, dict(p.costs),
                               p.stolen))
                if p.decision is Decision.MIGRATE:
                    futs.append((sid, rt.submit(p.peer, relax_h,
                                                {"sid": sid, "frontier": fr})))
                    continue
                if p.decision is Decision.FETCH:
                    shipped = rt.submit(p.peer, fetch_h, {"sid": sid})
                    local_shards[sid] = bytes(shipped.result())
                    directory.add_replica(sid, LOCAL_SITE)
                futs.append((sid, rt.run_local(local_relax, local_shards[sid],
                                               fr)))
            placements.append(placed)
            # 3.5) the failure: once the victim's cache is warm and it holds
            #      a relax of this round, it dies with one more in flight;
            #      the deadline inside the poll detects it, not this loop
            if (kill and not el["killed"] and d.peers[GRAPH_KILL].cached
                    and any(getattr(f, "peer", None) == GRAPH_KILL
                            for _, f in futs)):
                doomed_sid = next(s for s in sorted(directory.shards)
                                  if directory.owner(s) == GRAPH_KILL)
                doomed = rt.submit(GRAPH_KILL, relax_h,
                                   {"sid": doomed_sid,
                                    "frontier": by_shard[doomed_sid]})
                futs.append((doomed_sid, doomed))
                injector.kill_peer(GRAPH_KILL)
                t_kill = time.perf_counter()
                rt.flush()
                time.sleep(fleet.deadline + 0.05)
                rt.progress()       # poll crank: the deadline fires here
                el["killed"] = rounds
                el["kill_to_recovery_s"] = el["recovered_at"][0] - t_kill \
                    if el["recovered_at"] else None
                check(GRAPH_KILL not in d.peers
                      and fleet.alive() == sorted(set(hosts) - {GRAPH_KILL})
                      and directory.owner(doomed_sid) != GRAPH_KILL
                      and doomed.done(),
                      f"{GRAPH_KILL} killed at round {rounds}: still a peer "
                      f"{GRAPH_KILL in d.peers}, alive {fleet.alive()}, "
                      f"s{doomed_sid} at {directory.owner(doomed_sid)}, "
                      f"doomed relax done {doomed.done()}")
                el["doomed"] = (doomed_sid, directory.owner(doomed_sid),
                                fleet.generation)
            # 4) min-merge the updates into the next frontier
            new_frontier = {}
            for sid, fut in futs:
                try:
                    upd = fut.result()
                except (TransportError, TaskTimeout):
                    if not kill:
                        raise
                    # the relax died with its peer: re-run it from the
                    # source's canonical shard bytes (a min-merge, so a
                    # duplicate is idempotent)
                    el["recovered"] += 1
                    upd = local_relax(shard_bytes[sid], by_shard[sid])
                if isinstance(upd, (bytes, bytearray)):
                    upd = decode_updates(upd)
                for v, dv in upd.items():
                    if dv < dist[v] - 1e-7:
                        dist[v] = dv
                        new_frontier[v] = dv
            frontier = new_frontier
            directory.decay()
        rt.drain()                             # absorb the background burst
        sync(torch, dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    if kill and el["readmitted"]:
        re_peer = d.peers[GRAPH_KILL]
        el.update(stats=dict(ec.stats), fence=re_peer.fence,
                  rounds_stats=dict(re_peer.stats),
                  generation=fleet.generation, alive=fleet.alive(),
                  injector=dict(injector.stats))
        post = rt.submit(GRAPH_KILL, relax_h, {"sid": 1, "frontier": []})
        el["post_gen"] = FR.corr_gen(post.corr_id)  # the new epoch
        rt.flush()
        rt.drain()
        el["post_updates"] = decode_updates(post.result())
        el["peer_stats"] = dict(re_peer.stats)
    return {"rt": rt, "engine": engine, "directory": directory,
            "edges": edges, "shard_bytes": shard_bytes, "A_dev": A_dev,
            "dist": dist, "rounds": rounds, "wall": wall,
            "decisions": decisions, "placements": placements,
            "moves": moves, "congestion": congestion,
            "engine_stats": dict(engine.stats),
            "peer_stats": d.per_peer_stats(), "degrees": degrees,
            "hot": hot_log, "orphan_replies": rt.stats["orphan_replies"],
            "pending": rt.pending(), "counts": counts, "sweeps": sweeps,
            "elastic": el}


def graph_gates(np, res):
    """The example's checks (``examples/graph_analysis.py:331-386``) on a
    ``graph_workload`` run: ``dist`` finite and within TOL_GRAPH of
    Bellman-Ford; no orphan reply and nothing pending; each round's
    device futures, one on each shard, holding ``f_ind @ A_dev[d, 0]``
    exactly in every row (counts of 0/1 products, at most 128: exact in
    f32).  Without a kill: migrate, fetch and local each decided and the
    round-2 congestion moved a shard (GRAPH_OK).  With one: one death and
    one re-admission, at least one future failed by the recovery and
    re-run locally, beats folded, the re-admitted peer fenced at its
    generation with no NACK and serving replies, and a relax after the
    rounds carrying that generation with no update (ELASTIC_OK).  Fails
    with every failure named."""
    failures = []
    el = res.get("elastic")
    dist, ref = res["dist"], bellman_ford(np, res["edges"])
    if not np.isfinite(dist).all():
        failures.append(f"graph not fully relaxed: "
                        f"{int((~np.isfinite(dist)).sum())} vertices at inf")
    elif not np.allclose(dist, ref, **TOL_GRAPH):
        failures.append(f"dist off Bellman-Ford by "
                        f"{float(np.abs(dist - ref).max()):.3g}")
    if el is None and not all(res["decisions"].values()):
        failures.append(f"placement mix degenerate: {res['decisions']}")
    if el is None and (not res["moves"]
                       or res["congestion"][0] != GRAPH_CONGEST):
        failures.append(f"congestion never triggered an ownership "
                        f"rebalance: {res['congestion']}")
    if el is not None:
        failures += elastic_failures(el)
    if res["orphan_replies"] or res["pending"]:
        failures.append(f"{res['orphan_replies']} orphan replies, "
                        f"{res['pending']} futures pending")
    A_dev = res["A_dev"]
    for r, (f_ind, got) in enumerate(res["degrees"]):
        if sorted(s for s, _ in got) != list(range(len(A_dev))):
            failures.append(f"round {r + 1}: device futures on shards "
                            f"{[s for s, _ in got]}")
        for s, counts in got:
            want = f_ind @ A_dev[s, 0]
            if counts.shape != (1, T, T) or not (counts == want).all():
                failures.append(f"round {r + 1} shard {s}: degree counts "
                                f"off f_ind @ A by "
                                f"{float(np.abs(counts - want).max()):.3g}")
    word = "GRAPH" if el is None else "ELASTIC"
    check(not failures, f"{word}_FAILED: " + "; ".join(failures))
    log(f"{word}_OK")


def elastic_failures(el):
    """``--kill-peer``'s checks (``examples/graph_analysis.py:365-386``)."""
    if not (el["killed"] and el["readmitted"]):
        return [f"killed at round {el['killed']}, re-admitted at round "
                f"{el['readmitted']}"]
    st, ps, out = el["stats"], el["peer_stats"], []
    if st["deaths"] != 1 or st["readmissions"] != 1:
        out.append(f"deaths {st['deaths']}, readmissions "
                   f"{st['readmissions']}, want 1 and 1")
    if st["futures_failed"] < 1 or el["recovered"] < 1:
        out.append(f"{st['futures_failed']} futures failed, "
                   f"{el['recovered']} relaxes re-run, want >= 1 each")
    if st["beats_folded"] <= 0:
        out.append("no heartbeat folded")
    if el["fence"] != el["fence_gen"]:
        out.append(f"fence {el['fence']} != re-admission generation "
                   f"{el['fence_gen']}")
    # the example asserts replies >= 1 before its post-readmit relax
    # (``graph_analysis.py:374``); the placement keeps shard 1 local after
    # the re-admission, in the reference as here, so the gate is on the
    # relax it posts next: SLIM on the restored cache, no NACK, a reply
    if el["rounds_stats"]["nacks"] or ps["nacks"] or ps["replies"] < 1 \
            or ps["slim_sent"] < 1:
        out.append(f"re-admitted peer: {ps['nacks']} NACKs (warm manifest "
                   f"wants 0), {ps['replies']} replies, {ps['slim_sent']} "
                   f"SLIM frames")
    if el["post_gen"] != el["fence_gen"] or el["post_updates"] != {}:
        out.append(f"post-readmit relax: corr generation {el['post_gen']} "
                   f"(want {el['fence_gen']}), updates {el['post_updates']}")
    return out


def fig_graph(np, torch, dev, *, sizes=FIG_EDGES, iters=FIG_ITERS,
              repeats=FIG_REPEATS, lib_dir=None):
    """``benchmarks/bench_ifunc.py::bench_graph_placement`` on the port:
    for each shard of ``sizes`` edges (constant out-degree ``FIG_DEG``),
    one relax task on a 16-vertex frontier three ways through a loopback
    owner on a ``dev`` target with the bench's slot size: ``migrate``
    (``graph_relax`` to the owner, SLIM after the warm-up), ``fetch``
    (``graph_fetch`` pulls the whole shard back, the relax runs at the
    source) and ``local`` (the relax on the fetched replica).  The
    warm-ups are held against ``local_relax`` and the packed bytes.
    Returns {packed bytes: {way: median µs a task over ``repeats`` runs
    of ``iters`` tasks, the three ways in turns}}."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.tasks import TaskRuntime
    from repro_torch.tasks.graph import (decode_updates, local_relax,
                                         pack_csr_shard)
    from repro_torch.transport import LoopbackFabric, ProgressEngine

    rng = np.random.default_rng(FIG_SEED)
    frontier = [(int(i), 0.5) for i in range(16)]
    rows = {}
    for ne in sizes:
        nv = ne // FIG_DEG
        edges = [(u, int(rng.integers(0, 1 << 20)),
                  float(rng.uniform(0.1, 1)))
                 for u in range(nv) for _ in range(FIG_DEG)]
        packed = pack_csr_shard(0, nv, edges)
        src = Context("src", device=dev)
        rt = TaskRuntime(src, engine=ProgressEngine(flush_threshold=8),
                         default_timeout=60.0)
        rt.add_peer("owner", LoopbackFabric(),
                    Context("owner", link_mode="remote", device=dev),
                    n_slots=8, slot_size=max(64 << 10, len(packed) + 4096),
                    target_args={"shards": {0: packed}})
        h_relax = register_ifunc(src, "graph_relax", lib_dir)
        h_fetch = register_ifunc(src, "graph_fetch", lib_dir)
        task = {"sid": 0, "frontier": frontier}
        got = decode_updates(rt.submit("owner", h_relax, task).result())
        want = {v: float(np.float32(x))
                for v, x in local_relax(packed, frontier).items()}
        check(got == want, f"fig_graph {ne} edges: the migrated relax "
                           f"differs from local_relax")
        blob = rt.submit("owner", h_fetch, {"sid": 0}).result()
        check(bytes(blob) == packed, f"fig_graph {ne} edges: the fetched "
                                     f"shard differs from the packed one")

        def migrate():
            rt.submit("owner", h_relax, task).result()

        def fetch():
            local_relax(rt.submit("owner", h_fetch, {"sid": 0}).result(),
                        frontier)

        ways = {"migrate": migrate, "fetch": fetch,
                "local": lambda: local_relax(blob, frontier)}
        spent = {w: [] for w in ways}
        for _ in range(repeats):
            for w, fn in ways.items():
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                spent[w].append((time.perf_counter() - t0) / iters * 1e6)
        check(rt.pending() == 0, f"fig_graph {ne} edges: futures pending")
        rows[len(packed)] = {w: statistics.median(v)
                             for w, v in spent.items()}
    return rows


def host_degree(np, torch, dev, A_tile, tile):
    """One ``graph_degree`` μVM future to a host target on ``dev`` (a
    loopback peer with the adjacency tile resident as external "A" and a
    reply ring): the frame links at the target and runs through one
    ``ifunc_vm`` launch.  Returns (the result as numpy, the launches
    counted around the future)."""
    from repro_torch.core import Context, register_ifunc
    from repro_torch.tasks import TaskRuntime
    from repro_torch.transport import (Dispatcher, LoopbackFabric,
                                       ProgressEngine)

    source = Context("degree-source", device=dev)
    rt = TaskRuntime(source, Dispatcher(source, ProgressEngine(
        inflight_window="trailer")), default_timeout=60.0)
    h = register_ifunc(source, "graph_degree")
    rt.add_peer("host", LoopbackFabric(),
                Context("host", link_mode="remote", device=dev),
                n_slots=2, slot_size=GRAPH_DEV_SLOT,
                target_args={"externals": {
                    "A": torch.from_numpy(A_tile).to(dev)}})
    sync(torch, dev)
    reset_counts()
    out = rt.submit("host", h, tile).result()
    sync(torch, dev)
    counts = read_counts()
    check(rt.pending() == 0, "host graph_degree: future pending")
    return np.asarray(out), counts


def phase_graph(np, torch, dev, smi):
    """Phase 21: placement and the graph workload.  (a) ``graph_workload``
    at full width, ``GRAPH_RUNS`` whole runs each from a fresh runtime and
    directory, each passing ``graph_gates`` and traced by torch.profiler
    (device activity only) for the SMs' idle share; its launches must be
    ``ring_sweep_smem_kernel`` once a device sweep and nothing else.  (b)
    ``fig_graph`` at the bench's settings, migrate under fetch at the
    largest shard.  (c) ``host_degree`` on the card, one
    ``ifunc_vm_smem_kernel`` launch, equal to the device lane's result for
    the same frontier and shard.  All under ``no_plain``.  Returns the
    device sweeps and the host ``ifunc_vm`` launches."""
    from torch.profiler import ProfilerActivity, profile

    n_sweeps = 0
    with no_plain():
        for run in range(GRAPH_RUNS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = graph_workload(np, torch, dev)
            graph_gates(np, res)
            counts, sweeps = res["counts"], res["sweeps"]
            check(sweeps and set(sweeps) == {1}
                  and counts["ring_sweep"] == len(sweeps) and all(
                      v == 0 for k, v in counts.items()
                      if k != "ring_sweep"),
                  f"graph run {run}: launches {counts} in {len(sweeps)} "
                  f"device sweeps ({sorted(set(sweeps))} each), want "
                  f"ring_sweep once a sweep and nothing else")
            n_sweeps += len(sweeps)
            n_deg = sum(len(got) for _, got in res["degrees"])
            wall, rounds = res["wall"], res["rounds"]
            log(f"graph run {run} on {smi}: {rounds} rounds in {wall:.4f} s "
                f"({rounds / wall:.2f} rounds/s), {n_deg} degree futures "
                f"({n_deg / wall:.1f} futures/s), relax tasks "
                f"{res['decisions']}, engine {res['engine_stats']}, moves "
                f"{res['moves']} (round {res['congestion'][0]}: "
                f"{res['congestion'][1]} at depth {res['congestion'][2]}), "
                f"{len(sweeps)} device sweeps, launches {counts}")
            for r, placed in enumerate(res["placements"]):
                log(f"  round {r + 1}: " + ", ".join(
                    f"s{sid} {how}@{peer}{' (stolen)' if stolen else ''}"
                    for how, sid, peer, _, stolen in placed)
                    + "; hot " + ", ".join(
                        f"s{s}:{v:.0f}" for s, v in res["hot"][r].items()))
            log_card_busy(prof, wall, f"graph run {run} on {smi} (traced, "
                          f"device activity only)",
                          ("ring_sweep_smem_kernel",))
            res["rt"].dispatcher.print_stats()

        rows = fig_graph(np, torch, dev)
        for nb, us in rows.items():
            log(f"fig_graph {nb} B on {smi}, µs a task, median of "
                f"{FIG_REPEATS} x {FIG_ITERS}: migrate {us['migrate']:.2f}, "
                f"fetch {us['fetch']:.2f}, local {us['local']:.2f} "
                f"(fetch / migrate {us['fetch'] / us['migrate']:.2f}x)")
        big = rows[max(rows)]
        check(big["migrate"] < big["fetch"],
              f"fig_graph: migrate {big['migrate']:.2f} µs not under fetch "
              f"{big['fetch']:.2f} µs at the largest shard ({max(rows)} B)")

        f_ind, got = res["degrees"][1]           # round 2: the widest
        s = max(range(len(got)), key=lambda i: got[i][1].sum())
        shard, lane_out = got[s]
        out, counts = host_degree(np, torch, dev, res["A_dev"][shard, 0],
                                  np.broadcast_to(f_ind, (T, T))
                                  .reshape(1, T, T).copy())
        check(out.shape == lane_out.shape and (out == lane_out).all(),
              f"host graph_degree differs from the device lane's shard "
              f"{shard} by {float(np.abs(out - lane_out).max()):.3g}")
        check(counts["ifunc_vm"] == 1 and all(
            v == 0 for k, v in counts.items() if k != "ifunc_vm"),
            f"host graph_degree launched {counts}, want ifunc_vm once")
        log(f"host graph_degree on {smi}: one ifunc_vm launch, equal to the "
            f"device lane's shard {shard} ({int(lane_out[0, 0].sum())} "
            f"frontier edges)")
    return {"sweeps": n_sweeps, "host_launches": counts["ifunc_vm"]}


# ------------------------------------------------ streamed large payloads


def stream_slot(lib, chunk, window):
    """A slot that holds a stream frame of ``window`` cells of ``chunk``
    bytes with its FULL fallback (the code section restored), rounded up
    to 4 KiB."""
    from repro_torch.core import frame as F

    n = (F.HEADER_LEN + len(lib.code) + F.TRAILER_LEN
         + F.stream_payload_len(window, chunk + F.CHUNK_OVERHEAD))
    return (n + 4095) & ~4095


def stream_peer(pkg, W, *, codec, chunk, window, lib_dir=None, obs=None):
    """Phase 22 (a)'s topology through ``pkg`` (``core``, ``transport`` and
    the context keywords ``kw``; the port's on the card, either package on
    the CPU in the tests): a source ``Dispatcher`` with streaming on at
    ``chunk`` and ``window`` and one ``RdmaFabric`` peer ``rdma`` of two
    slots that each hold a stream frame of that geometry, its wire codec
    ``codec``, on a target with ``W`` resident, its link cache warmed by
    one FULL single-tile frame (so the streams that follow open SLIM).
    Returns (dispatcher, ``uvm_affine`` handle)."""
    import numpy as np

    core, X = pkg.core, pkg.transport
    src = core.Context("stream-source", lib_dir=lib_dir, **pkg.kw)
    d = X.Dispatcher(src, X.ProgressEngine(flush_threshold=64), obs=obs)
    h = core.register_ifunc(src, "uvm_affine", lib_dir)
    d.set_streaming(True, chunk_bytes=chunk, window=window)
    d.add_peer("rdma", X.RdmaFabric(),
               core.Context("stream-target", lib_dir=lib_dir,
                            link_mode="remote", **pkg.kw),
               n_slots=2, slot_size=stream_slot(h.lib, chunk, window),
               codec=codec, target_args={"externals": {"W": W}})
    one = core.ifunc_msg_create(h, np.zeros((1, T, T), np.float32))
    check(d.send("rdma", one), "warm-up send refused")
    d.drain()
    check(d.peers["rdma"].stats["delivered"] == 1, "warm-up not delivered")
    return d, h


def capture_runs(ctx):
    """Every fn ``ctx`` has linked records the payload each of its runs
    gets, in the list returned: for a stream, a view of the assembly
    buffer its one run reads (no copy; the buffer lives on in the view)."""
    seen = []
    entries = ctx.link_cache.entries
    for key, fn in list(entries.items()):
        def run(payload, size, targs, _fn=fn):
            seen.append(payload)
            return _fn(payload, size, targs)
        entries[key] = run
    return seen


def stream_one(d, h, x, peer="rdma"):
    """Stream the tiles ``x`` (numpy, sent as a view: no copy at the
    source) to ``peer`` with ``send_stream`` and drain; fails unless it
    took one stream of ``ceil(bytes / chunk)`` chunks, delivered once, and
    left no receive or pump state.  Returns the result."""
    p = d.peers[peer]
    before = dict(p.stats)
    chunk = d._stream_chunk
    check(d.send_stream(peer, h, x), f"send_stream to {peer} refused")
    d.drain()
    n_chunks = -(-x.nbytes // chunk)
    got = {k: p.stats[k] - before[k] for k in ("streams", "stream_chunks",
                                               "delivered", "rejected",
                                               "nacks")}
    check(got == {"streams": 1, "stream_chunks": n_chunks, "delivered": 1,
                  "rejected": 0, "nacks": 0},
          f"stream of {x.nbytes} B to {peer}: {got}, want one stream of "
          f"{n_chunks} chunks delivered")
    check(not any(r.mailbox.streams for r in p.rings)
          and not d._active_streams and not any(r.inflight for r in p.rings),
          f"stream to {peer} left receive or pump state")
    return p.target_args["result"]


def assembly_err(np, x, assembled, codec, chunk):
    """Hold the payload a stream's run got against the tiles sent: bit for
    bit when raw; under quant8 chunk 0 bit for bit and every other chunk
    within half a quantization step (``max|chunk| / 254``, the codec's
    rounding bound) plus ``max|chunk| * 2^-20`` (the scale's and the
    product's f32 rounding) of the raw values.  Returns the largest
    |difference| past chunk 0."""
    got = np.frombuffer(assembled, np.float32)
    raw = x.reshape(-1)
    check(got.size == raw.size, f"assembled {got.size} floats, sent "
                                f"{raw.size}")
    if codec == "raw":
        check(np.array_equal(got, raw), "raw stream: assembly differs from "
                                        "the payload")
        return 0.0
    per = chunk // 4
    check(np.array_equal(got[:per], raw[:per]),
          f"{codec}: chunk 0 not bit for bit")
    worst = 0.0
    for s in range(per, raw.size, per):
        g, r = got[s:s + per], raw[s:s + per]
        err = float(np.abs(g - r).max())
        bound = float(np.abs(r).max()) * (1 / 254 + 2 ** -20)
        check(err <= bound, f"{codec}: chunk {s // per} off by {err:.3g}, "
                            f"bound {bound:.3g}")
        worst = max(worst, err)
    return worst


def bulk_ingest(pkg, np, *, values=BULK_VALUES, repeat=BULK_REPEAT,
                chunk=BULK_CHUNK, window=STREAM_WINDOW, n_slots=BULK_SLOTS,
                slot=BULK_SLOT, seed=22, lib_dir=None, obs=None):
    """``examples/storage_pipeline.py`` Act 4 without the flow engine,
    through ``pkg``: ``np.repeat`` of ``values`` seeded u32 values x
    ``repeat`` streamed by ``send_ifunc``'s auto-route (threshold and
    chunk ``chunk``, window ``window``) to ``agg``, an ``RdmaFabric`` peer
    of ``n_slots`` x ``slot`` under the ``rle`` wire codec, where
    ``host_aggregate`` reduces each chunk as it lands.  The example's
    gates: the result equals numpy's count, sum, min and max, one stream
    of ``ceil(bytes / chunk)`` chunks, fewer than half the payload's bytes
    on the wire, no receive state left; STREAM_OK.  Returns what it
    measured."""
    core, X = pkg.core, pkg.transport
    src = core.Context("bulk-source", lib_dir=lib_dir, **pkg.kw)
    d = X.Dispatcher(src, X.ProgressEngine(flush_threshold=64), obs=obs)
    d.add_peer("agg", X.RdmaFabric(),
               core.Context("agg", lib_dir=lib_dir, link_mode="remote",
                            **pkg.kw),
               n_slots=n_slots, slot_size=slot, codec="rle", target_args={})
    d.set_streaming(True, chunk_bytes=chunk, window=window, threshold=chunk)
    h = core.register_ifunc(src, "host_aggregate", lib_dir)
    check(h.lib.streaming, "host_aggregate is not streaming-aware")
    rng = np.random.default_rng(seed)
    records = np.repeat(rng.integers(0, 1 << 32, size=values,
                                     dtype=np.uint32), repeat)
    payload = records.tobytes()
    bulk = d.peers["agg"]
    wire0 = sum(r.channel.ep.stats["bytes"] for r in bulk.rings)
    t0 = time.perf_counter()
    check(d.send_ifunc("agg", h, payload), "bulk send refused")
    d.drain()
    secs = time.perf_counter() - t0
    return {"d": d, **bulk_gates(bulk, records, wire0, secs, chunk)}


def bulk_gates(bulk, records, wire0, secs, chunk):
    """``storage_pipeline.py`` Act 4's gates on the peer ``bulk`` after
    the u32 ``records`` streamed to it (``wire0`` its channels' bytes
    before): the result equals numpy's count, sum, min and max, one
    stream of ``ceil(bytes / chunk)`` chunks, fewer than half the
    payload's bytes on the wire, no receive state left; STREAM_OK."""
    nbytes = records.nbytes
    got = bulk.target_args["result"]
    want = {"count": int(records.size), "sum": int(records.sum()),
            "min": int(records.min()), "max": int(records.max())}
    check(got == want, f"bulk ingest: {got}, want {want}")
    n_chunks = -(-nbytes // chunk)
    check(bulk.stats["streams"] == 1 and bulk.stats["stream_chunks"]
          == n_chunks, f"bulk ingest: {bulk.stats}, want 1 stream of "
                       f"{n_chunks} chunks")
    wire = sum(r.channel.ep.stats["bytes"] for r in bulk.rings) - wire0
    check(wire < nbytes // 2,
          f"RLE wire codec never engaged: {wire} B on the wire for "
          f"{nbytes} B of runs")
    check(not any(r.mailbox.streams for r in bulk.rings),
          "bulk ingest left receive state")
    log(f"  bulk ingest: {nbytes} B streamed in {n_chunks} chunks, "
        f"{wire} B on the wire ({nbytes / wire:.1f}x rle), reduced "
        f"on arrival at agg in {secs:.4f} s")
    log("STREAM_OK")
    return {"secs": secs, "wire": wire, "bytes": nbytes,
            "chunks": n_chunks, "result": got}


def striped_fifo(pkg, np, W, xs, *, n_slots=STRIPE_SLOTS, slot=STRIPE_SLOT,
                 evict_at=None, lib_dir=None, obs=None):
    """Phase 22 (c) through ``pkg``, the shape of
    ``tests/test_device_agg.py::test_striping_fifo_under_resends``: a
    ``Dispatcher`` coalescing up to 4 records, one ``RdmaFabric`` peer
    ``striped`` of 2 rings x ``n_slots`` x ``slot`` with ``stripe=True`` on
    a target with ``W`` resident; ``uvm_affine`` and ``counter_bump`` each
    delivered FULL once; ``counter_bump``'s digest evicted; then the
    two-tile frames ``xs`` in order, one ``counter_bump`` frame (which
    NACKs) sent before frame ``evict_at``, each send retried after a
    drain while backpressured.  Gates: nacks == 1, resent == 1, the
    counter bumped once more, and one result a frame (``results`` in
    ``target_args``, in execution order).  Returns what it measured."""
    core, X = pkg.core, pkg.transport
    src = core.Context("stripe-source", lib_dir=lib_dir, **pkg.kw)
    d = X.Dispatcher(src, X.ProgressEngine(flush_threshold=64), obs=obs)
    d.set_coalescing(True, max_subs=4)
    d.add_peer("striped", X.RdmaFabric(),
               core.Context("striped", lib_dir=lib_dir, link_mode="remote",
                            **pkg.kw),
               n_slots=n_slots, slot_size=slot, rings=2, stripe=True,
               target_args={"externals": {"W": W}, "count": 0})
    peer = d.peers["striped"]
    h = core.register_ifunc(src, "uvm_affine", lib_dir)
    h_cnt = core.register_ifunc(src, "counter_bump", lib_dir)
    for hh, arg in ((h, xs[0]), (h_cnt, b"\x01")):   # warm: FULL once each
        check(d.send_ifunc("striped", hh, arg), "warm-up send refused")
        d.drain()
    peer.target_args["results"] = []
    base = peer.target_args["count"]
    check(peer.target_ctx.link_cache.evict("counter_bump", h_cnt.digest),
          "counter_bump not cached")
    evict_at = len(xs) // 2 if evict_at is None else evict_at
    retries = 0
    t0 = time.perf_counter()
    for i, x in enumerate(xs):
        if i == evict_at:
            while not d.send_ifunc("striped", h_cnt, b"x"):
                retries += 1
                d.drain()
        while not d.send_ifunc("striped", h, x):
            retries += 1
            d.drain()
    rounds = 200
    while (peer.resend or any(q.subs for q in peer.coalesce.values())
           or peer.target_args["count"] < base + 1) and rounds:
        d.flush_coalesced("striped")
        d.drain()
        rounds -= 1
    d.drain()
    secs = time.perf_counter() - t0
    got = peer.target_args["results"]
    check(len(got) == len(xs), f"striped: {len(got)} results for "
                               f"{len(xs)} frames")
    check(peer.target_args["count"] == base + 1,
          f"striped: counter bumped {peer.target_args['count'] - base} "
          f"times, want once")
    check(peer.stats["nacks"] == 1 and peer.stats["resent"] == 1,
          f"striped: nacks {peer.stats['nacks']}, resent "
          f"{peer.stats['resent']}, want one each")
    check(peer.stripe_rx >= peer.stats["sent"] - len(peer.resend) - 2,
          f"striped: consume rotation at {peer.stripe_rx} for "
          f"{peer.stats['sent']} sent")
    return {"d": d, "secs": secs, "retries": retries, "results": got}


def fig_stream_cells(pkg, size, *, lib_dir=None):
    """``benchmarks/bench_ifunc.py::bench_stream``'s four cells at one
    payload size through ``pkg``, at the bare API: ``stream`` (a warm SLIM
    FLAG_STREAM frame posted as one gathered put from a pre-sealed template,
    the payload's chunks views of it, ``stream_sink`` run per chunk on
    arrival), ``sf`` and ``sf_full`` (the payload copied into one SLIM or
    FULL frame, one put) and ``am`` (the AM baseline).  Returns (the cells'
    functions, each timing ``n`` messages, and a check of what they
    delivered)."""
    core = pkg.core
    F = core.frame
    payload = b"x" * size
    pol = core.SecurityPolicy(max_frame_len=1 << 26)
    kw = dict(lib_dir=lib_dir, **pkg.kw)

    src = core.Context("src_stream", **kw)
    dst2 = core.Context("dst_stream", link_mode="remote", policy=pol, **kw)
    h = core.register_ifunc(src, "stream_sink", lib_dir)
    lib = h.lib
    chunk = min(size, 256 << 10)
    n_chunks = -(-size // chunk)
    cell = chunk + F.CHUNK_OVERHEAD
    plen = F.stream_payload_len(n_chunks, cell)
    slot_size = 1 << (F.HEADER_LEN + len(lib.code) + plen
                      + F.TRAILER_LEN).bit_length()
    fab = pkg.transport.RdmaFabric()
    mb = fab.open_mailbox(dst2, 2, slot_size)
    sep = fab.connect(src, mb).ep
    raddr, rkey = mb.slot_addr(0), mb.region.rkey
    key0, view0 = mb.slot_coords(0), mb.slot_view(0)
    targs_stream: dict = {}
    pv = memoryview(payload)

    def build(slim):
        sflags = F.SFLAG_EXEC_ON_ARRIVAL if lib.streaming else 0
        desc = F.StreamDesc(size, n_chunks, chunk, n_chunks, 0, sflags, cell,
                            1)
        code = b"" if slim else lib.code
        slab = bytearray(slot_size)
        flen = F.seal_frame(slab, lib.name, code, lib.kind, plen,
                            digest=lib.code_digest, slim=slim,
                            flags=F.FLAG_STREAM)
        F.pack_stream_desc(slab, F.HEADER_LEN + len(code), desc)
        prefix = F.HEADER_LEN + len(code) + F.STREAM_DESC_LEN
        segs, run_s = [], 0
        for seq in range(n_chunks):
            coff = prefix + desc.cell_off(seq)
            data = pv[seq * chunk:(seq + 1) * chunk]
            run_e = coff + F.CHUNK_HDR_LEN
            F.pack_chunk_into(slab, coff, run_e + len(data), seq, len(data),
                              len(data), 0, nonce=desc.nonce)
            segs.append((run_s, memoryview(slab)[run_s:run_e]))
            segs.append((run_e, data))
            run_s = run_e + len(data)
        segs.append((run_s, memoryview(slab)[run_s:flen]))
        return slab, segs

    _, full_segs = build(False)               # FULL: link and confirm
    sep.putv_nbi(full_segs, raddr, rkey, withhold_tail=F.TRAILER_LEN)
    sep.flush()
    check(core.poll_ifunc(dst2, view0, None, targs_stream, streams=mb.streams,
                          stream_key=key0) == core.Status.OK
          and targs_stream["result"] == size, "fig_stream: FULL stream")
    slab, segs = build(True)                  # the warm SLIM template
    wr = sep.prepare_putv(segs, raddr, rkey, withhold_tail=F.TRAILER_LEN)

    def stream(n):
        t0 = time.perf_counter()
        for _ in range(n):
            wr.post()
            sep.flush()
            while core.poll_ifunc(dst2, view0, None, targs_stream,
                                  streams=mb.streams,
                                  stream_key=key0) != core.Status.OK:
                pass
        return time.perf_counter() - t0

    s2 = core.Context("src", **kw)
    dst = core.Context("dst", link_mode="remote", policy=pol, **kw)
    ep = s2.nic.connect(dst.nic)
    h2 = core.register_ifunc(s2, "stream_sink", lib_dir)
    region = dst.nic.mem_map(1 << (size + 8192).bit_length())
    targs_sf: dict = {}
    core.ifunc_msg_send_nbix(ep, core.ifunc_msg_create(h2, payload),
                             region.base, region.rkey)
    check(core.poll_ifunc(dst, region.view(), None, targs_sf)
          == core.Status.OK and targs_sf["result"] == size, "fig_stream: sf")

    def sf(n, slim):
        t0 = time.perf_counter()
        for _ in range(n):
            msg = core.ifunc_msg_create(h2, payload, slim=slim)
            core.ifunc_msg_send_nbix(ep, msg, region.base, region.rkey)
            while core.poll_ifunc(dst, region.view(), None,
                                  targs_sf) != core.Status.OK:
                pass
        return time.perf_counter() - t0

    a, b = core.AmContext("a"), core.AmContext("b")
    got = []
    b.register(1, lambda p, n, t: got.append(n))
    ab = core.AmEndpoint(a, b)

    def am(n):
        t0 = time.perf_counter()
        for _ in range(n):
            ab.send(1, payload)
            while b.progress() == 0:
                pass
        return time.perf_counter() - t0

    def delivered(n_stream):
        check(dst2.stats["rejected"] == 0 and dst2.stats["nacks"] == 0
              and dst2.stats["streams"] == 1 + n_stream
              and targs_stream["result"] == size
              and targs_sf["result"] == size and got and got[-1] == size,
              f"fig_stream {size} B: {dst2.stats}")

    cells = {"stream": stream, "sf": lambda n: sf(n, True),
             "sf_full": lambda n: sf(n, False), "am": am}
    return cells, delivered, (dst2, mb, targs_stream)


def fig_stream(sizes=FIG_STREAM_SIZES, n_iters=FIG_STREAM_ITERS):
    """``bench_stream`` on the port: per size, the four cells timed in
    interleaved chunks of ``max(2, min(16, 2 MiB / size))`` messages, the
    garbage collector parked, µs a message the min over chunks.  Returns
    {size: {cell: µs}}."""
    import gc
    import types

    from repro_torch import core, transport

    pkg = types.SimpleNamespace(core=core, transport=transport, kw={})
    rows = {}
    for size in sizes:
        cells, delivered, _ = fig_stream_cells(pkg, size)
        per = max(2, min(16, (2 << 20) // size))
        for fn in cells.values():
            fn(per)                                # warm-up round
        times = {k: [] for k in cells}
        rounds = max(n_iters // per, 8)
        gc.collect()
        gc.disable()
        try:
            for _ in range(rounds):
                for k, fn in cells.items():
                    times[k].append(fn(per))
        finally:
            gc.enable()
        delivered(per * (1 + rounds))
        rows[size] = {k: min(v) / per * 1e6 for k, v in times.items()}
    return rows


def phase_streams(np, torch, dev, smi, mp_rates):
    """Phase 22: streamed large payloads on the port.  (a) ``uvm_affine``
    streams of ``STREAM_TILES`` tiles sent with ``send_stream`` at
    ``set_streaming``'s defaults to a ``device="cuda"`` target, raw and
    under ``quant8``: each one stream of ``ceil(bytes / chunk)`` chunks,
    one ``ifunc_vm`` launch and nothing else; the raw result bit for bit
    ``uvm_execute``'s on the same tiles, the quant8 result within rtol
    1e-4, atol 1e-5 of ``ifunc_vm_plain`` over the assembled tiles, the
    assembly within the codec's bound (``assembly_err``); host timers
    around the chunk posts (and quant8's encode), the target's sweep,
    ``run_uvm``'s copy and H2D and the launch; ``ifunc_vm``'s device time
    at each size; the SMs' idle share over one traced stream a size.  (b)
    ``bulk_ingest`` at the example's size.  (c) ``striped_fifo`` at
    phase 19's host geometry, 2 x 512 frames: the results in send order,
    one ``ifunc_vm`` launch a frame, frames/s beside phase 19's one RDMA
    peer.  (d) ``fig_stream``: µs a message of each cell (host timings,
    logged, not gated).  (a) to (c) run under ``no_plain``.  Returns the
    ``ifunc_vm`` launches of (a) and (c)."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, transport
    from repro_torch.core import api as A
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain, vm_plan

    pkg = types.SimpleNamespace(core=core, transport=transport,
                                kw={"device": dev})
    rng = np.random.default_rng(22)
    W = torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                         .astype(np.float32)).to(dev)
    spent: dict = {}

    def timed(what, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[what] = spent.get(what, 0.0) + time.perf_counter() - t
        return wrapper

    launches = 0
    runs = []
    saved = (A._host_copy, A._to_device, K.uvm_execute)
    with no_plain():
        A._host_copy = timed("host copy", A._host_copy)
        A._to_device = timed("H2D", A._to_device)
        K.uvm_execute = timed("launch", K.uvm_execute)
        try:
            for codec in STREAM_CODECS:
                d, h = stream_peer(pkg, W, codec=codec, chunk=STREAM_CHUNK,
                                   window=STREAM_WINDOW)
                peer = d.peers["rdma"]
                seen = capture_runs(peer.target_ctx)
                d.engine.post_chunk = timed("chunk posts",
                                            d.engine.post_chunk)
                d._encode_chunk = timed("encode", d._encode_chunk)
                mb = peer.rings[0].mailbox
                mb.sweep = timed("sweep", mb.sweep)
                for n in STREAM_TILES:
                    x = rng.standard_normal((n, T, T)).astype(np.float32)
                    sync(torch, dev)
                    spent.clear()
                    reset_counts()
                    t0 = time.perf_counter()
                    out = stream_one(d, h, x)
                    sync(torch, dev)
                    secs = time.perf_counter() - t0
                    counts = read_counts()
                    check(counts["ifunc_vm"] == 1 and all(
                        v == 0 for k, v in counts.items() if k != "ifunc_vm"),
                        f"{codec} stream of {n} tiles launched {counts}, "
                        f"want ifunc_vm once")
                    launches += 1
                    runs.append((codec, n, x, out, seen.pop(), secs,
                                 dict(spent), h))
                    check(not seen, "a stream ran its fn more than once")
                del mb.sweep
        finally:
            A._host_copy, A._to_device, K.uvm_execute = saved

    prog = deserialize_uvm(runs[0][7].lib.code)
    kernel = vm_plan(prog).kernel
    for codec, n, x, out, assembled, secs, parts, _ in runs:
        err = assembly_err(np, x, assembled, codec, STREAM_CHUNK)
        tiles = torch.from_numpy(np.frombuffer(assembled, np.float32)
                                 .reshape(n, T, T).copy()).to(dev)
        check(out.shape == (n, T, T) and bool(torch.isfinite(out).all()),
              f"{codec} stream of {n} tiles: result {tuple(out.shape)} or "
              f"not finite")
        if codec == "raw":
            want = K.uvm_execute(prog, torch.from_numpy(x).to(dev), [W],
                                 device=dev)
            check(torch.equal(out, want), f"raw stream of {n} tiles differs "
                                          f"from uvm_execute")
            vs = "bit for bit uvm_execute's"
        else:
            plain = ifunc_vm_plain(prog, tiles, W[None])
            check(torch.allclose(out, plain, **TOL_PATH),
                  f"{codec} stream of {n} tiles vs ifunc_vm_plain: "
                  f"{(out - plain).abs().max().item():.3g}")
            vs = (f"max |err| {(out - plain).abs().max().item():.3g} against "
                  f"ifunc_vm_plain over the assembly (assembly off the "
                  f"payload by at most {err:.3g})")
        post = parts.get("chunk posts", 0.0)
        sweep = parts.get("sweep", 0.0)
        run_s = parts.get("host copy", 0.0) + parts.get("H2D", 0.0) + \
            parts.get("launch", 0.0)
        log(f"{codec} stream of {n} tiles ({x.nbytes / 2 ** 20:.0f} MiB) on "
            f"{smi}: {secs:.4f} s, {x.nbytes / secs / 1e9:.3f} GB/s, "
            f"{-(-x.nbytes // STREAM_CHUNK)} chunks, one {kernel} launch; "
            f"{vs}; host timers: chunk posts {post:.4f} s, chunk encode "
            f"{parts.get('encode', 0.0):.4f} s, target sweeps "
            f"{sweep:.4f} s = assembly and polls {sweep - run_s:.4f} + "
            f"run_uvm (host copy {parts.get('host copy', 0.0):.4f}, H2D "
            f"{parts.get('H2D', 0.0):.4f}, launch "
            f"{parts.get('launch', 0.0):.4f})")

    # ifunc_vm alone at each size, and one traced raw stream a size
    d, h = stream_peer(pkg, W, codec="raw", chunk=STREAM_CHUNK,
                       window=STREAM_WINDOW)
    for n in STREAM_TILES:
        x = rng.standard_normal((n, T, T)).astype(np.float32)
        tiles = torch.from_numpy(x).to(dev)
        ms = device_ms(torch, lambda: ifunc_vm(prog, tiles, W[None]), kernel,
                       10)
        wall = [r[5] for r in runs if r[0] == "raw" and r[1] == n][0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stream_one(d, h, x)
            sync(torch, dev)
        log(f"{kernel} over {n} tiles on {smi}: "
            + ("device time not measured" if ms is None
               else f"{ms:.4f} ms device time")
            + f", of a {wall:.4f} s stream")
        log_card_busy(prof, wall, f"card over one raw stream of {n} tiles",
                      (kernel,))

    # (b) and (c)
    bulk_ingest(pkg, np)
    xs = rng.standard_normal((2 * STRIPE_SLOTS, NT, T, T)).astype(np.float32)
    sync(torch, dev)
    with no_plain():
        reset_counts()
        st = striped_fifo(pkg, np, W, xs)
        sync(torch, dev)
        counts = read_counts()
    check(counts["ifunc_vm"] == len(xs) + 1 and all(
        v == 0 for k, v in counts.items() if k != "ifunc_vm"),
        f"striped run launched {counts}, want {len(xs) + 1} ifunc_vm (one "
        f"a frame, the FULL warm-up's included)")
    launches += counts["ifunc_vm"]
    got = torch.stack([r for r in st["results"]])
    want = torch.relu(torch.from_numpy(xs).to(dev) @ W)
    check(torch.allclose(got, want, **TOL_PATH),
          f"striped results out of order or off: max |err| "
          f"{(got - want).abs().max().item():.3g}")
    p = st["d"].peers["striped"]
    log(f"striped peer (2 rings x {STRIPE_SLOTS} slots of "
        f"{STRIPE_SLOT >> 10} KiB) on {smi}: {len(xs)} frames in send order "
        f"in {st['secs']:.4f} s = {len(xs) / st['secs']:.1f} frames/s "
        f"(phase 19's one RDMA peer alone {mp_rates['rdma']:.1f} frames/s), "
        f"{st['retries']} backpressured sends, nacks {p.stats['nacks']}, "
        f"resent {p.stats['resent']}, {counts['ifunc_vm']} {kernel} "
        f"launches")

    # (d) fig_stream: host timings, logged
    for size, us in fig_stream().items():
        log(f"fig_stream {size} B on {smi}, µs a message (min of chunks): "
            + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
            + f"; stream <= sf_full {us['stream'] <= us['sf_full']}, "
              f"<= am {us['stream'] <= us['am']}"
            + (f", <= sf {us['stream'] <= us['sf']}" if size >= 256 << 10
               else ""))
    return {"launches": launches}


# ------------------------------------------------------------ the flow layer


def flow_engine(pkg, *, nodes=FLOW_NODES, slot=FLOW_SLOT, obs=None,
                lib_dir=None):
    """A ``FlowEngine`` through ``pkg`` (its ``core``, ``transport``,
    ``flow`` and the context keywords ``kw``) over an origin context
    ``host`` and one node a (name, fabric kind) of ``nodes``, each with
    slots of ``slot`` bytes; ``add_node`` builds each node's context on the
    origin's device."""
    core, X = pkg.core, pkg.transport
    eng = pkg.flow.FlowEngine(core.Context("host", lib_dir=lib_dir,
                                           **pkg.kw),
                              default_timeout=60.0, obs=obs)
    for name, kind in nodes:
        eng.add_node(name, X.RdmaFabric() if kind == "rdma"
                     else X.LoopbackFabric(), slot_size=slot)
    return eng


def make_blob(np, rng, nrecords):
    """``storage_pipeline.py``'s ``make_blob``: RLE-compressed u32 records
    (``nrecords // 4`` runs of 1 to 8) and the expanded records, from the
    same draws of ``rng`` and with the same bytes."""
    vals = rng.integers(0, 1 << 32, size=nrecords // 4, dtype=np.uint32)
    counts = rng.integers(1, 9, size=vals.size, dtype=np.uint32)
    runs = np.stack([vals, counts], axis=1).astype("<u4")
    return (struct.pack("<I", vals.size) + runs.tobytes(),
            np.repeat(vals, counts))


def etl_flow(pkg):
    """Act 1's chain: decompress at the CSD, filter at the cheaper DPU,
    aggregate at ``agg``."""
    return (pkg.flow.Flow("etl")
            .stage("csd_decompress", at="csd")
            .then("dpu_filter", at=["dpu_a", "dpu_b"],
                  bind={"mode": "kw", "key": "data",
                        "static": {"threshold": FLOW_THRESHOLD}},
                  est_bytes=64 << 10)
            .then("host_aggregate", at="agg"))


def affine_flow(pkg):
    """Phase 23 (d)'s chain: ``uvm_affine`` at the cheaper DPU, then
    ``uvm_affine`` at ``agg``, each with its node's resident W."""
    return (pkg.flow.Flow("affine")
            .stage("uvm_affine", at=["dpu_a", "dpu_b"])
            .then("uvm_affine", at="agg"))


def congest(pkg, node, peer, n=FLOW_BURST):
    """``n`` unconsumed ``counter_bump`` frames from ``node``'s dispatcher
    to ``peer`` (trailers withheld until a flush), so the hop pricer's
    queue term steers the next pick around ``peer``; returns the queue
    depth the pricer sees."""
    bump = pkg.core.register_ifunc(node.ctx, "counter_bump")
    for _ in range(n):
        check(node.dispatcher.send_ifunc(peer, bump, b"bg"),
              f"congestion frame to {peer} refused")
    return node.pricer.queue_depth(peer)


def etl_batches(pkg, np, eng, rng, *, batches=FLOW_BATCHES,
                congest_at=FLOW_CONGEST, records=FLOW_RECORDS):
    """Act 1: one ``etl_flow`` chain a batch of ``make_blob(records)``,
    ``dpu_a`` congested from ``csd`` before batch ``congest_at``; each
    result must equal numpy's count, sum, min and max of the kept records,
    both DPUs picked, SLIM forwards after the warm-up.  Returns [(the DPU
    picked, the result, the records expanded)] a batch."""
    rows = []
    for batch in range(batches):
        if batch == congest_at:
            depth = congest(pkg, eng.nodes["csd"], "dpu_a")
            log(f"  batch {batch}: congested dpu_a (queue depth {depth})")
        blob, recs = make_blob(np, rng, records)
        fut = eng.submit(etl_flow(pkg), blob)
        pick = eng._chains[fut.corr_id]["entries"][1].peer
        got = fut.result()
        kept = recs[recs >= FLOW_THRESHOLD]
        want = {"count": int(kept.size), "sum": int(kept.sum()),
                "min": int(kept.min()) if kept.size else 0,
                "max": int(kept.max()) if kept.size else 0}
        check(got == want, f"etl batch {batch}: {got}, want {want}")
        rows.append((pick, got, int(recs.size)))
    eng.drain()
    picks = {p for p, _, _ in rows}
    check(picks == {"dpu_a", "dpu_b"},
          f"hop pricing never steered around congestion: picks {picks}")
    slim = sum(p.stats["slim_sent"] for node in eng.nodes.values()
               for p in node.dispatcher.peers.values())
    check(slim > 0, "no SLIM forwards: the cached fast path never engaged")
    return rows


def scatter_count(pkg, np, eng, rng):
    """Act 2: ``FLOW_EDGES`` seeded edges over ``FLOW_V`` vertices in
    ``FLOW_SHARDS`` CSR shards at csd, dpu_a and dpu_b; ``graph_count``
    scattered to the owners, ``flow_reduce`` gathering at ``agg``.  The
    total must equal the direct count, with the branches buffered and
    reduced at ``agg``.  Returns the total."""
    V, R = FLOW_V, FLOW_V // FLOW_SHARDS
    edges = [(int(rng.integers(0, V)), int(rng.integers(0, V)),
              float(rng.uniform(0.0, 1.0))) for _ in range(FLOW_EDGES)]
    owners = [name for name, _ in FLOW_NODES[:FLOW_SHARDS]]
    for s, owner in enumerate(owners):
        shard = [(u, v, w) for u, v, w in edges if u // R == s]
        eng.nodes[owner].target_args.setdefault("shards", {})[s] = \
            pkg.graph.pack_csr_shard(s * R, R, shard)
    query = (pkg.flow.Flow("edge-count")
             .scatter("graph_count", at=owners,
                      binds=[{"mode": "static",
                              "static": {"sid": s, "wmin": FLOW_WMIN}}
                             for s in range(FLOW_SHARDS)])
             .gather("flow_reduce", at="agg"))
    total = eng.submit(query, None).result()
    want = sum(1 for _, _, w in edges if w >= FLOW_WMIN)
    check(total == want, f"edge count {total}, want {want}")
    agg = eng.nodes["agg"].stats
    check(agg["gather_reduced"] >= 1
          and agg["gather_buffered"] >= FLOW_SHARDS,
          f"gather at agg: {agg}")
    log(f"  analytics: {total} edges with w >= {FLOW_WMIN} across "
        f"{FLOW_SHARDS} shards (reduced at agg: {agg['gather_buffered']} "
        f"branch arrivals, {agg['gather_reduced']} reductions)")
    return total


def short_circuit(pkg, np, eng, rng):
    """Act 3: a chain probing a shard that does not exist dies at its
    second hop; the error names ``graph_count@dpu_a`` and ``agg`` never
    runs.  Returns the ``RemoteExecutionError``."""
    bad = (pkg.flow.Flow("bad-probe")
           .stage("csd_decompress", at="csd")
           .then("graph_count", at="dpu_a",
                 bind={"mode": "static", "static": {"sid": 99, "wmin": 0.0}})
           .then("host_aggregate", at="agg"))
    execd = eng.nodes["agg"].ctx.stats["executed"]
    fut = eng.submit(bad, make_blob(np, rng, 64)[0])
    try:
        fut.result()
    except pkg.tasks.RemoteExecutionError as e:
        err = e
    else:
        raise SmokeError("the bad chain did not fail")
    check(err.hop == "graph_count@dpu_a", f"short-circuit hop {err.hop}")
    check(eng.nodes["agg"].ctx.stats["executed"] == execd,
          "the aggregate stage ran after the short-circuit")
    log(f"  short-circuit: chain died at {err.hop} ({err.remote_type}); "
        f"aggregate stage never ran")
    return err


def flow_bulk(pkg, np, eng, rng):
    """Act 4: the bulk ingest through the origin's own dispatcher, a new
    lane to ``agg`` under ``rle`` with streaming on; ``bulk_gates``.
    Returns what it measured and the lane."""
    host, agg = eng.origin, eng.nodes["agg"]
    bulk = host.dispatcher.add_peer(
        "agg", agg.fabric, agg.ctx, n_slots=agg.n_slots,
        slot_size=agg.slot_size, target_args=agg.target_args, codec="rle")
    host.dispatcher.set_streaming(True, chunk_bytes=BULK_CHUNK,
                                  window=STREAM_WINDOW, threshold=BULK_CHUNK)
    h = pkg.core.register_ifunc(host.ctx, "host_aggregate")
    check(h.lib.streaming, "host_aggregate is not streaming-aware")
    records = np.repeat(rng.integers(0, 1 << 32, size=BULK_VALUES,
                                     dtype=np.uint32), BULK_REPEAT)
    wire0 = sum(r.channel.ep.stats["bytes"] for r in bulk.rings)
    t0 = time.perf_counter()
    check(host.dispatcher.send_ifunc("agg", h, records.tobytes()),
          "bulk send refused")
    host.dispatcher.drain()
    eng.drain()
    secs = time.perf_counter() - t0
    return {"peer": bulk, **bulk_gates(bulk, records, wire0, secs,
                                       BULK_CHUNK)}


def storage_pipeline(pkg, np, trace_dir, *, lib_dir=None):
    """``examples/storage_pipeline.py`` through ``pkg``: its topology
    (``flow_engine`` under ``Obs(trace=True)``), one ``rng`` of seed 11
    drawn in its order, Acts 1-4 and its gates.  FLOW_OK: nothing pending,
    no orphan reply.  OBS_OK: a ``flow`` span ``ifunc@peer`` for each
    stage run (3 a batch, a branch a shard, the reduce, Act 3's two), each
    on that peer's actor; one ``chain`` span a submitted flow; none open;
    a ``chunk:`` span a chunk of Act 4; the Chrome export (to
    ``trace_dir``) valid JSON.  Returns what it measured."""
    obs = pkg.obs.Obs("storage_pipeline", trace=True)
    eng = flow_engine(pkg, obs=obs, lib_dir=lib_dir)
    rng = np.random.default_rng(FLOW_SEED)
    t0 = time.perf_counter()
    rows = etl_batches(pkg, np, eng, rng)
    etl_s = time.perf_counter() - t0
    for b, (pick, got, n) in enumerate(rows):
        log(f"  batch {b}: {n} records -> {got['count']} kept (filter @ "
            f"{pick}), sum verified")
    total = scatter_count(pkg, np, eng, rng)
    err = short_circuit(pkg, np, eng, rng)
    bulk = flow_bulk(pkg, np, eng, rng)
    eng.drain()
    check(eng.pending() == 0 and eng.stats["orphan_replies"] == 0,
          f"flows left pending or orphaned: {eng.stats}")
    host = eng.origin.dispatcher.stats
    log(f"  host sent {host['sent']} frames for {eng.stats['submitted']} "
        f"flows ({eng.stats['completed']} completed, {eng.stats['errors']} "
        f"failed)")
    for node in eng.nodes.values():
        log("   ", node.summary())
    log("FLOW_OK")

    doc = obs.tracer.export_chrome(trace_dir / "storage_trace.json")
    with open(trace_dir / "storage_trace.json") as f:
        check(json.load(f)["traceEvents"] == doc["traceEvents"]
              and doc["traceEvents"], "empty or unreadable trace export")
    flow_spans = obs.tracer.spans(cat="flow")
    chain_spans = obs.tracer.spans(cat="chain")
    names = {s.name for s in flow_spans}
    want_spans = 3 * FLOW_BATCHES + FLOW_SHARDS + 1 + 2
    check(len(flow_spans) == want_spans,
          f"{len(flow_spans)} flow stage spans, want {want_spans}")
    for want in ("csd_decompress@csd", "host_aggregate@agg",
                 "flow_reduce@agg", "dpu_filter@dpu_a", "dpu_filter@dpu_b",
                 "graph_count@dpu_a"):
        check(want in names, f"no {want} span: {sorted(names)}")
    check(all(s.actor == s.name.split("@", 1)[1] for s in flow_spans),
          "a stage span is not on the lane of the peer that ran it")
    check(len(chain_spans) == eng.stats["submitted"],
          f"{len(chain_spans)} chain spans for {eng.stats['submitted']} "
          f"flows")
    check(obs.tracer.open_count() == 0,
          f"open spans: {[s.name for s in obs.tracer.open_spans()][:8]}")
    chunks = [s for s in obs.tracer.spans(cat="stream")
              if s.name.startswith("chunk:")]
    check(len(chunks) >= bulk["chunks"],
          f"{len(chunks)} chunk spans for {bulk['chunks']} chunks")
    log(f"  trace: {len(doc['traceEvents'])} events, {len(flow_spans)} flow "
        f"stage spans, {len(chain_spans)} chains, {len(chunks)} stream "
        f"chunks")
    log("OBS_OK")
    return {"eng": eng, "obs": obs, "rows": rows, "total": total,
            "err": err, "bulk": bulk, "etl_s": etl_s}


def flow_timers(eng, spent):
    """Wrap the host steps of ``eng``'s chains in timers that add their
    seconds to ``spent``: ``submit``, each node's forward sends
    (``send@node``) and polls (``poll@node``, holding the stage fns and
    forwards it runs), each stage's fn as it links (``fn name@node``),
    and the reply's ``encode`` and ``decode``.  Returns an undo."""
    from repro_torch.tasks import wire

    def timed(what, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[what] = spent.get(what, 0.0) + time.perf_counter() - t
        return wrapper

    saved = (wire.encode, wire.decode)
    wire.encode = timed("encode", wire.encode)
    wire.decode = timed("decode", wire.decode)
    eng.submit = timed("submit", eng.submit)
    shadowed = [(eng, "submit")]        # instance attributes over methods
    for name, node in eng.nodes.items():
        d, cache = node.dispatcher, node.ctx.link_cache
        d.send_ifunc = timed(f"send@{name}", d.send_ifunc)
        d.poll = timed(f"poll@{name}", d.poll)
        insert = cache.insert

        def linked(lname, digest, fn, _node=name, _insert=insert):
            return _insert(lname, digest, timed(f"fn {lname}@{_node}", fn))
        cache.insert = linked
        for key, fn in list(cache.entries.items()):
            cache.entries[key] = timed(f"fn {key[0]}@{name}", fn)
        shadowed += [(d, "send_ifunc"), (d, "poll"), (cache, "insert")]

    def restore():
        wire.encode, wire.decode = saved
        for obj, attr in shadowed:
            delattr(obj, attr)
    return restore


def timer_line(spent):
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        spent.items(), key=lambda kv: -kv[1]))


def chain_engine(pkg, Ws, *, slot=CHAIN_SLOT, lib_dir=None):
    """Phase 23 (d)'s topology through ``pkg``: ``flow_engine`` over the
    RDMA nodes ``CHAIN_NODES`` with slots of ``slot`` bytes, each node's W
    (``Ws[name]``) resident in its ``target_args["externals"]``."""
    eng = flow_engine(pkg, nodes=tuple((n, "rdma") for n in CHAIN_NODES),
                      slot=slot, lib_dir=lib_dir)
    for name in CHAIN_NODES:
        eng.nodes[name].target_args["externals"] = {"W": Ws[name]}
    return eng


def uvm_chains(pkg, eng, xs, *, congest_at=None):
    """``affine_flow`` chains on ``chain_engine``'s ``eng``: each payload
    of ``xs`` submitted and its result taken in turn, ``dpu_a`` congested
    from the origin before chain ``congest_at``.  Returns (the DPU picked
    a chain, the results)."""
    flow = affine_flow(pkg)
    picks, outs = [], []
    for i, x in enumerate(xs):
        if i == congest_at:
            congest(pkg, eng.origin, "dpu_a")
        fut = eng.submit(flow, x)
        picks.append(eng._chains[fut.corr_id]["entries"][0].peer)
        outs.append(fut.result())
    eng.drain()
    return picks, outs


def fig_flow(pkg, *, stages=FIG_FLOW_STAGES, nbytes=FIG_FLOW_BYTES,
             iters=FIG_FLOW_ITERS, lib_dir=None):
    """``bench_flow_chain`` ("fig_flow") through ``pkg``: an N-stage
    ``flow_xform`` chain of ``FlowEngine`` against the same N stages as
    ``TaskRuntime`` round-trips, at the same peers (RDMA and loopback
    alternating, slots of ``FIG_FLOW_SLOT``), each arm warmed by one run
    and then timed over ``iters``, every result checked.  Returns {N:
    {"chain": µs, "roundtrip": µs}}."""
    core, X = pkg.core, pkg.transport
    blob = bytes(range(256)) * (nbytes // 256)
    rows = {}
    for n in stages:
        peers = [f"hop{i}" for i in range(n)]
        fabrics = [X.RdmaFabric() if i % 2 == 0 else X.LoopbackFabric()
                   for i in range(n)]
        expect = blob if n % 2 == 0 else blob[::-1]
        eng = pkg.flow.FlowEngine(core.Context("host", lib_dir=lib_dir,
                                               **pkg.kw),
                                  default_timeout=60.0)
        for p, fab in zip(peers, fabrics):
            eng.add_node(p, fab, slot_size=FIG_FLOW_SLOT)
        flow = pkg.flow.Flow(f"chain{n}")
        for p in peers:
            flow.stage("flow_xform", at=p)
        check(eng.submit(flow, blob).result() == expect, "chain warm-up")
        t0 = time.perf_counter()
        for _ in range(iters):
            check(eng.submit(flow, blob).result() == expect, "chain result")
        chain = (time.perf_counter() - t0) / iters * 1e6
        rt = pkg.tasks.TaskRuntime(
            core.Context("host-rt", lib_dir=lib_dir, **pkg.kw),
            engine=X.ProgressEngine(flush_threshold=8,
                                    inflight_window="trailer"),
            default_timeout=60.0)
        for p, fab in zip(peers, fabrics):
            rt.add_peer(p, fab, core.Context(p, lib_dir=lib_dir, **pkg.kw),
                        n_slots=8, slot_size=FIG_FLOW_SLOT, target_args={})
        h = core.register_ifunc(rt.ctx, "flow_xform")

        def roundtrip(data):
            for p in peers:
                data = rt.submit(p, h, data).result()
            return data

        check(roundtrip(blob) == expect, "round-trip warm-up")
        t0 = time.perf_counter()
        for _ in range(iters):
            check(roundtrip(blob) == expect, "round-trip result")
        rows[n] = {"chain": chain,
                   "roundtrip": (time.perf_counter() - t0) / iters * 1e6}
    return rows


def phase_flow(np, torch, dev, smi):
    """Phase 23: the flow layer on card contexts (every node's context on
    ``dev``).  (a), (b) ``storage_pipeline``: Acts 1-4 with their gates,
    FLOW_OK, STREAM_OK and OBS_OK.  (c) the full-size ETL: ``etl_batches``
    of ``ETL_BATCHES`` x ``make_blob(ETL_RECORDS)`` at slots of
    ``ETL_SLOT``, ``dpu_a`` congested at batch ``ETL_CONGEST``, traced by
    torch.profiler (device activity only): chains/s, records/s, the host
    timers of ``flow_timers`` and the SMs' idle share.  (a) to (c) run
    PYBC verbs on the host: no kernel may launch.  (d) ``CHAIN_N``
    two-hop ``uvm_affine`` chains of one 2-tile payload each
    (``chain_engine``, each node's seeded W on the card), ``dpu_a``
    congested halfway: exactly 2 ``ifunc_vm`` launches a chain and no
    other kernel, both DPUs used, each result within ``TOL_PATH`` of
    ``ifunc_vm_plain`` run stage by stage (the picked DPU's W, then
    agg's); chains/s, µs a chain, the host timers; then
    ``CHAIN_TRACED`` more chains timed, and as many again traced, for
    ``ifunc_vm``'s device time a hop and the SMs' idle share.  (a) to
    (d) run under ``no_plain``.  (e) ``fig_flow`` at the bench's
    settings, the chain under the round-trips at every stage count.
    Returns the ``ifunc_vm`` launches of (d)."""
    import tempfile
    import types

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flow, obs, tasks, transport
    from repro_torch.core.codegen import deserialize_uvm
    from repro_torch.kernels.ifunc_vm import ifunc_vm_plain, vm_plan
    from repro_torch.tasks import graph

    pkg = types.SimpleNamespace(core=core, transport=transport, flow=flow,
                                obs=obs, tasks=tasks, graph=graph,
                                kw={"device": dev})
    t_phase = time.perf_counter()
    rng = np.random.default_rng(23)
    Ws = {n: torch.from_numpy((rng.standard_normal((T, T)) * 0.05)
                              .astype(np.float32)).to(dev)
          for n in CHAIN_NODES}
    xs = rng.standard_normal((CHAIN_N, NT, T, T)).astype(np.float32)
    with no_plain():
        # (a), (b) the example
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            sp = storage_pipeline(pkg, np, pathlib.Path(tmp))
        counts = read_counts()
        check(not any(counts.values()),
              f"the storage pipeline launched {counts}, want no kernel")
        log(f"storage_pipeline on {smi}: {FLOW_BATCHES} ETL chains in "
            f"{sp['etl_s']:.4f} s, edge count {sp['total']}, short-circuit "
            f"at {sp['err'].hop}, bulk ingest {sp['bulk']['secs']:.4f} s")

        # (c) the full-size ETL
        eng = flow_engine(pkg, slot=ETL_SLOT)
        spent: dict = {}
        restore = flow_timers(eng, spent)
        reset_counts()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rows = etl_batches(pkg, np, eng,
                                   np.random.default_rng(FLOW_SEED),
                                   batches=ETL_BATCHES,
                                   congest_at=ETL_CONGEST,
                                   records=ETL_RECORDS)
                wall = time.perf_counter() - t0
        finally:
            restore()
        counts = read_counts()
        check(not any(counts.values()),
              f"the full-size ETL launched {counts}, want no kernel")
        n_rec = sum(n for _, _, n in rows)
        picks = [p for p, _, _ in rows]
        log(f"full-size ETL on {smi} (traced, device activity only): "
            f"{ETL_BATCHES} chains of {ETL_RECORDS // 4} runs "
            f"({n_rec} records, the largest batch "
            f"{max(n for _, _, n in rows) * 4} B expanded) in {wall:.4f} s "
            f"= {ETL_BATCHES / wall:.2f} chains/s, {n_rec / wall:.0f} "
            f"records/s; dpu_a {picks.count('dpu_a')}, "
            f"dpu_b {picks.count('dpu_b')}; host timers (s; a poll holds "
            f"the stage fns and forwards it runs): {timer_line(spent)}")
        if log_card_busy(prof, wall, f"card over the full-size ETL on "
                         f"{smi}") is None:
            log("  no kernel counted either: the SMs sit idle 1.0000 of "
                "the ETL")

        # (d) the two-hop μVM chain
        eng = chain_engine(pkg, Ws)
        spent.clear()
        restore = flow_timers(eng, spent)
        sync(torch, dev)
        reset_counts()
        try:
            t0 = time.perf_counter()
            picks, outs = uvm_chains(pkg, eng, xs, congest_at=CHAIN_N // 2)
            sync(torch, dev)
            wall = time.perf_counter() - t0
        finally:
            restore()
        counts = read_counts()
        check(counts["ifunc_vm"] == 2 * CHAIN_N and not any(
            v for k, v in counts.items() if k != "ifunc_vm"),
            f"{CHAIN_N} μVM chains launched {counts}, want ifunc_vm twice "
            f"a chain and nothing else")
        check(set(picks) == {"dpu_a", "dpu_b"},
              f"μVM chains picked {set(picks)}, want both DPUs")
        check(eng.pending() == 0 and eng.stats["orphan_replies"] == 0
              and eng.stats["completed"] == CHAIN_N,
              f"μVM chains: {eng.stats}")
        launches = counts["ifunc_vm"]
        log(f"μVM chains on {smi}: {CHAIN_N} two-hop chains of {NT} tiles "
            f"in {wall:.4f} s = {CHAIN_N / wall:.1f} chains/s, "
            f"{wall / CHAIN_N * 1e6:.1f} µs a chain; dpu_a "
            f"{picks.count('dpu_a')}, dpu_b {picks.count('dpu_b')}; "
            f"{launches} ifunc_vm launches; host timers (s): "
            f"{timer_line(spent)}")

    prog = deserialize_uvm(eng.origin.ctx.handles["uvm_affine"].lib.code)
    kernel = vm_plan(prog).kernel
    x_dev = torch.from_numpy(xs).to(dev)
    got = torch.from_numpy(np.stack(outs)).to(dev)
    worst = 0.0
    for dpu in ("dpu_a", "dpu_b"):
        sel = torch.tensor([i for i, p in enumerate(picks) if p == dpu],
                           device=dev)
        hop1 = ifunc_vm_plain(prog, x_dev[sel].reshape(-1, T, T),
                              Ws[dpu][None])
        want = ifunc_vm_plain(prog, hop1, Ws["agg"][None]).reshape(
            len(sel), NT, T, T)
        err = (got[sel] - want).abs().max().item()
        check(torch.allclose(got[sel], want, **TOL_PATH),
              f"μVM chains through {dpu} vs ifunc_vm_plain stage by stage: "
              f"max |err| {err:.3g}")
        worst = max(worst, err)
    log(f"  every chain's result within rtol 1e-4, atol 1e-5 of "
        f"ifunc_vm_plain stage by stage (max |err| {worst:.3g})")
    with no_plain():
        sync(torch, dev)
        t0 = time.perf_counter()
        uvm_chains(pkg, eng, xs[:CHAIN_TRACED])
        sync(torch, dev)
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            uvm_chains(pkg, eng, xs[:CHAIN_TRACED])
            sync(torch, dev)
    log_card_busy(prof, wall, f"card over {CHAIN_TRACED} μVM chains on {smi} "
                  f"(timed untraced, then traced)", (kernel,))

    # (e) fig_flow
    rows = fig_flow(pkg)
    for n, us in rows.items():
        log(f"fig_flow {n} stages, {FIG_FLOW_BYTES >> 10} KiB on {smi}, µs a "
            f"message over {FIG_FLOW_ITERS}: chain {us['chain']:.2f}, "
            f"round-trip {us['roundtrip']:.2f} "
            f"({us['roundtrip'] / us['chain']:.2f}x)")
        check(us["chain"] < us["roundtrip"],
              f"fig_flow: the {n}-stage chain ({us['chain']:.2f} µs) is not "
              f"under its round-trips ({us['roundtrip']:.2f} µs)")
    log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


# ------------------------------------------------------------ the runtime


def state_bytes(cfg):
    """The bf16 train state's bytes, from ``param_specs``: the parameters
    in bf16, AdamW's two moments in f32, and the int32 ``count`` and
    ``step`` scalars the checkpoint writes."""
    from repro_torch.models.transformer import param_specs

    n = sum(math.prod(shape) for shape, _ in param_specs(cfg).values())
    return {"params": 2 * n, "moments": 2 * 4 * n, "total": 10 * n + 8}


def bit_equal(torch, a, b):
    """Two leaves equal bit for bit (tensors by their bit patterns)."""
    if isinstance(a, int) or isinstance(b, int):
        return type(a) is type(b) and a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(iv), b.view(iv))


def state_leaves(state, path=()):
    if isinstance(state, dict):
        for k in sorted(state):
            yield from state_leaves(state[k], path + (k,))
    else:
        yield "/".join(map(str, path)), state


def meta_like(torch, state):
    """A restore template of ``state``: tensor leaves on the meta device."""
    if isinstance(state, dict):
        return {k: meta_like(torch, v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return torch.empty(state.shape, dtype=state.dtype, device="meta")
    return state


def train_driver(np, torch, dev, smi, ckpt_dir, *, cfg=None,
                 shape=(TRAIN_B, TRAIN_S, TRAIN_MB)):
    """Phase 24 (a): the port's ``examples/train_driver.py`` at the full
    width of SmolLM-360M (phase 17's model, optimizer, batch and seeded
    weights): ``DRIVER_STEPS`` bf16 train steps, a ``WorkerAgent`` polled
    between them and a ``PodController`` injecting ``ctl_set_lr`` (0.5)
    after step ``DRIVER_CKPT`` and ``ctl_checkpoint`` after steps
    ``DRIVER_CKPT`` and ``DRIVER_STEPS``, the agent's hook saving
    asynchronously into ``CheckpointManager(ckpt_dir, keep=1)``.  The loop
    is traced by torch.profiler (device activity only).  Gates: the
    launches of each step equal phase 17's; ``lr_scale`` 0.5; only the
    last checkpoint kept; the last restored (sha256 verified) from a meta
    template equal to the live state bit for bit; one more step from the
    restored state and from the live one equal bit for bit (loss and
    every leaf).  ``cfg`` and ``shape`` (batch, sequence, microbatches)
    shrink it for a CPU run.  Returns the flash launches of the loop."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Context
    from repro_torch.data import Loader, TokenDataset
    from repro_torch.models import transformer as MT
    from repro_torch.runtime import (CheckpointManager, PodController,
                                     WorkerAgent)
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    if cfg is None:
        cfg = model_config("smollm_360m", {"attn_impl": "flash"},
                           remat="block")
    B, S, mb = shape
    opt = OptConfig(lr=1e-3, schedule="constant", warmup_steps=1,
                    state_dtype="float32")
    step = make_train_step(cfg, opt, microbatches=mb)
    params = MT.init_params(cfg, torch.Generator(device=dev).manual_seed(400),
                            dev)
    live = {"state": {"params": params, "opt": step.init_opt(params),
                      "step": 0}}
    del params
    nb = state_bytes(cfg)
    free = shutil.disk_usage(ckpt_dir).free
    need = 2 * nb["total"] + (1 << 30)       # step 6 beside step 12's .tmp
    log(f"train driver state: {nb['total'] / 1e9:.3f} GB ({nb['params'] / 1e9:.3f} "
        f"GB of bf16 parameters, {nb['moments'] / 1e9:.3f} GB of f32 moments); "
        f"disk free under {ckpt_dir}: {free / 1e9:.1f} GB (need {need / 1e9:.1f})")
    check(free >= need, f"checkpoint disk short by {(need - free) / 1e9:.2f} "
                        f"GB: {free / 1e9:.2f} GB free under {ckpt_dir}, the "
                        f"driver needs {need / 1e9:.2f}")
    cm = CheckpointManager(ckpt_dir, keep=1)
    saves = []

    def checkpoint(s):
        t0 = time.perf_counter()
        cm.save(int(s), live["state"], blocking=False)
        saves.append((int(s), time.perf_counter() - t0))

    agent = WorkerAgent("w0", Context("w0", device=dev))
    agent.hooks["lr_scale"] = 1.0
    agent.hooks["checkpoint"] = checkpoint
    ctl = PodController(Context("ctl", device=dev))
    ctl.attach(agent)
    loader = Loader(TokenDataset(cfg.vocab_size, seed=7), shard_id=0,
                    n_shards=1, batch_per_shard=B, seq_len=S)
    per_step = train_launches_per_step(cfg, mb)
    try:
        times, overlapped, losses = [], [], []
        sync(torch, dev)
        reset_counts()
        card = dev.type == "cuda"
        with (profile(activities=[ProfilerActivity.CUDA]) if card
              else contextlib.nullcontext()) as prof:
            t_loop = time.perf_counter()
            for i in range(DRIVER_STEPS):
                _, b = next(loader)
                batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                writing = cm._thread is not None and cm._thread.is_alive()
                before = read_counts()
                t0 = time.perf_counter()
                live["state"], m = step(live["state"], batch)
                sync(torch, dev)
                times.append(time.perf_counter() - t0)
                overlapped.append(writing or (cm._thread is not None
                                              and cm._thread.is_alive()))
                now = read_counts()
                delta = {k: now[k] - before[k] for k in now}
                want = {k: per_step.get(k, 0) for k in now}
                check(delta == want, f"driver step {i + 1} launches {delta}, "
                                     f"want {want}")
                losses.append(float(m["loss"]))
                check(np.isfinite(losses[-1]), f"driver loss {losses[-1]}")
                if i + 1 == DRIVER_CKPT:      # mid-run LR hot-update
                    ctl.inject("ctl_set_lr", struct.pack("<d", 0.5))
                if (i + 1) % DRIVER_CKPT == 0:
                    ctl.inject("ctl_checkpoint",
                               int(m["step"]).to_bytes(8, "little"))
                agent.poll()
            t_wait = time.perf_counter()
            cm.wait()
            wait_s = time.perf_counter() - t_wait
            loop_s = time.perf_counter() - t_loop
        launches = read_counts()
        check(agent.hooks["lr_scale"] == 0.5,
              f"lr_scale {agent.hooks['lr_scale']} after ctl_set_lr")
        check([s for s, _ in saves] == [DRIVER_CKPT, DRIVER_STEPS]
              and cm.steps() == [DRIVER_STEPS],
              f"checkpoints triggered {saves}, kept {cm.steps()}: want "
              f"[{DRIVER_STEPS}] kept of {DRIVER_CKPT} and {DRIVER_STEPS}")
        check(all(h["bytes"] == nb["total"] for h in cm.history),
              f"checkpoint bytes {[h['bytes'] for h in cm.history]}, "
              f"param_specs counts {nb['total']}")
        for h in cm.history:
            log(f"checkpoint step {h['step']} on {smi}: {h['bytes'] / 1e9:.3f} "
                f"GB, host copy {h['host_s']:.4f} s (inside save), write "
                f"{h['write_s']:.4f} s = {h['bytes'] / h['write_s'] / 1e9:.3f} "
                f"GB/s (files, sha256, rename, retention) on the writer thread")
        calm = [t for t, o in zip(times, overlapped) if not o]
        busy = [t for t, o in zip(times, overlapped) if o]
        log(f"train driver on {smi}: {DRIVER_STEPS} steps of "
            + ", ".join(f"{t:.4f}{'*' if o else ''}"
                        for t, o in zip(times, overlapped))
            + f" s (* overlapped an async write); median "
            f"{statistics.median(times):.4f} s, "
            + (f"{statistics.median(calm):.4f} s alone" if calm else "")
            + (f", {statistics.median(busy):.4f} s beside a write ("
               f"{len(busy)} steps)" if busy else "")
            + f"; last wait {wait_s:.4f} s; loop {loop_s:.4f} s; losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; lr_scale {agent.hooks['lr_scale']}; acks "
            f"{agent.hooks['acks']}; launches {launches}")
        if card:
            log_card_busy(prof, loop_s, f"train driver loop on {smi} "
                          f"(traced, device activity only, the checkpoints' "
                          f"copies included)",
                          ("flash_fwd_wgmma_kernel",
                           "flash_bwd_dq_wgmma_kernel",
                           "flash_bwd_dkv_wgmma_kernel"), wall_is="traced")

        like = meta_like(torch, live["state"])
        sync(torch, dev)
        t0 = time.perf_counter()
        back = cm.restore(like, step=DRIVER_STEPS, device=dev)
        sync(torch, dev)
        restore_s = time.perf_counter() - t0
        del back
        t0 = time.perf_counter()
        back = cm.restore(like, step=DRIVER_STEPS, device=dev, verify=True)
        sync(torch, dev)
        verified_s = time.perf_counter() - t0
        lv, bk = dict(state_leaves(live["state"])), dict(state_leaves(back))
        check(list(lv) == list(bk), f"restored leaves {sorted(bk)}")
        bad = [k for k in lv if not bit_equal(torch, lv[k], bk[k])]
        check(not bad, f"restored state differs from the live one in {bad}")
        log(f"restore of step {DRIVER_STEPS} on {smi} from a meta template: "
            f"{restore_s:.4f} s, with sha256 verify {verified_s:.4f} s "
            f"(verify {verified_s - restore_s:.4f} s); {len(lv)} leaves "
            f"equal to the live state bit for bit")

        _, b = next(loader)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        resumed, mr = step(back, batch)
        del back
        cont, mc = step(live["state"], batch)
        sync(torch, dev)
        rv, cv = dict(state_leaves(resumed)), dict(state_leaves(cont))
        bad = [k for k in cv if not bit_equal(torch, cv[k], rv[k])]
        check(float(mr["loss"]) == float(mc["loss"]) and not bad,
              f"resume != continue: loss {float(mr['loss'])} vs "
              f"{float(mc['loss'])}, leaves differing {bad}")
        log(f"resume equals continue: one step from the restored state and "
            f"from the live one, loss {float(mc['loss']):.6f} both, "
            f"{len(cv)} leaves equal bit for bit")
    finally:
        loader.close()
        cm.wait()
    del live, resumed, cont
    torch.cuda.empty_cache()
    return {k: launches[k] for k in per_step}


def elastic_graph(np, torch, dev, smi):
    """Phase 24 (b): ``graph_workload(kill=True)``, the port's
    ``examples/graph_analysis.py --kill-peer``, under ``no_plain``: the
    ELASTIC_OK gates, ``dist`` against Bellman-Ford, the device futures
    exact, ``ring_sweep`` once a device sweep and nothing else launched.
    Returns the device sweeps."""
    with no_plain():
        res = graph_workload(np, torch, dev, kill=True)
    graph_gates(np, res)
    counts, sweeps, el = res["counts"], res["sweeps"], res["elastic"]
    check(sweeps and set(sweeps) == {1}
          and counts["ring_sweep"] == len(sweeps) and all(
              v == 0 for k, v in counts.items() if k != "ring_sweep"),
          f"elastic graph: launches {counts} in {len(sweeps)} device sweeps, "
          f"want ring_sweep once a sweep and nothing else")
    st = el["stats"]
    log(f"elastic graph on {smi}: {res['rounds']} rounds in "
        f"{res['wall']:.4f} s; {GRAPH_KILL} killed at round {el['killed']} "
        f"with s{el['doomed'][0]} in flight, recovered "
        f"{el['kill_to_recovery_s']:.4f} s after the kill (deadline "
        f"{GRAPH_DEADLINE} s: {el['kill_to_recovery_s'] / GRAPH_DEADLINE:.3f}x"
        f"), s{el['doomed'][0]} -> {el['doomed'][1]}, generation "
        f"{el['doomed'][2]}; re-admitted at round {el['readmitted']} with "
        f"{len(el['manifest'])} manifest entries, fence "
        f"{el['fence']}; {el['recovered']} relaxes re-run locally; "
        f"controller {st}; post-readmit relax corr generation "
        f"{el['post_gen']}, {el['peer_stats']['slim_sent']} SLIM, "
        f"{el['peer_stats']['nacks']} NACKs; {len(sweeps)} device sweeps, "
        f"launches {counts}")
    return len(sweeps)


def fig_elastic(torch, dev, *, deadlines_ms=FIG_ELASTIC_DEADLINES,
                repeats=3, n_msgs=1024):
    """``bench_ifunc.py``'s ``fig_elastic`` on the port, every context on
    ``dev``: recovery time against the heartbeat deadline (a two-peer
    fleet, ``pa`` killed with a ``task_sum`` in flight, timed from the
    kill to its retirement by the poll loop, best of ``repeats``) and
    ``hb_overhead`` (``n_msgs`` warm tasks under a 0.5 s deadline:
    nominal beats/s over task messages/s).  Returns the bench's rows."""
    import gc

    from repro_torch.core import Context, register_ifunc
    from repro_torch.runtime import ElasticController, FleetState
    from repro_torch.tasks import TaskRuntime
    from repro_torch.transport import (FaultInjector, LoopbackFabric,
                                       ProgressEngine, RdmaFabric,
                                       TransportError)

    names = ("pa", "pb")

    def mk(deadline_s):
        src = Context("src", device=dev)
        rt = TaskRuntime(src, engine=ProgressEngine(
            flush_threshold=64, inflight_window="trailer"),
            default_timeout=30.0)
        fabs, ctxs = {}, {}
        for i, name in enumerate(names):
            fabs[name] = RdmaFabric() if i % 2 == 0 else LoopbackFabric()
            ctxs[name] = Context(name, link_mode="remote", device=dev)
            rt.add_peer(name, fabs[name], ctxs[name], n_slots=8,
                        slot_size=16 << 10, target_args={})
        fleet = FleetState(list(names), heartbeat_deadline=deadline_s)
        inj = FaultInjector()
        ec = ElasticController(rt, fleet, injector=inj)   # rides progress()
        for name in names:
            ec.watch(name, fabs[name], ctxs[name])
        return rt, ec, inj, register_ifunc(src, "task_sum")

    def settle(rt, fut):
        rt.flush()
        while not fut.done():
            rt.progress()

    def run_recover(deadline_s):
        rt, ec, inj, h = mk(deadline_s)
        f = rt.submit("pa", h, b"\x01" * 8)   # warm rings, fold a beat
        settle(rt, f)
        f.result()
        rt.progress()                          # freshest last heartbeat
        inj.kill_peer("pa")
        doomed = rt.submit("pa", h, b"\x02" * 8)
        rt.flush()
        t0 = time.perf_counter()
        while "pa" in rt.dispatcher.peers:     # the poll loop detects it
            rt.progress()
        dt = time.perf_counter() - t0
        check(doomed.done() and ec.stats["deaths"] == 1 and rt.generation > 0,
              f"fig_elastic recover: doomed done {doomed.done()}, controller "
              f"{ec.stats}, generation {rt.generation}")
        try:
            doomed.result()
        except TransportError:
            pass
        else:
            raise SmokeError("fig_elastic: the future on the dead peer "
                             "resolved")
        return dt

    def run_overhead(deadline_s=0.5):
        rt, _ec, _inj, h = mk(deadline_s)
        payload = b"\x05" * 64
        for name in names:                     # warm the SLIM cache
            settle(rt, rt.submit(name, h, payload))
        t0 = time.perf_counter()
        i = 0
        while i < n_msgs:
            burst = [rt.submit(names[i % len(names)], h, payload)
                     for _ in range(min(8, n_msgs - i))]
            i += len(burst)
            rt.flush()
            while not all(f.done() for f in burst):
                rt.progress()
        msgs_per_s = n_msgs / (time.perf_counter() - t0)
        beats_per_s = len(names) * 3.0 / deadline_s   # interval deadline/3
        return msgs_per_s, beats_per_s / msgs_per_s

    rows = []
    run_recover(deadlines_ms[0] / 1e3)         # warm (link cache, slabs)
    gc.collect()
    gc.disable()
    try:
        for dms in deadlines_ms:
            dt = min(run_recover(dms / 1e3) for _ in range(repeats))
            rows.append({"cell": f"recover/{dms}ms", "us": dt * 1e6,
                         "ratio": dt / (dms / 1e3)})
        msgs_per_s, ratio = run_overhead()
        rows.append({"cell": "hb_overhead", "us": 1e6 / msgs_per_s,
                     "msgs_per_s": msgs_per_s, "ratio": ratio})
    finally:
        gc.enable()
    return rows


def phase_runtime(np, torch, dev, smi):
    """Phase 24: the runtime on the card.  (a) ``train_driver`` at full
    width, its checkpoints under ``build/``, removed after; (b)
    ``elastic_graph``; (c) ``fig_elastic`` gated by ``check_bench.py``'s
    bounds: recovery within [0.8, 3.0] of each deadline, ``hb_overhead``
    at most 0.02.  Returns the driver's flash launches and the elastic
    run's device sweeps."""
    t_phase = time.perf_counter()
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    try:
        driver = train_driver(np, torch, dev, smi, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    sweeps = elastic_graph(np, torch, dev, smi)
    rows = fig_elastic(torch, dev)
    for r in rows:
        if r["cell"] == "hb_overhead":
            log(f"fig_elastic hb_overhead on {smi}: {r['msgs_per_s']:.1f} "
                f"task msgs/s, nominal beats / msgs {r['ratio']:.5f} "
                f"(bound 0.02)")
            check(r["ratio"] <= 0.02, f"heartbeat overhead {r['ratio']:.4f} "
                                      f"over the 2% budget")
        else:
            log(f"fig_elastic {r['cell']} on {smi}: recover "
                f"{r['us']:.1f} µs = {r['ratio']:.3f}x the deadline (bound "
                f"[0.8, 3.0])")
            check(0.8 <= r["ratio"] <= 3.0,
                  f"fig_elastic {r['cell']}: recovery {r['ratio']:.3f}x the "
                  f"deadline, outside [0.8, 3.0]")
    log(f"phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return {"driver": driver, "sweeps": sweeps}


# ------------------------------------------------- the disaggregated fleet


def streamed_fabric():
    """The port's ``ServingFabric`` with KV streams sized for SmolLM-360M's
    slabs: ``FLEET_CHUNK`` chunks, ``FLEET_WINDOW`` in flight (each
    prefill peer grows its ring slots to hold them).  At the class's 8 KiB
    chunks one 1,024-token slab would take about 10,000 chunks."""
    from repro_torch.serving import ServingFabric

    class StreamedFabric(ServingFabric):
        kv_chunk_bytes, kv_window = FLEET_CHUNK, FLEET_WINDOW

    return StreamedFabric


def fleet_requests(np, cfg, prompts, news, seed):
    from repro_torch.serving import Request

    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    news[i % len(news)]) for i, n in enumerate(prompts)]


def tick_spans(obs):
    """(decode ticks, their host s, the tokens they emitted) from the
    batchers' ``decode_tick`` spans in ``obs``'s trace."""
    ticks = [sp for sp in obs.tracer.spans(cat="serve")
             if sp.name.startswith("decode_tick:")]
    return (len(ticks), sum(sp.dur for sp in ticks) / 1e6,
            sum(sp.args["tokens"] for sp in ticks))


def host_serve(torch, dev, cfg, params, reqs):
    """The single host (``FLEET_SLOTS`` slots, cache ``FLEET_CACHE``,
    traced): admit in order while slots are free, tick until all are done
    (the example's loop).  Returns ({rid: tokens}, wall s, ``tick_spans``)."""
    from repro_torch.obs import Obs
    from repro_torch.serving import Server

    srv = Server(cfg, params, FLEET_SLOTS, FLEET_CACHE,
                 obs=Obs("server", trace=True), device=dev)
    out, pending = {}, list(reqs)
    sync(torch, dev)
    t0 = time.perf_counter()
    while pending or srv.active:
        while pending and srv.admit(pending[0]):
            pending.pop(0)
        _, fin = srv.tick()
        for r in fin:
            out[r.rid] = list(r.out)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    ticks = tick_spans(srv.obs)
    del srv
    return out, wall, ticks


def fleet_serve(torch, dev, cfg, params, reqs, *, codecs=("rle", "raw"),
                prof=None):
    """One run of the 2+2 fleet (``streamed_fabric``, ``FLEET_SLOTS`` slots
    and cache ``FLEET_CACHE`` a decode peer, traced), under ``prof`` when
    given.  Returns the fabric (dropped by the caller) and the run: its
    {rid: tokens}, wall s, rounds, whether a decode batch ran live slots
    at unequal positions (the example's ``watch``), and its start on the
    trace's clock (µs)."""
    from repro_torch.obs import Obs

    fab = streamed_fabric()(
        cfg, params, n_prefill=2, n_decode=2, batch_slots=FLEET_SLOTS,
        cache_len=FLEET_CACHE, decode_codecs=codecs,
        obs=Obs("serving", trace=True), device=dev)
    run = {"mixed": False, "rounds": 0}

    def watch(f):
        run["rounds"] += 1
        for dw in f.decode_workers:
            live = [int(dw.batcher.pos[s]) for s in dw.batcher.active]
            if len(live) >= 2 and len(set(live)) >= 2:
                run["mixed"] = True

    sync(torch, dev)
    t0 = time.perf_counter()
    run["t0_us"] = fab.obs.tracer.now_us()
    with (prof if prof is not None else contextlib.nullcontext()):
        done = fab.run(reqs, tick_cb=watch)
        fab.drain()
        sync(torch, dev)
    run["wall"] = time.perf_counter() - t0
    run["out"] = {rid: list(r.out) for rid, r in done.items()}
    return fab, run


def first_divergence(got, want):
    for rid in sorted(want):
        g, w = got.get(rid, []), want[rid]
        for step, (a, b) in enumerate(zip(g, w)):
            if a != b:
                return f"rid {rid} step {step}: {a} against the host's {b}"
        if len(g) != len(w):
            return f"rid {rid}: {len(g)} tokens against the host's {len(w)}"
    return None


def wire_bytes(fab):
    return sum(p.stats["bytes"] for pw in fab.prefill_workers
               for p in pw.rt.dispatcher.peers.values())


def agree(got, want):
    n = sum(a == b for rid in want for a, b in zip(got[rid], want[rid]))
    return n, sum(len(w) for w in want.values())


def slab_of(fab, rid):
    """The decode-side landing slab that holds ``rid``'s KV cache."""
    from repro_torch.serving import kv

    for dw in fab.decode_workers:
        for slab in dw.slabs.values():
            if any(slab[:4]) and kv.peek_kv(slab)[0] == rid:
                return kv.unpack_kv(slab)
    raise SmokeError(f"no landed slab holds rid {rid}")


def fleet_streams_log(fab, run, reqs, smi, what):
    """Log each KV stream's bytes, chunks, open-to-acked s and GB/s (the
    dispatcher's ``stream`` spans; prompt lengths are distinct, so the
    slabs' sizes rank as the prompts') and each request's enqueue to
    install (the batchers' ``kv_install`` spans, by rid), and the prefill
    D2H; check the chunks against the decode peers' counts."""
    spans = fab.obs.tracer.spans()
    streams = sorted((sp for sp in spans if sp.cat == "stream"
                      and sp.name.startswith("stream:kv_install@")),
                     key=lambda sp: sp.args["bytes"])
    installs = {sp.corr: sp for sp in spans
                if sp.name.startswith("kv_install:")}
    check(len(streams) == len(reqs) and len(installs) == len(reqs),
          f"{what}: {len(streams)} KV stream spans and {len(installs)} "
          f"install spans for {len(reqs)} requests")
    landed = sum(dw.ctx.stats.get("stream_chunks", 0)
                 for dw in fab.decode_workers)
    sent = sum(sp.args["chunks"] for sp in streams)
    check(sent == landed, f"{what}: the streams sent {sent} chunks, the "
                          f"decode peers took {landed}")
    by_len = sorted(reqs, key=lambda r: len(r.prompt))
    for r, sp in zip(by_len, streams):
        n, s = sp.args["bytes"], sp.dur / 1e6
        done = installs[r.rid]
        log(f"  {what} rid {r.rid} prompt {len(r.prompt)}: slab {n} B "
            f"({n / 2**20:.2f} MiB) in {sp.args['chunks']} chunks, open to "
            f"acked {s:.4f} s = {n / s / 1e9:.3f} GB/s; enqueue to install "
            f"{(done.ts + done.dur - run['t0_us']) / 1e6:.4f} s")
    total = sum(sp.args["bytes"] for sp in streams)
    d2h = sum(pw.d2h_s for pw in fab.prefill_workers)
    log(f"{what} on {smi}: {len(streams)} slabs {total} B in {landed} "
        f"chunks of {fab.kv_chunk_bytes} B (window {fab.kv_window}, slots "
        f"of {fab.prefill_workers[0].slot_size} B); prefill D2H {d2h:.4f} s "
        f"= {total / max(d2h, 1e-9) / 1e9:.3f} GB/s over the slabs' bytes")


def fleet_group(np, torch, dev, cfg, params, smi):
    """Phase 25 (b): 4 prompts of one length through a fleet of one
    prefill and two decode peers, so one forward is [4, S]: each row's
    slab entries and first-token logits against a [1, S] prefill of the
    same prompt (relative L2 within TOL_FLEET_GROUP); decoded tokens
    against the host's, logged."""
    from repro_torch.train import serve as SRV

    n, S, new = FLEET_GROUP
    reqs = lambda: fleet_requests(np, cfg, (S,) * n, (new,), 252)  # noqa: E731
    want, _, _ = host_serve(torch, dev, cfg, params, reqs())
    groups = []
    fab = streamed_fabric()(
        cfg, params, n_prefill=1, n_decode=2, batch_slots=FLEET_SLOTS,
        cache_len=FLEET_CACHE, device=dev)
    pw = fab.prefill_workers[0]
    inner = pw._prefill

    def captured(p, inputs):
        cache, last = inner(p, inputs)
        groups.append((tuple(inputs["tokens"].shape),
                       last[:, -1].float().cpu().numpy()))
        return cache, last

    pw._prefill = captured
    rq = reqs()
    done = fab.run(rq)
    fab.drain()
    got = {rid: list(r.out) for rid, r in done.items()}
    check([g[0] for g in groups] == [(n, S)],
          f"(b): prefill groups {[g[0] for g in groups]}, want one ({n}, {S})")
    prefill = SRV.jit_prefill_step(cfg)
    worst, worst_abs, firsts = 0.0, 0.0, 0
    for row, r in enumerate(rq):
        cache1, last = prefill(params, {"tokens": torch.from_numpy(
            r.prompt[None]).to(dev)})
        ref_logits = last[0, -1].float().cpu().numpy()
        pairs = [("logits", groups[0][1][row], ref_logits)]
        slab = slab_of(fab, r.rid)
        check(slab["first_token"] == int(np.argmax(groups[0][1][row])),
              f"(b) rid {r.rid}: slab first token {slab['first_token']}")
        firsts += slab["first_token"] == int(np.argmax(ref_logits))
        for k, v in slab["entries"].items():
            pairs.append((k, v, cache1[k].float().cpu().numpy()))
        for k, a, b in pairs:
            rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            worst = max(worst, rel)
            worst_abs = max(worst_abs, float(np.max(np.abs(a - b))))
            check(rel <= TOL_FLEET_GROUP,
                  f"(b) rid {r.rid} {k}: relative L2 {rel:.3g} against the "
                  f"[1, {S}] prefill (tolerance {TOL_FLEET_GROUP})")
        del cache1, last
    ok, total = agree(got, want)
    log(f"phase 25 (b) on {smi}: one [{n}, {S}] prefill group; each row's "
        f"slab entries and first-token logits against its own [1, {S}] "
        f"prefill: worst relative L2 {worst:.3g} (tolerance "
        f"{TOL_FLEET_GROUP}, the port's two-bf16-forward bound), max |err| "
        f"{worst_abs:.3g}; first tokens equal {firsts}/{n}; decoded tokens "
        f"equal to the host's {ok}/{total}")
    check(fab.buffered_installs() == 0 and fab.streams_landed() == n,
          f"(b): buffered {fab.buffered_installs()}, streams "
          f"{fab.streams_landed()}")
    del fab


def fleet_cli(dev):
    """Phase 25 (d): ``python -m repro_torch.launch.serve`` at its defaults
    in both modes on ``dev``, two child processes at once, neither of
    which may load jax or the JAX package; returns each mode's wall s."""
    probe = ("import runpy, sys\n"
             "sys.argv = ['serve'] + sys.argv[1:]\n"
             "runpy.run_module('repro_torch.launch.serve', "
             "run_name='__main__')\n"
             "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
             "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
             "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", probe, "--mode", mode, "--device", dev.type],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for mode in ("host", "disagg")}
    walls = {}
    try:
        for mode, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            walls[mode] = time.perf_counter() - t0
            check(proc.returncode == 0, f"launch.serve --mode {mode}: rc "
                                        f"{proc.returncode}: {err[-2000:]}")
            check("FORBIDDEN []" in out,
                  f"launch.serve --mode {mode} loaded jax or the JAX "
                  f"package: {out[-500:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith(
                ("served", "metrics", "router"))]
            log(f"  launch.serve --mode {mode} (done {walls[mode]:.1f} s "
                f"after both started): " + " | ".join(lines))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return walls


def phase_fabric(np, torch, dev, smi):
    """Phase 25: the disaggregated serving fleet at SmolLM-360M's width.
    (a) the single host and the 2+2 fleet on the same 8 requests:
    tokens equal, every slab streamed, mixed positions, ``flash_fwd``
    launched 32 times a host prefill and a fleet prefill group, and then
    the fleet again under torch.profiler for the SMs' idle share; (b)
    ``fleet_group``; (c) decode peers advertising quant8: every request
    completes, quant8 negotiated, wire bytes against (a)'s; (d)
    ``fleet_cli``.  Returns the fleet's ``flash_fwd`` launches in (a)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as MT
    from repro_torch.train import serve as SRV

    t_phase = time.perf_counter()
    cfg = model_config("smollm_360m", {"attn_impl": "flash"})
    params = MT.init_params(cfg, torch.Generator(device=dev).manual_seed(250),
                            dev)

    def reqs():
        return fleet_requests(np, cfg, FLEET_PROMPTS, FLEET_NEW, 25)

    SRV.jit_prefill_step(cfg)(params, {"tokens": torch.from_numpy(
        reqs()[0].prompt[None]).to(dev)})                      # warm-up
    sync(torch, dev)
    n = len(FLEET_PROMPTS)

    # (a) the single host, then the fleet, each counted
    reset_counts()
    want, host_wall, host_ticks = host_serve(torch, dev, cfg, params, reqs())
    host_counts = read_counts()
    reset_counts()
    fab, run = fleet_serve(torch, dev, cfg, params, reqs())
    counts = read_counts()
    got, wall = run["out"], run["wall"]
    snap = fab.obs.snapshot()["counters"]
    groups = sum(v for k, v in snap.items() if k.endswith("prefill_batches"))
    for what, c, k in (("host", host_counts, n), ("fleet", counts, groups)):
        want_c = {key: (cfg.num_layers * k if key == "flash_fwd" else 0)
                  for key in c}
        check(c == want_c, f"(a) {what}: launches {c}, want {want_c}")
    check(groups == n, f"(a): {groups} prefill groups for {n} distinct "
                       f"prompt lengths")
    bad = first_divergence(got, want)
    check(bad is None, f"(a): the fleet's tokens differ from the single "
                       f"host's at {bad}")
    check(fab.buffered_installs() == 0 and fab.streams_landed() == n,
          f"(a): buffered installs {fab.buffered_installs()}, streams "
          f"landed {fab.streams_landed()} of {n}")
    check(run["mixed"], "(a): no decode batch ran live slots at unequal "
                        "positions")
    dec = sum(len(t) - 1 for t in want.values())
    fleet_ticks = tick_spans(fab.obs)
    for what, (k, s, toks) in (("host", host_ticks), ("fleet", fleet_ticks)):
        check(toks == dec, f"(a) {what}: its {k} decode ticks emitted "
                           f"{toks} tokens, the requests {dec}")
    log(f"phase 25 (a) {cfg.name} bf16 on {smi}: {n} requests (prompts "
        f"{list(FLEET_PROMPTS)}, budgets {list(FLEET_NEW)} in turn), "
        f"{FLEET_SLOTS} slots, cache {FLEET_CACHE}, {dec} decoded tokens; "
        f"single host {host_wall:.4f} s = {n / host_wall:.3f} requests/s, "
        f"{dec / host_wall:.1f} decoded tokens/s over the run, "
        f"{host_ticks[0]} decode ticks in {host_ticks[1]:.4f} s = "
        f"{dec / host_ticks[1]:.1f} tokens/s over tick time; 2+2 fleet "
        f"{wall:.4f} s ({run['rounds']} rounds) = {n / wall:.3f} "
        f"requests/s, {dec / wall:.1f} decoded tokens/s over the run, "
        f"{fleet_ticks[0]} decode ticks in {fleet_ticks[1]:.4f} s = "
        f"{dec / fleet_ticks[1]:.1f} tokens/s over tick time (both traced); "
        f"tokens equal the host's token for token; {fab.streams_landed()} "
        f"streams landed, 0 buffered installs, mixed positions seen; "
        f"flash_fwd {counts['flash_fwd']} launches in the fleet "
        f"({groups} groups), {host_counts['flash_fwd']} on the host")
    fleet_streams_log(fab, run, reqs(), smi, "(a)")
    raw_wire = wire_bytes(fab)
    codec = sorted({c for pw in fab.prefill_workers
                    for c in pw._negotiated.values()})
    del fab
    torch.cuda.empty_cache()
    prof = profile(activities=[ProfilerActivity.CUDA])
    fab, run2 = fleet_serve(torch, dev, cfg, params, reqs(), prof=prof)
    check(run2["out"] == want, "(a): the traced fleet's tokens differ")
    log_card_busy(prof, run2["wall"], "(a) the traced fleet run",
                  ("flash_fwd",), wall_is="traced")
    del fab
    torch.cuda.empty_cache()

    fleet_group(np, torch, dev, cfg, params, smi)
    sync(torch, dev)
    torch.cuda.empty_cache()

    # (c) quant8 negotiated
    fab, run3 = fleet_serve(torch, dev, cfg, params, reqs(),
                            codecs=("quant8", "raw"))
    got3 = run3["out"]
    neg = sorted({c for pw in fab.prefill_workers
                  for c in pw._negotiated.values()})
    check(len(got3) == n and all(len(got3[r.rid]) == r.max_new
                                 for r in reqs()),
          f"(c): {len(got3)} of {n} requests completed")
    check(fab.buffered_installs() == 0, "(c): a KV slab arrived unstreamed")
    check(neg == ["quant8"], f"(c): negotiated {neg}, want quant8")
    ok, total = agree(got3, want)
    q8_wire = wire_bytes(fab)
    log(f"phase 25 (c) on {smi}: decode peers advertise (quant8, raw): "
        f"negotiated {neg}; {n} requests in {run3['wall']:.4f} s "
        f"({run3['rounds']} rounds); prefill wire bytes {q8_wire} against "
        f"(a)'s {raw_wire} ({codec}) = {q8_wire / raw_wire:.4f}x; tokens "
        f"equal to the host's {ok}/{total}")
    del fab, params
    torch.cuda.empty_cache()

    fleet_cli(dev)
    log(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_fwd"]


# ------------------------------------------------------------ model stack


def model_config(arch, impl, **kw):
    from repro_torch.configs import get_config

    return get_config(arch).with_(**impl, **kw)


def model_kernel(impl):
    """The kernel a model's selection in ``MODELS`` runs."""
    return "flash_fwd" if "attn_impl" in impl else "ssd_scan"


def kernel_layers(cfg, kernel):
    """The layers of ``cfg`` that launch ``kernel`` once a prefill: the
    attention blocks for ``flash_fwd``, the SSD blocks for ``ssd_scan``
    (RecurrentGemma-2B: 8 of 26)."""
    from repro_torch.models.transformer import ATTN_KINDS

    kinds = ATTN_KINDS if kernel == "flash_fwd" else ("ssd",)
    return sum(kind in kinds for kind in cfg.layer_kinds)


def serve_positions(cfg):
    """The positions of each prompt phase 13 serves through ``cfg``, its
    prefix of external embeddings included."""
    return SERVE_EXT_POSITIONS if cfg.ext_embed_len else SERVE_PROMPTS


def flash_fwd_shapes():
    """flash's forward [BH, S, hd, window] for phase 10: ``FLASH_SHAPES``;
    every shape phase 13's prefills give the kernel, derived from each
    flash model of ``SERVE_MODELS`` (at batch 1, KV repeated to all
    heads, each attention kind's window, over :func:`serve_positions` and
    the ``PREFILL_S`` prefill), so that no model served there goes
    unchecked; and ``PHI3_FLASH_SHAPES``."""
    shapes = list(FLASH_SHAPES)
    for arch, kern in SERVE_MODELS.items():
        if model_kernel(kern) != "flash_fwd":
            continue
        cfg = model_config(arch, kern)
        shapes += [(cfg.num_heads, S, cfg.head_dim, w)
                   for S in (*serve_positions(cfg), PREFILL_S)
                   for w in attn_windows(cfg)]
    shapes = tuple(dict.fromkeys(shapes + list(PHI3_FLASH_SHAPES)))
    for shape in (RG_FLASH_SHAPE, *WIDE_FLASH_SHAPES):
        check(shape in shapes, f"phase 11's {shape} is not on the serving "
                               f"path")
    return shapes


def flash_work(BH, S, hd, window):
    """(FLOP, bytes) a causal flash forward must do: Q K^T and P V over
    the pairs the mask keeps (``flash_flops``), q, k, v read and O
    written once in bf16, LSE written in f32."""
    from repro_torch.kernels.flash_attn import flash_flops

    return (flash_flops(BH, S, hd, window)[0],
            4 * BH * S * hd * 2 + BH * S * 4)


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
    per row (``ssd_flops``); x, la, B and C read once and y written once,
    f32."""
    from repro_torch.kernels.ssd_scan import ssd_flops

    return (ssd_flops(BH, G, nc, Q, hd, ds),
            (2 * BH * nc * Q * hd + BH * nc * Q + 2 * G * nc * Q * ds) * 4)


def attn_windows(cfg):
    """The windows ``cfg``'s attention layers give flash: 0 for ``attn``,
    ``attn_window`` for ``attn_local``."""
    from repro_torch.models.transformer import ATTN_KINDS

    return sorted({cfg.attn_window if kind == "attn_local" else 0
                   for kind in cfg.layer_kinds if kind in ATTN_KINDS})


def dryrun_train_split(arch, policy, shape=None, mesh_kind="pod"):
    """How a ``DRYRUN_TRAIN`` cell (a ``shape`` cell: ``DRYRUN_TRAIN_SHAPE``
    by default) splits on the ``mesh_kind`` mesh: (config, microbatches, a
    rank's rows a step, its q heads, its words of the vocabulary).
    The rows are the global batch over the axes its spec keeps, and where
    the batch splits over ``model`` in padded tiles (the port's own
    decision, ``parallel.sharding.row_group``) rank 0's tile of each
    microbatch's, the widest; the heads and the vocabulary split over
    ``model`` (tensor parallelism) where the rules give them ``model``
    and leave it out of the batch (``parallel.sharding.tile_group``), into
    padded tiles where ``model`` does not divide them: rank 0's, the
    widest, which the dry run runs."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import (DryOps, apply_policy,
                                           make_abstract_mesh)
    from repro_torch.parallel import sharding as SH

    shape = shape or DRYRUN_TRAIN_SHAPE
    cfg, rules, mb = apply_policy(C.get_config(arch), shape, policy)
    sp = C.SHAPES[shape]
    mesh = make_abstract_mesh(multi_pod=mesh_kind == "multipod")
    model = SH.mesh_shape(mesh)["model"]

    def tile(logical, n):
        """Rank 0's tile of a dimension of ``n`` named ``logical``."""
        if "model" in rules.get("batch") or SH.logical_sharding(
                (logical,), mesh, rules).spec != ("model",):
            return n
        return SH.tile(n, model, 0)[1]

    with SH.sharding_context(mesh, rules):
        rows = SH.shard_rows(mesh, "batch", sp.global_batch)
        split = SH.row_group(DryOps(mesh, None, {}), sp.global_batch)
    if split is not None:
        rows = mb * split.block(rows // mb)[1]
    return (cfg, mb, rows, tile("heads", cfg.num_heads),
            tile("vocab", cfg.vocab_size))


def rows_phrase(arch, policy, shape, mesh_kind, rows):
    """'``rows`` x S a rank' for a cell whose rank runs ``rows`` rows a
    step (:func:`dryrun_train_split`), and of how many of its batch
    shard's where the batch splits over ``model`` in padded tiles."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import apply_policy, make_abstract_mesh
    from repro_torch.parallel import sharding as SH

    _, rules, _ = apply_policy(C.get_config(arch), shape, policy)
    sp = C.SHAPES[shape]
    mesh = make_abstract_mesh(multi_pod=mesh_kind == "multipod")
    with SH.sharding_context(mesh, rules):
        n = SH.shard_rows(mesh, "batch", sp.global_batch)
    of = (f" of its shard's {n} (the batch over model in padded tiles)"
          if rows != n else "")
    return f"{rows}{of} x {sp.seq_len:,} a rank"


def dryrun_train_flash_shapes(cells=None):
    """flash's [BH, S, hd, window] in phase 27 (b)'s train ``cells``
    (default ``DRYRUN_TRAIN``): each on one rank's rows of a microbatch
    and its q heads
    (:func:`dryrun_train_split`; KV repeated to those heads, each
    attention kind's window)."""
    from repro_torch import configs as C

    S = C.SHAPES[DRYRUN_TRAIN_SHAPE].seq_len
    shapes = []
    for arch, policy, mk in DRYRUN_TRAIN if cells is None else cells:
        cfg, mb, rows, heads, _ = dryrun_train_split(arch, policy,
                                                     mesh_kind=mk)
        shapes += [(rows // mb * heads, S, cfg.head_dim, w)
                   for w in attn_windows(cfg)]
    return shapes


def recurrent_split(arch, policy, shape):
    """How a pod cell's ``model`` group splits ``arch``'s RG-LRU channels
    and SSD heads, as the port decides it: ``rglru.tp_split`` /
    ``ssm.tp_split`` (what ``transformer._gather_block`` asks) of a
    rank's shards, on meta, of the first such block's leaves (and, in
    decode, its cache) on the pod's ``AbstractMesh``.  {"rglru": (a
    rank's channels, all), "ssd": (a rank's heads, all)} for the kinds
    it has."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import rglru, ssm
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    cfg, rules, _ = DR.apply_policy(C.get_config(arch), shape, policy)
    mesh = DR.make_abstract_mesh()
    sp = C.SHAPES[shape]
    shapes, axes = T.param_shapes(cfg), T.param_axes(cfg)
    cache_keys = ()
    if sp.kind == "decode":
        B, S = sp.global_batch, sp.seq_len
        cache_keys = tuple(T.cache_shapes(cfg, B, S))
        shapes.update(T.cache_shapes(cfg, B, S))
        axes.update(T.cache_axes(cfg, B, S))
    ops = DR.DryOps(mesh, DR.meta_gather, {})

    def shard(key, stacked):
        spec, ax = shapes[key], tuple(axes[key])
        sh = SH.logical_sharding(ax, mesh, rules, tuple(spec.shape))
        local = torch.empty(DR.Leaf(key, spec, ax, sh).shard_shape,
                            device="meta")
        leaf = SH.ShardedLeaf(local, sh, ops, key=key)
        return leaf.unbind(0)[0] if stacked else leaf

    slots = [f"s{i}_" for i in range(len(cfg.block_pattern))] + [
        f"t{i}_" for i in range(len(cfg.trailing))]
    kinds = list(cfg.block_pattern) + list(cfg.trailing)
    out = {}
    with SH.sharding_context(mesh, rules):
        for kind, mod, whole in (("rglru", rglru, cfg.rnn_width),
                                 ("ssd", ssm, cfg.ssm_heads)):
            if kind not in kinds:
                continue
            prefix = slots[kinds.index(kind)]
            stacked = prefix[0] == "s"
            p = {k: shard(prefix + k, stacked) for k in mod.TP_WEIGHTS}
            cache = ({k[len(prefix):]: shard(k, stacked) for k in cache_keys
                      if k.startswith(prefix)} if cache_keys else None)
            tp = mod.tp_split(p, cache)
            out[kind] = (whole if tp is None else whole // tp.size, whole)
    return out


def recurrent_phrase(split):
    """:func:`recurrent_split`'s result as a phrase for the logs."""
    what = {"rglru": "RG-LRU channels", "ssd": "SSD heads"}
    return "".join(f", {n:,} of the {whole:,} {what[k]} a rank"
                   for k, (n, whole) in split.items())


def dryrun_prefill_ssd_shape(arch="mamba2_780m"):
    """``ssd_scan``'s [BH, nc, Q, hd, ds, G] in ``arch``'s ``prefill_32k``
    pod cell: one rank's rows times its SSD heads (split over ``model``
    where it divides them and ``d_inner``: ``ssm.tp_split``), chunks of
    ``ssm_chunk``, B and C one group a row."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import apply_policy, make_abstract_mesh
    from repro_torch.parallel import sharding as SH

    cfg, rules, _ = apply_policy(C.get_config(arch), DRYRUN_SHAPE, "ssdk")
    sp = C.SHAPES[DRYRUN_SHAPE]
    mesh = make_abstract_mesh()
    sizes = SH.mesh_shape(mesh)
    spec = SH.logical_sharding(("batch", None), mesh, rules,
                               (sp.global_batch, sp.seq_len)).spec
    rows = sp.global_batch // math.prod(
        sizes[a] for a in SH.spec_axes(spec, 2)[0])
    nh = recurrent_split(arch, "ssdk", DRYRUN_SHAPE)["ssd"][0]
    Q = min(cfg.ssm_chunk, sp.seq_len)
    return (rows * nh, sp.seq_len // Q, Q, cfg.ssm_head_dim, cfg.ssm_state,
            rows)


def dryrun_prefill_flash_shapes():
    """flash's [BH, S, hd, window] in phase 27 (b)'s ``prefill_32k`` pod
    cells (``DRYRUN_MUST_RUN`` that attend, then ``DRYRUN_PREFILL``): one
    rank's rows (its tile of them where the batch splits over ``model``)
    and its q heads (:func:`dryrun_train_split`: under ``baseline`` the
    heads split over ``model``, in padded tiles where it does not divide
    them), KV repeated to those heads, each attention kind's window."""
    from repro_torch import configs as C
    from repro_torch.models.transformer import ATTN_KINDS

    S = C.SHAPES[DRYRUN_SHAPE].seq_len
    shapes = []
    for arch, policy, mk in [(a, "flash", "pod") for a in DRYRUN_MUST_RUN] \
            + list(DRYRUN_PREFILL):
        cfg, _, rows, heads, _ = dryrun_train_split(arch, policy,
                                                    DRYRUN_SHAPE, mk)
        if any(k in ATTN_KINDS for k in cfg.layer_kinds):
            shapes += [(rows * heads, S, cfg.head_dim, w)
                       for w in attn_windows(cfg)]
    return tuple(dict.fromkeys(shapes))


def flash_fwd_plain_rows(torch, q, k, v, scale, window, max_elems=1 << 30):
    """``flash_fwd_plain`` (f32) over chunks of batch-heads whose score
    tensor holds at most ``max_elems`` elements (one batch-head a call at
    32,768 positions), concatenated; one call where the whole fits."""
    from repro_torch.kernels.flash_attn import flash_fwd_plain

    BH, S = q.shape[:2]
    n = max(1, max_elems // (S * S))
    parts = [flash_fwd_plain(q[i:i + n].float(), k[i:i + n].float(),
                             v[i:i + n].float(), scale=scale, window=window)
             for i in range(0, BH, n)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([o for o, _ in parts]),
            torch.cat([lse for _, lse in parts]))


def train_flash_shapes():
    """flash's [BH, S, hd, window] on the training path: each model of
    ``TRAIN_MODELS`` over one microbatch of phase 17 and of
    ``PARITY_MODELS`` over phase 16's batch (KV repeated to all heads,
    each attention kind's window), and phase 27 (b)'s train cells
    (:func:`dryrun_train_flash_shapes`)."""
    shapes = []
    for arch, (over, B, S, mb, _) in TRAIN_MODELS.items():
        cfg = model_config(arch, FLASH, **over)
        shapes += [(B // mb * cfg.num_heads, S, cfg.head_dim, w)
                   for w in attn_windows(cfg)]
    for arch, (over, B, S) in PARITY_MODELS.items():
        cfg = model_config(arch, FLASH, **over)
        shapes += [(B * cfg.num_heads, S, cfg.head_dim, w)
                   for w in attn_windows(cfg)]
    shapes = tuple(dict.fromkeys(shapes + dryrun_train_flash_shapes()))
    check(RG_FLASH_SHAPE in shapes, f"{RG_FLASH_SHAPE} is not on the "
                                    f"training path")
    return shapes


def phase_model_kernels(np, torch, dev):
    """``flash_fwd`` and ``ssd_scan`` against their plain versions at the
    shapes the serving and training paths give them; returns the largest
    |diff| of each."""
    from repro_torch.kernels.flash_attn import flash_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    errs = {"flash_fwd": 0.0, "ssd_scan": 0.0}
    both = flash_fwd_shapes() + train_flash_shapes()
    # phase 27 (b)'s prefill cells run bf16: their shapes in bf16 alone
    # (the plain version a batch-head at a time at 32,768 positions)
    shapes = tuple(dict.fromkeys(both + dryrun_prefill_flash_shapes()))
    for BH, S, hd, window in shapes:
        scale = 1.0 / float(np.sqrt(hd))
        dtypes = (torch.float32, torch.bfloat16) if (BH, S, hd, window) \
            in both else (torch.bfloat16,)
        for dtype in dtypes:
            q, k, v = flash_inputs(np, torch, dev, rng, BH, S, hd, dtype)
            o, lse = flash_fwd(q, k, v, scale=scale, window=window)
            o_p, lse_p = flash_fwd_plain_rows(torch, q, k, v, scale, window)
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
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s over {len(shapes)} "
        f"flash shapes")
    return errs


def prefill_decode(torch, params, toks, cfg):
    """Prefill ``PARITY_PREFILL`` tokens through ``cfg``, then decode the
    rest one at a time; -> each step's logits [B, V]: the prefill's last,
    then each decode step's."""
    from repro_torch.models import transformer as MT
    from repro_torch.train import serve as SRV

    cache, last = SRV.make_prefill_step(cfg)(
        params, {"tokens": toks[:, :PARITY_PREFILL]})
    steps = [last[:, 0]]
    cache = SRV.pad_cache_to(cache, MT.cache_shapes(cfg, PARITY_B, PARITY_S))
    decode = SRV.make_decode_step(cfg)
    for t in range(PARITY_PREFILL, PARITY_S):
        cache, lg = decode(params, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    del cache, last
    return steps


def teacher_forcing(torch, params, toks, cfg, cfg_p):
    """:func:`prefill_decode` through ``cfg`` (the kernels), each step's
    logits against ``cfg_p``'s (the plain path's) train logits; -> each
    step's max |err|."""
    from repro_torch.models import transformer as MT

    lt, _, _ = MT.forward(params, {"tokens": toks}, cfg_p, mode="train")
    steps = prefill_decode(torch, params, toks, cfg)
    tf = [(lg - lt[:, t]).abs().max().item()
          for t, lg in zip(range(PARITY_PREFILL - 1, PARITY_S), steps)]
    del lt, steps
    return tf


def phase_model_parity(np, torch, dev):
    """Each model of ``MODELS`` at full width in f32 and at most
    ``PARITY_LAYERS`` layers (Qwen3-30B-A3B at 4): the kernel path's
    prefill logits and cache against the plain
    path's, and teacher forcing.  A MoE drops a token copy past an
    expert's capacity, ``max(4, ceil(t k cf / E))`` for the t tokens of
    one forward, so the train forward (1,024 tokens), the prefill (960)
    and a decode step (4) route alike only where none is dropped: its
    teacher forcing is held at ``cf = E / k`` (capacity t: no copy
    dropped in any mode); at the published factor the kernel path's
    prefill and decode logits are held to the plain path's, which drops
    the same copies."""
    from repro_torch.models import transformer as MT

    t0 = time.perf_counter()
    for i, (arch, (kern, plain)) in enumerate(MODELS.items()):
        cfg = model_config(arch, kern, dtype="float32", param_dtype="float32")
        cfg = cfg.with_(num_layers=min(cfg.num_layers, PARITY_LAYERS))
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
        torch.cuda.empty_cache()
        tcfg = cfg
        if cfg.num_experts:
            tcfg = cfg.with_(
                capacity_factor=cfg.num_experts / cfg.experts_per_token)
        tf = teacher_forcing(torch, params, toks, tcfg, tcfg.with_(**plain))
        check(max(tf) < TOL_TEACHER,
              f"{arch} teacher forcing: max |err| {max(tf):.3g} over "
              f"{TOL_TEACHER}")
        note = ""
        if cfg.num_experts:
            pairs = zip(prefill_decode(torch, params, toks, cfg),
                        prefill_decode(torch, params, toks, cfg_p))
            ok, e_pub = True, 0.0
            for a, b in pairs:
                ok = ok and torch.allclose(a, b, **TOL_MODEL)
                e_pub = max(e_pub, (a - b).abs().max().item())
            check(ok, f"{arch} prefill and decode at capacity factor "
                      f"{cfg.capacity_factor:g}, kernel path vs plain path: "
                      f"max |err| {e_pub:.3g} over {TOL_MODEL}")
            note = (f" at capacity factor {tcfg.capacity_factor:g} (E / k: "
                    f"no copy dropped); at the published "
                    f"{cfg.capacity_factor:g}, prefill {PARITY_PREFILL} and "
                    f"decode {PARITY_S - PARITY_PREFILL} through the kernels "
                    f"vs the plain path (the same copies dropped): max |err| "
                    f"{e_pub:.3g} (tolerance {TOL_MODEL['atol']})")
            del pairs
        errs_s = ", ".join(f"{k} {v:.3g}" for k, v in list(errs.items())[:8])
        if len(errs) > 8:
            errs_s += (f", ... ({len(errs)} entries, largest "
                       f"{max(errs.values()):.3g})")
        n_par = sum(v.numel() for v in params.values())
        log(f"{arch} f32 full width ({n_par / 1e6:.1f} M params, "
            f"{cfg.num_layers} layers): prefill of {PARITY_B} x {PARITY_S} "
            f"tokens through the kernels vs the plain path ("
            f"{ {**plain} }): max |err| {errs_s} (tolerance "
            f"{TOL_MODEL['atol']}); teacher forcing, prefill "
            f"{PARITY_PREFILL} then decode {PARITY_S - PARITY_PREFILL} vs "
            f"train logits: max |err| {max(tf):.3g} (tolerance "
            f"{TOL_TEACHER}){note}")
        del params
        torch.cuda.empty_cache()
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")


def serve_requests(torch, cfg, params, prompts, dev, kernel, ext=None):
    """Admit every prompt into a free slot of a fresh ContinuousBatcher
    (prefill, greedy first token, install) and tick until all have
    finished.  ``ext`` ([1, L, D] on the card, or None) is prepended to
    every prompt in its prefill, which then installs at position ``L +
    len(prompt)``.  Checks that ``kernel`` launched once per layer in each
    prefill, no counted kernel launched otherwise, and that every logit
    was finite.  Returns (requests, prefill s, decode s, tokens emitted by
    the ticks, ticks, wall s).  ``kernel`` launches once per layer that
    runs it (:func:`kernel_layers`)."""
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
    per_prefill = kernel_layers(cfg, kernel)
    n_ext = 0 if ext is None else ext.shape[1]
    reqs = [Request(i, p, SERVE_NEW) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_s = 0.0
    for req in reqs:
        before = read_counts()
        c0 = time.perf_counter()
        inputs = {"tokens": torch.from_numpy(req.prompt[None]).to(dev)}
        if ext is not None:
            inputs["ext_embed"] = ext
        cache1, last = prefill(params, inputs)
        first = int(torch.argmax(last[0, -1]))
        finite.append(bool(torch.isfinite(last).all()))
        b.install(b.free_slots()[0], cache1, n_ext + len(req.prompt), first,
                  req)
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - c0
        now = read_counts()
        delta = {key: now[key] - before[key] for key in now}
        want = {key: (per_prefill if key == kernel else 0) for key in now}
        check(delta == want, f"{cfg.name} prefill of {n_ext} + "
                             f"{len(req.prompt)}: launches {delta}, want "
                             f"{want}")
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


def phase_serving(np, torch, dev, smi):
    """Each model of ``SERVE_MODELS`` in bf16 at its published width and
    depth serves 4 requests through a ContinuousBatcher — the main path;
    Phi-3-Vision's each after the same seeded prefix of its 577 image
    embeddings.  Then the same under torch.profiler for the SMs' idle
    share (its tokens must equal the untraced run's), and prefill
    positions/s at batch 1 and ``PREFILL_S`` positions.  Logs the peak
    memory after ``init_params`` and over the model's whole run; each
    model's parameters are freed before the next is drawn.  Returns
    {kernel: launches on the main path, summed over the models}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as MT
    from repro_torch.train import serve as SRV

    t0 = time.perf_counter()
    launches = {}
    gib = 2 ** 30
    base = torch.cuda.memory_allocated()
    for i, (arch, kern) in enumerate(SERVE_MODELS.items()):
        cfg = model_config(arch, kern)
        kernel = model_kernel(kern)
        per_prefill = kernel_layers(cfg, kernel)
        held = torch.cuda.memory_allocated() - base
        check(held < gib, f"{arch}: {held / gib:.2f} GiB still held on "
                          f"the card before its parameters are drawn")
        torch.cuda.reset_peak_memory_stats()
        c0 = time.perf_counter()
        params = MT.init_params(
            cfg, torch.Generator(device=dev).manual_seed(200 + i), dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - c0
        init_peak = torch.cuda.max_memory_allocated()
        n_par = sum(v.numel() for v in params.values())
        par_bytes = sum(v.numel() * v.element_size() for v in params.values())
        rng = np.random.default_rng(40 + i)
        n_ext = cfg.ext_embed_len
        prompts = [rng.integers(0, cfg.vocab_size, n - n_ext)
                   for n in serve_positions(cfg)]
        ext = None
        if n_ext:
            ext = torch.from_numpy(rng.standard_normal(
                (1, n_ext, cfg.d_model)).astype(np.float32)).to(
                dev, cfg.act_dtype)
        prefix = {} if ext is None else {"ext_embed": ext}
        prefill = SRV.jit_prefill_step(cfg)
        prefill(params, {"tokens": torch.from_numpy(prompts[-1][None])
                         .to(dev), **prefix})                  # warm-up
        torch.cuda.synchronize()

        reset_counts()
        reqs, prefill_s, decode_s, emitted, ticks, wall = serve_requests(
            torch, cfg, params, prompts, dev, kernel, ext)
        counts = read_counts()
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        check(counts[kernel] == per_prefill * len(prompts),
              f"{arch}: {kernel} launched {counts[kernel]} times in the "
              f"serving run, want {per_prefill} x {len(prompts)}")
        what = f"prompts {tuple(len(p) for p in prompts)}"
        if n_ext:
            what += f" after {n_ext} image positions"
        log(f"{arch} bf16 serving ({smi}), {SERVE_SLOTS} slots, cache_len "
            f"{SERVE_CACHE}: {len(reqs)} requests ({what}) x {SERVE_NEW} "
            f"tokens in {wall:.3f} s; prefills {prefill_s:.3f} s, {ticks} "
            f"decode ticks {decode_s:.3f} s = {emitted / decode_s:.1f} "
            f"decode tokens/s; {kernel} {per_prefill} launches per prefill "
            f"({cfg.num_layers} layers), none in decode; launches {counts}; "
            f"first tokens {[r.out[:4] for r in reqs]}")

        c0 = time.perf_counter()
        # device records only, all log_card_busy reads: recording every
        # CPU-side op of a decode run made the run 2-4x as long
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reqs2, *_ = serve_requests(torch, cfg, params, prompts, dev,
                                       kernel, ext)
        traced_s = time.perf_counter() - c0
        log_card_busy(prof, wall, f"{arch} card over the serving phase")
        read_s = time.perf_counter() - c0 - traced_s
        check([r.out for r in reqs2] == [r.out for r in reqs],
              f"{arch}: the traced serving run's tokens differ from the "
              f"untraced run's")
        log(f"{arch}: traced serving run's tokens equal the untraced run's")

        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (1, PREFILL_S - n_ext))).to(dev)
        c0 = time.perf_counter()
        times = []
        for rep in range(4):                # one warm-up, 3 timed
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            cache, last = prefill(params, {"tokens": toks, **prefix})
            torch.cuda.synchronize()
            if rep:
                times.append(time.perf_counter() - c0)
            check(bool(torch.isfinite(last).all()),
                  f"{arch}: prefill of {PREFILL_S} not finite")
            del cache, last
        med = statistics.median(times)
        log(f"{arch} bf16 prefill at batch 1, {PREFILL_S} positions"
            f"{f' ({n_ext} of them image positions)' if n_ext else ''}: "
            f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s "
            f"= {PREFILL_S / med:.1f} positions/s ({smi})")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cache, last = prefill(params, {"tokens": toks, **prefix})
            torch.cuda.synchronize()
        log_card_busy(prof, med, f"{arch} prefill of {PREFILL_S} positions, "
                                 f"its longest device kernels",
                      ("flash_fwd" if kernel == "flash_fwd" else "ssd_",))
        del cache, last
        log(f"{arch} phase 13 steps: draw {init_s:.1f} s, serving "
            f"{wall:.1f} s, traced serving {traced_s:.1f} s and reading "
            f"its trace {read_s:.1f} s, the {PREFILL_S}-position prefills "
            f"and their trace {time.perf_counter() - c0:.1f} s")
        log(f"{arch} memory ({smi}): {n_par / 1e9:.3f} B parameters, "
            f"{par_bytes / gib:.2f} GiB in bf16; peak "
            f"{init_peak / gib:.2f} GiB after init_params, "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB over the "
            f"serving runs and the {PREFILL_S}-position prefill")
        del params, toks, ext, prefix
        torch.cuda.empty_cache()
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return launches


def flash_times(np, torch, dev, rng, shape):
    """``flash_fwd`` in bf16 at ``shape`` [BH, S, hd, window]: device and
    wrapper ms, the plain version (over chunks of batch-heads at long
    sequences), the bound, and SDPA causal on the same
    inputs ([1, BH, S, hd]: the 4-D layout PyTorch's fused attention
    backends take); with a window also SDPA given the window as a boolean
    mask (the kernel's function; SDPA has no window argument), the causal
    call then computing more than the kernel."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attn import flash_fwd, flash_fwd_plain

    bw, _, bf16 = card_peaks(torch.cuda.get_device_name(0))
    BH, S, hd, window = shape
    scale = 1.0 / float(np.sqrt(hd))
    q, k, v = flash_inputs(np, torch, dev, rng, BH, S, hd, torch.bfloat16)
    ms, wrap = kernel_times(
        torch, lambda: flash_fwd(q, k, v, scale=scale, window=window),
        "flash_fwd_wgmma_kernel", 20, require=True)
    # the plain version over chunks of batch-heads whose [n, S, S] scores
    # hold at most 2^30 elements: one call at 4,096 positions, one
    # batch-head a call at 32,768
    n = max(1, (1 << 30) // (S * S))
    plain = cuda_ms(torch, lambda: [
        flash_fwd_plain(q[i:i + n], k[i:i + n], v[i:i + n], scale=scale,
                        window=window) for i in range(0, BH, n)],
        3, repeats=3)
    o = flash_fwd(q, k, v, scale=scale, window=window)[0]
    q4, k4, v4 = q[None], k[None], v[None]
    lib = {"library_ms": cuda_ms(torch, lambda: sdpa(
        q4, k4, v4, is_causal=True, scale=scale), 20)}
    want = sdpa(q4, k4, v4, is_causal=True, scale=scale)[0]
    if window:
        pos = torch.arange(S, device=dev)
        band = (pos[:, None] >= pos[None, :]) \
            & (pos[:, None] - pos[None, :] < window)
        want = sdpa(q4, k4, v4, attn_mask=band, scale=scale)[0]
        lib["library_window_mask_ms"] = cuda_ms(torch, lambda: sdpa(
            q4, k4, v4, attn_mask=band, scale=scale), 20)
        del band
    check(torch.allclose(o.float(), want.float(), **TOL_FLASH_BF16),
          f"scaled_dot_product_attention disagrees with the kernel at "
          f"{list(shape)}")
    flops, nbytes = flash_work(BH, S, hd, window)
    b_ops, b_bytes = flops / bf16 * 1e3, nbytes / bw * 1e3
    bound = max(b_ops, b_bytes)
    sdpa_s = f"scaled_dot_product_attention causal {lib['library_ms']:.4f}"
    if window:
        sdpa_s += (f" (no window: all {S * (S + 1) // 2} causal pairs), with "
                   f"the window as a boolean mask "
                   f"{lib['library_window_mask_ms']:.4f}")
    log(f"flash_fwd [{BH}, {S}, {hd}] window {window} bf16: {ms:.4f} ms on "
        f"the card (wrapper {wrap:.4f}, plain {plain:.4f}, {sdpa_s}; bound "
        f"{bound:.4f} ms: {flops:.3g} FLOP at bf16 -> {b_ops:.4f} ms, "
        f"{nbytes / 1e6:.1f} MB -> {b_bytes:.4f} ms); "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.3f} of the bound, "
        f"{ms / lib['library_ms']:.2f}x SDPA causal")
    del q, k, v, o, want, q4, k4, v4
    torch.cuda.empty_cache()
    return {"shape": list(shape), "ms": ms, "wrapper_ms": wrap,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "tflops": flops / ms / 1e9, **lib}


def phase_model_timings(np, torch, dev, errs):
    """``flash_fwd`` and ``ssd_scan`` at the path's largest shapes: device
    time, wrapper time, plain version, bound, library; ``flash_fwd`` also
    at head_dim 256, 96 and 128 (:func:`flash_times`, under the entry's
    ``head_dims``) and at MiniCPM-2B's [36, 4,096, 64] (``wide_64``);
    returns their kernels-line entries, whose ``launches`` the serving
    phase fills."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    t0 = time.perf_counter()
    bw, fp32, _ = card_peaks(torch.cuda.get_device_name(0))
    rng = np.random.default_rng(50)
    # [15, 4,096, 64], head_dim 256 and 96 at their largest shapes, then
    # 128 at Qwen1.5-4B's 20 heads and 64 at MiniCPM-2B's 36
    fl = [flash_times(np, torch, dev, rng, shape) for shape in
          (FLASH_SHAPES[2], RG_FLASH_SHAPE, PHI3_FLASH_SHAPE,
           *WIDE_FLASH_SHAPES)]

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

    per_prefill = {kernel: kernel_layers(
        model_config(arch, MODELS[arch][0]), kernel) for arch, kernel in
        (("smollm_360m", "flash_fwd"), ("mamba2_780m", "ssd_scan"))}
    log(f"flash_fwd: {per_prefill['flash_fwd']} launches per SmolLM "
        f"prefill")
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
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    (ss_ms, ss_wrap, ss_plain, f1, n1), row = ss[1], ss[BHs]
    ss_b_ops, ss_b_bytes = f1 / fp32 * 1e3, n1 / bw * 1e3
    return [
        {"name": "flash_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attn.cu",
         "replaces": "src/repro/kernels/flash_attn.py:81",
         "launches": None, "max_abs_err": errs["flash_fwd"],
         **{key: fl[0][key] for key in ("ms", "wrapper_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
         "head_dims": {str(f["shape"][2]): f for f in fl[1:4]},
         "wide_64": fl[4]},
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


def shape_seed(base, shape):
    """A seed of ``shape``'s own, derived from ``base`` and the shape (as
    ``launch/dryrun.py``'s ``_seed`` derives one from a name), so that a
    shape added to a list moves no other shape's draws."""
    key = ",".join(str(int(x)) for x in shape)
    return (base * 1_000_003 + zlib.crc32(key.encode())) & ((1 << 63) - 1)


def bwd_shapes():
    """Phase 14's [BH, S, hd, window]: ``FLASH_SHAPES``, every shape of the
    training path and the ragged and one-position shapes at 96 and 256."""
    return tuple(dict.fromkeys(FLASH_SHAPES + train_flash_shapes()
                               + BWD_EDGE_SHAPES))


def plain_rows(torch, fn, args, S, max_elems=1 << 30, **kw):
    """A plain backward ``fn(*args, **kw)`` over chunks of the batch-heads
    (every argument's leading dimension) whose ``[n, S, S]`` tensors hold
    at most ``max_elems`` elements, each output concatenated; one call
    where the whole fits."""
    BH = args[0].shape[0]
    n = max(1, max_elems // (S * S))
    if n >= BH:
        return fn(*args, **kw)
    parts = [fn(*(a[i:i + n] for a in args), **kw) for i in range(0, BH, n)]
    return tuple(torch.cat(outs) for outs in zip(*parts))


def bwd_rel_l2(torch, a, b):
    """Relative L2 of ``a`` against ``b``, the denominator at least the
    norm of a tensor of ``TOL_FLASH_BWD``'s atol in every entry."""
    floor = TOL_FLASH_BWD["atol"] * math.sqrt(b.numel())
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / max(float(torch.linalg.vector_norm(b.float())), floor))


def phase_bwd_kernels(np, torch, dev):
    """``flash_bwd_dq`` and ``flash_bwd_dkv`` at each of :func:`bwd_shapes`,
    q, k, v and dO drawn from the shape's own seed (:func:`shape_seed`),
    first in f32, then in bf16 (the plain versions over chunks of
    batch-heads, :func:`plain_rows`): f32 results against
    ``flash_bwd_plain`` within ``TOL_FLASH_BWD``; bf16 results against the
    plain version's bf16 twin ``flash_bwd_plain_bf16`` within ``TOL_FLASH_BWD_EMUL`` (and,
    rounded to bf16, within ``TOL_FLASH_BWD_EMUL_L2`` relative L2) and
    against ``flash_bwd_plain`` (f32) within ``TOL_SDPA_BWD`` relative L2.
    Returns the largest |diff| of each kernel against its plain version
    (the f32 one for f32, the twin for bf16) and, under ``*_vs_f32``, of
    the bf16 results against the f32 plain version."""
    from repro_torch.kernels.flash_attn import (flash_bwd_dkv, flash_bwd_dq,
                                                flash_bwd_plain,
                                                flash_bwd_plain_bf16,
                                                flash_delta)

    t0 = time.perf_counter()
    errs = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
            "flash_bwd_dq_vs_f32": 0.0, "flash_bwd_dkv_vs_f32": 0.0}
    shapes = bwd_shapes()
    for shape in shapes:
        BH, S, hd, window = shape
        scale = 1.0 / float(np.sqrt(hd))
        kw = {"scale": scale, "window": window}
        rng = np.random.default_rng(shape_seed(70, shape))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, o, lse = flash_bwd_inputs(np, torch, dev, rng, BH, S,
                                                   hd, window, dtype)
            delta = flash_delta(o, do)
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
            f32 = plain_rows(torch, flash_bwd_plain,
                             (q.float(), k.float(), v.float(), o.float(), lse,
                              do.float()), S, **kw)
            bf16 = dtype == torch.bfloat16
            want = plain_rows(torch, flash_bwd_plain_bf16,
                              (q, k, v, do, lse, delta), S, **kw) \
                if bf16 else f32
            sync(torch, dev)
            got = {"dQ": dq, "dK": dk, "dV": dv}
            tol = TOL_FLASH_BWD_EMUL if bf16 else TOL_FLASH_BWD
            e = {n: (g.float() - w).abs().max().item()
                 for (n, g), w in zip(got.items(), want)}
            e32 = {n: (g.float() - w).abs().max().item()
                   for (n, g), w in zip(got.items(), f32)}
            rel = {n: bwd_rel_l2(torch, g, w)
                   for (n, g), w in zip(got.items(), f32)}
            rel_tw = {n: bwd_rel_l2(torch, g, w.to(dtype))
                      for (n, g), w in zip(got.items(), want)}
            what = (f"flash_bwd_dq / flash_bwd_dkv [{BH}, {S}, {hd}] window "
                    f"{window} {str(dtype)[6:]}")
            check(all(g.dtype == dtype and bool(torch.isfinite(g).all())
                      and torch.allclose(g.float(), w, **tol)
                      for g, w in zip(got.values(), want))
                  and (not bf16 or (max(rel.values()) < TOL_SDPA_BWD and
                                    max(rel_tw.values())
                                    < TOL_FLASH_BWD_EMUL_L2)),
                  f"{what}: max |err| {e} over {tol} against "
                  f"{'flash_bwd_plain_bf16' if bf16 else 'flash_bwd_plain'}"
                  f" (relative L2 against it rounded {rel_tw}); against the "
                  f"f32 plain max |err| {e32}, relative L2 {rel}")
            errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dQ"])
            errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e["dK"],
                                        e["dV"])
            line = (f"{what}: max |err| vs "
                    + ("the bf16 twin " if bf16 else "plain (f32) ")
                    + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
                    + f" (allclose rtol {tol['rtol']}, atol {tol['atol']})")
            if bf16:
                errs["flash_bwd_dq_vs_f32"] = max(errs["flash_bwd_dq_vs_f32"],
                                                  e32["dQ"])
                errs["flash_bwd_dkv_vs_f32"] = max(
                    errs["flash_bwd_dkv_vs_f32"], e32["dK"], e32["dV"])
                line += (", relative L2 vs the twin rounded to bf16 "
                         + ", ".join(f"{n} {x:.3g}" for n, x in rel_tw.items())
                         + f" (tolerance {TOL_FLASH_BWD_EMUL_L2})"
                         + "; vs plain (f32) max |err| "
                         + ", ".join(f"{n} {x:.3g}" for n, x in e32.items())
                         + ", relative L2 "
                         + ", ".join(f"{n} {x:.3g}" for n, x in rel.items())
                         + f" (tolerance {TOL_SDPA_BWD})")
            log(line)
            del q, k, v, do, o, lse, delta, dq, dk, dv, f32, want, got
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s over "
        f"{len(shapes)} shapes")
    return errs


def bwd_work(BH, S, hd, window):
    """(FLOP, bytes) of dQ and of dK/dV: three and four products of
    ``2 hd`` FLOP over the pairs the mask keeps; q, k, v, dO read and
    each output written once in bf16, LSE and delta read in f32
    (``flash_flops``)."""
    from repro_torch.kernels.flash_attn import flash_flops

    _, dq, dkv = flash_flops(BH, S, hd, window)
    t_bytes, row_bytes = BH * S * hd * 2, BH * S * 4
    ins = 4 * t_bytes + 2 * row_bytes
    return (dq, ins + t_bytes), (dkv, ins + 2 * t_bytes)


def bwd_times(np, torch, dev, rng, shape):
    """Both backward kernels in bf16 at ``shape`` [BH, S, hd, window]:
    {kernel: device and wrapper ms, plain ms, bound}, and the library:
    ``scaled_dot_product_attention``'s backward (its own forward, then
    the backward alone, timed as one call) causal and, with a window, also
    given the window as a boolean mask; the kernels' gradients held to
    SDPA's of the same function within ``TOL_SDPA_BWD``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attn import (flash_bwd, flash_bwd_dkv,
                                                flash_bwd_dkv_plain,
                                                flash_bwd_dq,
                                                flash_bwd_dq_plain,
                                                flash_delta)

    bw, _, bf16 = card_peaks(torch.cuda.get_device_name(0))
    BH, S, hd, window = shape
    scale = 1.0 / float(np.sqrt(hd))
    q, k, v, do, o, lse = flash_bwd_inputs(np, torch, dev, rng, BH, S, hd,
                                           window, torch.bfloat16)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta)
    kw = {"scale": scale, "window": window}
    out = {}
    for name, fn, plain, (flops, nbytes) in zip(
            ("flash_bwd_dq", "flash_bwd_dkv"), (flash_bwd_dq, flash_bwd_dkv),
            (flash_bwd_dq_plain, flash_bwd_dkv_plain),
            bwd_work(BH, S, hd, window)):
        ms, wrap = kernel_times(torch, lambda: fn(*args, **kw),
                                f"{name}_wgmma_kernel", 10, require=True)
        b_ops, b_bytes = flops / bf16 * 1e3, nbytes / bw * 1e3
        out[name] = {
            "shape": list(shape), "ms": ms, "wrapper_ms": wrap,
            "plain_ms": cuda_ms(torch, lambda: plain(*args, **kw), 2,
                                repeats=3),
            "bound_ms": max(b_ops, b_bytes),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "bound_ops_ms": b_ops,
            "bound_bytes_ms": b_bytes, "tflops": flops / ms / 1e9}
    whole = cuda_ms(torch, lambda: flash_bwd(q, k, v, o, lse, do, **kw), 10)
    ours = flash_bwd(q, k, v, o, lse, do, **kw)
    # the library: [1, BH, S, hd], the layout of PyTorch's fused backends
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    do4 = do[None]
    lib, rel = {}, None
    variants = [("library_ms", {"is_causal": True})]
    if window:
        pos = torch.arange(S, device=dev)
        band = (pos[:, None] >= pos[None, :]) \
            & (pos[:, None] - pos[None, :] < window)
        variants.append(("library_window_mask_ms", {"attn_mask": band}))
    for key, mask_kw in variants:
        o4 = sdpa(q4, k4, v4, scale=scale, **mask_kw)
        g = torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
        if key == variants[-1][0]:          # the kernels' own function
            rel = [rel_l2(torch, a, b[0]) for a, b in zip(ours, g)]
        lib[key] = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), 10)
        del o4, g
    check(max(rel) < TOL_SDPA_BWD, f"the SDPA backward disagrees with the "
                                   f"kernels at {list(shape)}: relative L2 "
                                   f"{rel}")
    sdpa_s = f"scaled_dot_product_attention's backward causal " \
             f"{lib['library_ms']:.4f} ms"
    if window:
        sdpa_s += (f" (no window: all {S * (S + 1) // 2} causal pairs), with "
                   f"the window as a boolean mask "
                   f"{lib['library_window_mask_ms']:.4f} ms")
    for name, e in out.items():
        e.update(lib)
        log(f"{name} {list(shape)} bf16: {e['ms']:.4f} ms on the card "
            f"(wrapper {e['wrapper_ms']:.4f}, plain {e['plain_ms']:.4f}, "
            f"bound {e['bound_ms']:.4f} ms: {e['flops']:.3g} FLOP at bf16 "
            f"-> {e['bound_ops_ms']:.4f} ms, {e['bytes'] / 1e6:.1f} MB -> "
            f"{e['bound_bytes_ms']:.4f} ms); {e['tflops']:.2f} TFLOP/s, "
            f"{e['bound_ms'] / e['ms']:.3f} of the bound, "
            f"{e['ms'] / lib['library_ms']:.2f}x SDPA's whole causal "
            f"backward")
    log(f"flash backward {list(shape)} bf16, both kernels and delta "
        f"through flash_bwd: {whole:.4f} ms; {sdpa_s} (relative L2 against "
        f"the kernels: dQ {rel[0]:.3g}, dK {rel[1]:.3g}, dV {rel[2]:.3g})")
    del q, k, v, do, o, lse, delta, args, ours, q4, k4, v4, do4
    torch.cuda.empty_cache()
    return out


def phase_bwd_timings(np, torch, dev, errs):
    """Both backward kernels in bf16 at [15, 4,096, 64] and, under each
    entry's ``head_dims``, at [10, 4,096, 256] with window 2,048,
    [32, 4,096, 96] and [20, 4,096, 128] (phase 11's shapes): device time,
    wrapper time, plain version, bound, and the SDPA backward
    (:func:`bwd_times`); returns their kernels-line entries, whose
    ``launches`` the training phase fills."""
    rng = np.random.default_rng(80)
    t0 = time.perf_counter()
    runs = [bwd_times(np, torch, dev, rng, shape) for shape in
            (FLASH_SHAPES[2], RG_FLASH_SHAPE, PHI3_FLASH_SHAPE,
             WIDE_FLASH_SHAPES[0])]
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    keys = ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
             "replaces": ("src/repro/kernels/flash_attn.py:183"
                          if name == "flash_bwd_dq"
                          else "src/repro/kernels/flash_attn.py:200"),
             "launches": None, "max_abs_err": errs[name],
             "max_abs_err_bf16_vs_f32": errs[f"{name}_vs_f32"],
             **{key: runs[0][name][key] for key in keys},
             "head_dims": {str(r[name]["shape"][2]): r[name]
                           for r in runs[1:]}}
            for name in ("flash_bwd_dq", "flash_bwd_dkv")]


def rel_l2(torch, a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.clamp(torch.linalg.vector_norm(b.float()), min=1e-30))


def no_drop(cfg):
    """A MoE at capacity factor E / k (capacity t: no token copy dropped,
    so two paths whose router logits differ in the last bits route alike
    wherever no tie is that close); other models as they are."""
    if not cfg.num_experts:
        return cfg
    return cfg.with_(capacity_factor=cfg.num_experts / cfg.experts_per_token)


def train_batch(torch, dev, cfg, tokens, labels, gen):
    """A train batch of ``cfg`` on ``dev`` from tokens and labels
    [B, S - L]: a model with L = ``ext_embed_len`` image positions (the
    frontend's stub) gets ``ext_embed`` [B, L, D] drawn from N(0, 1) by
    ``gen`` in the activation type, before the tokens, and labels
    ``IGNORE`` there, so that labels are [B, S]."""
    from repro_torch.train.step import IGNORE

    batch = {"tokens": torch.as_tensor(tokens).to(dev),
             "labels": torch.as_tensor(labels).to(dev)}
    L = cfg.ext_embed_len
    if L:
        B = batch["tokens"].shape[0]
        batch["ext_embed"] = torch.randn(
            B, L, cfg.d_model, generator=gen, device=dev).to(cfg.act_dtype)
        batch["labels"] = torch.cat(
            [torch.full((B, L), IGNORE, dtype=batch["labels"].dtype,
                        device=dev), batch["labels"]], dim=1)
    return batch


def grad_parity(np, torch, dev, arch, over, B, S, seed):
    """One f32 ``make_train_step`` of ``arch`` (``over`` applied, a MoE at
    :func:`no_drop`) on a seeded B x S batch, through the flash kernels
    and through the naive path, from the same parameters: the loss within
    ``TOL_TRAIN_LOSS`` relative, every gradient leaf finite, non-zero and
    within ``TOL_TRAIN_GRAD`` relative L2, the flash launches one of each
    kernel an attention layer.  The kernel path's gradients wait on the
    host while the naive path runs.  Returns a dict: the config, params
    and batch, both losses and their relative difference, {leaf: relative
    L2}, the launches and the peak of allocated bytes."""
    from repro_torch.models import transformer as MT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = no_drop(model_config(arch, FLASH, dtype="float32",
                               param_dtype="float32", remat="none", **over))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = MT.init_params(cfg, gen, dev)
    rng = np.random.default_rng(seed)
    L = cfg.ext_embed_len
    tl = [rng.integers(0, cfg.vocab_size, (B, S - L)).astype(np.int32)
          for _ in range(2)]
    batch = train_batch(torch, dev, cfg, *tl, gen)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    loss_f, _, g_f = make_train_step(cfg, OptConfig()).grads(params, batch)
    sync(torch, dev)
    counts = read_counts()
    n = kernel_layers(cfg, "flash_fwd")
    want = {k: n if k.startswith("flash_") and dev.type == "cuda" else 0
            for k in counts}
    check(counts == want, f"{arch} f32 flash train step: launches {counts}, "
                          f"want {want}")
    g_f = {k: g.cpu() for k, g in g_f.items()}
    loss_n, _, g_n = make_train_step(
        cfg.with_(attn_impl="naive"), OptConfig()).grads(params, batch)
    sync(torch, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    check(set(g_f) == set(g_n) == set(params),
          f"{arch} gradient leaves {sorted(g_f)} vs {sorted(params)}")
    dl = abs(float(loss_f) - float(loss_n)) / abs(float(loss_n))
    check(dl < TOL_TRAIN_LOSS, f"{arch} f32 loss flash {float(loss_f)} vs "
                               f"naive {float(loss_n)}: {dl:.3g} relative")
    errs = {}
    for key in list(g_n):
        g, ref = g_f.pop(key).to(dev), g_n.pop(key)
        fin = bool(torch.isfinite(g).all())
        nz = float(g.abs().max()) > 0
        errs[key] = rel_l2(torch, g, ref)
        check(fin and nz and errs[key] < TOL_TRAIN_GRAD,
              f"{arch} f32 gradient {key}: finite {fin}, non-zero {nz}, "
              f"relative L2 vs naive {errs[key]:.3g} (tolerance "
              f"{TOL_TRAIN_GRAD})")
        del g, ref
    check(sum(k.endswith(("_wq", "_wk", "_wv")) for k in errs) == 3,
          f"{arch}: no wq/wk/wv among {sorted(errs)}")
    return {"cfg": cfg, "params": params, "batch": batch,
            "loss": float(loss_f), "loss_naive": float(loss_n), "rel": dl,
            "errs": errs, "counts": counts, "peak": peak}


def phase_train_parity(np, torch, dev):
    """Each model of ``PARITY_MODELS`` at full width in f32: one train
    step's loss and gradients through the flash kernels against the naive
    path's (:func:`grad_parity`), and SmolLM-360M's AdamW step; then
    Mamba-2 780M's kernel path refuses a gradient."""
    from repro_torch.kernels.ssd_scan import SsdScanGradError
    from repro_torch.models import transformer as MT
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    for i, (arch, (over, B, S)) in enumerate(PARITY_MODELS.items()):
        t0 = time.perf_counter()
        r = grad_parity(np, torch, dev, arch, over, B, S, 300 + i)
        cfg, params, errs, loss = r["cfg"], r["params"], r["errs"], r["loss"]
        named = {k: errs[k] for k in errs
                 if k.endswith(("_wq", "_wk", "_wv"))}
        note = ""
        if arch == "smollm_360m":
            step = make_train_step(cfg, OptConfig())
            state, m = step({"params": params, "opt": step.init_opt(params),
                             "step": 0}, r["batch"])
            check(abs(float(m["loss"]) - loss) <= 1e-6 * abs(loss)
                  and all(bool(torch.isfinite(t).all())
                          for t in state["params"].values()),
                  f"f32 AdamW step: loss {float(m['loss'])} vs {loss}")
            note = f"; AdamW step grad norm {float(m['grad_norm']):.4f}"
            del state
        extra = ""
        if cfg.ext_embed_len:
            extra += f", {cfg.ext_embed_len} of them image positions"
        if cfg.num_experts:
            extra += f", capacity factor {cfg.capacity_factor:g} (E / k)"
        n_par = sum(v.numel() for v in params.values())
        log(f"{arch} f32 full width ({n_par / 1e6:.1f} M params, "
            f"{cfg.num_layers} layers, {kernel_layers(cfg, 'flash_fwd')} "
            f"attention), train step on {B} x {S} positions{extra} (remat "
            f"none): loss flash {loss:.6f} vs naive {r['loss_naive']:.6f} "
            f"({r['rel']:.3g} relative, tolerance {TOL_TRAIN_LOSS}); "
            f"gradients relative L2 "
            f"vs naive, max {max(errs.values()):.3g} over {len(errs)} leaves "
            f"(tolerance {TOL_TRAIN_GRAD}): "
            + ", ".join(f"{k} {v:.3g}" for k, v in named.items())
            + f"; every leaf finite and non-zero; launches "
            f"{ {k: v for k, v in r['counts'].items() if v} }; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB{note}; "
            f"{time.perf_counter() - t0:.1f} s")
        del r, params
        torch.cuda.empty_cache()

    rng = np.random.default_rng(60)

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
    log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")


def train_launches_per_step(cfg, mb=TRAIN_MB):
    """The flash launches of one bf16 train step in ``mb`` microbatches
    with block remat: each attention layer's forward twice (the
    recomputation), each backward kernel once, per microbatch
    (RecurrentGemma-2B: 8 of its 26 layers)."""
    n = kernel_layers(cfg, "flash_fwd")
    return {"flash_fwd": n * 2 * mb, "flash_bwd_dq": n * mb,
            "flash_bwd_dkv": n * mb}


def train_setup(arch, over, mb):
    """Phase 17's config and step of ``arch`` (``over`` applied): bf16 at
    full width through the flash kernels, ``remat="block"``, AdamW with
    f32 state at a constant rate, the state donated, ``mb``
    microbatches."""
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = model_config(arch, FLASH, remat="block", **over)
    opt = OptConfig(lr=1e-3, schedule="constant", warmup_steps=1,
                    state_dtype="float32")
    return cfg, make_train_step(cfg, opt, microbatches=mb, donate=True)


def train_meta_peak(torch, cfg, step, B, S):
    """``step`` of :func:`train_setup` run once on meta tensors (a fresh
    state of ``cfg``: parameters in ``init_params``' sorted order, which
    the donated update follows leaf by leaf, the optimizer's moments, a
    B x S batch with ``train_batch``'s keys) under ``launch/dryrun.py``'s
    ``LiveBytes``: -> (bytes of the arguments, peak live bytes over the
    step, the arguments included).  The kernels take their meta launches
    (``kernels/meta.py``), so the count of launches does not move."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.models import transformer as MT

    params = {k: torch.empty(sp.shape, dtype=sp.dtype, device="meta")
              for k, sp in sorted(MT.param_shapes(cfg).items())}
    state = {"params": params, "opt": step.init_opt(params), "step": 0}
    del params
    L = cfg.ext_embed_len
    batch = {"tokens": torch.empty(B, S - L, dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty(B, S, dtype=torch.int32, device="meta")}
    if L:
        batch["ext_embed"] = torch.empty(B, L, cfg.d_model,
                                         dtype=cfg.act_dtype, device="meta")
    mem = LiveBytes("meta")
    args = sum(mem.track(t) for t in pytree.tree_leaves((state, batch)))
    with mem:
        state, _ = step(state, batch)
    del state
    return args, mem.peak


def train_meta_estimate(arch):
    """:func:`train_meta_peak` of ``TRAIN_MODELS[arch]``'s step, for a
    worker process: -> (argument bytes, peak bytes, seconds)."""
    import torch

    t0 = time.perf_counter()
    over, B, S, mb, _ = TRAIN_MODELS[arch]
    cfg, step = train_setup(arch, over, mb)
    return (*train_meta_peak(torch, cfg, step, B, S),
            time.perf_counter() - t0)


def train_model(np, torch, dev, arch, over, B, S, mb, steps, seed, smi,
                estimate):
    """``arch`` (``over`` applied) trained in bf16 through the flash kernels
    — ``remat="block"``, AdamW with f32 state, the state donated to the
    step, B x S batches in ``mb`` microbatches from ``data.Loader`` (a
    model with image positions gets its ``ext_embed`` stub,
    :func:`train_batch`): ``steps`` = (warm-up, timed, one-batch) steps,
    each step's launches equal to :func:`train_launches_per_step` and its
    loss finite; the timed steps' time, tokens/s and peak memory, a
    traced step's idle share and flash kernel times; then the one-batch
    steps, whose loss must fall.  The peak is held to ``TRAIN_PEAK_RATIO``
    of the same step's estimate on meta tensors (``estimate``, a pending
    result of :func:`train_meta_estimate`) plus what the card held before
    the model; ``smi`` is the card's name and power limit.  Returns
    {kernel: launches in the timed steps}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import Loader, TokenDataset
    from repro_torch.models import transformer as MT

    t_model = time.perf_counter()
    warm, timed, fit_steps = steps
    cfg, step = train_setup(arch, over, mb)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    else:
        held = 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = MT.init_params(cfg, gen, dev)
    n_par = sum(v.numel() for v in params.values())
    state = {"params": params, "opt": step.init_opt(params), "step": 0}
    del params
    L = cfg.ext_embed_len
    loader = Loader(TokenDataset(cfg.vocab_size, seed=7), shard_id=0,
                    n_shards=1, batch_per_shard=B, seq_len=S - L)
    per_step = train_launches_per_step(cfg, mb)

    def batch_on_card():
        _, b = next(loader)
        return train_batch(torch, dev, cfg, b["tokens"], b["labels"], gen)

    def one_step(state, batch):
        before = read_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(torch, dev)
        dt = time.perf_counter() - t0
        now = read_counts()
        delta = {k: now[k] - before[k] for k in now}
        want = {k: per_step.get(k, 0) if dev.type == "cuda" else 0
                for k in now}
        check(delta == want, f"{arch} train step launches {delta}, want "
                             f"{want}")
        check(np.isfinite(float(m["loss"])), f"{arch} loss "
                                             f"{float(m['loss'])}")
        return state, m, dt

    try:
        for _ in range(warm):
            state, m, _ = one_step(state, batch_on_card())
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        times, losses = [], []
        for _ in range(timed):
            state, m, dt = one_step(state, batch_on_card())
            times.append(dt)
            losses.append(float(m["loss"]))
        launches = read_counts()
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        med = statistics.median(times)
        tokens = B * S
        image = f" ({L} image positions a row)" if L else ""
        est_args, est_peak, est_s = estimate.get(timeout=600)
        est = held + est_peak
        log(f"{arch} bf16 training, {cfg.num_layers} layers "
            f"({kernel_layers(cfg, 'flash_fwd')} attention), "
            f"{n_par / 1e9:.3f} B params, batch {B} x {S}{image} in {mb} "
            f"microbatches, remat block, AdamW f32 state: {timed} steps of "
            + ", ".join(f"{t:.4f}" for t in times)
            + f" s, median {med:.4f} s = {tokens / med:.1f} tokens/s; peak "
            f"memory {peak / 2**30:.2f} GiB ({peak} B) against the meta "
            f"estimate {est / 2**30:.2f} GiB ({est} B: {held} B held before "
            f"the model, the step's arguments {est_args} B, its peak "
            f"{est_peak} B; {est_s:.1f} s on meta), ratio "
            f"{peak / est:.4f}; {smi}; losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; launches per step {per_step}, in the timed steps "
            f"{ {k: v for k, v in launches.items() if v} }")
        lo, hi = TRAIN_PEAK_RATIO
        check(dev.type != "cuda" or lo <= peak / est <= hi,
              f"{arch}: measured peak / meta estimate {peak / est:.4f} "
              f"outside [{lo}, {hi}]")
        batch = batch_on_card()
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, m, dt = one_step(state, batch)
            idle = log_card_busy(prof, med,
                                 f"{arch} card over a traced train step",
                                 ("flash_fwd_wgmma_kernel",
                                  "flash_bwd_dq_wgmma_kernel",
                                  "flash_bwd_dkv_wgmma_kernel"))
            TRAIN_STATS[arch] = (med, idle)
            log(f"{arch} traced step {dt:.4f} s (untraced median "
                f"{med:.4f} s)")
        fit = []
        for _ in range(fit_steps):
            state, m, _ = one_step(state, batch)
            fit.append(float(m["loss"]))
        check(fit[-1] < fit[0], f"{arch}: loss on one batch did not fall: "
                                f"{fit}")
        log(f"{arch}: {fit_steps} steps on one batch: loss "
            + ", ".join(f"{x:.4f}" for x in fit)
            + f"; {time.perf_counter() - t_model:.1f} s for the model")
    finally:
        loader.close()
    del state, batch
    torch.cuda.empty_cache()
    return launches


def phase_training(np, torch, dev, smi):
    """bf16 training at published width through the flash kernels, the
    training path: each model of ``TRAIN_MODELS`` (:func:`train_model`),
    its peak beside its meta estimate (``TRAIN_META_WORKERS`` processes
    compute every model's while the card trains) and the card's name and
    power limit; returns {arch: {kernel: launches in its timed steps}}."""
    import multiprocessing

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(
            TRAIN_META_WORKERS, initializer=_dryrun_worker,
            initargs=(str(ROOT / "src"),)) as pool:
        pending = {arch: pool.apply_async(train_meta_estimate, (arch,))
                   for arch in TRAIN_MODELS}
        out = {arch: train_model(np, torch, dev, arch, over, B, S, mb, steps,
                                 400 + i, smi, pending[arch])
               for i, (arch, (over, B, S, mb, steps))
               in enumerate(TRAIN_MODELS.items())}
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------ sharded training (phase 26)

# (a) SmolLM-360M through ``repro_torch.launch.train`` on a one-rank NCCL
# (1, 1) mesh at phase 17's batch, length and microbatches: LAUNCH_STEPS
# steps with a checkpoint every LAUNCH_RESUME_AT, then a second launcher
# resumed from that step.  (b) the MoE's expert-parallel branch: Qwen3 at
# phase 17's 4 of 48 layers, one forward and backward under the mesh.
LAUNCH_ARCH, LAUNCH_STEPS, LAUNCH_RESUME_AT = "smollm_360m", 8, 4
LAUNCH_TURNS = 4      # (sharded, direct) step pairs timed in turns
LAUNCH_MOE = ("qwen3_moe_30b_a3b", {"num_layers": 4}, 4, 2048, 2)


def launcher_argv(arch, ckpt, steps, every, shape, reduced, dev):
    B, S, mb = shape
    return (["--arch", arch, "--mesh", "host", "--steps", str(steps),
             "--batch", str(B), "--seq", str(S), "--microbatches", str(mb),
             "--ckpt", str(ckpt), "--ckpt-every", str(every), "--device",
             dev.type] + (["--reduced"] if reduced else []))


def dtensor_placed(torch, state, shardings):
    """Whether every tensor leaf of ``state`` is a DTensor with its
    sharding's placements (ints stay ints)."""
    from torch.distributed.tensor import DTensor

    if isinstance(state, dict):
        return all(dtensor_placed(torch, v, shardings[k])
                   for k, v in state.items())
    if isinstance(state, torch.Tensor):
        return (isinstance(state, DTensor)
                and tuple(state.placements) == tuple(shardings.placements))
    return isinstance(state, int)


def local_leaves(state):
    """{path: leaf} of a state, DTensors by their local tensors (the whole
    tensor at world size 1)."""
    return {k: (v.to_local() if hasattr(v, "to_local") else v)
            for k, v in state_leaves(state)}


def launcher_run(np, torch, dev, smi, ckpt_dir, *, arch=LAUNCH_ARCH,
                 reduced=False, shape=(TRAIN_B, TRAIN_S, TRAIN_MB),
                 steps=LAUNCH_STEPS, resume_at=LAUNCH_RESUME_AT):
    """Phase 26 (a): ``launch.train.main`` at ``arch``'s full width in bf16
    (flash attention, block remat, AdamW with f32 state, the state
    donated) over the one-rank group's (1, 1) mesh, ``steps`` steps with
    a checkpoint every ``resume_at``; then a second launcher resumed from
    step ``resume_at`` (``restore(placements=)``) for the rest.  Gates:
    every state leaf a DTensor with the rules' placements; the first
    run's losses and final state equal, bit for bit, ``make_train_step``
    applied directly to the same seeded state and batches (at world size
    1 the sharded step changes no number); the resumed run's losses and
    final state equal the first run's bit for bit; the flash launches of
    each step phase 17's.  Then ``LAUNCH_TURNS`` pairs of one sharded
    step (``make_sharded_step``) and one direct step, in turns from the
    two runs' equal states on the same batches, each ended by its loss
    read back, their losses equal bit for bit: the sharded step's cost
    at world size 1.  One more sharded step is traced for the SMs' idle
    share of the untraced median step, as phase 17's.  ``reduced`` and
    ``shape`` shrink it for a CPU run.  Returns the first run's flash
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import Loader, TokenDataset
    from repro_torch.launch import train as LT
    from repro_torch.parallel import sharding as SH
    from repro_torch.train.step import make_train_step, train_state_specs

    B, S, mb = shape
    cfg = LT.train_config(arch, reduced, dev)
    opt = LT.opt_config(steps)
    per_step = train_launches_per_step(cfg, mb)
    want = {k: steps * per_step.get(k, 0) if dev.type == "cuda" else 0
            for k in read_counts()}
    nb = state_bytes(cfg)
    free = shutil.disk_usage(ckpt_dir).free
    need = 3 * nb["total"] + (1 << 30)    # steps 4 and 8, the resumed 8
    check(free >= need, f"launcher checkpoints need {need / 1e9:.2f} GB, "
                        f"{free / 1e9:.2f} GB free under {ckpt_dir}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    first = LT.main(launcher_argv(arch, ckpt_dir / "run", steps, resume_at,
                                  shape, reduced, dev))
    wall1 = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    check(counts == want, f"launcher launches {counts}, want {want} "
                          f"({steps} steps of {per_step})")
    shapes, axes = train_state_specs(cfg, opt)
    state_sh = SH.tree_shardings(axes, shapes, first["mesh"])
    check(dtensor_placed(torch, first["state"], state_sh),
          "a launcher state leaf is not a DTensor with the rules' placements")

    step = make_train_step(cfg, opt, microbatches=mb, donate=True)
    state = LT.init_state(cfg, step, dev)
    loader = Loader(TokenDataset(cfg.vocab_size, seed=0), shard_id=0,
                    n_shards=1, batch_per_shard=B, seq_len=S)
    direct, direct_times = [], []
    try:
        for _ in range(steps):
            t1 = time.perf_counter()
            _, b = next(loader)
            state, m = step(state, b)
            direct.append(float(m["loss"]))      # waits for the step
            direct_times.append(time.perf_counter() - t1)
    finally:
        loader.close()
    times = first["times"]
    got = local_leaves(first["state"])
    same = all(bit_equal(torch, got[k], v)
               for k, v in state_leaves(state))
    check(first["losses"] == direct and same,
          f"launcher losses {first['losses']} vs the direct step's {direct}; "
          f"final state bit for bit {same}")

    resume = ckpt_dir / "resume"
    shutil.copytree(ckpt_dir / "run" / f"step_{resume_at}",
                    resume / f"step_{resume_at}")
    shutil.rmtree(ckpt_dir / "run")
    second = LT.main(launcher_argv(arch, resume, steps - resume_at, steps,
                                   shape, reduced, dev))
    again = local_leaves(second["state"])
    same = all(bit_equal(torch, again[k], v) for k, v in got.items())
    check(second["losses"] == first["losses"][resume_at:] and same,
          f"resumed losses {second['losses']} vs "
          f"{first['losses'][resume_at:]}; final state bit for bit {same}")
    shutil.rmtree(resume)
    del got, again

    # the sharded step and the direct one in turns, on the same batches
    jstep = LT.make_sharded_step(step, second["mesh"], state_sh)
    placed = second["state"]
    del first, second
    ds = TokenDataset(cfg.vocab_size, seed=0)

    def timed(fn, st, b):
        sync(torch, dev)
        t1 = time.perf_counter()
        st, m = fn(st, b)
        return st, float(m["loss"]), time.perf_counter() - t1

    turns = {"sharded": [], "direct": []}
    for i in range(steps, steps + LAUNCH_TURNS):
        b = ds.batch(i, 0, 1, B, S)
        placed, loss_s, t_s = timed(jstep, placed, b)
        state, loss_d, t_d = timed(step, state, b)
        check(loss_s == loss_d, f"in turns, step {i + 1}: sharded loss "
                                f"{loss_s} vs direct {loss_d}")
        turns["sharded"].append(t_s)
        turns["direct"].append(t_d)
    del state

    # one more sharded step, traced: launches and the SMs' idle share
    b = ds.batch(steps + LAUNCH_TURNS, 0, 1, B, S)
    state = placed
    med = statistics.median(times[1:])
    med_direct = statistics.median(direct_times[1:])
    reset_counts()
    idle = None
    if dev.type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = jstep(state, b)
            float(m["loss"])
        idle = log_card_busy(prof, med, f"{arch} card over a traced "
                             f"launcher step", ("flash_fwd_wgmma_kernel",
                                                "flash_bwd_dq_wgmma_kernel",
                                                "flash_bwd_dkv_wgmma_kernel"))
    else:
        state, m = jstep(state, b)
    one = read_counts()
    check(one == {k: per_step.get(k, 0) if dev.type == "cuda" else 0
                  for k in one}, f"a traced launcher step launched {one}")
    del state
    med17, idle17 = TRAIN_STATS.get(arch, (float("nan"), None))
    idle17 = "not measured" if idle17 is None else f"{idle17:.4f}"
    log(f"{arch} through launch.train on the one-rank (1, 1) mesh on {smi}: "
        f"{steps} steps of {B} x {S} in {mb} microbatches, steps of "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s, median after the first {med:.4f} s = {B * S / med:.1f} "
        f"tokens/s; the direct step's here "
        + ", ".join(f"{t:.4f}" for t in direct_times)
        + f" s, median after the first {med_direct:.4f} s (phase 17's: "
        f"{med17:.4f} s, idle {idle17}); peak memory "
        f"{peak / 2**30:.2f} GiB; the run {wall1:.1f} s with checkpoints "
        f"after steps {resume_at} and {steps}; losses "
        + ", ".join(f"{x:.4f}" for x in direct)
        + f" equal to the direct step's bit for bit, the resumed run's too; "
        f"launches { {k: v for k, v in counts.items() if v} }; "
        f"{LAUNCH_TURNS} pairs in turns, sharded "
        + ", ".join(f"{t:.4f}" for t in turns["sharded"])
        + f" s (median {statistics.median(turns['sharded']):.4f}), direct "
        + ", ".join(f"{t:.4f}" for t in turns["direct"])
        + f" s (median {statistics.median(turns['direct']):.4f}), losses "
        f"equal bit for bit")
    return {"launches": counts, "losses": direct, "med": med,
            "med_direct": med_direct, "peak": peak, "idle": idle,
            "turns": turns}


def moe_mesh_branch(np, torch, dev, cfg, B, S, mb, seed):
    """Phase 26 (b): one forward and backward of ``cfg`` (a MoE) on a
    seeded B x S batch in ``mb`` microbatches, under
    ``sharding_context(make_host_mesh())`` — the expert-parallel ``a2a``
    path, its two ``all_to_all`` a layer over the one-rank group in the
    forward, the backward and the remat recompute — and
    without a mesh (the dense fallback), from the same parameters: loss
    and every gradient equal in value (``torch.equal``).  Returns the
    ``all_to_all`` calls, the mesh run's wall seconds, and the mesh run's
    loss."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as MT
    from repro_torch.parallel.sharding import sharding_context
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = MT.init_params(cfg, gen, dev)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int64)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, OptConfig(), mb)
    loss_d, _, g_d = step.grads(params, batch)
    calls = []
    real = dist.all_to_all_single

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    dist.all_to_all_single = counted
    try:
        mesh = make_host_mesh(dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        with sharding_context(mesh):
            loss_a, _, g_a = step.grads(params, batch)
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        dist.all_to_all_single = real
    # two a MoE layer and microbatch in the forward, in the backward, and
    # in the remat recompute (run under the forward's mesh)
    n_moe = sum(k == "attn_moe" for k in cfg.layer_kinds)
    want = (4 if cfg.remat == "none" else 6) * n_moe * mb
    check(len(calls) == want,
          f"the mesh run made {len(calls)} all_to_all calls, want {want} "
          f"(two a MoE layer and microbatch forward, two backward, two in "
          f"the remat recompute)")
    diff = {k: float((g.float() - g_d[k].float()).abs().max())
            for k, g in g_a.items()}
    check(torch.equal(loss_a, loss_d) and all(
        torch.equal(g, g_d[k]) for k, g in g_a.items()),
        f"MoE a2a branch vs dense: loss {float(loss_a)} vs {float(loss_d)}; "
        f"gradients max |diff| {max(diff.values()):.3g} "
        f"({sorted(diff.items(), key=lambda kv: -kv[1])[:3]})")
    return {"calls": len(calls), "wall": wall, "loss": float(loss_a),
            "leaves": len(g_a)}


def phase_launcher(np, torch, dev, smi):
    """Phase 26: sharded training through the launcher on a one-rank NCCL
    group (set up here, torn down after): (a) :func:`launcher_run` at
    SmolLM-360M's full width, checkpoints under ``build/`` removed after;
    (b) :func:`moe_mesh_branch` for Qwen3-30B-A3B at 4 of 48 layers.
    Returns (a)'s flash launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_one_rank_group

    t_phase = time.perf_counter()
    ckpt_dir = ROOT / "build" / "chip_smoke_launch"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    init_one_rank_group(dev)
    try:
        run = launcher_run(np, torch, dev, smi, ckpt_dir)
        torch.cuda.empty_cache()
        arch, over, B, S, mb = LAUNCH_MOE
        cfg = model_config(arch, FLASH, remat="block", **over)
        moe = moe_mesh_branch(np, torch, dev, cfg, B, S, mb, 426)
        log(f"{arch} at {cfg.num_layers} layers, {B} x {S} in {mb} "
            f"microbatches, one forward and backward under the (1, 1) mesh: "
            f"{moe['calls']} all_to_all calls over the one-rank NCCL group; "
            f"loss {moe['loss']:.6f} and all {moe['leaves']} gradient leaves "
            f"equal to the dense fallback's; {moe['wall']:.4f} s")
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return run["launches"]


# --------------------------------------------------------------- dry run

DRYRUN_WORKERS = 6      # processes running phase 27 (a)'s cells on meta
DRYRUN_SHAPE = "prefill_32k"
DRYRUN_RATIO = (0.90, 1.10)         # (b): measured peak / estimate
# (b) runs a prefill_32k cell of each (pod first): all ten; Llama-4
# Maverick's pod rank runs 2 rows x 3 of its 40 heads (flash at [6,
# 32,768, 128]) and its 24 MoE layers on the expert-parallel path, 8 of
# the 128 experts a layer gathered (rank 0's), its all_to_all moving
# nothing
DRYRUN_MUST_RUN = ("smollm_360m", "mamba2_780m", "recurrentgemma_2b",
                   "qwen3_moe_30b_a3b", "internlm2_1_8b", "qwen1_5_4b",
                   "minicpm_2b", "musicgen_large", "phi3_vision_4_2b",
                   "llama4_maverick_400b_a17b")
# (b)'s decode cells: one rank of the pod's decode_32k (8 rows, its 2,048
# of the cache's 32,768 slots a layer), Qwen3-30B-A3B and Llama-4
# Maverick at all 48 layers (their MoEs on the psum path: 8 tokens a
# rank, fewer than model's 16 ranks); RecurrentGemma-2B's RG-LRU and
# Mamba-2's SSD states split over model
DRYRUN_DECODE = ("qwen1_5_4b", "qwen3_moe_30b_a3b", "recurrentgemma_2b",
                 "mamba2_780m", "llama4_maverick_400b_a17b")
DRYRUN_DECODE_SHAPE = "decode_32k"
# (b)'s kernels at the prefill's 32,768 positions against their plain
# versions: flash_fwd on one batch-head at each head_dim (and window) the
# cells give it; ssd_scan [BH, nc, Q, hd, ds, G] on one batch row of
# Mamba-2 (48 heads, 128 chunks of 256, B and C shared by the row's heads)
# and at the pod rank's own shape (dryrun_prefill_ssd_shape: 2 rows x 3 of
# the 48 heads, split over model; B and C one group a row)
DRYRUN_FLASH_SHAPES = ((1, 32768, 64, 0), (1, 32768, 96, 0),
                       (1, 32768, 128, 0), (1, 32768, 256, 2048))
DRYRUN_SSD_SHAPES = ((48, 128, 256, 64, 128, 1), (6, 128, 256, 64, 128, 2))
# (b)'s train cells: one rank of the pod's train_4k step each, the state
# kept sharded, at published width and depth; under baseline the rank's
# model group splits attention's heads, the MLPs and the vocabulary
# (tensor parallelism), in padded tiles where 16 does not divide them: 16
# rows a rank, Qwen3's 2 q heads of 32 and InternLM2's 1 of 16, their KV
# heads cut from the whole leaves; RecurrentGemma-2B's RG-LRU channels and
# MLP split, 1 of its 10 heads; MiniCPM-2B's 3 of 36 heads and 7,673 of
# 122,753 words; Llama-4 Maverick's 3 of 40 heads ([48, 4,096, 128]),
# 12,628 of 202,048 words and 8 of 128 experts a layer (the MoE's a2a
# path: each rank routes its 256 of the 4,096 positions)
# RecurrentGemma-2B's dp_fsdp multipod cell: 256 rows over the 32 (pod,
# data) shards, 8 a shard, which model's 16 do not divide: each rank runs
# its padded tile of them, rank 0 (the dry run's) 1 row of 8 with all 10
# heads and the whole vocabulary.  (arch, policy, mesh)
DRYRUN_TRAIN = (("qwen3_moe_30b_a3b", "dp_fsdp+flash", "pod"),
                ("qwen1_5_4b", "dp_fsdp+flash", "pod"),
                ("qwen3_moe_30b_a3b", "baseline+flash", "pod"),
                ("internlm2_1_8b", "baseline+flash", "pod"),
                ("recurrentgemma_2b", "baseline+flash", "pod"),
                ("minicpm_2b", "baseline+flash", "pod"),
                ("recurrentgemma_2b", "dp_fsdp+flash", "multipod"),
                ("llama4_maverick_400b_a17b", "baseline+flash", "pod"))
# (b)'s prefill cells beside DRYRUN_MUST_RUN's: RecurrentGemma-2B's
# dp_fsdp pod prefill_32k, 2 rows a (data) shard over model's 16: rank 0
# runs 1 row, all 10 heads, and relays each layer's cache to its block
# (every row of the shard, its 128 of the local ring's 2,048 slots).
# (arch, policy, mesh)
DRYRUN_PREFILL = (("recurrentgemma_2b", "dp_fsdp+flash", "pod"),)
DRYRUN_TRAIN_SHAPE = "train_4k"
# (b)'s train cells: |cross-entropy - random_head_ce| at most this; the
# labels' logits average over 4,096 draws of sd sigma sqrt(D) (1.01 at
# most): about 0.016; a head gathered as zeros moves the CE by 0.41-0.51
DRYRUN_CE_MARGIN = 0.1
CACHED_SLIM = 64        # (c): SLIM invocations after the one FULL frame
SUBQUADRATIC = ("ssm", "hybrid")    # the families long_500k runs


def _dryrun_worker(src):
    """A worker of phase 27 (a): the card hidden (its cells run on meta
    tensors; ``fits`` is against an H100 80GB's memory), the port on the
    path."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, src)


def dryrun_cell(cell):
    """Phase 27 (a): one (arch, shape, mesh) cell at ``baseline``; an
    exception comes back as an ``error`` record."""
    import traceback

    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    try:
        rec = run_cell(*cell, save=False)
    except Exception as e:  # noqa: BLE001 - the phase gates on it
        rec = {"cell": "__".join(cell), "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-1500:]}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dryrun_gates(recs, cells):
    """(a)'s gates: a record a cell, none an ``error``, and ``skipped``
    exactly where the reference skips (``long_500k`` outside the ``ssm``
    and ``hybrid`` families); logs the table."""
    from repro_torch import configs as C

    check(len(recs) == len(cells), f"{len(recs)} records for {len(cells)} "
          f"cells")
    errors = [r for r in recs if r["status"] == "error"]
    check(not errors, "dry run cells failed: " + "; ".join(
        f"{r['cell']}: {r['error']}" for r in errors[:3]))
    skipped = {r["cell"] for r in recs if r["status"] == "skipped"}
    want = {f"{a}__{s}__{m}" for a, s, m in cells if s == "long_500k"
            and C.get_config(a).family not in SUBQUADRATIC}
    check(skipped == want, f"skipped {sorted(skipped ^ want)} differ from "
          f"the reference's set")
    log(f"{'cell':48s} {'arg GiB':>9s} {'temp GiB':>10s} {'fits':>5s} "
        f"{'FLOP':>10s} {'s':>6s}")
    for r in recs:
        if r["status"] != "ok":
            log(f"{r['cell']:48s} skipped: {r['reason']}")
            continue
        m = r["memory"]
        log(f"{r['cell']:48s} {m['argument_bytes'] / 2**30:9.3f} "
            f"{m['temp_bytes'] / 2**30:10.3f} {str(r['fits']):>5s} "
            f"{r['cost_analysis']['flops']:10.4g} {r['seconds']:6.2f}")
    ok = [r for r in recs if r["status"] == "ok"]
    return {"ok": len(ok), "skipped": len(skipped),
            "fits": sum(r["fits"] for r in ok),
            "cpu_s": sum(r["seconds"] for r in recs)}


def dryrun_kernels(np, torch, dev):
    """(b)'s kernels at the prefill's length against their plain versions
    (``DRYRUN_FLASH_SHAPES`` in bf16, ``DRYRUN_SSD_SHAPES``); returns the
    largest |diff| of each and, under ``ssd_scan_rank``, the pod rank's
    ``ssd_scan`` shape timed: device and plain ms, FLOP and bytes."""
    from repro_torch.kernels.flash_attn import flash_fwd, flash_fwd_plain
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    rng = np.random.default_rng(27)
    errs = {"flash_fwd": 0.0, "ssd_scan": 0.0}
    for BH, S, hd, window in DRYRUN_FLASH_SHAPES:
        q, k, v = flash_inputs(np, torch, dev, rng, BH, S, hd, torch.bfloat16)
        scale = 1.0 / float(np.sqrt(hd))
        o, lse = flash_fwd(q, k, v, scale=scale, window=window)
        o_p, lse_p = flash_fwd_plain(q.float(), k.float(), v.float(),
                                     scale=scale, window=window)
        torch.cuda.synchronize()
        eo = (o.float() - o_p).abs().max().item()
        el = (lse - lse_p).abs().max().item()
        check(bool(torch.isfinite(o).all())
              and torch.allclose(o.float(), o_p, **TOL_FLASH_BF16)
              and torch.allclose(lse, lse_p, **TOL_FLASH),
              f"flash_fwd [{BH}, {S}, {hd}] window {window} bf16: max |err| "
              f"O {eo:.3g}, LSE {el:.3g}")
        errs["flash_fwd"] = max(errs["flash_fwd"], eo, el)
        log(f"flash_fwd [{BH}, {S}, {hd}] window {window} bf16: max |err| "
            f"vs plain (f32) O {eo:.3g}, LSE {el:.3g} (tolerance O "
            f"{TOL_FLASH_BF16['atol']}, LSE {TOL_FLASH['atol']})")
        del q, k, v, o, lse, o_p, lse_p
        torch.cuda.empty_cache()
    check(DRYRUN_SSD_SHAPES[-1] == dryrun_prefill_ssd_shape(),
          f"the pod rank's ssd_scan shape {dryrun_prefill_ssd_shape()} is "
          f"not among {DRYRUN_SSD_SHAPES}")
    for BH, nc, Q, hd, ds, G in DRYRUN_SSD_SHAPES:
        x, la, Bm, Cm = ssd_inputs(np, torch, dev, rng, BH, nc, Q, hd, ds)
        bg, cg = Bm[:G].contiguous(), Cm[:G].contiguous()
        del Bm, Cm
        y, y_p = ssd_scan(x, la, bg, cg), ssd_scan_plain(x, la, bg, cg)
        torch.cuda.synchronize()
        err = (y - y_p).abs().max().item()
        what = f"ssd_scan [{BH}, {nc}, {Q}, {hd}] ds {ds} G {G} f32"
        check(bool(torch.isfinite(y).all())
              and torch.allclose(y, y_p, **TOL_SSD),
              f"{what}: max |err| {err:.3g}")
        errs["ssd_scan"] = max(errs["ssd_scan"], err)
        log(f"{what}: max |err| vs plain {err:.3g} (tolerance "
            f"{TOL_SSD['atol']})")
        del y, y_p
        if (BH, nc, Q, hd, ds, G) == DRYRUN_SSD_SHAPES[-1]:
            ms, _ = kernel_times(torch, lambda: ssd_scan(x, la, bg, cg),
                                 "ssd_", 10, require=True)
            plain = cuda_ms(torch, lambda: ssd_scan_plain(x, la, bg, cg), 3,
                            repeats=3)
            flops, nbytes = ssd_work(BH, G, nc, Q, hd, ds)
            errs["ssd_scan_rank"] = {"shape": [BH, nc, Q, hd, ds],
                                     "groups": G, "ms": ms, "plain_ms": plain,
                                     "flops": flops, "bytes": nbytes}
            log(f"{what}, the pod rank's: {ms:.4f} ms on the card, its four "
                f"ssd_ kernels summed (plain {plain:.4f} ms); {flops:.4g} "
                f"FLOP, {nbytes / 1e6:.1f} MB")
        del x, la, bg, cg
        torch.cuda.empty_cache()
    return errs


def dryrun_execute(torch, smi):
    """(b): for each arch, the first ``prefill_32k`` cell (``pod``, then
    ``multipod``) whose estimate leaves ``EXECUTE_HEADROOM`` of the card
    free, run there by ``run_cell(execute=True)`` at the config's width
    and depth with ``flash`` (``ssdk`` for Mamba-2), then each of
    ``DRYRUN_PREFILL``; the launches of each run counted from 0.  Returns
    {arch: record} of the ``DRYRUN_MUST_RUN`` cells run, {"arch policy
    mesh": record} of the others, and the launches of all of them."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import EXECUTE_HEADROOM, run_cell
    from repro_torch.models.transformer import ATTN_KINDS

    runs, total = {}, {"flash_fwd": 0, "ssd_scan": 0}
    checked = dryrun_prefill_flash_shapes()
    for arch in DRYRUN_MUST_RUN:
        cfg = C.get_config(arch)
        attends = any(k in ATTN_KINDS for k in cfg.layer_kinds)
        policy = "flash" if attends else "ssdk"
        tried = []
        for mk in ("pod", "multipod"):
            torch.cuda.empty_cache()
            reset_counts()
            rec = run_cell(arch, DRYRUN_SHAPE, mk, policy, save=False,
                           execute=True)
            counts = read_counts()
            if "peak_bytes" not in rec["execute"]:
                m = rec["memory"]
                est = m["argument_bytes"] + m["temp_bytes"]
                tried.append(f"{mk} {est / 2**30:.2f} GiB")
                continue
            kernel, want = dryrun_prefill_gates(rec, counts, arch, policy,
                                                mk, checked, smi)
            runs[arch] = rec
            total[kernel] += want
            break
        if arch not in runs:
            card = torch.cuda.get_device_properties(0).total_memory
            log(f"{arch}: no {DRYRUN_SHAPE} cell fits "
                f"{1 - EXECUTE_HEADROOM:.2f} of the card's "
                f"{card / 2**30:.2f} GiB: estimates {', '.join(tried)}")
        torch.cuda.empty_cache()
    missing = [a for a in DRYRUN_MUST_RUN if a not in runs]
    check(not missing, f"no {DRYRUN_SHAPE} cell run on the card for {missing}")
    others = {}
    for arch, policy, mk in DRYRUN_PREFILL:
        torch.cuda.empty_cache()
        reset_counts()
        rec = run_cell(arch, DRYRUN_SHAPE, mk, policy, save=False,
                       execute=True)
        counts = read_counts()
        check("peak_bytes" in rec["execute"], f"{rec['cell']} ({policy}) did "
              f"not run on the card: {rec['execute']}")
        kernel, want = dryrun_prefill_gates(rec, counts, arch, policy, mk,
                                            checked, smi)
        others[f"{arch} {policy} {mk}"] = rec
        total[kernel] += want
        torch.cuda.empty_cache()
    return runs, others, total


def dryrun_prefill_gates(rec, counts, arch, policy, mk, checked, smi):
    """The gates of a ``prefill_32k`` cell run on the card (``rec``, its
    launches ``counts``): its kernel (``flash_fwd``, or ``ssd_scan`` where
    nothing attends) launched once a layer that has it and nothing else,
    flash at shapes phase 10 holds (``checked``) and ``ssd_scan`` at
    ``DRYRUN_SSD_SHAPES``, the cache and logits finite and of their
    shards' shapes, the measured peak within ``DRYRUN_RATIO`` of the
    estimate; logs the run.  Returns (kernel, its launches)."""
    from repro_torch.models.transformer import ATTN_KINDS

    m, ex = rec["memory"], rec["execute"]
    est = m["argument_bytes"] + m["temp_bytes"]
    cfg, _, B, heads, words = dryrun_train_split(arch, policy, DRYRUN_SHAPE,
                                                 mk)
    attends = any(k in ATTN_KINDS for k in cfg.layer_kinds)
    kernel = "flash_fwd" if attends else "ssd_scan"
    shapes = [(B * heads, 32768, cfg.head_dim, w)
              for w in attn_windows(cfg)] if attends else []
    check(all(sh in checked for sh in shapes),
          f"{rec['cell']}: flash at {shapes}, not among phase 10's shapes")
    want = kernel_layers(cfg, kernel)
    check(rec[("attn_impl" if attends else "ssd_impl")] ==
          ("flash" if attends else "kernel"),
          f"{rec['cell']}: ran {rec['attn_impl']} / {rec['ssd_impl']}")
    check(ex["finite"] and ex["shapes_ok"],
          f"{rec['cell']}: cache or logits not finite or misshapen")
    check(counts[kernel] == want and ex["launches"][kernel] == want
          and sum(counts.values()) == want,
          f"{rec['cell']}: launches {counts}, want {kernel} {want} and "
          f"nothing else")
    if not attends:
        from repro_torch.kernels.ssd_scan import ssd_scan

        # [BH, nc, Q, hd, ds, G] as the wrapper launched them
        shapes = sorted(ssd_scan.shapes)
        check(bool(shapes) and set(shapes) <= set(DRYRUN_SSD_SHAPES),
              f"{rec['cell']}: ssd_scan launched at {shapes}, not among the "
              f"held {DRYRUN_SSD_SHAPES}")
    lo, hi = DRYRUN_RATIO
    q = f"{heads} of {cfg.num_heads} q heads and " if attends else ""
    tp = (f", {q}{words:,} of {cfg.vocab_size:,} words a rank (tensor "
          f"parallelism)" if heads < cfg.num_heads or words < cfg.vocab_size
          else "")
    if cfg.num_experts:
        tp += (f", {moe_experts(cfg, mk)} of {cfg.num_experts} experts a "
               f"layer (the MoE's expert-parallel path)")
    log(f"{rec['cell']} ({policy}, "
        f"{rows_phrase(arch, policy, DRYRUN_SHAPE, mk, B)}{tp}; {kernel} at "
        f"{shapes}): "
        f"estimate {est / 2**30:.3f} GiB (argument {m['argument_bytes']} B, "
        f"temp {m['temp_bytes']} B), measured peak "
        f"{ex['peak_bytes'] / 2**30:.3f} GiB ({ex['peak_bytes']} B), ratio "
        f"{ex['ratio']:.4f}; {ex['wall_s']:.3f} s "
        f"({B * 32768 / ex['wall_s']:.1f} tokens/s, the gather's seeded draws "
        f"included); {kernel} {want} launches; "
        f"{rec['cost_analysis']['flops']:.4g} FLOP; {smi}")
    check(lo <= ex["ratio"] <= hi,
          f"{rec['cell']}: measured peak / estimate {ex['ratio']:.4f} "
          f"outside [{lo}, {hi}]")
    return kernel, want


def dryrun_decode(torch, smi):
    """(b)'s decode cells: each of ``DRYRUN_DECODE`` run on the card by
    ``run_cell(execute=True)``, one rank's ``decode_32k`` step of the pod
    from seed 0 at published width and depth: its shards of the weights
    gathered a layer at a time, the products split over ``model``, its
    block of the cache's slots (every slot valid, the token at the
    cache's last position) attended sequence-parallel.  Gates: the cell
    fits and ran; the measured peak within ``DRYRUN_RATIO`` of the
    estimate; the cache and logits finite and of their shards' shapes; no
    kernel launched (decode's attention is PyTorch's).  Returns {arch:
    record}."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.transformer import ATTN_KINDS

    runs = {}
    lo, hi = DRYRUN_RATIO
    for arch in DRYRUN_DECODE:
        torch.cuda.empty_cache()
        reset_counts()
        rec = run_cell(arch, DRYRUN_DECODE_SHAPE, "pod", save=False,
                       execute=True)
        counts = read_counts()
        m, ex = rec["memory"], rec["execute"]
        est = m["argument_bytes"] + m["temp_bytes"]
        check("peak_bytes" in ex, f"{rec['cell']} did not run on the card: "
                                  f"{ex}")
        check(ex["finite"] and ex["shapes_ok"],
              f"{rec['cell']}: cache or logits not finite or misshapen")
        check(not any(counts.values()),
              f"{rec['cell']}: launches {counts}, want none")
        cfg, _, B, heads, words = dryrun_train_split(arch, "baseline",
                                                     DRYRUN_DECODE_SHAPE)
        attn = (f"{heads} of {cfg.num_heads} q heads' rows of wo, "
                if any(k in ATTN_KINDS for k in cfg.layer_kinds) else "")
        slots = (", 2,048 of the cache's 32,768 slots a layer (sequence "
                 "parallelism)" if attn else "")
        rec_split = recurrent_phrase(recurrent_split(
            arch, "baseline", DRYRUN_DECODE_SHAPE))
        if cfg.num_experts:
            rec_split += (f", {moe_experts(cfg)} of {cfg.num_experts} "
                          f"experts a layer (the MoE's psum path)")
        log(f"{rec['cell']} (baseline, {cfg.num_layers} layers, {B} rows a "
            f"rank, {attn}{words:,} of {cfg.vocab_size:,} words{rec_split} "
            f"(tensor parallelism){slots}, the token "
            f"at position 32,767): estimate {est / 2**30:.3f} GiB (argument "
            f"{m['argument_bytes']} B, temp {m['temp_bytes']} B), measured "
            f"peak {ex['peak_bytes'] / 2**30:.3f} GiB ({ex['peak_bytes']} B), "
            f"ratio {ex['ratio']:.4f}; {ex['wall_s']:.3f} s (the gathers' "
            f"seeded draws included); "
            f"{rec['cost_analysis']['flops']:.4g} FLOP; {smi}")
        check(lo <= ex["ratio"] <= hi,
              f"{rec['cell']}: measured peak / estimate {ex['ratio']:.4f} "
              f"outside [{lo}, {hi}]")
        runs[arch] = rec
        torch.cuda.empty_cache()
    return runs


def moe_experts(cfg, mesh_kind="pod"):
    """The experts a layer a rank of ``mesh_kind``'s mesh runs on the MoE's
    expert-parallel paths: ``num_experts`` over ``model``'s ranks."""
    from repro_torch.launch.dryrun import make_abstract_mesh
    from repro_torch.parallel import sharding as SH

    mesh = make_abstract_mesh(multi_pod=mesh_kind == "multipod")
    return cfg.num_experts // SH.mesh_shape(mesh)["model"]


def random_head_ce(cfg, words=None):
    """The cross-entropy that seeded random weights give on labels drawn
    apart from them: the logits are h W with h the final norm's output
    (scale ones: rms 1, |h|^2 = D) and W's entries normal x sigma, the
    head's ``init_from_specs`` std (of the whole leaf), so each logit is
    normal of variance s^2 = sigma^2 D; E[ln sum_V exp] = ln V + s^2 / 2
    (V >> e^(s^2)), and the label's logit averages 0.  Where the rank's
    ``model`` group splits the vocabulary (tensor parallelism) and its
    sums over the group move nothing (the dry run's ``DryOps``), the
    rank's log-sum-exp is over its own tile of ``words`` logits (V / 16,
    or a padded tile's ceil(V / 16)): ln(words) + s^2 / 2; the label's
    logit is the tile's where the label falls in it, else 0, and still
    averages 0."""
    D, V = cfg.d_model, cfg.vocab_size
    fan_in = V if cfg.tie_embeddings else D
    sigma = min(0.02, 1.0 / math.sqrt(fan_in))
    return math.log(words or V) + sigma * sigma * D / 2


def dryrun_train(torch, smi):
    """(b)'s train cells: each of ``DRYRUN_TRAIN`` run on the card by
    ``run_cell(execute=True)``, one rank's step of its mesh from seed 0,
    its launches counted from 0.  Gates: the cell fits (a tenth of the
    card left free) and ran; the measured peak within ``DRYRUN_RATIO`` of
    the estimate; each flash kernel launched as ``train_launches_per_step``
    says and nothing else, at a shape of :func:`train_flash_shapes`
    (phases 10 and 14 hold the kernels there); finite metrics; the
    cross-entropy within ``DRYRUN_CE_MARGIN`` of :func:`random_head_ce`
    over the rank's block of the vocabulary; state and metrics of their
    shards' shapes.  Returns {"arch policy mesh": record} and the
    launches of all of them."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import run_cell

    runs = {}
    total = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    lo, hi = DRYRUN_RATIO
    for arch, policy, mk in DRYRUN_TRAIN:
        torch.cuda.empty_cache()
        reset_counts()
        rec = run_cell(arch, DRYRUN_TRAIN_SHAPE, mk, policy, save=False,
                       execute=True)
        counts = read_counts()
        m, ex = rec["memory"], rec["execute"]
        est = m["argument_bytes"] + m["temp_bytes"]
        check("peak_bytes" in ex, f"{rec['cell']} ({policy}) did not run on "
                                  f"the card: {ex}")
        cfg, mb, B, heads, words = dryrun_train_split(arch, policy,
                                                      mesh_kind=mk)
        want = train_launches_per_step(cfg, mb)
        check(rec["attn_impl"] == "flash" and all(
            counts[k] == n == ex["launches"][k] for k, n in want.items())
            and sum(counts.values()) == sum(want.values()),
            f"{rec['cell']}: launches {counts}, want {want} and nothing else")
        check(ex["finite"] and ex["shapes_ok"] and math.isfinite(ex["loss"]),
              f"{rec['cell']}: loss {ex['loss']}, metrics finite "
              f"{ex['finite']}, state and metrics of their shards' shapes "
              f"{ex['shapes_ok']}")
        S = C.SHAPES[DRYRUN_TRAIN_SHAPE].seq_len
        shapes = [(B // mb * heads, S, cfg.head_dim, w)
                  for w in attn_windows(cfg)]
        check(all(sh in train_flash_shapes() for sh in shapes),
              f"{rec['cell']}: flash at {shapes}, not among phases 10 and "
              f"14's shapes")
        n = rec["devices"]
        loss, ce, aux = (ex[k] for k in ("loss", "ce", "aux"))
        want_ce = random_head_ce(cfg, words)
        moe = (f" (the MoE's expert-parallel path: {moe_experts(cfg, mk)} "
               f"of {cfg.num_experts} experts a layer a rank, its "
               f"all_to_all moving nothing)" if cfg.num_experts else "")
        rs = recurrent_phrase(recurrent_split(arch, policy,
                                              DRYRUN_TRAIN_SHAPE))
        tp = (f", {heads} of {cfg.num_heads} q heads and {words:,} of "
              f"{cfg.vocab_size:,} words a rank{rs} (tensor parallelism)"
              if heads < cfg.num_heads or words < cfg.vocab_size else "")
        log(f"{rec['cell']} ({policy}, {cfg.num_layers} layers, "
            f"{rows_phrase(arch, policy, DRYRUN_TRAIN_SHAPE, mk, B)}, the "
            f"state sharded{tp}){moe}: estimate "
            f"{est / 2**30:.3f} "
            f"GiB (argument {m['argument_bytes']} B, temp {m['temp_bytes']} "
            f"B), measured peak {ex['peak_bytes'] / 2**30:.3f} GiB "
            f"({ex['peak_bytes']} B), ratio {ex['ratio']:.4f}; loss "
            f"{loss:.4f}: cross-entropy {ce:.4f} (ln({words}) + "
            f"sigma^2 D / 2 = {want_ce:.4f}, ln V "
            f"{math.log(cfg.vocab_size):.4f}), "
            f"router aux {aux * n:.4f} / {n} ranks x weight "
            f"{cfg.router_aux_weight} = {aux * cfg.router_aux_weight:.4f}, "
            f"z-loss {loss - ce - aux * cfg.router_aux_weight:.4f} (the "
            f"mean over ranks moving nothing: the cross-entropy and z-loss "
            f"the rank's own, its shares' sums over ranks moving nothing; "
            f"the aux, every rank's on a process group, the rank's own "
            f"over the rank count); "
            f"{ex['wall_s']:.3f} s "
            f"({B * 4096 / ex['wall_s']:.1f} tokens/s, the gathers' seeded "
            f"draws included); launches "
            f"{ {k: v for k, v in counts.items() if v} }; "
            f"{rec['cost_analysis']['flops']:.4g} FLOP; {smi}")
        check(lo <= ex["ratio"] <= hi,
              f"{rec['cell']}: measured peak / estimate {ex['ratio']:.4f} "
              f"outside [{lo}, {hi}]")
        check(abs(ce - want_ce) <= DRYRUN_CE_MARGIN,
              f"{rec['cell']}: the rank's cross-entropy {ce:.4f}, want "
              f"{want_ce:.4f} +- {DRYRUN_CE_MARGIN} (ln({words}) + "
              f"sigma^2 D / 2)")
        runs[f"{arch} {policy} {mk}"] = rec
        for k in total:
            total[k] += want[k]
        torch.cuda.empty_cache()
    return runs, total


def cached_invocation(pkg, n_slim=CACHED_SLIM, lib_dir=None):
    """(c), ``fig5_cached``'s scenario (the paper's §3.4) through ``pkg``
    (``core``, ``transport``, context keywords ``kw``): ``bench_hot``
    (about 256 KiB of code behind a trivial main) sent by a ``Dispatcher``
    to one ``RdmaFabric`` host peer, each invocation drained before the
    next: the first FULL, the ``n_slim`` after it SLIM.  Returns
    (dispatcher, host seconds of each invocation, the peer's wire bytes
    after the first)."""
    core, X = pkg.core, pkg.transport
    src = core.Context("hot-source", lib_dir=lib_dir, **pkg.kw)
    d = X.Dispatcher(src, X.ProgressEngine(flush_threshold=64))
    h = core.register_ifunc(src, "bench_hot", lib_dir)
    slot = 1 << (len(h.lib.code) + 4096).bit_length()   # a FULL frame
    d.add_peer("hot", X.RdmaFabric(),
               core.Context("hot-target", lib_dir=lib_dir,
                            link_mode="remote", **pkg.kw),
               n_slots=2, slot_size=slot, target_args={})
    peer, times, first = d.peers["hot"], [], 0
    for i in range(1 + n_slim):
        t0 = time.perf_counter()
        check(d.send_ifunc("hot", h, b"x" * 16), f"invocation {i} refused")
        d.drain()
        times.append(time.perf_counter() - t0)
        if i == 0:
            first = peer.stats["bytes"]
    return d, times, first


def card_headroom(torch, dev, when):
    """Logs the card's free bytes (``torch.cuda.mem_get_info``), this
    process's allocator's reserved bytes and what neither accounts for
    (other processes' and this one's CUDA contexts, memory outside the
    allocator), and fails where that last is more than
    ``EXECUTE_HEADROOM`` of the card: (b)'s cells are sized against the
    whole card."""
    from repro_torch.launch.dryrun import EXECUTE_HEADROOM

    free, total = torch.cuda.mem_get_info(dev)
    reserved = torch.cuda.memory_reserved(dev)
    outside = total - free - reserved
    log(f"{when}: the card's free {free} B ({free / 2**30:.2f} GiB) of "
        f"{total / 2**30:.2f}, this process's allocator reserves "
        f"{reserved / 2**30:.2f} GiB, {outside / 2**30:.2f} GiB held "
        f"outside it")
    check(outside <= EXECUTE_HEADROOM * total,
          f"{when}: {outside / 2**30:.2f} GiB of the card held outside this "
          f"process's allocator (another process on the card?)")


def phase_dryrun(np, torch, dev, smi):
    """Phase 27: (a) every cell's dry run on meta in ``DRYRUN_WORKERS``
    processes while (b) checks the kernels at 32,768 positions and runs
    each arch's fitting ``prefill_32k`` cell on the card; (c) the cached
    invocation.  Returns (b)'s prefill launches, the kernels' largest
    |diff| and (b)'s train cells' launches."""
    import multiprocessing
    import types

    import repro_torch.core as core
    import repro_torch.transport as transport
    from repro_torch.launch.dryrun import H100_80GB_BYTES, iter_cells

    t_phase = time.perf_counter()
    card_headroom(torch, dev, "phase 27's start")
    total_mem = torch.cuda.get_device_properties(dev).total_memory
    log(f"the card's total_memory {total_mem} B ({total_mem / 2**30:.2f} "
        f"GiB); (a)'s fits are against an H100 80GB's {H100_80GB_BYTES} B"
        f"{'' if total_mem == H100_80GB_BYTES else ' (differs)'}")
    cells = list(iter_cells(["pod", "multipod"]))
    with multiprocessing.get_context("spawn").Pool(
            DRYRUN_WORKERS, initializer=_dryrun_worker,
            initargs=(str(ROOT / "src"),)) as pool:
        pending = pool.map_async(dryrun_cell, cells, chunksize=1)
        errs = dryrun_kernels(np, torch, dev)
        card_headroom(torch, dev, "(b)'s cells' start, (a)'s workers running")
        t_b = time.perf_counter()
        runs, prefills, launches = dryrun_execute(torch, smi)
        t_b = time.perf_counter() - t_b
        t_t = time.perf_counter()
        trains, train_launches = dryrun_train(torch, smi)
        t_t = time.perf_counter() - t_t
        t_d = time.perf_counter()
        decodes = dryrun_decode(torch, smi)
        t_d = time.perf_counter() - t_d
        t_wait = time.perf_counter()
        recs = pending.get(timeout=900)
        t_wait = time.perf_counter() - t_wait
    a = dryrun_gates(recs, cells)
    log(f"(a) {len(cells)} cells: {a['ok']} ok, {a['skipped']} skipped, "
        f"{a['fits']} fit one card; {a['cpu_s']:.1f} s of cell time in "
        f"{DRYRUN_WORKERS} processes, {t_wait:.1f} s waited for after (b)")
    log(f"(b) {len(runs)} of 10 archs ran a {DRYRUN_SHAPE} cell on the card "
        f"and {len(prefills)} more ({sorted(prefills)}) in {t_b:.1f} s: "
        f"{sorted(runs)}; launches {launches}; "
        f"{len(trains)} {DRYRUN_TRAIN_SHAPE} cells in {t_t:.1f} s: "
        f"{sorted(trains)}; launches {train_launches}; "
        f"{len(decodes)} {DRYRUN_DECODE_SHAPE} cells in {t_d:.1f} s: "
        f"{sorted(decodes)}")

    pkg = types.SimpleNamespace(core=core, transport=transport, kw={})
    d, times, first = cached_invocation(pkg)
    peer = d.peers["hot"]
    tgt = peer.target_ctx
    code = len(d.src_ctx.handles["bench_hot"].lib.code)
    check(tgt.stats["links"] == 1 and peer.stats["slim_sent"] == CACHED_SLIM
          and peer.target_args["count"] == 1 + CACHED_SLIM,
          f"cached invocation: links {tgt.stats['links']}, SLIM "
          f"{peer.stats['slim_sent']}, invocations "
          f"{peer.target_args.get('count')}")
    check(first > code >= 256 << 10
          and peer.stats["bytes"] - first < CACHED_SLIM * 1024,
          f"cached invocation: {first} B with the FULL frame, "
          f"{peer.stats['bytes'] - first} B after, code {code} B")
    slim_us = statistics.median(times[1:]) * 1e6
    log(f"(c) bench_hot: 1 FULL + {CACHED_SLIM} SLIM invocations, links 1, "
        f"{code} B of code shipped once ({first} B on the wire with the "
        f"FULL frame, {peer.stats['bytes'] - first} B for the SLIM ones); "
        f"host µs an invocation: FULL {times[0] * 1e6:.1f}, SLIM median "
        f"{slim_us:.1f} ({times[0] / statistics.median(times[1:]):.1f}x)")
    log(f"phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return launches, errs, train_launches


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
    # the model stack (phases 10-17, 12, 13) before the host phases: after
    # their long traces (phases 24-25 hold 170,000-180,000 device records
    # each), torch.profiler lost whole traces of the timed kernels on the
    # H100, three in a row once
    model_errs = phase_model_kernels(np, torch, dev)
    bwd_errs = phase_bwd_kernels(np, torch, dev)
    model_entries = phase_model_timings(np, torch, dev, model_errs)
    bwd_entries = phase_bwd_timings(np, torch, dev, bwd_errs)
    phase_train_parity(np, torch, dev)
    train_launches = phase_training(np, torch, dev, smi)
    launcher_launches = phase_launcher(np, torch, dev, smi)
    for entry in model_entries[:1] + bwd_entries:
        entry["train_launches"] = {arch: n[entry["name"]]
                                   for arch, n in train_launches.items()}
        entry["launcher_launches"] = launcher_launches[entry["name"]]
    for entry in bwd_entries:
        entry["launches"] = sum(entry["train_launches"].values())
    phase_model_parity(np, torch, dev)
    launches = phase_serving(np, torch, dev, smi)
    for entry in model_entries:
        entry["launches"] = launches[entry["name"]]
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
    gr = phase_graph(np, torch, dev, smi)
    vm["graph_host_launches"] = gr["host_launches"]
    vm["launches"] += gr["sweeps"]        # graph_degree inside the sweeps
    kernels[0]["launches"] += gr["sweeps"]
    sm = phase_streams(np, torch, dev, smi, mp["rates"])
    vm["stream_launches"] = sm["launches"]
    fl = phase_flow(np, torch, dev, smi)
    vm["flow_launches"] = fl["launches"]
    ru = phase_runtime(np, torch, dev, smi)
    vm["elastic_launches"] = ru["sweeps"]     # graph_degree in the sweeps
    kernels[0]["elastic_launches"] = ru["sweeps"]
    vm["launches"] += ru["sweeps"]
    kernels[0]["launches"] += ru["sweeps"]
    model_entries[0]["fabric_launches"] = phase_fabric(np, torch, dev, smi)
    dry_launches, dry_errs, dry_train = phase_dryrun(np, torch, dev, smi)
    model_entries[0]["dryrun_shapes"] = dryrun_prefill_flash_shapes()
    for entry in model_entries:
        name = entry["name"]
        entry["dryrun_launches"] = dry_launches[name]
        entry["launches"] += dry_launches[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], dry_errs[name])
    for entry in model_entries[:1] + bwd_entries:
        entry["dryrun_train_launches"] = dry_train[entry["name"]]
        entry["launches"] += dry_train[entry["name"]]
    bw, fp32, bf16 = card_peaks(torch.cuda.get_device_name(0))
    rank = dry_errs["ssd_scan_rank"]
    model_entries[1]["dryrun_rank"] = {**rank, "bound_ms": max(
        rank["flops"] / fp32, rank["bytes"] / bw) * 1e3}
    # each flash kernel's bound at the per-rank shapes of phase 27 (b)'s
    # bf16 train cells (forward and backward) and prefill cells (forward)
    for shape in dict.fromkeys(dryrun_train_flash_shapes()):
        work = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                        (flash_work(*shape), *bwd_work(*shape))))
        for entry in model_entries[:1] + bwd_entries:
            flops, nbytes = work[entry["name"]]
            entry.setdefault("dryrun_train_bounds", []).append(
                {"shape": list(shape), "bound_ms": max(
                    flops / bf16, nbytes / bw) * 1e3})
    model_entries[0]["dryrun_bounds"] = [
        {"shape": list(shape), "bound_ms": max(
            flash_work(*shape)[0] / bf16, flash_work(*shape)[1] / bw) * 1e3}
        for shape in dryrun_prefill_flash_shapes()]
    kernels += model_entries + bwd_entries
    for entry in kernels:
        if entry["name"] in ru["driver"]:
            entry["driver_launches"] = ru["driver"][entry["name"]]
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
