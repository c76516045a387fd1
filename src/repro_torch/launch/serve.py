"""Serving driver — a thin CLI over :mod:`repro_torch.serving`.

Two deployment shapes, one decode engine:

* ``--mode host`` (default): single-host :class:`~repro_torch.serving.Server`
  fed ``srv_enqueue`` frames by an :class:`~repro_torch.serving.IfuncFrontend`
  over a credit-flow-controlled ring.
* ``--mode disagg``: the disaggregated
  :class:`~repro_torch.serving.ServingFabric` — dedicated prefill peers stream
  each sequence's KV cache to continuous-batching decode peers as
  ``FLAG_STREAM`` payloads, placed by a pricing router.

Completion is signalled off the decode path in both modes: a request is
done when its last token has been *decoded*, never at admission.  The
model runs on the card unless ``--device cpu`` is given; parameters are
``init_params(TINY)`` from a generator on that device seeded with 0.

    PYTHONPATH=src python -m repro_torch.launch.serve --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode disagg --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import os
import pathlib
import time

import numpy as np
import torch

from repro_torch.core.registry import ENV_LIB_DIR
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import (TINY, IfuncFrontend, Request, Server,
                                 ServingFabric)


def make_requests(n: int, max_new: int, *, seed: int = 0) -> list[Request]:
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, TINY.vocab_size, size=8,
                                    dtype=np.int32), max_new=max_new)
            for i in range(n)]


def run_host(args, params) -> None:
    from repro_torch.core import Context

    server_ctx = Context("server")
    fe = IfuncFrontend(server_ctx)
    # ONE bundle across frontend transport + batcher: the final snapshot
    # shows ingest (peer/dispatcher counters) and serving side by side
    srv = Server(TINY, params, args.slots, args.cache, obs=fe.rt.obs,
                 device=args.device)
    reqs = make_requests(args.requests, args.steps)
    unsubmitted = list(reqs)
    acks = []
    done: dict[int, Request] = {}
    pending: list[Request] = []
    t0 = time.time()
    total = 0
    while unsubmitted or pending or srv.active:
        while unsubmitted:                                 # credits permitting
            fut = fe.submit(unsubmitted[0])
            if fut is None:
                break
            acks.append(fut)
            unsubmitted.pop(0)
        pending.extend(fe.server_poll())
        admitted_now = 0
        while pending and srv.admit(pending[0]):
            pending.pop(0)
            admitted_now += 1
        # completion comes off the DECODE path: tick() hands back the
        # requests whose last token just landed — only those are done
        emitted, finished = srv.tick()
        total += emitted
        for req in finished:
            done[req.rid] = req
        if admitted_now:
            print(" ", srv.wave_summary())
    dt = time.time() - t0
    acked = [f.result(timeout=10.0) for f in acks]
    assert all(a["queued"] for a in acked), acked
    assert len(done) == len(reqs), (len(done), len(reqs))
    # shutdown drain with the transport liveness floor: if the server ring
    # wedged, outstanding admission futures fail with a TransportError
    # after the deadline instead of hanging the frontend forever
    fe.rt.drain(deadline=5.0)
    stats = fe.dispatcher.per_peer_stats()["server"]
    assert stats["timed_out"] == 0, stats
    print(f"served {len(reqs)} requests ({len(acked)} acked, max queue depth "
          f"{max(a['depth'] for a in acked)}), {total} decode tokens in "
          f"{dt:.2f}s ({total / max(dt, 1e-9):.0f} tok/s, batch={args.slots}); "
          f"ingest: sent={stats['sent']} slim={stats['slim_sent']} "
          f"delivered={stats['delivered']} backpressure={stats['backpressure']} "
          f"replies={stats['replies']} via {stats['bytes']}B of ifunc frames "
          f"(oldest in-flight {stats['oldest_inflight_s']:.3f}s)")
    snap = srv.metrics()
    print(f"metrics: admitted={snap['counters']['serve.admitted']} "
          f"decoded={snap['counters']['serve.decoded']} "
          f"({len(snap['counters'])} counters, "
          f"{len(snap['histograms'])} histograms in the registry)")
    for rid in sorted(done)[:2]:
        r = done[rid]
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")


def run_disagg(args, params) -> None:
    fab = ServingFabric(TINY, params, n_prefill=args.prefill,
                        n_decode=args.decode, batch_slots=args.slots,
                        cache_len=args.cache, device=args.device)
    reqs = make_requests(args.requests, args.steps)
    t0 = time.time()
    done = fab.run(reqs)
    dt = time.time() - t0
    fab.drain()
    total = sum(len(r.out) for r in done.values())
    assert fab.buffered_installs() == 0, "a KV slab arrived unstreamed"
    print(f"served {len(done)} requests across {args.prefill} prefill + "
          f"{args.decode} decode peers: {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.0f} tok/s); "
          f"{fab.streams_landed()} KV streams landed, "
          f"{fab.buffered_installs()} buffered installs")
    snap = fab.obs.snapshot()["counters"]
    routed = snap.get("serve.router.routed", 0)
    comps = snap.get("serve.router.completions", 0)
    print(f"router: routed={routed} completions={comps} "
          f"admit_retries={snap.get('serve.router.admit_retries', 0)}")
    for rid in sorted(done)[:2]:
        r = done[rid]
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("host", "disagg"), default="host")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache", type=int, default=64)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prefill", type=int, default=2)
    ap.add_argument("--decode", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args()
    os.environ.setdefault(
        ENV_LIB_DIR,
        str(pathlib.Path(__file__).resolve().parents[1] / "ifunc_libs"))
    dev = resolve_device(args.device)
    params = T.init_params(TINY, torch.Generator(dev).manual_seed(0), dev)
    if args.mode == "host":
        run_host(args, params)
    else:
        run_disagg(args, params)


if __name__ == "__main__":
    main()
