"""Coalesced dispatch on host lanes (frame v2.3 ``FLAG_AGG``) and the
coalesced reply path in the port held against the reference: the cases of
``tests/test_agg.py``, each run as the same scenario through both
packages on the same inputs (the port's contexts at ``device="cpu"``,
``ifunc_libs/`` loaded into both registries).

Besides the reference test's own assertions, the two runs must agree on
everything ``same_run`` compares (statuses, per-peer stats, mailbox and
slab bytes, obs counters) and, where futures ride the reply path, on every
future's outcome, the runtime's stats and the reply rings' bytes.
"""

import time

import numpy as np
import pytest

from test_torch_tasks import both, held, outcome
from test_torch_transport import ctx, same_run


def same(scenario, lib_dir, **kw):
    """Run through both packages: the scenarios return (dispatcher, what
    the test read); both must agree."""
    (rd, rv), (pd, pv) = both(scenario, lib_dir, **kw)
    assert pv == rv
    same_run(rd, pd)
    return pv


def _mk(pkg, lib_dir, *, n_slots=4, slot_size=16 << 10, engine=None,
        fabric="rdma", max_subs=16, max_age=5e-4, target_args=None):
    T_ = pkg.transport
    d = T_.Dispatcher(ctx(pkg, "src", lib_dir),
                      engine or T_.ProgressEngine(flush_threshold=64))
    d.set_coalescing(True, max_subs=max_subs, max_age=max_age)
    d.add_peer("p", T_.RdmaFabric() if fabric == "rdma"
               else T_.LoopbackFabric(),
               ctx(pkg, "p", lib_dir, link_mode="remote"),
               n_slots=n_slots, slot_size=slot_size,
               target_args=target_args if target_args is not None
               else {"db": []})
    return d


def _warm(pkg, d, name, lib_dir):
    """First delivery is FULL (links and confirms the digest); everything
    after is aggregate-eligible."""
    h = pkg.core.register_ifunc(d.src_ctx, name, lib_dir)
    assert d.send_ifunc("p", h, b"\x01")
    d.drain()
    assert h.digest in d.peers["p"].cached
    return h


def _msg(pkg, h, payload):
    return pkg.core.ifunc_msg_create(h, payload)


# ---------------------------------------------------------------------------


def _fifo(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    base = list(peer.target_args["db"])
    recs = [bytes([65 + i]) * (2 + i) for i in range(7)]
    for r in recs[:3]:
        assert d.send_ifunc("p", h, r)          # -> coalescing queue
    assert d.send("p", _msg(pkg, h, recs[3]))   # a singleton mid-stream
    for r in recs[4:]:
        assert d.send_ifunc("p", h, r)
    d.drain()
    assert peer.target_args["db"] == base + recs
    assert peer.stats["agg_sent"] >= 1
    assert peer.stats["agg_subs"] >= 3
    return d, peer.target_args["db"]


def test_fifo_across_aggregate_boundaries(lib_dir):
    """Records queued before a singleton execute before it, records queued
    after it after: packing never reorders a peer's traffic."""
    same(_fifo, lib_dir)


def _one_credit(pkg, lib_dir):
    d = _mk(pkg, lib_dir, n_slots=4)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    credits = [peer.credits]
    for i in range(6):
        assert d.send_ifunc("p", h, bytes([97 + i]) * 4)
    credits.append(peer.credits)                # queued: no slot claimed
    assert d.flush_coalesced("p")
    credits.append(peer.credits)                # ONE slot for the container
    assert peer.stats["agg_sent"] == 1 and peer.stats["agg_subs"] == 6
    d.drain()
    credits.append(peer.credits)
    assert credits == [4, 4, 3, 4]
    assert len(peer.target_args["db"]) == 7     # warmup + 6
    return d, credits


def test_one_credit_per_aggregate(lib_dir):
    same(_one_credit, lib_dir)


def _singleton_slim(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    assert d.send_ifunc("p", h, b"solo")
    d.drain()
    assert peer.target_args["db"][-1] == b"solo"
    assert peer.stats["agg_sent"] == 0          # no aggregate was built
    assert peer.stats["slim_sent"] >= 1
    return d, peer.target_args["db"]


def test_singleton_queue_flushes_as_plain_slim(lib_dir):
    """One queued record never pays the container wrapper."""
    same(_singleton_slim, lib_dir)


def _age(pkg, lib_dir):
    d = _mk(pkg, lib_dir, max_age=0.01)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    assert d.send_ifunc("p", h, b"straggler")
    assert d.poll() == 0                        # young: still queued
    assert any(q.subs for q in peer.coalesce.values())
    time.sleep(0.02)
    d.poll()                                    # the age bound flushes it
    d.drain()
    assert peer.target_args["db"][-1] == b"straggler"
    return d, peer.target_args["db"]


def test_age_bound_flushes_stragglers(lib_dir):
    same(_age, lib_dir)


def _partial_trailer(pkg, lib_dir):
    eng = pkg.transport.ProgressEngine(flush_threshold=64,
                                       inflight_window="trailer")
    d = _mk(pkg, lib_dir, engine=eng)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    peer.target_ctx.max_trailer_spins = 10      # don't spin long in tests
    base = list(peer.target_args["db"])
    recs = [bytes([49 + i]) * 3 for i in range(3)]
    for r in recs:
        assert d.send_ifunc("p", h, r)
    assert d.flush_coalesced("p")               # posted, trailer withheld
    assert d.poll() == 0
    assert peer.stats["inflight_polls"] >= 1
    assert peer.target_args["db"] == base       # nothing executed
    eng.flush()                                 # publishes the trailer
    assert d.poll() == 3                        # whole batch in one pass
    assert peer.target_args["db"] == base + recs
    return d, peer.target_args["db"]


def test_partial_trailer_aggregate_in_progress(lib_dir):
    """A container whose trailer is withheld reads IN_PROGRESS: none of its
    records execute until the flush publishes it, then all in one
    sweep."""
    same(_partial_trailer, lib_dir)


def _sub_nack(pkg, lib_dir):
    d = _mk(pkg, lib_dir, slot_size=32 << 10)
    h_rle = _warm(pkg, d, "rle_insert", lib_dir)
    h_cnt = _warm(pkg, d, "counter_bump", lib_dir)
    peer = d.peers["p"]
    tgt = peer.target_ctx
    assert tgt.link_cache.evict("counter_bump", h_cnt.digest)
    base = list(peer.target_args["db"])
    base_count = peer.target_args["count"]      # the warmup bump
    assert d.send_ifunc("p", h_rle, b"AAAA")
    assert d.send_ifunc("p", h_cnt, b"x")       # digest evicted at target
    assert d.send_ifunc("p", h_rle, b"BBBB")
    d.drain()
    assert peer.target_args["db"] == base + [b"AAAA", b"BBBB"]
    assert peer.stats["nacks"] == 1
    assert peer.stats["resent"] == 1
    assert peer.target_args["count"] == base_count + 1   # once, not twice
    assert tgt.stats["nacks"] == 1
    assert h_cnt.digest in peer.cached          # re-confirmed by the retry
    assert not peer.resend
    return d, (peer.target_args["db"], peer.target_args["count"])


def test_sub_record_nack_recovers_without_replaying_siblings(lib_dir):
    """Evicting ONE digest inside a mixed container NACKs only that
    record; its siblings run once and it alone is resent FULL."""
    same(_sub_nack, lib_dir)


def _corrupt(pkg, lib_dir):
    F = pkg.core.frame
    d = _mk(pkg, lib_dir, fabric="loopback")
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    base = list(peer.target_args["db"])
    for i in range(3):
        assert d.send_ifunc("p", h, bytes([70 + i]) * 4)
    assert d.flush_coalesced("p")
    d.engine.flush()
    mb = peer.rings[0].mailbox
    buf = mb.slot_view(mb.head)
    hdr = F.peek_header(buf)
    assert hdr is not None and hdr.is_agg
    buf[hdr.payload_offset + 5] ^= 0xFF         # corrupt one sub-record byte
    F._U32.pack_into(buf, hdr.frame_len - F.TRAILER_LEN, F.TRAILER)
    d.drain()
    assert peer.stats["rejected"] == 1
    assert peer.target_args["db"] == base       # no partial execution
    assert peer.credits == 4                    # slot cleared and returned
    return d, peer.target_ctx.stats["last_reject"]


def test_corrupt_aggregate_rejected_whole(lib_dir):
    same(_corrupt, lib_dir)


def _rt(pkg, lib_dir, **kw):
    rt = pkg.tasks.TaskRuntime(
        ctx(pkg, "src", lib_dir),
        engine=pkg.transport.ProgressEngine(flush_threshold=64),
        coalesce=True, **kw)
    rt.add_peer("p", pkg.transport.RdmaFabric(),
                ctx(pkg, "p", lib_dir, link_mode="remote"),
                n_slots=8, slot_size=16 << 10, target_args={})
    h = pkg.core.register_ifunc(rt.ctx, "task_sum", lib_dir)
    assert rt.submit("p", h, b"warm").result(10) == sum(b"warm")
    return rt, h


def _coalesced_reply(pkg, lib_dir):
    rt, h = _rt(pkg, lib_dir, agg_max_subs=16)
    payloads = [bytes([i]) * i for i in range(1, 9)]
    payloads[3] = bytes([255, 7])               # poison record #4
    futs = rt.submit_many("p", h, payloads)
    peer = rt.dispatcher.peers["p"]
    for i, fut in enumerate(futs):
        if i == 3:
            with pytest.raises(pkg.wire.RemoteExecutionError,
                               match="poisoned"):
                fut.result(10)
        else:
            assert fut.result(10) == sum(payloads[i])
    assert peer.stats["agg_sent"] >= 1          # requests coalesced
    assert peer.stats["agg_replies"] >= 1       # ... and so did the replies
    assert rt.stats["orphan_replies"] == 0
    return rt, [outcome(f) for f in futs]


def test_coalesced_reply_demux_to_right_futures(lib_dir):
    """A batch of corr-carrying tasks comes back as ONE FLAG_AGG|FLAG_REPLY
    frame and every future resolves with ITS value, including an error
    future for a poisoned record in the middle of the batch."""
    held(_coalesced_reply, lib_dir)


def _unbudgeted(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    d.set_coalescing(False)                     # plain singletons
    h = _warm(pkg, d, "rle_insert", lib_dir)
    for i in range(4):
        assert d.send("p", _msg(pkg, h, bytes([80 + i]) * 3))
    d.engine.flush()
    rounds_before = d.stats["poll_rounds"]
    assert d.poll() == 4                        # one unbudgeted poll call
    assert d.stats["poll_rounds"] == rounds_before + 1
    for i in range(2):
        assert d.send("p", _msg(pkg, h, bytes([90 + i]) * 3))
    d.engine.flush()
    assert d.poll(budget=1) == 1
    d.drain()
    return d, d.peers["p"].target_args["db"]


def test_unbudgeted_poll_sweeps_whole_ring(lib_dir):
    same(_unbudgeted, lib_dir)


def _overgrown(pkg, lib_dir):
    d = _mk(pkg, lib_dir, n_slots=1, slot_size=8 << 10, max_subs=64)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    base = list(peer.target_args["db"])
    assert d.send("p", _msg(pkg, h, b"hog"))    # occupy the only slot
    recs = [bytes((i * 7 + j) % 251 for j in range(600)) for i in range(24)]
    for r in recs:                              # far past the slot budget
        assert d.send_ifunc("p", h, r)
    assert sum(len(q.subs) for q in peer.coalesce.values()) > 0
    d.drain()                                   # drains hog, splits the queue
    assert peer.target_args["db"] == base + [b"hog"] + recs
    assert peer.stats["agg_sent"] >= 2
    assert not peer.coalesce or not any(
        q.subs for q in peer.coalesce.values())
    return d, peer.target_args["db"]


def test_overgrown_queue_splits_into_multiple_containers(lib_dir):
    same(_overgrown, lib_dir)


def _poisoned_behind(pkg, lib_dir):
    rt, h = _rt(pkg, lib_dir)
    d = rt.dispatcher
    futs, corrs = [], []
    for _ in (b"ab", b"cde"):
        rt._corr += 1
        fut = pkg.tasks.Future(rt, rt._corr, "p", h.name)
        rt.futures[rt._corr] = fut
        futs.append(fut)
        corrs.append(rt._corr)
    assert d.send_ifunc_many("p", h, [b"ab", b"cde"],
                             corr_ids=corrs, futures=futs) == 2
    d.flush_coalesced("p")
    # a corr-less poisoned frame in the NEXT slot
    assert d.send("p", _msg(pkg, h, bytes([255, 9])))
    d.engine.flush()
    with pytest.raises(ValueError, match="poisoned"):
        d.poll()                         # the batched sweep hits both slots
    rt.progress()                        # routes the coalesced reply
    assert futs[0].result(10) == sum(b"ab")
    assert futs[1].result(10) == sum(b"cde")
    assert d.peers["p"].stats["errors"] == 1
    return rt, [outcome(f) for f in futs]


def test_poisoned_slot_behind_aggregate_in_one_batch(lib_dir):
    """A corr-less ifunc raising mid-batch must not discard the statuses of
    frames the same sweep consumed: the aggregate ahead of it completes
    (its futures resolve), then the exception surfaces."""
    held(_poisoned_behind, lib_dir)


def _plain_poisoned(pkg, lib_dir):
    F = pkg.core.frame
    d = _mk(pkg, lib_dir, slot_size=32 << 10)
    h_rle = _warm(pkg, d, "rle_insert", lib_dir)
    h_cnt = _warm(pkg, d, "counter_bump", lib_dir)
    peer = d.peers["p"]
    tgt = peer.target_ctx
    base = list(peer.target_args["db"])
    base_count = peer.target_args["count"]
    assert tgt.link_cache.evict("counter_bump", h_cnt.digest)
    assert d.send_ifunc("p", h_rle, b"AAAA")
    assert d.send_ifunc("p", h_cnt, b"x")
    assert d.flush_coalesced("p")
    h_poison = pkg.core.register_ifunc(d.src_ctx, "task_sum", lib_dir)
    assert d.send("p", _msg(pkg, h_poison, bytes([255, 3])))
    d.engine.flush()
    with pytest.raises(ValueError, match="poisoned"):
        d.poll()                         # one batched sweep hits both
    assert peer.target_args["db"] == base + [b"AAAA"]
    assert peer.stats["nacks"] == 1 and len(peer.resend) == 1
    mb = peer.rings[0].mailbox           # the poisoned slot is still there
    F.scrub_slot(mb.slot_view(mb.head))
    mb.head += 1
    mb.consumed += 1
    d.drain()
    assert peer.target_args["count"] == base_count + 1
    assert not peer.resend
    return d, (peer.target_args["db"], peer.target_args["count"])


def test_plain_lane_poisoned_slot_behind_aggregate(lib_dir):
    """The non-reply-lane twin: the consumed aggregate's status (its NACKed
    record rebuilt, its siblings' digests confirmed) is processed before
    the exception surfaces, and the poisoned slot stays unconsumed."""
    same(_plain_poisoned, lib_dir)


def _bounded(pkg, lib_dir):
    # The age bound is set far past the run's length: an age flush would
    # count one more ``backpressure`` whenever the clock let it fire, and
    # nothing here relies on one (``drain`` flushes the queues itself).
    d = _mk(pkg, lib_dir, n_slots=2, slot_size=8 << 10, max_subs=4,
            max_age=3600.0)
    h = _warm(pkg, d, "rle_insert", lib_dir)
    peer = d.peers["p"]
    assert d.send("p", _msg(pkg, h, b"h1"))     # occupy every ring slot
    assert d.send("p", _msg(pkg, h, b"h2"))
    accepted = 0
    for i in range(64):                  # bound = max_subs * n_slots = 8
        if not d.send_ifunc("p", h, bytes([65 + i % 26]) * 4):
            break
        accepted += 1
    assert accepted == 8
    assert peer.stats["backpressure"] >= 1
    d.drain()
    assert len(peer.target_args["db"]) == 1 + 2 + 8
    return d, accepted


def test_coalescing_queue_bounded_backpressure(lib_dir):
    same(_bounded, lib_dir)


def _ineligible(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = pkg.core.register_ifunc(d.src_ctx, "rle_insert", lib_dir)
    peer = d.peers["p"]
    assert d.send_ifunc("p", h, b"first")       # cold: FULL singleton
    assert peer.stats["coalesced"] == 0
    assert peer.credits == 3                    # claimed a slot at once
    d.drain()
    assert d.send_ifunc("p", h, b"second")      # warm: queued
    assert peer.stats["coalesced"] == 1
    d.drain()
    assert peer.target_args["db"] == [b"first", b"second"]
    return d, peer.target_args["db"]


def test_aggregate_ineligible_until_cache_warm(lib_dir):
    same(_ineligible, lib_dir)


def test_vectorized_parse_matches_naive_oracle():
    """The port's packer and structured parse against the reference's
    packer, structured parse and naive per-record walk: identical
    container bytes, records (continuations, err flags, digests, corr
    ids) and reply tuples, and the same corruptions rejected."""
    import repro.core.frame as RF
    import repro_torch.core.frame as PF

    rng = np.random.default_rng(7)
    subs = []
    for i in range(23):
        name = ["alpha", "beta", "gamma_long_name"][i % 3]
        payload = bytes(rng.integers(0, 256, rng.integers(0, 97),
                                     dtype=np.uint8))
        cont = (bytes(rng.integers(0, 256, 17, dtype=np.uint8))
                if i % 4 == 0 else None)
        subs.append(PF.AggSub(name, PF.CodeKind.PYBC,
                              bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
                              int(rng.integers(0, 1 << 48)), payload,
                              cont=cont, err=i % 5 == 0))
    view = bytearray(PF.agg_frame_len(subs))
    n = PF.pack_agg_into(view, subs)
    payload = bytes(view[:n])
    rview = bytearray(RF.agg_frame_len(subs))
    assert RF.pack_agg_into(rview, subs) == n and bytes(rview[:n]) == payload
    fast = PF.unpack_agg(payload)
    slow = RF.unpack_agg_py(payload)
    assert len(fast) == len(slow) == len(subs)
    for a, b, want in zip(fast, slow, subs):
        for s in (a, b):
            assert (s.name, s.kind, bytes(s.digest), s.corr_id,
                    bytes(s.payload), s.err) == (
                want.name, want.kind, want.digest, want.corr_id,
                bytes(want.payload), want.err)
            assert (want.cont is None and (s.cont is None or len(s.cont) == 0)
                    or bytes(s.cont) == want.cont)
    assert PF.parse_agg(payload).reply_tuples() == \
        RF.parse_agg(payload).reply_tuples()
    # a coalesced reply container seals to the reference's bytes
    cells = [bytearray(PF.agg_frame_len(subs) + PF.HEADER_LEN + 64)
             for _ in range(2)]
    assert PF.seal_agg_frame(cells[0], subs, reply=True) == \
        RF.seal_agg_frame(cells[1], subs, reply=True)
    assert cells[0] == cells[1]
    for pos in (0, 3, len(payload) - 5, len(payload) - 40):
        bad = bytearray(payload)
        bad[pos] ^= 0xFF
        with pytest.raises(PF.FrameError):
            PF.unpack_agg(bytes(bad))
        with pytest.raises(RF.FrameError):
            RF.unpack_agg_py(bytes(bad))
