"""The port's host target held against the reference's on the same bytes.

Each case builds its frame with both packages (from the repo's
``ifunc_libs/`` files, so PYBC sections are equal bit for bit), asserts
the two frames equal, puts each into its own package's mapped region and
polls it with its own package's ``poll_ifunc``.  The outcomes must match:
the ``Status`` by name, the target's ``stats``, the region's bytes after
the poll (cleared or scrubbed), the PYBC ``target_args`` and, for an
aggregate container, each sub-record's status, corr id and error type.

μVM frames run here only in the port (the reference's μVM path needs
``pl.load``, which this jax lacks): their results are held against
``repro.kernels.ref.ifunc_vm_ref`` within 2e-5.  Everything runs on the
CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core import api as RA
from repro.core import frame as RF
from repro.kernels.ref import ifunc_vm_ref
from repro.transport import fabric as RX
import repro_torch.core as PC
from repro_torch.core import api as PA
from repro_torch.core import frame as PF
from repro_torch.core.codegen import deserialize_uvm
from repro_torch.transport import fabric as PX

T = 128
TOL = 2e-5


class Side:
    """One package's source and target over its own RDMA emulation."""

    def __init__(self, core, lib_dir, target_policy=None,
                 source_policy=None, region=1 << 16, **target_kw):
        self.core, self.lib_dir = core, lib_dir
        if core is PC:
            target_kw.setdefault("device", "cpu")
        self.src = core.Context("src", lib_dir=lib_dir, policy=core.SecurityPolicy(
            **(source_policy or {})))
        self.dst = core.Context("dst", lib_dir=lib_dir, policy=core.SecurityPolicy(
            **(target_policy or {})), **target_kw)
        self.ep = self.src.nic.connect(self.dst.nic)
        self.region = self.dst.nic.mem_map(region)

    def handle(self, name):
        return (self.src.handles.get(name)
                or self.core.register_ifunc(self.src, name, self.lib_dir))

    def msg(self, name, payload, **kw):
        return self.core.ifunc_msg_create(self.handle(name), payload, **kw)

    def put(self, frame, deliver=None):
        self.ep.put_nbi(frame, self.region.base, self.region.rkey,
                        deliver_bytes=deliver)

    def poll(self, targs):
        return self.core.poll_ifunc(self.dst, self.region.view(), None, targs)


@pytest.fixture()
def sides(lib_dir):
    def make(**kw):
        return Side(RC, lib_dir, **kw), Side(PC, lib_dir, **kw)
    return make


def _agree(ref, port, want, ref_targs, port_targs, frames=None):
    """Poll both targets once each; both must give ``want`` and agree."""
    if frames is not None:
        assert bytes(frames[0]) == bytes(frames[1])
        ref.put(frames[0])
        port.put(frames[1])
    rs, ps = ref.poll(ref_targs), port.poll(port_targs)
    assert rs.name == ps.name == want
    assert ref.dst.stats == port.dst.stats
    assert bytes(ref.region.buf) == bytes(port.region.buf)
    assert ref_targs == port_targs
    return ps


def _both(ref, port, name, payload, **kw):
    return ref.msg(name, payload, **kw).frame, port.msg(name, payload,
                                                        **kw).frame


def test_full_then_slim_hit(sides):
    ref, port = sides()
    rt, pt = {}, {}
    _agree(ref, port, "OK", rt, pt, _both(ref, port, "counter_bump", b"abc"))
    _agree(ref, port, "OK", rt, pt,
           _both(ref, port, "counter_bump", b"abcd", slim=True))
    assert port.dst.stats["links"] == 1 and pt["count"] == 2


def test_slim_miss_nacks_then_full_resend(sides):
    ref, port = sides()
    rt, pt = {}, {}
    rm = ref.msg("counter_bump", b"xy", slim=True, corr_id=5)
    pm = port.msg("counter_bump", b"xy", slim=True, corr_id=5)
    _agree(ref, port, "NACK_UNCACHED", rt, pt, (rm.frame, pm.frame))
    assert port.dst.stats["last_nack"] == ("counter_bump",
                                           pm.handle.digest)
    full = (RA.ifunc_msg_to_full(rm).frame, PA.ifunc_msg_to_full(pm).frame)
    assert PF.peek_header(full[1]).corr_id == 5
    _agree(ref, port, "OK", rt, pt, full)


def test_corrupt_digest_rejected(sides):
    ref, port = sides()
    frames = _both(ref, port, "counter_bump", b"x")
    for f in frames:
        f[PF.HEADER_LEN + 10] ^= 0x40           # a code byte, not the header
    _agree(ref, port, "REJECTED", {}, {}, frames)
    assert "digest mismatch" in port.dst.stats["last_reject"]


def test_reply_frame_on_request_ring(sides):
    ref, port = sides()
    frames = (RF.pack_reply("counter_bump", b"res", RF.CodeKind.PYBC, 7),
              PF.pack_frame("counter_bump", b"", b"res", PF.CodeKind.PYBC,
                            corr_id=7, flags=PF.FLAG_REPLY))
    _agree(ref, port, "REJECTED", {}, {}, frames)
    assert "reply frame" in port.dst.stats["last_reject"]


def test_continuation_frame_on_flowless_target(sides):
    ref, port = sides()
    cont = bytes(range(24))
    rm = ref.msg("counter_bump", b"x", cont=cont)
    pm = port.msg("counter_bump", b"x", cont=cont)
    assert bytes(pm.cont_view) == bytes(rm.cont_view) == cont
    _agree(ref, port, "REJECTED", {}, {}, (rm.frame, pm.frame))
    assert "flow-less" in port.dst.stats["last_reject"]


class _Hook:
    """A recording flow hook (what ``ctx.flow`` holds on a flow node): it
    notes each continuation it is handed and runs the linked fn, or, with
    ``fail``, raises ``FrameError`` as an ill-formed descriptor does."""

    def __init__(self, frame_mod, fail=False):
        self.F, self.fail, self.seen = frame_mod, fail, []

    def on_flow_frame(self, ctx, hdr, fn, payload, cont, target_args):
        self.seen.append((hdr.name, bytes(payload), bytes(cont)))
        if self.fail:
            raise self.F.FrameError("ill-formed continuation descriptor")
        fn(payload, len(payload), target_args)


@pytest.mark.parametrize("fail", [False, True])
def test_continuation_frame_on_a_hooked_target(sides, fail):
    """With a hook installed the continuation frame goes to
    ``on_flow_frame`` (which owns execution: ``executed`` stays 0); a
    ``FrameError`` out of the hook REJECTS the frame and scrubs the slot,
    in both packages alike."""
    ref, port = sides()
    ref.dst.flow, port.dst.flow = _Hook(RF, fail), _Hook(PF, fail)
    cont = bytes(range(24))
    rt, pt = {}, {}
    _agree(ref, port, "REJECTED" if fail else "OK", rt, pt,
           (ref.msg("counter_bump", b"x", cont=cont).frame,
            port.msg("counter_bump", b"x", cont=cont).frame))
    assert port.dst.flow.seen == ref.dst.flow.seen == [
        ("counter_bump", b"x", cont)]
    assert port.dst.stats["executed"] == 0
    if fail:
        assert "ill-formed" in port.dst.stats["last_reject"]
    else:
        assert pt["count"] == 1


def test_oversize_frame(sides):
    ref, port = sides(target_policy={"max_frame_len": 512})
    _agree(ref, port, "REJECTED", {}, {},
           _both(ref, port, "counter_bump", b"z" * 1024))
    assert "too long" in port.dst.stats["last_reject"]


def test_bad_name(sides):
    ref, port = sides()
    h = port.handle("counter_bump")
    frames = (RF.pack_frame("bad-name", h.lib.code, b"x", RF.CodeKind.PYBC),
              PF.pack_frame("bad-name", h.lib.code, b"x", PF.CodeKind.PYBC))
    _agree(ref, port, "REJECTED", {}, {}, frames)
    assert port.dst.stats["last_reject"].startswith("PolicyViolation")


def test_disallowed_kind(sides):
    ref, port = sides()
    ref.dst.policy = RC.DEVICE_ONLY
    port.dst.policy = PC.DEVICE_ONLY
    _agree(ref, port, "REJECTED", {}, {},
           _both(ref, port, "counter_bump", b"x"))
    assert "not allowed" in port.dst.stats["last_reject"]


@pytest.mark.parametrize("source_key", [None, b"k2"])
def test_hmac_mismatch(sides, source_key):
    ref, port = sides(target_policy={"hmac_key": b"k1"},
                      source_policy={"hmac_key": source_key})
    _agree(ref, port, "REJECTED", {}, {},
           _both(ref, port, "counter_bump", b"x"))
    assert "HMAC" in port.dst.stats["last_reject"]


def test_inflight_trailer_then_flush(sides):
    ref, port = sides()
    ref.dst.max_trailer_spins = port.dst.max_trailer_spins = 20
    frames = _both(ref, port, "rle_insert", b"aaaabbbb" * 8)
    ref.put(frames[0], deliver=len(frames[0]) - 3)
    port.put(frames[1], deliver=len(frames[1]) - 3)
    rt, pt = {"db": []}, {"db": []}
    _agree(ref, port, "IN_PROGRESS", rt, pt)
    ref.ep.flush()
    port.ep.flush()
    _agree(ref, port, "OK", rt, pt)
    assert pt["db"] == [b"aaaabbbb" * 8]


def _agg_subs(F, digests, bad_digests):
    """A mixed container: cached fire-and-forget and corr-carrying records,
    records of two uncached digests (NACKed, two groups), a record whose
    name the policy refuses, corr-carrying records that raise and a
    continuation record (REJECTED on a flow-less target)."""
    cb, rle = digests
    P = F.CodeKind.PYBC
    return [F.AggSub("counter_bump", P, cb, 0, b"a"),
            F.AggSub("counter_bump", P, cb, 0, b"bb"),
            F.AggSub("counter_bump", P, bad_digests[0], 11, b"c"),
            F.AggSub("rle_insert", P, rle, 12, b"\x03a"),
            F.AggSub("bad-name", P, cb, 13, b"d"),
            F.AggSub("counter_bump", P, cb, 14, b"eee"),
            F.AggSub("counter_bump", P, bad_digests[1], 15, b"f"),
            F.AggSub("rle_insert", P, rle, 0, b"\x02b"),
            F.AggSub("counter_bump", P, cb, 0, b"g"),
            F.AggSub("counter_bump", P, cb, 16, b"h", cont=bytes(8))]


def test_host_agg_container_mixed(sides):
    ref, port = sides()
    rt, pt = {"db": []}, {"db": []}
    for name, payload in (("counter_bump", b"x"), ("rle_insert", b"qq")):
        _agree(ref, port, "OK", rt, pt, _both(ref, port, name, payload))
    del rt["db"], pt["db"]                  # rle_insert raises KeyError now
    handles = (port.handle("counter_bump").digest,
               port.handle("rle_insert").digest)
    bad = (b"\xee" * 16, b"\x01" * 16)
    frames = []
    for F in (RF, PF):
        buf = bytearray(4096)
        n = F.seal_agg_frame(buf, _agg_subs(F, handles, bad))
        frames.append(buf[:n])
    _agree(ref, port, "OK", rt, pt, frames)

    def outcome(results):
        return [(r.status.name, r.name, r.digest, r.corr_id, r.value,
                 None if r.error is None else type(r.error).__name__)
                for r in results]
    got = outcome(port.dst.last_agg_results)
    assert got == outcome(ref.dst.last_agg_results)
    assert [g[0] for g in got] == ["OK", "OK", "NACK_UNCACHED", "OK",
                                   "REJECTED", "OK", "NACK_UNCACHED", "OK",
                                   "OK", "REJECTED"]
    assert got[3][5] == got[7][5] == "KeyError"     # poisoned, delivered
    assert got[9][5] == "FrameError"
    # groups run in key order, as np.unique orders them in the reference:
    # the last NACK is the larger digest's, though it comes first
    assert port.dst.stats["last_nack"] == ("counter_bump", bad[0])
    assert port.dst.stats["agg_errors"] == 2
    assert pt["count"] == 5


def test_host_agg_container_mixed_on_a_hooked_target(sides):
    """``test_host_agg_container_mixed``'s container on a target with a
    flow hook: the continuation record goes to ``on_flow_frame`` (its
    name, payload and descriptor) instead of being rejected; every other
    record's outcome is unchanged, in both packages alike."""
    ref, port = sides()
    rt, pt = {"db": []}, {"db": []}
    for name, payload in (("counter_bump", b"x"), ("rle_insert", b"qq")):
        _agree(ref, port, "OK", rt, pt, _both(ref, port, name, payload))
    del rt["db"], pt["db"]
    ref.dst.flow, port.dst.flow = _Hook(RF), _Hook(PF)
    handles = (port.handle("counter_bump").digest,
               port.handle("rle_insert").digest)
    bad = (b"\xee" * 16, b"\x01" * 16)
    frames = []
    for F in (RF, PF):
        buf = bytearray(4096)
        n = F.seal_agg_frame(buf, _agg_subs(F, handles, bad))
        frames.append(buf[:n])
    _agree(ref, port, "OK", rt, pt, frames)

    def outcome(results):
        return [(r.status.name, r.name, r.digest, r.corr_id, r.value,
                 None if r.error is None else type(r.error).__name__)
                for r in results]
    got = outcome(port.dst.last_agg_results)
    assert got == outcome(ref.dst.last_agg_results)
    assert [g[0] for g in got] == ["OK"] * 2 + ["NACK_UNCACHED", "OK",
                                                "REJECTED", "OK",
                                                "NACK_UNCACHED"] + ["OK"] * 3
    assert got[9][5] is None
    assert port.dst.flow.seen == ref.dst.flow.seen == [
        ("counter_bump", b"h", bytes(8))]
    assert port.dst.stats["agg_errors"] == 2
    assert pt["count"] == 6


# ---------------------------------------------------------------- HLO


def test_hlo_frames_match_reference():
    """The same function as a reference ``jax.export`` frame on a reference
    target and as a ``torch.export`` frame on a port target, each with the
    same payload bytes, FULL then a SLIM cache hit: equal results,
    ``Status`` and stats (``bytes_in`` aside, since the two code sections
    differ in length, each is its frames' lengths) and cleared slots."""
    import jax
    import jax.numpy as jnp

    from repro.core import codegen as RCG
    from repro_torch.core import codegen as PCG

    codes = (RCG.serialize_hlo(lambda x: (x.astype(jnp.float32) * 3 - 7).sum(),
                               (jax.ShapeDtypeStruct((16,), jnp.uint8),)),
             PCG.serialize_hlo(lambda x: (x.to(torch.float32) * 3 - 7).sum(),
                               (torch.zeros(16, dtype=torch.uint8),)))
    seen = []
    for core, F, code in ((RC, RF, codes[0]), (PC, PF, codes[1])):
        kw = {"device": "cpu"} if core is PC else {}
        dst = core.Context("dst", **kw)
        region = dst.nic.mem_map(1 << 16)
        ep = core.Context("src").nic.connect(dst.nic)
        out, lens = [], 0
        for payload, slim in ((bytes(range(16)), False),
                              (bytes(range(200, 216)), True)):
            frame = F.pack_frame("hlo_affine_sum", code, payload,
                                 F.CodeKind.HLO, slim=slim)
            lens += len(frame)
            ep.put_nbi(frame, region.base, region.rkey)
            targs = {}
            st = core.poll_ifunc(dst, region.view(), None, targs)
            out.append((st.name, float(np.asarray(targs["result"]))))
        assert dst.stats.pop("bytes_in") == lens
        seen.append((out, dst.stats, bytes(region.buf)))
    assert seen[0] == seen[1]
    assert seen[1][0] == [("OK", float(np.arange(16).sum() * 3 - 7 * 16)),
                          ("OK", float(np.arange(200, 216).sum() * 3
                                       - 7 * 16))]
    assert seen[1][1]["links"] == 1 and not any(seen[1][2])


# ---------------------------------------------------------------- μVM


def _uvm_pair(lib_dir, dst):
    """The reference's and the port's uvm_affine handles (the port's from
    its own library file, the μVM section equal), a region on the port
    target ``dst`` and an endpoint to it."""
    ref_h = RC.register_ifunc(RC.Context("rs", lib_dir=lib_dir), "uvm_affine")
    src = PC.Context("ps", device="cpu")
    port_h = PC.register_ifunc(src, "uvm_affine")
    assert port_h.lib.code == ref_h.lib.code
    return ref_h, port_h, dst.nic.mem_map(1 << 20), src.nic.connect(dst.nic)


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_uvm_frame_against_oracle(lib_dir, n_tiles):
    dst = PC.Context("dst", device="cpu")
    ref_h, port_h, region, ep = _uvm_pair(lib_dir, dst)
    rng = np.random.default_rng(n_tiles)
    x = rng.standard_normal((n_tiles, T, T)).astype(np.float32)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    frame = PC.ifunc_msg_create(port_h, x).frame
    assert frame == RC.ifunc_msg_create(ref_h, x).frame
    PC.ifunc_msg_send_nbix(ep, PC.ifunc_msg_create(port_h, x), region.base,
                           region.rkey)
    targs = {"externals": {"W": torch.from_numpy(W)}}
    assert PC.poll_ifunc(dst, region.view(), None, targs) == PC.Status.OK
    want = ifunc_vm_ref(deserialize_uvm(port_h.lib.code), x, W[None])
    np.testing.assert_allclose(targs["result"].numpy(), want, rtol=TOL,
                               atol=TOL)
    assert targs["results"] == [targs["result"]]
    assert dst.stats["links"] == 1 and not any(region.buf)


def test_uvm_result_is_copied_out_of_the_slot(lib_dir):
    """Two frames through one slot: the poll clears the slot after each,
    and the second overwrites it, yet the first result stands."""
    dst = PC.Context("dst", device="cpu")
    _, h, region, ep = _uvm_pair(lib_dir, dst)
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 1, T, T)).astype(np.float32)
    W = np.eye(T, dtype=np.float32)
    targs = {"externals": {"W": W}}
    for x in xs:
        PC.ifunc_msg_send_nbix(ep, PC.ifunc_msg_create(h, x), region.base,
                               region.rkey)
        assert PC.poll_ifunc(dst, region.view(), None, targs) == PC.Status.OK
    first, second = targs["results"]
    np.testing.assert_array_equal(first.numpy(), np.maximum(xs[0], 0))
    np.testing.assert_array_equal(second.numpy(), np.maximum(xs[1], 0))


def test_uvm_frame_without_a_card_raises(lib_dir, monkeypatch):
    """A μVM frame on a ``device="cuda"`` target with no card is an error
    out of ``poll_ifunc``: never REJECTED, never run on the CPU, the slot
    left as it was."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dst = PC.Context("dst", device="cuda")
    _, h, region, ep = _uvm_pair(lib_dir, dst)
    x = np.ones((1, T, T), np.float32)
    PC.ifunc_msg_send_nbix(ep, PC.ifunc_msg_create(h, x), region.base,
                           region.rkey)
    before = bytes(region.buf)
    targs = {"externals": {"W": np.eye(T, dtype=np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PC.poll_ifunc(dst, region.view(), None, targs)
    assert bytes(region.buf) == before
    assert dst.stats["rejected"] == 0 and dst.stats["executed"] == 0
    assert "result" not in targs


def test_uvm_agg_container_records(lib_dir):
    """A host FLAG_AGG container of one-tile μVM records: one result per
    record, each against the oracle."""
    dst = PC.Context("dst", device="cpu")
    _, h, region, ep = _uvm_pair(lib_dir, dst)
    rng = np.random.default_rng(5)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    targs = {"externals": {"W": W}}
    PC.ifunc_msg_send_nbix(ep, PC.ifunc_msg_create(h, W[None]), region.base,
                           region.rkey)                 # links uvm_affine
    assert PC.poll_ifunc(dst, region.view(), None, targs) == PC.Status.OK
    xs = rng.standard_normal((4, T, T)).astype(np.float32)
    buf = bytearray(region.size)
    n = PF.seal_agg_frame(buf, [PF.AggSub("uvm_affine", PF.CodeKind.UVM,
                                          h.digest, 100 + i, x.tobytes())
                                for i, x in enumerate(xs)])
    ep.put_nbi(buf[:n], region.base, region.rkey)
    assert PC.poll_ifunc(dst, region.view(), None, targs) == PC.Status.OK
    prog = deserialize_uvm(h.lib.code)
    for i, r in enumerate(dst.last_agg_results):
        assert (r.status, r.corr_id, r.error) == (PC.Status.OK, 100 + i, None)
        np.testing.assert_allclose(r.value.numpy(), ifunc_vm_ref(
            prog, xs[i:i + 1], W[None]), rtol=TOL, atol=TOL)


# ------------------------------------------------ the quickstart and rings


def test_quickstart_matches_reference(lib_dir):
    """The paper's Listing 1.4 on both packages: the same frame, the record
    decoded at the target, links=1 executed=1."""
    record = b"aaaaabbbbbccccc" * 100
    out = []
    for core in (RC, PC):
        kw = {"device": "cpu"} if core is PC else {}
        source = core.Context("source", lib_dir=lib_dir)
        target = core.Context("target", lib_dir=lib_dir, link_mode="remote",
                              **kw)
        region = target.nic.mem_map(1 << 20)
        ep = source.nic.connect(target.nic)
        msg = core.ifunc_msg_create(core.register_ifunc(source, "rle_insert"),
                                    record)
        frame = bytes(msg.frame)
        core.ifunc_msg_send_nbix(ep, msg, region.base, region.rkey)
        core.ifunc_msg_free(msg)
        assert msg.nbytes == 0
        database = {"db": []}
        while core.poll_ifunc(target, region.view(), None,
                              database) != core.Status.OK:
            pass
        assert database["db"] == [record]
        assert (target.stats["links"], target.stats["executed"]) == (1, 1)
        out.append((frame, target.stats))
    assert out[0] == out[1]


def _ring_side(core, X, lib_dir, n_slots=4, slot=1024):
    kw = {"device": "cpu"} if core is PC else {}
    src = core.Context("src", lib_dir=lib_dir)
    dst = core.Context("dst", lib_dir=lib_dir, **kw)
    region = dst.nic.mem_map(n_slots * slot)
    ring = core.RingBuffer(region, slot)
    return src, dst, src.nic.connect(dst.nic), ring, X.ring_mailbox(ring)


def test_ring_sweep_pending_raise_and_agg_harvest(lib_dir):
    """``ring_mailbox(ring).sweep``: an ifunc that raises behind consumed
    frames stops the batch into ``pending_raise`` with the slot left; a
    consumed container's outcomes land in ``last_agg`` under its slot."""
    seen = []
    for core, X, F in ((RC, RX, RF), (PC, PX, PF)):
        src, dst, ep, ring, mb = _ring_side(core, X, lib_dir)
        h_cb = core.register_ifunc(src, "counter_bump")
        h_rle = core.register_ifunc(src, "rle_insert")
        frames = [core.ifunc_msg_create(h_cb, b"a").frame,
                  core.ifunc_msg_create(h_rle, b"b").frame]
        for f in frames:
            ep.put_nbi(f, ring.slot_addr(ring.tail), ring.region.rkey)
            ring.tail += 1
        targs = {"db": []}
        assert mb.sweep(dst, targs) == [core.Status.OK, core.Status.OK,
                                        core.Status.NO_MESSAGE]
        del targs["db"]                         # the next rle_insert raises
        buf = bytearray(512)
        n = F.seal_agg_frame(buf, [F.AggSub("counter_bump", F.CodeKind.PYBC,
                                            h_cb.digest, 9, b"z")])
        for f in (buf[:n], core.ifunc_msg_create(h_rle, b"c").frame):
            ep.put_nbi(f, ring.slot_addr(ring.tail), ring.region.rkey)
            ring.tail += 1
        sts = mb.sweep(dst, targs)
        assert sts == [core.Status.OK]
        assert isinstance(mb.pending_raise, KeyError)
        assert [r.corr_id for r in mb.last_agg[2]] == [9]
        with pytest.raises(KeyError):
            core.poll_ring(dst, ring, targs)
        seen.append((ring.head, mb.consumed, dst.stats,
                     bytes(ring.region.buf), targs))
    assert seen[0] == seen[1]


def test_stream_frame_rejected(lib_dir):
    """A FLAG_STREAM frame whose descriptor is all zeros is REJECTED and
    scrubbed, polled directly (no stream state: the reference's refusal)
    and through a mailbox sweep (the descriptor's geometry fails to
    parse), with the slot bytes and stats the reference ends with."""
    seen = []
    for core, X, F in ((RC, RX, RF), (PC, PX, PF)):
        src, dst, ep, ring, mb = _ring_side(core, X, lib_dir)
        h = core.register_ifunc(src, "counter_bump")
        frame = F.pack_frame("counter_bump", h.lib.code, bytes(64),
                             F.CodeKind.PYBC, flags=F.FLAG_STREAM)
        core.ifunc_msg_send_nbix(ep, core.ifunc_msg_create(h, b"x"),
                                 ring.slot_addr(0), ring.region.rkey)
        ep.put_nbi(frame, ring.slot_addr(1), ring.region.rkey)
        direct = core.poll_ifunc(dst, ring.slot_view(1), None, {})
        ep.put_nbi(frame, ring.slot_addr(1), ring.region.rkey)
        sts = (mb.sweep(dst, {}, budget=2) if core is PC
               else [core.poll_ifunc(dst, ring.slot_view(0), None, {}),
                     core.poll_ifunc(dst, ring.slot_view(1), None, {})])
        seen.append(([s.name for s in [direct] + sts],
                     {k: v for k, v in dst.stats.items() if k != "last_reject"},
                     bytes(ring.region.buf)))
    assert seen[0] == seen[1]
    assert seen[1][0] == ["REJECTED", "OK", "REJECTED"]
    assert "inconsistent stream geometry" in dst.stats["last_reject"]


def test_active_messages_match_reference():
    """The AM baseline in both packages, driven with the same sends: eager,
    a 100,000 B rendezvous, 20 ordered sends and one to an unregistered
    id.  Delivered payloads, ``progress()`` counts, stats, the channel's
    and endpoint's counters, the internal ring's bytes and the error must
    match."""
    seen = []
    for core in (RC, PC):
        a, b = core.AmContext("a"), core.AmContext("b")
        got = []
        b.register(3, lambda p, n, t: got.append((3, n, bytes(p))))
        b.register(1, lambda p, n, t: got.append((1, n, bytes(p))))
        ep = core.AmEndpoint(a, b)
        ep.send(3, b"small")
        ep.send(3, bytes(range(256)) * 390 + b"L" * 160)   # 100,000 B
        ep.flush()
        counts = [b.progress()]
        for i in range(20):
            ep.send(1, bytes([i]) * (i + 1))
        ep.flush()
        counts.append(b.progress())
        ep.send(9, b"x")
        ep.flush()
        with pytest.raises(Exception) as e:
            b.progress()
        seen.append((got, counts, dict(b.stats), ep._chan.stats,
                     ep.ep.stats, bytes(b._region.buf),
                     type(e.value).__name__, str(e.value)))
    assert seen[0] == seen[1]
    assert seen[1][1] == [2, 20] and seen[1][6] == "AmError"
    assert seen[1][0][1][1] == 100_000


# --------------------------------------------------- fabric and rdma bytes


def test_rdma_fabric_channel_ops_match_reference(lib_dir):
    """Channel puts (whole, sub-slot, scatter-gather with a withheld tail),
    the Channel form of ``ifunc_msg_send_nbix`` and the bounds checks land
    the same bytes in both packages' regions."""
    regions = []
    for core, X in ((RC, RX), (PC, PX)):
        kw = {"device": "cpu"} if core is PC else {}
        src = core.Context("src", lib_dir=lib_dir)
        dst = core.Context("dst", lib_dir=lib_dir, **kw)
        fab = X.RdmaFabric()
        mb = fab.open_mailbox(dst, 4, 512)
        ch = fab.connect(src, mb)
        msg = core.ifunc_msg_create(core.register_ifunc(src, "counter_bump"),
                                    b"hello")
        assert core.ifunc_msg_send_nbix(ch, msg, 1) == core.Status.OK
        assert X.frame_fits(msg.frame, mb) and mb.peek() is None
        ch.put_at(b"\x07" * 9, 2, 100, deliver_bytes=4)
        ch.putv_at([(0, b"head"), (40, b"tail-bytes")], 3, withhold_tail=3)
        with pytest.raises(X.TransportError):
            ch.put(bytes(513), 0)
        with pytest.raises(X.TransportError):
            ch.putv_at([(500, bytes(16))], 0)
        before = bytes(mb.region.buf)
        ch.flush()
        mb.head = 1
        assert mb.peek().name == "counter_bump"
        t = {}
        assert mb.sweep(dst, t, budget=1) == [core.Status.OK]
        regions.append((before, bytes(mb.region.buf), ch.stats, t))
    assert regions[0] == regions[1]


def test_rdma_access_checks_match_reference():
    """rkey, permission and bounds are checked before any byte moves; a
    prepared work request re-checks its mapping on each post."""
    from repro.core import rdma as RR
    from repro_torch.core import rdma as PR

    seen = []
    for R in (RR, PR):
        a, b = R.Nic("a"), R.Nic("b")
        ro = b.mem_map(256, R.Access.READ)
        rw = b.mem_map(256)
        ep = a.connect(b)
        errs = []
        for args in ((b"x", ro.base, ro.rkey), (b"x" * 300, rw.base, rw.rkey),
                     (b"x", rw.base, rw.rkey ^ 1)):
            with pytest.raises(R.AccessDenied) as e:
                ep.put_nbi(*args)
            errs.append(str(e.value).split(":")[1].split("@")[0])
        wr = ep.prepare_putv([(0, b"abc"), (8, b"defgh")], rw.base, rw.rkey,
                             withhold_tail=2)
        wr.post()
        mid = bytes(rw.buf)
        ep.flush()
        assert ep.get(rw.base, 13, rw.rkey) == bytes(rw.buf[:13])
        b.mem_unmap(rw)
        with pytest.raises(R.AccessDenied):
            wr.post()
        seen.append((errs, mid, bytes(rw.buf), ep.stats))
    assert seen[0] == seen[1]


def test_registry_link_cache_and_kinds(lib_dir):
    """LinkCache's LRU bound, eviction and stats, and the library kinds
    (pybc with an HMAC key, uvm), against the reference's registry."""
    from repro.core import registry as RR
    from repro_torch.core import registry as PR

    seen = []
    for R in (RR, PR):
        c = R.LinkCache(capacity=2)
        for k in ("a", "b", "c"):
            c.insert(k, b"d", k.upper())
        hits = [c.lookup("a", b"d"), c.lookup("b", b"d"), c.lookup("c", b"d")]
        c.insert("d", b"d", "D")
        c.invalidate("b")
        evicted = (c.evict("d", b"d"), c.evict("d", b"d"))
        lib = R.IfuncLibrary.load("rle_insert", lib_dir, hmac_key=b"k")
        seen.append((hits, evicted, c.stats(), lib.code, lib.code_digest,
                     lib.kind.name, lib.streaming))
        with pytest.raises(R.RegistryError):
            R.LinkCache(capacity=0)
    assert seen[0] == seen[1]
    ctx = PC.Context("c")
    h = PC.register_ifunc(ctx, "counter_bump", lib_dir)
    assert ctx.handles == {"counter_bump": h}
    PC.deregister_ifunc(ctx, h)
    assert ctx.handles == {}
