"""The port's streamed large payloads (frame v2.5 ``FLAG_STREAM``), wire
codecs and multi-ring striping, held against the reference's on the CPU.

* The 16 cases of ``tests/test_stream.py``, each run through both packages
  on the same inputs: the wire format (descriptor and chunk round trips,
  the flag rules, the pending-versus-corrupt order of ``peek_chunk``), the
  blockwise ``fletcher32`` against ``fletcher32_py``, the codecs, the
  dispatcher's stream life (exec-on-arrival past the window, buffered
  assembly, the auto-route, SLIM -> NACK -> FULL re-open once, the
  geometry clamp), its failures (a corrupt chunk rejects its stream
  alone; ``fail_inflight`` and ``drain(deadline=)`` resolve a
  half-arrived stream's future) and the striping-aware queue depth.
  Besides each case's own assertions the two runs must agree on
  statuses, ``per_peer_stats()`` (``links``, ``nacks``, ``resent``,
  ``streams``, ``stream_chunks`` among them), the dispatcher's, engine's
  and targets' stats, link-cache counters, ring and slab bytes, the
  channels' wire bytes, results, obs counters and span names
  (``same_stream_run``).
* ``tests/test_device_agg.py::test_striping_fifo_under_resends`` (an RDMA
  peer of two striped rings) the same way.
* ``fig_stream``'s stream cell (``chip_smoke.fig_stream_cells``) at small
  sizes through both packages.
* ``chip_smoke.py`` phase 22's parts at a small size through both
  packages (the port at ``device="cpu"``): 4-tile ``uvm_affine`` streams
  raw and under ``quant8`` (the assembled bytes equal, within the codec's
  bound of the payload), the bulk ingest at 64 KiB, and a striped peer of
  2 x 8 slots.  The reference's μVM path needs ``pl.load``, which this
  jax lacks, so its ``uvm_execute`` is swapped for
  ``repro.kernels.ref.ifunc_vm_ref`` there.
"""

import importlib
import struct

import numpy as np
import pytest

import chip_smoke
import repro.kernels.ops as RK
from repro.kernels.ref import ifunc_vm_ref
from test_torch_transport import PKGS, PORT, REF, ctx, same_run

T = 128
TOL = dict(rtol=1e-4, atol=1e-5)


def mod(pkg, name):
    """``<package>.<name>`` of ``pkg`` (REF or PORT)."""
    root = "repro" if pkg is REF else "repro_torch"
    return importlib.import_module(f"{root}.{name}")


_MEMOS = (("core.frame", "_PEEK_MEMO"), ("core.frame", "_DESC_MEMO"),
          ("core.frame", "_CHUNK_MEMO"), ("core.api", "_OPEN_MEMO"))


@pytest.fixture(autouse=True)
def fresh_memos():
    """Both packages' receive-side memos start empty, so a case's two runs
    begin from the same state whatever ran before in this process."""
    for pkg in PKGS:
        for name, attr in _MEMOS:
            memo = getattr(mod(pkg, name), attr)
            memo[:] = [None] * len(memo)


@pytest.fixture()
def ref_uvm_oracle(monkeypatch):
    """The reference's host μVM execution through its numpy oracle."""
    monkeypatch.setattr(RK, "uvm_execute", lambda prog, tiles, ext:
                        ifunc_vm_ref(prog, tiles, np.stack(ext)))


def outcome(fn):
    """("ok", value) or ("err", exception type, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return ("err", type(e).__name__, str(e))


def _wire(ch):
    return (getattr(ch, "ep", None) or ch).stats


def same_stream_run(rd, pd, *, spans=True):
    """``same_run`` plus what streams and stripes add: link-cache counters
    (the memos' bookkeeping), each channel's wire stats, receive state,
    the stripe rotation and the pump."""
    same_run(rd, pd, spans=spans)
    for name, rp in rd.peers.items():
        pp = pd.peers[name]
        if rp.target_ctx is not None:
            assert pp.target_ctx.link_cache.stats() == \
                rp.target_ctx.link_cache.stats(), name
        for rr, pr in zip(rp.rings, pp.rings):
            assert _wire(pr.channel) == _wire(rr.channel), name
            assert sorted(pr.mailbox.streams) == sorted(rr.mailbox.streams)
        assert (pp.stripe, pp.stripe_tx, pp.stripe_rx) == \
            (rp.stripe, rp.stripe_tx, rp.stripe_rx), name
    assert len(pd._active_streams) == len(rd._active_streams)


def both(scenario, lib_dir, **kw):
    return tuple(scenario(pkg, lib_dir, **kw) for pkg in PKGS)


def _mk(pkg, lib_dir, *, n_slots=4, slot_size=32 << 10, fabric=None,
        **peer_kw):
    """The reference test's ``_mk`` through ``pkg``, traced."""
    X = pkg.transport
    d = X.Dispatcher(ctx(pkg, "src", lib_dir),
                     X.ProgressEngine(flush_threshold=64),
                     obs=pkg.obs.Obs("stream", trace=True))
    d.add_peer("p", fabric if fabric is not None else X.RdmaFabric(),
               ctx(pkg, "p", lib_dir, link_mode="remote"),
               n_slots=n_slots, slot_size=slot_size,
               target_args={"db": []}, **peer_kw)
    return d


def _reg(pkg, d, lib_dir, name):
    return pkg.core.register_ifunc(d.src_ctx, name, lib_dir)


# ---------------------------------------------------------------------------
# wire format


def _legality(F):
    pay = bytes(F.STREAM_DESC_LEN)
    out = []
    for flags, cont, body in (
            (F.FLAG_STREAM | F.FLAG_REPLY, None, pay),
            (F.FLAG_STREAM | F.FLAG_AGG, None, pay),
            (F.FLAG_STREAM, b"\x01\x02", pay),
            (F.FLAG_STREAM, None, pay[:-1]),      # smaller than the desc
            (F.FLAG_STREAM, None, pay)):
        buf = F.pack_frame("x", b"", body, F.CodeKind.PYBC, flags=flags,
                           cont=cont)
        out.append((bytes(buf),
                    outcome(lambda b=buf: F.peek_header(b).is_stream)))
    return out


def test_stream_flag_legality():
    ref, port = _legality(mod(REF, "core.frame")), _legality(
        mod(PORT, "core.frame"))
    assert port == ref
    got = [o for _, o in port]
    for o in got[:3]:
        assert o[0] == "err" and "request singletons" in o[2]
    assert got[3][0] == "err" and "smaller than its" in got[3][2]
    assert got[4] == ("ok", True)


def _desc_cases(F, W):
    d = F.StreamDesc(total_len=1000, n_chunks=4, chunk_bytes=256, window=2,
                     codec=W.RLE, sflags=F.SFLAG_EXEC_ON_ARRIVAL,
                     cell=256 + F.CHUNK_OVERHEAD, nonce=0xDEAD)
    buf = bytearray(F.stream_payload_len(d.window, d.cell))
    F.pack_stream_desc(buf, 0, d)
    got = F.parse_stream_desc(buf, 0, len(buf))
    assert got == d and got.exec_on_arrival
    assert got.cell_off(0) == 0 and got.cell_off(3) == d.cell
    out = [bytes(buf), (got.total_len, got.n_chunks, got.chunk_bytes,
                        got.window, got.codec, got.sflags, got.cell,
                        got.nonce)]
    for kw in ({"window": 0}, {"cell": 256}, {"n_chunks": 5},
               {"window": 3}):
        b = F.StreamDesc(**{**d.__dict__, **kw})
        buf2 = bytearray(len(buf))
        F.pack_stream_desc(buf2, 0, b)
        o = outcome(lambda b2=buf2: F.parse_stream_desc(b2, 0, len(buf)))
        assert o[:2] == ("err", "FrameError"), kw
        out.append((bytes(buf2), o))
    return out


def test_stream_desc_roundtrip_and_validation():
    assert _desc_cases(mod(PORT, "core.frame"),
                       mod(PORT, "transport.codec")) == \
        _desc_cases(mod(REF, "core.frame"), mod(REF, "transport.codec"))


def _peek_cases(F, W):
    out = []
    data = bytes(range(64))
    cell = bytearray(len(data) + F.CHUNK_OVERHEAD)
    hdr, seal = F.pack_chunk_hdr(3, len(data), len(data), W.RAW, nonce=7)
    out.append((hdr, seal))
    cell[:F.CHUNK_HDR_LEN] = hdr
    cell[F.CHUNK_HDR_LEN:F.CHUNK_HDR_LEN + len(data)] = data
    peek = lambda *a, **k: outcome(lambda: F.peek_chunk(cell, *a, **k))  # noqa: E731
    out.append(peek(3, nonce=7))                 # seal withheld: pending
    cell[F.CHUNK_HDR_LEN + len(data):] = seal
    out += [peek(3, nonce=7), peek(4, nonce=7), peek(3, nonce=8),
            peek(3, max_raw=len(data) - 1, nonce=7)]
    big, _ = F.pack_chunk_hdr(3, len(cell), len(data), W.RAW, nonce=7)
    cell[:F.CHUNK_HDR_LEN] = big
    out.append(peek(3, nonce=7))                 # comp_len out of the cell
    cell[:F.CHUNK_HDR_LEN] = hdr
    cell[12] ^= 0xFF                             # codec_used, covered
    chk = struct.unpack_from("<I", bytes(cell), 16)[0]
    struct.pack_into("<I", cell, F.CHUNK_HDR_LEN + len(data), chk)
    out.append(peek(3, nonce=7))                 # the fletcher catches it
    stage = bytearray(96)
    F.pack_chunk_into(stage, 8, 60, 5, 32, 40, W.RLE, nonce=9)
    out.append(bytes(stage))
    return out


def test_chunk_peek_pending_vs_corrupt():
    port = _peek_cases(mod(PORT, "core.frame"), mod(PORT, "transport.codec"))
    assert port == _peek_cases(mod(REF, "core.frame"),
                               mod(REF, "transport.codec"))
    _, pending, ok, other_seq, other_nonce, raw_big, oob, flipped, _ = port
    assert pending == ("ok", None) and ok == ("ok", (64, 64, 0))
    assert other_seq == other_nonce == ("ok", None)
    assert raw_big[0] == "err" and "exceeds the" in raw_big[2]
    assert oob[0] == "err" and "exceeds its" in oob[2]
    assert flipped[0] == "err" and "fletcher mismatch" in flipped[2]


def test_blockwise_fletcher_matches_oracle(monkeypatch):
    RF, PF = mod(REF, "core.frame"), mod(PORT, "core.frame")
    for F in (RF, PF):
        monkeypatch.setattr(F, "_VEC_BLOCK", 8)   # many carried blocks
    rng = np.random.default_rng(42)
    for n in (0, 1, 2, 15, 16, 17, 127, 128, 129, 255, 1024, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = RF.fletcher32_py(data)
        assert PF.fletcher32_py(data) == want, n
        assert PF.fletcher32(data) == RF.fletcher32(data) == want, n


# ---------------------------------------------------------------------------
# wire codecs


def _codec_cases(W):
    out = [W.get_codec(None).id, W.get_codec("rle").id,
           W.get_codec(W.QUANT8).name, W.get_codec(W.get_codec("rle")).id,
           outcome(lambda: W.get_codec("zstd"))[:2]]
    rle = W.get_codec("rle")
    runs = np.repeat(np.arange(5, dtype="<u4"), 200).tobytes()
    coded = rle.encode(runs)
    assert coded is not None and len(coded) < len(runs)
    assert rle.decode(coded, len(runs)) == runs
    out += [coded, rle.encode(np.arange(256, dtype="<u4").tobytes()),
            rle.encode(b"abc")]
    q8 = W.get_codec("quant8")
    vals = np.linspace(-1.0, 1.0, 512, dtype="<f4")
    coded = q8.encode(vals.tobytes())
    assert coded is not None and len(coded) < vals.nbytes // 3
    back = np.frombuffer(q8.decode(coded, vals.nbytes), "<f4")
    assert np.allclose(back, vals, atol=1.0 / 127.0)
    q, scale = W.quantize8_np(vals)
    out += [coded, back.tobytes(), q.tobytes(), scale,
            outcome(lambda: q8.decode(coded[:-1], vals.nbytes))[:2],
            outcome(lambda: rle.decode(b"\x05\x00\x00\x00", 8))[:2]]
    return out


def test_codec_negotiation_and_roundtrips():
    port = _codec_cases(mod(PORT, "transport.codec"))
    assert port == _codec_cases(mod(REF, "transport.codec"))
    assert port[:4] == [0, 1, "quant8", 1]
    assert port[4] == ("err", "CodecError")
    assert port[-2] == port[-1] == ("err", "CodecError")


# ---------------------------------------------------------------------------
# dispatcher end to end


def _exec_on_arrival(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    assert h.lib.streaming
    vals = np.arange(5000, dtype="<u4")
    assert d.send_stream("p", h, vals.tobytes(), chunk_bytes=2048, window=3)
    d.drain()
    peer = d.peers["p"]
    assert peer.target_args["result"] == {
        "count": 5000, "sum": int(vals.sum()), "min": 0, "max": 4999}
    assert peer.stats["streams"] == 1
    assert peer.stats["stream_chunks"] == 10
    assert peer.stats["delivered"] == 1
    assert not peer.rings[0].mailbox.streams
    assert not d._active_streams
    return d


def test_stream_exec_on_arrival_past_window(lib_dir):
    """10 chunks through a window of 3: the pump refills in-poll and the
    streaming-aware ifunc reduces every chunk as it lands."""
    rd, pd = both(_exec_on_arrival, lib_dir)
    same_stream_run(rd, pd)
    assert pd.peers["p"].target_args["result"] == \
        rd.peers["p"].target_args["result"]
    names = {s.name.split("[")[0] for s in pd.obs.tracer.events}
    assert {"stream_open:host_aggregate@p", "chunk:host_aggregate",
            "stream:host_aggregate@p"} <= names


def _buffered(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir, "rle_insert")
    assert not h.lib.streaming
    payload = bytes((3, 65, 2, 66)) * 100
    assert d.send_stream("p", h, payload, chunk_bytes=64, window=2)
    d.drain()
    assert d.peers["p"].target_args["db"] == [b"AAABB" * 100]
    return d


def test_stream_buffered_assembly_for_plain_ifunc(lib_dir):
    """A non-streaming ifunc sees ONE assembled payload and runs once."""
    rd, pd = both(_buffered, lib_dir)
    same_stream_run(rd, pd)
    assert "exec:rle_insert@p" in {s.name for s in pd.obs.tracer.events}


def _autoroute(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    d.set_streaming(True, chunk_bytes=2048, window=2, threshold=1024)
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    big = np.arange(2000, dtype="<u4")
    d.send_ifunc("p", h, big.tobytes())
    d.drain()
    peer = d.peers["p"]
    assert peer.stats["streams"] == 1
    counts = [peer.target_args["result"]["count"]]
    small = np.arange(100, dtype="<u4")
    d.send_ifunc("p", h, small.tobytes())
    d.drain()
    assert peer.stats["streams"] == 1
    counts.append(peer.target_args["result"]["count"])
    assert counts == [2000, 100]
    return d


def test_stream_autoroute_threshold(lib_dir):
    same_stream_run(*both(_autoroute, lib_dir))


def _autoroute_off_and_striped(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    d.send_ifunc("p", h, np.arange(3000, dtype="<u4").tobytes())
    d.drain()
    assert d.peers["p"].stats["streams"] == 0
    assert d.peers["p"].target_args["result"]["count"] == 3000
    X = pkg.transport
    d2 = X.Dispatcher(ctx(pkg, "src", lib_dir),
                      X.ProgressEngine(flush_threshold=64),
                      obs=pkg.obs.Obs("stripe", trace=True))
    d2.add_peer("s", X.RdmaFabric(), ctx(pkg, "s", lib_dir,
                                         link_mode="remote"),
                n_slots=4, slot_size=32 << 10, rings=2, stripe=True,
                target_args={})
    d2.set_streaming(True, threshold=1024)
    h2 = _reg(pkg, d2, lib_dir, "host_aggregate")
    refused = outcome(lambda: d2.send_stream("s", h2, bytes(8192)))
    assert refused[:2] == ("err", "TransportError") and "striped" in \
        refused[2]
    ring_kw = outcome(lambda: d2.send_ifunc("s", h2, b"\x01\x00\x00\x00",
                                            ring=1))
    assert ring_kw[:2] == ("err", "TransportError")
    d2.send_ifunc("s", h2, np.arange(2000, dtype="<u4").tobytes())
    d2.drain()
    assert d2.peers["s"].stats["streams"] == 0
    assert d2.peers["s"].target_args["result"]["count"] == 2000
    return d, d2, (refused, ring_kw)


def test_stream_autoroute_off_and_striped_excluded(lib_dir):
    """Streaming off: the oversize bypass ships a plain singleton.  A
    striped peer is never auto-routed into a stream, and ``send_stream``
    and ``ring=`` refuse it with the reference's messages."""
    (rd, rd2, rmsg), (pd, pd2, pmsg) = both(_autoroute_off_and_striped,
                                            lib_dir)
    assert pmsg == rmsg
    same_stream_run(rd, pd)
    same_stream_run(rd2, pd2)


def _codec_shrinks(pkg, lib_dir):
    d = _mk(pkg, lib_dir, codec="rle")
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    vals = np.full(8000, 7, dtype="<u4")
    assert d.send_stream("p", h, vals.tobytes(), chunk_bytes=4096, window=2)
    d.drain()
    peer = d.peers["p"]
    assert peer.target_args["result"] == {
        "count": 8000, "sum": 7 * 8000, "min": 7, "max": 7}
    assert peer.stats["bytes"] < vals.nbytes // 4
    return d


def test_stream_codec_shrinks_wire_bytes(lib_dir):
    rd, pd = both(_codec_shrinks, lib_dir)
    same_stream_run(rd, pd)
    assert _wire(pd.peers["p"].rings[0].channel)["bytes"] < 8000


def _slim_nack(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    h = _reg(pkg, d, lib_dir, "rle_insert")
    payload = bytes((2, 67)) * 120
    assert d.send_stream("p", h, payload, chunk_bytes=64, window=2)
    d.drain()
    peer = d.peers["p"]
    assert peer.target_args["db"] == [b"CC" * 120]
    assert peer.target_ctx.link_cache.evict(h.lib.name, h.lib.code_digest)
    assert d.send_stream("p", h, payload, chunk_bytes=64, window=2)
    d.drain()
    assert peer.target_args["db"] == [b"CC" * 120, b"CC" * 120]
    assert peer.stats["nacks"] == 1
    assert peer.stats["resent"] == 1
    assert peer.stats["streams"] == 2
    assert not d._active_streams
    return d


def test_stream_slim_nack_rebuilds_full_exactly_once(lib_dir):
    rd, pd = both(_slim_nack, lib_dir)
    same_stream_run(rd, pd)
    assert pd.peers["p"].target_ctx.stats["links"] == 2


def _clamps(pkg, lib_dir):
    d = _mk(pkg, lib_dir, slot_size=8 << 10)
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    vals = np.arange(7500, dtype="<u4")
    assert d.send_stream("p", h, vals.tobytes(), chunk_bytes=1 << 20,
                         window=64)
    d.drain()
    peer = d.peers["p"]
    assert peer.target_args["result"]["count"] == 7500
    assert peer.stats["stream_chunks"] > 4
    return d


def test_stream_geometry_clamps_to_slot(lib_dir):
    same_stream_run(*both(_clamps, lib_dir))


# ---------------------------------------------------------------------------
# failure modes


def _corrupt_chunk(pkg, lib_dir):
    F, W = mod(pkg, "core.frame"), mod(pkg, "transport.codec")
    core = pkg.core
    src = ctx(pkg, "src", lib_dir)
    tgt = ctx(pkg, "tgt", lib_dir, link_mode="remote")
    h = core.register_ifunc(src, "rle_insert", lib_dir)
    lib = h.lib
    fab = pkg.transport.RdmaFabric()
    mb = fab.open_mailbox(tgt, 4, 16 << 10)
    chunk, nonce = 64, 5
    cell = chunk + F.CHUNK_OVERHEAD
    desc = F.StreamDesc(2 * chunk, 2, chunk, 2, W.RAW, 0, cell, nonce)
    slab = bytearray(16 << 10)
    flen = F.seal_frame(slab, lib.name, lib.code, lib.kind,
                        F.stream_payload_len(2, cell),
                        digest=lib.code_digest, flags=F.FLAG_STREAM)
    prefix = F.HEADER_LEN + len(lib.code)
    F.pack_stream_desc(slab, prefix, desc)
    cells = prefix + F.STREAM_DESC_LEN
    data = bytes((2, 68)) * (chunk // 2)
    hdr0, seal0 = F.pack_chunk_hdr(0, chunk, chunk, W.RAW, nonce=nonce)
    slab[cells:cells + F.CHUNK_HDR_LEN] = hdr0
    slab[cells + F.CHUNK_HDR_LEN:cells + F.CHUNK_HDR_LEN + chunk] = data
    slab[cells + cell - 4:cells + cell] = seal0
    hdr1, seal1 = F.pack_chunk_hdr(1, chunk, chunk, W.RAW, nonce=nonce)
    bad = bytearray(hdr1)
    bad[12] ^= 0xFF
    c1 = cells + cell
    slab[c1:c1 + F.CHUNK_HDR_LEN] = bad
    slab[c1 + F.CHUNK_HDR_LEN:c1 + F.CHUNK_HDR_LEN + chunk] = data
    slab[c1 + cell - 4:c1 + cell] = seal1
    mb.slot_view(0)[:flen] = slab[:flen]
    ta = {"db": []}
    sts = []
    for _ in range(4):
        sts += mb.sweep(tgt, ta)
        if core.Status.REJECTED in sts:
            break
    assert core.Status.REJECTED in sts
    assert not mb.streams
    assert ta["db"] == []
    msg = F.pack_frame(lib.name, lib.code, bytes((1, 69)), lib.kind,
                       digest=lib.code_digest)
    mb.slot_view(1)[:len(msg)] = msg
    later = mb.sweep(tgt, ta)
    assert core.Status.OK in later
    assert ta["db"] == [b"E"]
    return ([s.name for s in sts + later], ta, dict(tgt.stats),
            bytes(mb.region.buf), (mb.head, mb.consumed))


def test_corrupt_chunk_rejects_only_its_stream(lib_dir):
    """A chunk whose covered header was flipped (its seal still echoing)
    rejects the stream: slot scrubbed, rx state dropped, the ring usable
    for the next frame."""
    ref, port = both(_corrupt_chunk, lib_dir)
    assert port == ref
    assert "fletcher mismatch" in port[2]["last_reject"]


def _wedge(d):
    for r in d.peers["p"].rings:
        r.mailbox.sweep = lambda *a, **k: []


def _fail_half_arrived(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    _wedge(d)
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, type(value).__name__, is_err))
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    assert d.send_stream("p", h, bytes(20000), corr_id=77, chunk_bytes=2048,
                         window=2)
    assert d.fail_inflight("wedged peer") >= 1
    assert replies == [(77, "TransportError", True)]
    d.drain()
    assert not d._active_streams
    return d, replies


def test_fail_inflight_resolves_half_arrived_stream(lib_dir):
    (rd, rr), (pd, pr) = both(_fail_half_arrived, lib_dir)
    assert pr == rr
    same_stream_run(rd, pd)


def _deadline(pkg, lib_dir):
    d = _mk(pkg, lib_dir)
    _wedge(d)
    replies = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        replies.append((corr, is_err))
    h = _reg(pkg, d, lib_dir, "host_aggregate")
    assert d.send_stream("p", h, bytes(20000), corr_id=88, chunk_bytes=2048,
                         window=2)
    d.drain(deadline=0.05)
    assert replies == [(88, True)]
    assert not d._active_streams
    return d, replies


def test_drain_deadline_fails_wedged_stream(lib_dir):
    (rd, rr), (pd, pr) = both(_deadline, lib_dir)
    assert pr == rr
    # how many poll rounds fit in the wall-clock deadline varies run to run
    assert pd.stats["poll_rounds"] > 1 and rd.stats["poll_rounds"] > 1
    pd.stats["poll_rounds"] = rd.stats["poll_rounds"]
    same_stream_run(rd, pd)


# ---------------------------------------------------------------------------
# placement: striping-aware queue-depth pricing


def _queue_depth(pkg, lib_dir):
    X = pkg.transport
    d = X.Dispatcher(ctx(pkg, "src", lib_dir),
                     X.ProgressEngine(flush_threshold=64))
    for name, kw in (("plain", {}), ("striped", {"rings": 2,
                                                  "stripe": True})):
        d.add_peer(name, X.RdmaFabric(), ctx(pkg, name, lib_dir,
                                             link_mode="remote"),
                   n_slots=4, slot_size=8 << 10, target_args={"db": []},
                   **kw)
    eng = mod(pkg, "tasks.placement").PlacementEngine(None, d)
    h = _reg(pkg, d, lib_dir, "rle_insert")
    for _ in range(4):
        for name in ("plain", "striped"):
            assert d.send(name, pkg.core.ifunc_msg_create(h, b"\x01A"))
    depths = [eng.queue_depth("plain"), eng.queue_depth("striped")]
    d.peers["striped"].resend.append(object())
    depths.append(eng.queue_depth("striped"))
    d.peers["striped"].resend.clear()
    d.drain()
    depths += [eng.queue_depth("plain"), eng.queue_depth("striped")]
    assert depths == [4, 2.0, 3.0, 0, 0.0]
    assert eng.hop_cost("plain", 0) == pytest.approx(
        eng.hop_cost("striped", 0))
    return d, depths


def test_queue_depth_scales_with_stripe_width(lib_dir):
    (rd, rdep), (pd, pdep) = both(_queue_depth, lib_dir)
    assert pdep == rdep
    same_stream_run(rd, pd, spans=False)


# ---------------------------------------------------------------------------
# striping under resends (tests/test_device_agg.py)


def _striping_fifo(pkg, lib_dir):
    X = pkg.transport
    d = X.Dispatcher(ctx(pkg, "src", lib_dir),
                     X.ProgressEngine(flush_threshold=64),
                     obs=pkg.obs.Obs("stripe", trace=True))
    d.set_coalescing(True, max_subs=4)
    d.add_peer("p", X.RdmaFabric(), ctx(pkg, "p", lib_dir,
                                        link_mode="remote"),
               n_slots=2, slot_size=32 << 10, rings=2, stripe=True,
               target_args={"db": [], "count": 0})
    peer = d.peers["p"]
    h_rle = _reg(pkg, d, lib_dir, "rle_insert")
    h_cnt = _reg(pkg, d, lib_dir, "counter_bump")
    for h in (h_rle, h_cnt):
        assert d.send_ifunc("p", h, b"\x01")
        d.drain()
    base = list(peer.target_args["db"])
    base_count = peer.target_args["count"]
    assert peer.target_ctx.link_cache.evict("counter_bump", h_cnt.digest)
    recs = [bytes([65 + i]) * 3 for i in range(8)]
    for r in recs[:3]:
        assert d.send_ifunc("p", h_rle, r)
    assert d.send_ifunc("p", h_cnt, b"x")
    for r in recs[3:]:
        assert d.send_ifunc("p", h_rle, r)
    deadline = 200
    while (peer.resend or any(q.subs for q in peer.coalesce.values())
           or peer.target_args["count"] < base_count + 1) and deadline:
        d.flush_coalesced("p")
        d.drain()
        deadline -= 1
    assert peer.target_args["db"] == base + recs
    assert peer.target_args["count"] == base_count + 1
    assert peer.stats["nacks"] == 1 and peer.stats["resent"] == 1
    assert peer.stripe_rx >= peer.stats["sent"] - len(peer.resend) - 2
    return d


def test_striping_fifo_under_resends(lib_dir):
    """Striped peer (rings=2) and a digest eviction mid-run: the NACKed
    record is rebuilt FULL without replaying its siblings, and every other
    record executes in program order across the rotation."""
    same_stream_run(*both(_striping_fifo, lib_dir))


# ---------------------------------------------------------------------------
# fig_stream's stream cell


@pytest.mark.parametrize("size", [64 << 10, 256 << 10])
def test_fig_stream_stream_cell(lib_dir, size):
    """``bench_stream``'s ``stream`` cell at the bare API, four warm SLIM
    stream messages after the FULL one, through both packages: the same
    target stats, results and mailbox bytes."""
    seen = []
    for pkg in PKGS:
        cells, _, (dst, mb, targs) = chip_smoke.fig_stream_cells(
            pkg, size, lib_dir=lib_dir)
        cells["stream"](4)
        assert dst.stats["streams"] == 5 and dst.stats["rejected"] == 0
        assert targs["result"] == size and not mb.streams
        seen.append((dict(dst.stats), targs["result"],
                     bytes(mb.region.buf), dst.link_cache.stats()))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 22's parts, small


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


@pytest.mark.parametrize("codec", ["raw", "quant8"])
@pytest.mark.parametrize("chunk,window", [(64 << 10, 2), (256 << 10, 4)])
def test_uvm_streams_small(lib_dir, ref_uvm_oracle, codec, chunk, window):
    """Phase 22 (a) at 4 tiles: ``uvm_affine`` streams to a μVM target,
    pumped (4 chunks through a window of 2) and eager (one chunk), raw and
    under ``quant8``.  Both packages assemble the same bytes, within the
    codec's bound of the payload (``chip_smoke.assembly_err``), run the
    program once over them, and agree on every stat."""
    rng = np.random.default_rng(22)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    xs = [rng.standard_normal((4, T, T)).astype(np.float32)
          for _ in range(2)]
    runs = []
    for pkg in PKGS:
        d, h = chip_smoke.stream_peer(pkg, W, codec=codec, chunk=chunk,
                                      window=window, lib_dir=lib_dir,
                                      obs=pkg.obs.Obs("s", trace=True))
        seen = chip_smoke.capture_runs(d.peers["rdma"].target_ctx)
        got = []
        for x in xs:
            out = _np(chip_smoke.stream_one(d, h, x))
            (assembled,) = seen
            seen.clear()
            chip_smoke.assembly_err(np, x, assembled, codec, chunk)
            a = np.frombuffer(assembled, np.float32).reshape(4, T, T)
            np.testing.assert_allclose(out, np.maximum(a @ W, 0), **TOL)
            got.append((bytes(assembled), out))
        runs.append((d, got))
    (rd, rgot), (pd, pgot) = runs
    same_stream_run(rd, pd)
    for (ra, rout), (pa, pout) in zip(rgot, pgot):
        assert pa == ra
        np.testing.assert_allclose(pout, rout, **TOL)
    st = pd.peers["rdma"].stats
    assert st["streams"] == 2 and st["slim_sent"] == 2
    assert st["stream_chunks"] == 2 * -(-xs[0].nbytes // chunk)


def test_bulk_ingest_small(lib_dir):
    """Phase 22 (b) at 64 KiB (128 values x 128, 1 KiB chunks): the
    example's gates in both packages, and the same stats, wire bytes and
    result."""
    res = [chip_smoke.bulk_ingest(
        pkg, np, values=128, repeat=128, chunk=1 << 10, window=4, n_slots=8,
        slot=8 << 10, lib_dir=lib_dir, obs=pkg.obs.Obs("b", trace=True))
        for pkg in PKGS]
    assert [r["result"] for r in res[1:]] == [res[0]["result"]]
    assert res[1]["wire"] == res[0]["wire"] and res[1]["chunks"] == 64
    same_stream_run(res[0]["d"], res[1]["d"])


def test_striped_fifo_small(lib_dir, ref_uvm_oracle):
    """Phase 22 (c) at 2 rings x 8 slots: 16 two-tile μVM frames with one
    ``counter_bump`` NACK and resend; results in send order in both
    packages, which agree on every stat and the rotation."""
    rng = np.random.default_rng(23)
    W = (rng.standard_normal((T, T)) * 0.05).astype(np.float32)
    xs = rng.standard_normal((16, 2, T, T)).astype(np.float32)
    want = np.maximum(xs @ W, 0)
    res = []
    for pkg in PKGS:
        r = chip_smoke.striped_fifo(pkg, np, W, xs, n_slots=8,
                                    slot=132 << 10, lib_dir=lib_dir,
                                    obs=pkg.obs.Obs("c", trace=True))
        got = np.stack([_np(v) for v in r["results"]])
        np.testing.assert_allclose(got, want, **TOL)
        res.append(r)
    assert res[1]["retries"] == res[0]["retries"] > 0
    same_stream_run(res[0]["d"], res[1]["d"])
