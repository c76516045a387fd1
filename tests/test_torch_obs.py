"""The port's ``repro_torch.obs`` held against ``repro.obs``: the cases of
``tests/test_obs.py`` — power-of-two histograms, the registry's live-dict
aliasing, span lifecycles across SLIM -> NACK -> FULL, the flight
recorder, the counters-only and disabled modes — each run through both
packages on the same inputs, the two agreeing on every number the case
reads (spans and histograms by name and count, not by time).
"""

import io
import json

import numpy as np
import pytest

from repro.obs import metrics as RM
from repro_torch.core import Context, register_ifunc
from repro_torch.core.codegen import deserialize_uvm
from repro_torch.kernels.agg_poll import SUB_SALT
from repro_torch.kernels.ring_poll import HDR_WORDS
from repro_torch.obs import Obs
from repro_torch.obs import metrics as PM
from repro_torch.transport import DeviceMeshFabric, Dispatcher, ProgressEngine
from test_torch_transport import PKGS, both, ctx, same_run


def _per_pkg(fn):
    """``fn(obs_module)`` for the reference and the port; returns both."""
    return tuple(fn(pkg.obs) for pkg in PKGS)


# ---------------------------------------------------------------------------
# histogram bucket math


def _buckets(O):
    H = O.Histogram
    h = H("t")
    n_buckets = (RM if O.__name__ == "repro.obs" else PM).N_BUCKETS
    assert [H.bucket_of(v) for v in (0, 0.5, 1, 1.9, 2, 3, 4)] == \
        [0, 0, 1, 1, 2, 2, 3]
    assert H.bucket_of(2 ** 70) == n_buckets - 1           # clamped
    for v in (0, 1, 3, 100, 100, 100):
        h.observe(v)
    assert h.count == 6 and h.min == 0 and h.max == 100
    assert h.mean == pytest.approx(304 / 6)
    assert h.buckets[:3] == [1, 1, 1] and h.buckets[7] == 3
    return (n_buckets, h.buckets, [h.quantile(q) for q in
                                   (0.0, 0.5, 0.75, 1.0)])


def test_histogram_bucket_math():
    ref, port = _per_pkg(_buckets)
    assert port == ref
    assert port[2] == [1, 4, 128, 128]


def test_histogram_empty_quantile_is_none():
    for O in (pkg.obs for pkg in PKGS):
        h = O.Histogram("t")
        assert h.quantile(0.5) is None and h.mean == 0.0


def _merge(O):
    a, b = O.Histogram("a"), O.Histogram("b")
    for v in (1, 2, 4):
        a.observe(v)
    for v in (1024, 0):
        b.observe(v)
    a.merge(b)
    assert (a.count, a.min, a.max) == (5, 0, 1024)
    assert a.total == pytest.approx(1031.0)
    snap = a.snapshot()
    assert snap["buckets"][11] == 1
    back = O.Histogram.from_snapshot("a2", snap)
    assert back.count == a.count and back.buckets == a.buckets
    assert back.quantile(0.99) == a.quantile(0.99) == 2048
    return snap


def test_histogram_merge_and_snapshot_roundtrip():
    ref, port = _per_pkg(_merge)
    assert port == ref


# ---------------------------------------------------------------------------
# registry: aliased live dicts, uniquification, delta/merge


def _aliases(O):
    r = O.Registry("t")
    stats = {"sent": 0, "note": "not-a-number"}
    other = {"sent": 7}
    prefixes = [r.register_dict("peer.a", stats),
                r.register_dict("peer.a", stats),
                r.register_dict("peer.a", other),
                r.register_dict("peer.a", other)]
    assert prefixes == ["peer.a", "peer.a", "peer.a.2", "peer.a.2"]
    stats["sent"] = 3                                      # live, no copy
    snap = r.snapshot()
    assert snap["counters"]["peer.a.sent"] == 3
    assert snap["counters"]["peer.a.2.sent"] == 7
    assert "peer.a.note" not in snap["counters"]
    return snap, r.to_text()


def test_registry_aliases_live_dicts_and_uniquifies():
    ref, port = _per_pkg(_aliases)
    assert port == ref


def _delta_merge(O):
    r = O.Registry("t")
    c, h = r.counter("x"), r.histogram("lat")
    c.inc(2)
    h.observe(10)
    prev = r.snapshot()
    c.inc(5)
    h.observe(10)
    d = O.delta(r.snapshot(), prev)
    assert d["counters"]["x"] == 5 and d["histograms"]["lat"]["count"] == 1
    merged = O.merge_snapshots([prev, r.snapshot()])
    assert merged["counters"]["x"] == 2 + 7
    assert merged["histograms"]["lat"]["count"] == 3
    return d, merged


def test_snapshot_delta_and_merge():
    ref, port = _per_pkg(_delta_merge)
    assert port == ref


# ---------------------------------------------------------------------------
# transport integration: span lifecycle across SLIM -> NACK -> FULL


def _mk(pkg, lib_dir, obs, n_slots=4):
    T = pkg.transport
    d = T.Dispatcher(ctx(pkg, "src", lib_dir),
                     T.ProgressEngine(flush_threshold=64), obs=obs)
    tgt = ctx(pkg, "p", lib_dir, link_mode="remote")
    d.add_peer("p", T.RdmaFabric(), tgt, n_slots=n_slots, slot_size=8 << 10,
               target_args={"db": []})
    return d, tgt, pkg.core.register_ifunc(d.src_ctx, "rle_insert", lib_dir)


def _nack_spans(pkg, lib_dir):
    obs = pkg.obs.Obs("t", trace=True)
    d, tgt, h = _mk(pkg, lib_dir, obs)
    assert d.send_ifunc("p", h, b"first", corr_id=11)      # FULL warmup
    d.drain()
    tgt.link_cache.invalidate(h.name)                      # eviction
    assert d.send_ifunc("p", h, b"second", corr_id=22)     # goes out SLIM
    d.drain()
    assert (d.peers["p"].stats["nacks"], d.peers["p"].stats["resent"]) == \
        (1, 1)
    tr = obs.tracer
    assert tr.open_count() == 0, [s.name for s in tr.open_spans()]
    assert [s.args.get("status") for s in tr.spans(cat="wire", corr=11)] \
        == ["ok"]
    nacked = [s for s in tr.spans(cat="wire")
              if s.args.get("status") == "nack"]
    assert len(nacked) == 1 and nacked[0].corr == 22
    resends = tr.spans(cat="resend")
    assert len(resends) == 1
    rs = resends[0]
    assert rs.name == "resend:rle_insert@p" and rs.corr == 22
    assert rs.args.get("status") == "ok"
    assert rs.ts >= nacked[0].ts + nacked[0].dur           # strictly after
    assert len(tr.spans(cat="exec")) == 2                  # never the NACK
    kinds = [k for _, k, _, _ in obs.recorder.events()]
    assert "nack" in kinds and "resend" in kinds and "put" in kinds
    return d


def test_span_lifecycle_nack_retransmit(lib_dir):
    """One logical frame, two wire legs: the SLIM put's span closes with
    status=nack, and the FULL resend is a separate cat=resend span tied to
    the same corr."""
    same_run(*both(_nack_spans, lib_dir))


def _chrome(pkg, lib_dir, path):
    obs = pkg.obs.Obs("t", trace=True)
    d, _, h = _mk(pkg, lib_dir, obs)
    assert d.send_ifunc("p", h, b"x", corr_id=9)
    d.drain()
    obs.tracer.export_chrome(path / f"{pkg.name}.json")
    doc = json.loads((path / f"{pkg.name}.json").read_text())
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    spans = [e for e in evs if e["ph"] == "X"]
    assert meta and spans
    assert {m["args"]["name"] for m in meta} >= {"src", "p"}
    put = next(e for e in spans if e["name"].startswith("put:"))
    assert put["args"]["corr"] == 9
    assert put["dur"] >= 0 and isinstance(put["tid"], int)
    return d, [(e["name"], e["ph"], e.get("cat"), e["tid"]) for e in evs]


def test_chrome_export_schema(tmp_path, lib_dir):
    (rd, rev), (pd, pev) = both(_chrome, lib_dir, path=tmp_path)
    assert pev == rev
    same_run(rd, pd)


# ---------------------------------------------------------------------------
# flight recorder ring


def _wrap(O):
    clock_t = [0.0]
    r = O.FlightRecorder(capacity=4, clock=lambda: clock_t[0])
    for i in range(10):
        clock_t[0] = float(i)
        r.add("put", f"peer{i}", f"ev{i}")
    assert len(r) == 4 and r.total == 10
    assert [info for _, _, _, info in r.events()] == \
        ["ev6", "ev7", "ev8", "ev9"]                       # oldest first
    assert [info for _, _, _, info in r.last(2)] == ["ev8", "ev9"]
    text = r.format("test")
    assert "last 4 of 10 events, 6 older dropped" in text
    assert text.count("\n") == 5
    r.clear()
    assert len(r) == 0 and r.total == 0
    return text


def test_flight_recorder_wraparound():
    ref, port = _per_pkg(_wrap)
    assert port == ref


def _under(O):
    r = O.FlightRecorder(capacity=8)
    r.add("nack", "p", "one")
    assert len(r) == 1 and r.total == 1
    assert "older dropped" not in r.format()
    assert "manual" in r.format()
    buf = io.StringIO()
    assert r.dump("why", stream=buf) == buf.getvalue().rstrip("\n")
    return [e[1:] for e in r.events()], buf.getvalue().count("\n")


def test_flight_recorder_under_capacity():
    ref, port = _per_pkg(_under)
    assert port == ref


# ---------------------------------------------------------------------------
# operating modes


def _counters_only(pkg, lib_dir):
    obs = pkg.obs.Obs("t")
    assert not obs.tracing
    d, _, h = _mk(pkg, lib_dir, obs)
    for i in range(4):
        assert d.send_ifunc("p", h, bytes([i]), corr_id=i + 1)
    d.drain()
    assert obs.tracer.begin("x") is None
    assert obs.tracer.events == [] and obs.tracer.open_count() == 0
    assert obs.rtt_hist.count == 4
    assert len(obs.recorder) >= 4
    snap = obs.snapshot()
    assert snap["counters"]["peer.p.sent"] == 4
    assert snap["counters"]["peer.p.delivered"] == 4
    assert "peer.p.sent 4" in obs.to_text()
    return d


def test_counters_only_mode_records_no_spans(lib_dir):
    """The default Obs(): histograms, counters and recorder live, tracer
    dark."""
    same_run(*both(_counters_only, lib_dir))


def _disabled(pkg, lib_dir):
    obs = pkg.obs.Obs("t", enabled=False, trace=True)      # enabled wins
    d, _, h = _mk(pkg, lib_dir, obs)
    for i in range(3):
        assert d.send_ifunc("p", h, bytes([i]))
    d.drain()
    assert obs.rtt_hist.count == 0 and len(obs.recorder) == 0
    assert obs.tracer.events == []
    assert d.peers["p"].stats["delivered"] == 3
    return d


def test_disabled_obs_is_inert(lib_dir):
    """Obs(enabled=False): traffic flows, nothing is observed."""
    same_run(*both(_disabled, lib_dir))


def _toggle(pkg, lib_dir):
    obs = pkg.obs.Obs("t")
    d, _, h = _mk(pkg, lib_dir, obs)
    assert d.send_ifunc("p", h, b"dark")
    d.drain()
    assert obs.tracer.events == []
    obs.set_tracing(True)
    assert d.send_ifunc("p", h, b"lit")
    d.drain()
    assert obs.tracer.spans(cat="wire") and obs.tracer.open_count() == 0
    return d


def test_set_tracing_toggles_midrun(lib_dir):
    same_run(*both(_toggle, lib_dir))


def _fail_dump(pkg, lib_dir, capsys, dump_on_fail):
    obs = pkg.obs.Obs("t", dump_on_fail=dump_on_fail)      # counters-only
    d, _, h = _mk(pkg, lib_dir, obs)
    for r in d.peers["p"].rings:                     # peer stops consuming
        r.mailbox.sweep = lambda *a, **k: []
    errs = []
    d.reply_router = lambda corr, name, value, is_err, decoded: \
        errs.append((corr, is_err, type(value).__name__))
    corr = 404 if dump_on_fail else 7
    assert d.send_ifunc("p", h, b"doomed", corr_id=corr)
    assert d.fail_inflight("wedged peer") >= 1
    assert errs == [(corr, True, "TransportError")]
    err = capsys.readouterr().err
    if dump_on_fail:
        assert "flight recorder dump (fail_inflight: wedged peer)" in err
        assert "corr=404" in err                           # the dead frame
        assert "put" in err                                # ...and its put
    else:
        assert "flight recorder dump" not in err
    # the events stay in the ring for a manual obs.dump()
    kinds = [k for _, k, _, _ in obs.recorder.events()]
    assert "fail_inflight" in kinds
    # the dump's lines naming a frame, without their clock and age
    return d, [" ".join(line.split()[2:]).split("age=")[0]
               for line in err.splitlines() if "corr=" in line]


def _fail_both(lib_dir, capsys, dump_on_fail):
    (rd, rlines), (pd, plines) = both(_fail_dump, lib_dir, capsys=capsys,
                                      dump_on_fail=dump_on_fail)
    assert plines == rlines
    assert pd.stats["timed_out"] == rd.stats["timed_out"] == 1
    same_run(rd, pd)


def test_fail_inflight_dumps_recorder(lib_dir, capsys):
    """A wedged peer's fail_inflight resolves its futures with a
    TransportError and auto-dumps the flight recorder: the postmortem names
    the frames that died and the reason, on stderr, unprompted."""
    _fail_both(lib_dir, capsys, True)


def test_fail_inflight_dump_can_be_disabled(lib_dir, capsys):
    _fail_both(lib_dir, capsys, False)


def test_device_lane_nack_leaves_no_open_span():
    """A NACKed sub-record on an agg-bound device lane is rebuilt FULL and
    resent; the port opens wire, agg and resend spans on host lanes only,
    so a traced device lane ends with no span open (the reference opens a
    resend span there that nothing closes)."""
    h = register_ifunc(Context("src"), "uvm_affine")
    obs = Obs("t", trace=True)
    d = Dispatcher(h.ctx, ProgressEngine(inflight_window="trailer"), obs=obs)
    d.set_coalescing(True, max_subs=4, max_sub_bytes=128 << 10)
    d.add_peer("mesh", DeviceMeshFabric(1, device="cpu"), None, n_slots=2,
               slot_size=8 << 20, prog=deserialize_uvm(h.lib.code),
               externals=np.eye(128, dtype=np.float32)[None, None],
               agg_k=4, prog_name=h.lib.name)
    xs = [np.full((1, 128, 128), i, np.float32) for i in range(3)]
    assert d.send_ifunc_many("mesh", h, xs, corr_ids=[1, 2, 3]) == 3
    mb = d.peers["mesh"].rings[0].mailbox
    mb._staged[0, 0, HDR_WORDS + 2] = 0x1234          # sub 1: another name
    mb._staged[0, 0, HDR_WORDS + 3] = 0x1234 ^ SUB_SALT
    d.reply_router = lambda *a: None
    assert d.drain() == 3
    s = d.peers["mesh"].stats
    assert (s["nacks"], s["resent"], s["delivered"]) == (1, 1, 3)
    assert obs.tracer.open_count() == 0 and obs.tracer.spans(cat="resend") \
        == []
    assert "resend" in [k for _, k, _, _ in obs.recorder.events()]
