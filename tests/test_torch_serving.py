"""The port's serving tier (``repro_torch.serving``: the continuous
batcher's counters, the KV slab format, the single-host ``Server`` and
``IfuncFrontend``, the prefill and decode workers, the router and the
disaggregated ``ServingFabric``; ``repro_torch.launch.serve``) on the CPU,
held against the reference's ``repro.serving``.

* The 11 cases of ``tests/test_serving.py``, each through the port at
  ``TINY`` in bf16 on ``device="cpu"``; the fabric is held to the port's
  own host, token for token, as the reference's test holds its fabric.
* Cross-package: ``pack_kv`` bytes and ``slab_bytes`` equal; at ``TINY``
  in f32 the port's ``Server`` tokens equal the reference's, and the
  port's fabric equals the reference's on tokens, every ``serve.*``
  counter, streams, buffered installs, negotiation and the decode slabs
  (headers and layout bit for bit, the f32 KV values within the
  prefill cache's 2e-4 of ``tests/test_torch_models.py``: XLA's and
  PyTorch's f32 prefills differ in summation order, by about 4e-7 here);
  ``examples/serving_fabric.py``'s request mix gives the reference
  example's tokens.
* The CLI runs in both modes at ``--device cpu`` and loads no jax.

Parameters are the reference's ``init_params(TINY, PRNGKey(0))``, carried
across with ``params_from_numpy``; two initializations are never
compared.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as RS
import repro_torch.serving as PS
from repro.models import transformer as RT
from repro.serving import kv as RKV
from repro.train import serve as RSRV
from repro_torch.convert import params_from_numpy
from repro_torch.core import Context, register_ifunc
from repro_torch.core import frame as F
from repro_torch.obs import Obs
from repro_torch.models import transformer as PT
from repro_torch.serving import (TINY, ContinuousBatcher, IfuncFrontend,
                                 Request, Server, ServingFabric)
from repro_torch.serving import kv
from repro_torch.tasks import TaskRuntime
from repro_torch.train import serve as PSRV
from repro_torch.transport import Dispatcher, ProgressEngine, RdmaFabric
from repro_torch.transport import codec as WC

REPO = pathlib.Path(__file__).resolve().parents[1]
F32 = dict(dtype="float32", param_dtype="float32")
TOL_KV = 2e-4        # the prefill cache's f32 tolerance (test_torch_models)
CPU = {"device": "cpu"}


def _pair(**kw):
    """(reference TINY, its parameters, port TINY, the same parameters)."""
    cr, cp = RS.TINY.with_(**kw), TINY.with_(**kw)
    pr = RT.init_params(cr, jax.random.PRNGKey(0))
    pp = params_from_numpy(cp, {k: np.asarray(v) for k, v in pr.items()},
                           "cpu")
    return cr, pr, cp, pp


@pytest.fixture(scope="module")
def bf16():
    return _pair()


@pytest.fixture(scope="module")
def f32():
    return _pair(**F32)


@pytest.fixture(scope="module")
def params(bf16):
    return bf16[3]


def _reqs(n, *, seed=11, max_new=5, plens=(4, 7, 9), cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(i, np.asarray(
        rng.integers(0, TINY.vocab_size, plens[i % len(plens)]), np.int32),
        max_new=max_new) for i in range(n)]


def _host_tokens(server, reqs):
    """Admit in order while slots are free, tick until all are done, as
    the reference's test and example do; returns {rid: tokens}."""
    out, pending = {}, list(reqs)
    while pending or server.active:
        while pending and server.admit(pending[0]):
            pending.pop(0)
        _, fin = server.tick()
        for r in fin:
            out[r.rid] = list(r.out)
    return out


def _serve_counters(obs):
    return {k: v for k, v in obs.snapshot()["counters"].items()
            if k.startswith("serve.")}


# ---------------------------------------------------------------------------
# per-slot positions (true continuous batching)


def test_per_slot_cache_specs():
    specs = PT.cache_shapes(TINY, 4, 16, per_slot=True)
    slot_pos = [v for k, v in specs.items() if k.endswith("slot_pos")]
    assert slot_pos and all(tuple(v.shape)[-2:] == (4, 16) for v in slot_pos)
    ref = RT.cache_shapes(RS.TINY, 4, 16, per_slot=True)
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_per_slot_decode_matches_scalar(params):
    """At uniform positions the per-slot path reproduces the scalar-pos
    decode."""
    B, W, S = 2, 16, 6
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, TINY.vocab_size, (B, S)).astype(np.int32))
    prefill = PSRV.make_prefill_step(TINY)
    decode = PSRV.make_decode_step(TINY)
    outs = {}
    for per_slot in (False, True):
        cache = PT.init_cache(TINY, B, W, per_slot=per_slot, device="cpu")
        c1, last = prefill(params, {"tokens": toks})
        c1 = PSRV.pad_cache_to(c1, PT.cache_shapes(TINY, B, W))
        if per_slot:    # prefill emits SHARED slot_pos; broadcast per row
            c1 = {k: (v[:, None].expand(v.shape[0], B, W)
                      if k.endswith("slot_pos") else v)
                  for k, v in c1.items()}
        cache = {k: c1[k].to(v.dtype).clone() for k, v in cache.items()}
        nxt = torch.argmax(last[:, -1], dim=-1).to(torch.int32)[:, None]
        pos = torch.full((B,), S, dtype=torch.int32) if per_slot else S
        cache, logits = decode(params, cache, nxt, pos)
        outs[per_slot] = logits[:, -1].float().numpy()
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-5, atol=1e-5)


def test_mid_wave_admission_unequal_pos(bf16):
    """A sequence joining mid-wave decodes at its own position: the live
    batch holds unequal positions and both finish with their full budget.
    The reference's batcher on the same admissions gives the same tokens
    and the same ``serve.decode.*`` counters."""
    cr, pr, _, params = bf16
    b = ContinuousBatcher(TINY, params, batch_slots=4, cache_len=32, **CPU)
    rb = RS.ContinuousBatcher(cr, pr, batch_slots=4, cache_len=32)
    prefill = PSRV.jit_prefill_step(TINY)
    rprefill = jax.jit(RSRV.make_prefill_step(cr))
    rng = np.random.default_rng(5)

    def admit(rid, plen, max_new):
        p = np.asarray(rng.integers(0, TINY.vocab_size, plen), np.int32)
        c1, last = prefill(params, {"tokens": torch.from_numpy(p[None])})
        req = Request(rid, p, max_new)
        b.install(b.free_slots()[0], c1, plen, int(torch.argmax(last[0, -1])),
                  req)
        rc1, rlast = rprefill(pr, {"tokens": p[None]})
        rreq = RS.Request(rid, p, max_new)
        rb.install(rb.free_slots()[0], rc1, plen,
                   int(jnp.argmax(rlast[0, -1])), rreq)
        return req, rreq

    r0, q0 = admit(0, 9, 6)
    for _ in range(2):
        b.tick()
        rb.tick()
    r1, q1 = admit(1, 4, 6)          # joins while r0 is 2 tokens deep
    live = sorted(int(b.pos[s]) for s in b.active)
    assert len(set(live)) == 2, live     # genuinely mixed positions
    finished = []
    for _ in range(20):
        _, fin = b.tick()
        rb.tick()
        finished += fin
        if not b.active:
            break
    assert {r.rid for r in finished} == {0, 1}
    assert len(r0.out) == 6 and len(r1.out) == 6
    assert (r0.out, r1.out) == (q0.out, q1.out)
    assert _serve_counters(b.obs) == _serve_counters(rb.obs)
    assert b.install_hist.count == 2


def test_install_takes_numpy_entries(params):
    """A slab's f32 numpy views install like the prefill's own tensors:
    the cache rows written are equal bit for bit (bf16 -> f32 -> bf16
    restores the bits), and the tokens that follow are equal."""
    p = np.asarray(np.random.default_rng(3).integers(0, 512, 7), np.int32)
    c1, last = PSRV.jit_prefill_step(TINY)(params, {"tokens": torch.from_numpy(
        p[None])})
    first = int(torch.argmax(last[0, -1]))
    slab = bytearray(kv.pack_kv(c1, 0, 1, 7, first))
    got = kv.unpack_kv(slab)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in got["entries"].values())
    outs = []
    for entries in (c1, got["entries"]):
        b = ContinuousBatcher(TINY, params, 2, 16, **CPU)
        req = Request(0, p, 4)
        b.install(1, entries, 7, first, req)
        while b.active:
            b.tick()
        outs.append((req.out, {k: v.clone() for k, v in b.cache.items()}))
    assert outs[0][0] == outs[1][0]
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k


# ---------------------------------------------------------------------------
# KV slab wire format


def test_kv_slab_roundtrip():
    rng = np.random.default_rng(2)
    entries = {"s0_k": rng.standard_normal((1, 1, 8, 4)).astype(np.float32),
               "s0_v": rng.standard_normal((1, 1, 8, 4)).astype(np.float32),
               "s0_slot_pos": np.arange(8, dtype=np.int32)}   # elided
    slab = kv.pack_kv(entries, rid=7, slot=3, pos0=5, first_token=42)
    assert kv.peek_kv(slab) == (7, 3)
    got = kv.unpack_kv(slab)
    assert (got["rid"], got["slot"], got["pos0"],
            got["first_token"]) == (7, 3, 5, 42)
    assert set(got["entries"]) == {"s0_k", "s0_v"}
    np.testing.assert_array_equal(got["entries"]["s0_k"], entries["s0_k"])
    assert kv.slab_bytes(dict(entries)) == len(slab)
    assert slab == RKV.pack_kv(entries, rid=7, slot=3, pos0=5,
                               first_token=42)
    with pytest.raises(ValueError, match="bad KV slab magic"):
        kv.peek_kv(b"\x00" * 12)


@pytest.mark.parametrize("kind", ["f32", "bf16", "f32_tensor"])
def test_pack_kv_bytes_equal_reference(kind):
    """The same entries pack to the reference's bytes: f32 arrays, a bf16
    tensor against the reference's bf16 array (one widening on the
    tensor's device, one copy to the host), an f32 tensor."""
    rng = np.random.default_rng(4)
    a = {f"s0_{n}": rng.standard_normal((4, 1, 6, 2, 8)).astype(np.float32)
         for n in ("k", "v")}
    a["s0_slot_pos"] = np.arange(6, dtype=np.int32)
    if kind == "f32":
        port_in, ref_in = a, a
    elif kind == "bf16":
        ref_in = {k: jnp.asarray(v).astype(jnp.bfloat16) if v.dtype ==
                  np.float32 else v for k, v in a.items()}
        port_in = {k: torch.from_numpy(v).bfloat16() if v.dtype == np.float32
                   else torch.from_numpy(v) for k, v in a.items()}
    else:
        ref_in = a
        port_in = {k: torch.from_numpy(v) for k, v in a.items()}
    got = kv.pack_kv(port_in, rid=3, slot=2, pos0=6, first_token=9)
    assert got == RKV.pack_kv(ref_in, rid=3, slot=2, pos0=6, first_token=9)
    assert len(got) == kv.slab_bytes(port_in) == RKV.slab_bytes(ref_in)


@pytest.mark.parametrize("arch", ["tiny", "smollm_360m"])
def test_slab_bytes_equal_reference(arch):
    """``slab_bytes`` from the port's ``TensorSpec``s equals the
    reference's from its ShapeDtypeStructs (shapes only, nothing
    allocated) at prompt and cache widths."""
    from repro import configs as RC
    from repro_torch import configs as PC

    cr, cp = ((RS.TINY, TINY) if arch == "tiny" else
              (RC.get_config(arch), PC.get_config(arch)))
    for width in (1, 64, 1024, 2048):
        assert kv.slab_bytes(PT.cache_shapes(cp, 1, width)) == \
            RKV.slab_bytes(RT.cache_shapes(cr, 1, width))
    if arch == "smollm_360m":      # 32 layers x (K, V) x 5 heads x 64 x f32
        per_tok = 32 * 2 * 5 * 64 * 4
        assert kv.slab_bytes(PT.cache_shapes(cp, 1, 1024)) - \
            kv.slab_bytes(PT.cache_shapes(cp, 1, 1023)) == per_tok == 80 << 10


def test_kv_quant8_stream_roundtrip(params):
    """A real prefilled KV slab streamed under the lossy ``quant8`` wire
    codec lands within quantization tolerance: chunk 0 (the peekable
    header) ships bit-exact, the f32 body dequantizes to ~1/127 of each
    chunk's max magnitude."""
    prompt = np.arange(1, 9, dtype=np.int32)
    cache1, _ = PSRV.jit_prefill_step(TINY)(
        params, {"tokens": torch.from_numpy(prompt[None])})
    entries = {k: v.float().numpy() for k, v in cache1.items()
               if not k.endswith("slot_pos")}
    slab = kv.pack_kv(entries, rid=1, slot=0, pos0=8, first_token=9)

    src, dst = Context("src", **CPU), Context("dst", **CPU)
    sink = {"slabs": {0: bytearray(len(slab))}, "kv_arrivals": [],
            "counters": {"buffered_installs": 0}}
    rt = TaskRuntime(src, Dispatcher(src, ProgressEngine(flush_threshold=2)))
    rt.dispatcher.set_streaming(True, chunk_bytes=4 << 10, window=2,
                                threshold=1 << 10)
    rt.add_peer("dst", RdmaFabric(), dst, n_slots=4, slot_size=16 << 10,
                target_args=sink, codec="quant8")
    h = register_ifunc(src, "kv_install")
    assert h.lib.streaming
    fut = rt.submit("dst", h, slab)
    rt.drain(deadline=5.0)
    ack = fut.result(timeout=5.0)
    assert ack["streamed"] and ack["rid"] == 1
    assert sink["counters"]["buffered_installs"] == 0
    assert sink["kv_arrivals"] == [0]

    got = kv.unpack_kv(bytes(sink["slabs"][0]))
    assert (got["rid"], got["slot"], got["pos0"],
            got["first_token"]) == (1, 0, 8, 9)       # header bit-exact
    for k, ref in entries.items():
        arr = got["entries"][k]
        tol = float(np.max(np.abs(ref))) / 127.0 + 1e-6
        np.testing.assert_allclose(arr, ref, atol=tol)


def test_codec_lossy_flags():
    assert not WC.get_codec("raw").lossy
    assert not WC.get_codec("rle").lossy
    assert WC.get_codec("quant8").lossy


# ---------------------------------------------------------------------------
# admission backpressure


def test_enqueue_backpressure_no_leak():
    """A frontend outrunning the server: ``submit`` returns None once ring
    credits run out, no queued request is overwritten, and the refused
    submits never leak futures in the corr table."""
    fe = IfuncFrontend(Context("server", **CPU), n_slots=2)
    reqs = _reqs(6, max_new=3, plens=(4,))
    futs, refused = [], 0
    for r in reqs:
        f = fe.submit(r)
        if f is None:
            refused += 1
        else:
            futs.append(f)
    assert refused > 0 and futs                       # both behaviors seen
    assert len(fe.rt.futures) == len(futs)
    arrived = fe.server_poll()
    arrived += fe.server_poll()
    assert sorted(r.rid for r in arrived) == sorted(
        r.rid for r in reqs[:len(futs)])
    for a in arrived:
        want = next(r for r in reqs if r.rid == a.rid)
        assert a.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, want.prompt)
        assert a.max_new == want.max_new
    for f in futs:
        assert f.result(timeout=5.0)["queued"]
    retry = [r for r in reqs if r.rid not in {a.rid for a in arrived}]
    for r in retry:
        f = None
        for _ in range(20):                   # poll loop frees ring credits
            f = fe.submit(r)
            if f is not None:
                break
            fe.server_poll()
        assert f is not None, f"rid {r.rid} never admitted"
    fe.rt.drain(deadline=5.0)
    stats = fe.dispatcher.per_peer_stats()["server"]
    assert stats["timed_out"] == 0
    assert stats["backpressure"] >= refused
    assert len(fe.rt.futures) == 0                    # all resolved


# ---------------------------------------------------------------------------
# single-host server


def test_batcher_traces_installs_and_ticks(params):
    """With tracing on, each install is a ``kv_install`` span keyed by its
    rid and each decode tick a ``decode_tick`` span holding the tokens it
    emitted: the ticks' tokens are the ``decoded`` counter's."""
    srv = Server(TINY, params, batch_slots=4, cache_len=32,
                 obs=Obs("server", trace=True), **CPU)
    out = _host_tokens(srv, _reqs(6, max_new=4))
    spans = srv.obs.tracer.spans(cat="serve")
    installs = [sp for sp in spans if sp.name == "kv_install:host"]
    ticks = [sp for sp in spans if sp.name == "decode_tick:host"]
    assert sorted(sp.corr for sp in installs) == sorted(out) == list(range(6))
    decoded = srv.obs.snapshot()["counters"]["serve.host.decoded"]
    assert sum(sp.args["tokens"] for sp in ticks) == decoded == 6 * 3
    assert all(sp.dur > 0 for sp in ticks)


def test_host_server_completion_off_decode_path(params):
    """admit() means *running*; a request is done only when tick() returns
    it — and then its token count matches its budget exactly."""
    srv = Server(TINY, params, batch_slots=4, cache_len=32, **CPU)
    reqs = _reqs(3, max_new=4)
    for r in reqs:
        assert srv.admit(r)
        assert len(r.out) == 1            # first (prefill) token only
    done = []
    for _ in range(20):
        _, fin = srv.tick()
        done += fin
        if not srv.active:
            break
    assert {r.rid for r in done} == {0, 1, 2}
    assert all(len(r.out) == 4 for r in done)
    line1 = srv.wave_summary()
    assert "admitted=3" in line1
    line2 = srv.wave_summary()
    assert "admitted=0" in line2 and "decoded=0" in line2


def test_server_tokens_equal_reference_f32(f32):
    """The port's ``Server`` and the reference's on the same f32 requests
    (six, four slots, so two join mid-wave): equal tokens, equal
    ``serve.*`` counters, equal wave summaries less the latencies."""
    cr, pr, cp, pp = f32
    ref = RS.Server(cr, pr, batch_slots=4, cache_len=32)
    port = Server(cp, pp, batch_slots=4, cache_len=32, **CPU)
    want = _host_tokens(ref, _reqs(6, max_new=6, cls=RS.Request))
    got = _host_tokens(port, _reqs(6, max_new=6))
    assert got == want and len(got) == 6
    assert _serve_counters(port.obs) == _serve_counters(ref.obs)
    cut = lambda s: s.split(" admit_us")[0]   # noqa: E731
    assert cut(port.wave_summary()) == cut(ref.wave_summary())


# ---------------------------------------------------------------------------
# the disaggregated fabric


def test_fabric_matches_host_token_for_token(params):
    host = Server(TINY, params, batch_slots=8, cache_len=32, **CPU)
    ref = _host_tokens(host, _reqs(6))
    fab = ServingFabric(TINY, params, n_prefill=2, n_decode=2,
                        batch_slots=8, cache_len=32, **CPU)
    done = fab.run(_reqs(6))
    fab.drain()
    assert {rid: list(r.out) for rid, r in done.items()} == ref
    assert fab.buffered_installs() == 0               # every slab streamed
    assert fab.streams_landed() == 6


def test_fabric_negotiates_advertised_codec(params):
    """The decode peer's admission ack advertises its codecs; the prefill
    tier arms its per-peer wire codec from the ack, not a constructor."""
    fab = ServingFabric(TINY, params, n_prefill=1, n_decode=2,
                        batch_slots=4, cache_len=32,
                        decode_codecs=("rle", "raw"), **CPU)
    fab.run(_reqs(3, max_new=3))
    pw = fab.prefill_workers[0]
    assert pw._negotiated == {"decode0": "rle", "decode1": "rle"}
    for d in ("decode0", "decode1"):
        assert pw.rt.dispatcher.peers[d].codec.id == WC.RLE


def test_fabric_quant8_negotiation_completes(params):
    """quant8-advertising decode tier: negotiation lands on the lossy
    codec and the fabric still serves every request (header chunks ship
    raw, so slab routing survives)."""
    fab = ServingFabric(TINY, params, n_prefill=1, n_decode=2,
                        batch_slots=4, cache_len=32,
                        decode_codecs=("quant8", "raw"), **CPU)
    done = fab.run(_reqs(4, max_new=3))
    assert len(done) == 4
    assert fab.buffered_installs() == 0
    pw = fab.prefill_workers[0]
    assert set(pw._negotiated.values()) == {"quant8"}


@pytest.mark.parametrize("chunk,window", [(8 << 10, 4), (32 << 10, 2)])
def test_prefill_slot_holds_the_stream_window(chunk, window):
    """A prefill peer's rings into the decode peers hold ``window`` chunks
    of ``chunk_bytes`` unclamped: at the defaults the slot is the
    reference's 48 KiB; larger chunks grow it to the stream frame's
    size."""
    dw = PS.DecodeWorker("d0", TINY, None, 1, 32, **CPU)
    pw = PS.PrefillWorker("p0", TINY, None, {"d0": (dw.ctx, dw.kv_ingress())},
                          chunk_bytes=chunk, window=window, **CPU)
    need = F.stream_slot_len(len(pw._kv.lib.code), chunk, window)
    assert pw.slot_size == max(48 << 10, need)
    ring = pw.rt.dispatcher.peers["d0"].rings[0]
    assert ring.mailbox.slot_size == pw.slot_size
    if chunk == 8 << 10:
        rdw = RS.DecodeWorker("d0", RS.TINY, None, 1, 32)
        rpw = RS.PrefillWorker("p0", RS.TINY, None,
                               {"d0": (rdw.ctx, rdw.kv_ingress())})
        rring = rpw.rt.dispatcher.peers["d0"].rings[0]
        assert rring.mailbox.slot_size == pw.slot_size == 48 << 10
    else:
        assert pw.slot_size == need > 48 << 10


def test_fabric_streams_at_its_kv_chunk_size(params):
    """A ``ServingFabric`` subclass that sets ``kv_chunk_bytes`` and
    ``kv_window`` streams each slab in chunks of that size (one chunk a
    ``TINY`` slab here, two or three at the class's 8 KiB) and serves the same
    tokens as the host."""
    class Wide(ServingFabric):
        kv_chunk_bytes, kv_window = 32 << 10, 2

    host = Server(TINY, params, batch_slots=8, cache_len=32, **CPU)
    ref = _host_tokens(host, _reqs(6))
    chunks = {}
    for cls in (ServingFabric, Wide):
        fab = cls(TINY, params, n_prefill=2, n_decode=2, batch_slots=8,
                  cache_len=32, obs=Obs("serving", trace=True), **CPU)
        done = fab.run(_reqs(6))
        fab.drain()
        assert {rid: list(r.out) for rid, r in done.items()} == ref
        assert fab.buffered_installs() == 0 and fab.streams_landed() == 6
        streams = [sp for sp in fab.obs.tracer.spans(cat="stream")
                   if sp.name.startswith("stream:kv_install@")]
        assert [sp.args["chunks"] for sp in streams] == [
            -(-sp.args["bytes"] // cls.kv_chunk_bytes) for sp in streams]
        chunks[cls] = sum(dw.ctx.stats["stream_chunks"]
                          for dw in fab.decode_workers)
        assert chunks[cls] == sum(sp.args["chunks"] for sp in streams)
    assert chunks[Wide] == 6 and chunks[ServingFabric] == 14


def _slabs_close(ref_fab, port_fab):
    """Each decode slot's landing slab: headers, layout and the unwritten
    tail bit for bit, the f32 KV values within TOL_KV."""
    for rw, pw in zip(ref_fab.decode_workers, port_fab.decode_workers):
        assert sorted(rw.slabs) == sorted(pw.slabs)
        for s in rw.slabs:
            r, p = bytes(rw.slabs[s]), bytes(pw.slabs[s])
            assert len(r) == len(p)
            if not any(r):
                assert not any(p), (rw.name, s)
                continue
            hr, hp = RKV.unpack_kv(r), kv.unpack_kv(p)
            assert {k: hr[k] for k in ("rid", "slot", "pos0", "first_token")
                    } == {k: hp[k] for k in ("rid", "slot", "pos0",
                                             "first_token")}
            head = int.from_bytes(r[24:28], "little")
            assert r[:head] == p[:head]
            end = RKV.slab_bytes(hr["entries"])
            assert r[end:] == p[end:]
            for k, v in hr["entries"].items():
                np.testing.assert_allclose(hp["entries"][k], v, rtol=TOL_KV,
                                           atol=TOL_KV, err_msg=k)


def test_fabric_equals_reference_f32(f32):
    """The same f32 request mix through both packages' 2+2 fleets: tokens,
    every ``serve.*`` counter, streams landed, buffered installs, each
    prefill worker's negotiation and the decode slabs."""
    cr, pr, cp, pp = f32
    kw = dict(n_prefill=2, n_decode=2, batch_slots=4, cache_len=32)
    rfab = RS.ServingFabric(cr, pr, **kw)
    pfab = ServingFabric(cp, pp, **kw, **CPU)
    rdone = rfab.run(_reqs(7, max_new=6, cls=RS.Request))
    pdone = pfab.run(_reqs(7, max_new=6))
    rfab.drain()
    pfab.drain()
    assert {k: list(r.out) for k, r in pdone.items()} == \
        {k: list(r.out) for k, r in rdone.items()}
    counters = _serve_counters(pfab.obs)
    assert counters == _serve_counters(rfab.obs)
    assert counters["serve.router.completions"] == 7
    assert pfab.streams_landed() == rfab.streams_landed() == 7
    assert pfab.buffered_installs() == rfab.buffered_installs() == 0
    assert [w._negotiated for w in pfab.prefill_workers] == \
        [w._negotiated for w in rfab.prefill_workers]
    _slabs_close(rfab, pfab)


def _example():
    spec = importlib.util.spec_from_file_location(
        "_serving_fabric_example", REPO / "examples" / "serving_fabric.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_fabric_example_mix_equals_reference(bf16):
    """``examples/serving_fabric.py``'s mix (seed 7, ten requests, 8
    slots, cache 64, bf16): the port's host and fleet give the reference
    example's tokens; every slab streamed and the decode tier ran mixed
    positions, as the example asserts."""
    ex = _example()
    cr, pr, _, pp = bf16
    rhost = RS.Server(cr, pr, ex.SLOTS, ex.CACHE)
    want = _host_tokens(rhost, ex.make_requests())
    rfab = RS.ServingFabric(cr, pr, n_prefill=ex.N_PREFILL,
                            n_decode=ex.N_DECODE, batch_slots=ex.SLOTS,
                            cache_len=ex.CACHE)
    rdone = rfab.run(ex.make_requests())
    assert {k: list(r.out) for k, r in rdone.items()} == want

    port_reqs = lambda: [Request(r.rid, r.prompt, r.max_new)  # noqa: E731
                         for r in ex.make_requests()]
    host = Server(TINY, pp, ex.SLOTS, ex.CACHE, **CPU)
    assert _host_tokens(host, port_reqs()) == want
    fab = ServingFabric(TINY, pp, n_prefill=ex.N_PREFILL,
                        n_decode=ex.N_DECODE, batch_slots=ex.SLOTS,
                        cache_len=ex.CACHE, **CPU)
    mixed = {"seen": False}

    def watch(f):
        for dw in f.decode_workers:
            live = [int(dw.batcher.pos[s]) for s in dw.batcher.active]
            if len(live) >= 2 and len(set(live)) >= 2:
                mixed["seen"] = True

    done = fab.run(port_reqs(), tick_cb=watch)
    fab.drain()
    assert {k: list(r.out) for k, r in done.items()} == want
    assert fab.streams_landed() == len(done) == 10
    assert fab.buffered_installs() == 0
    assert mixed["seen"]
    chunks = sum(dw.ctx.stats.get("stream_chunks", 0)
                 for dw in fab.decode_workers)
    assert chunks == sum(dw.ctx.stats.get("stream_chunks", 0)
                         for dw in rfab.decode_workers)


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(TINY, {}, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingFabric(TINY, {}, n_prefill=1, n_decode=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.PrefillWorker("p", TINY, {}, {})


_CLI = r"""
import runpy, sys
sys.argv = ["serve"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print("FORBIDDEN", bad)
"""


@pytest.mark.parametrize("mode", ["host", "disagg"])
def test_launch_serve_cpu(mode):
    """``python -m repro_torch.launch.serve --device cpu`` at its defaults
    exits 0 in both modes (its own asserts hold) and loads no jax."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_TORCH_IFUNC_LIB_DIR", None)
    r = subprocess.run([sys.executable, "-c", _CLI, "--mode", mode,
                        "--device", "cpu"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "served 6 requests" in r.stdout, r.stdout
    assert "FORBIDDEN []" in r.stdout, r.stdout
    if mode == "disagg":
        assert "6 KV streams landed, 0 buffered installs" in r.stdout
    else:
        assert "metrics: admitted=6 decoded=42" in r.stdout


def test_decode_peer_accepts_streams_up_to_its_landing_slab(params):
    """A decode peer's context takes KV streams as large as its landing
    slab: the default 64 MiB bound where the slab is smaller (``TINY`` at
    cache 32, as the reference's), the slab's size where it is larger
    (a cache of 40,000 positions: 2 KiB a token at ``TINY``)."""
    small = PS.DecodeWorker("d0", TINY, params, 1, 32, **CPU)
    ref = RS.DecodeWorker("d0", RS.TINY, None, 1, 32)
    assert small.ctx.max_stream_bytes == ref.ctx.max_stream_bytes == 64 << 20
    big = PS.DecodeWorker("d1", TINY, params, 1, 40_000, **CPU)
    cap = kv.slab_bytes(PT.cache_shapes(TINY, 1, 40_000))
    assert cap > 64 << 20
    assert big.ctx.max_stream_bytes == cap == len(big.slabs[0])
