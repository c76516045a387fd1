"""The ifunc API (paper Listing 1.1), UCP-style.

    register_ifunc(ctx, name)            ~ ucp_register_ifunc
    deregister_ifunc(ctx, handle)        ~ ucp_deregister_ifunc
    ifunc_msg_create(handle, args)       ~ ucp_ifunc_msg_create
    ifunc_msg_free(msg)                  ~ ucp_ifunc_msg_free
    ifunc_msg_send_nbix(ep, msg, addr, rkey) ~ ucp_ifunc_msg_send_nbix
    poll_ifunc(ctx, buf, size, target_args)  ~ ucp_poll_ifunc
    submit(runtime, peer, handle, args)  -> tasks.Future (result-returning)

Registration happens at the *source*; the frame carries the code; the
target auto-links first-seen names (hash-table cached) and rejects
ill-formed frames.  Frames carry a code digest: a link-cache hit never
hashes code, and a SLIM frame (code elided) whose digest misses the cache
is consumed with ``Status.NACK_UNCACHED`` so the source retransmits FULL.

A host target links each code kind to where it runs: PYBC on the host
against the target's :class:`~repro_torch.core.codegen.SymbolSpace`, an
HLO (``torch.export``) program and a μVM program on ``Context.device`` —
the card unless the context says ``device="cpu"``.  A μVM frame launches
the ``ifunc_vm`` kernel once.

``poll_ifunc`` is the reference's (``repro.core.api``) without its
stream branch: a ``FLAG_STREAM`` frame is REJECTED.  The device mesh
links its μVM program at mailbox-open time and reports per-slot
:class:`Status` values through its own sweep.
"""

from __future__ import annotations

import enum
import pathlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import codegen as CG
from repro_torch.core import frame as F
from repro_torch.core import rdma as R
from repro_torch.core.registry import IfuncLibrary, LinkCache, RegistryError
from repro_torch.core.security import (PERMISSIVE, PolicyViolation,
                                       SecurityPolicy)
from repro_torch.device import resolve_device


class Status(enum.Enum):
    OK = 0
    NO_MESSAGE = 1         # nothing at this address yet
    IN_PROGRESS = 2        # header here, trailer not yet (put in flight)
    REJECTED = 3           # ill-formed / policy violation (frame cleared)
    NACK_UNCACHED = 4      # SLIM frame, digest not in the link cache (frame
    #                        cleared; source must retransmit FULL)


def _default_wait_mem(spins: int) -> None:
    """ucs_arch_wait_mem analogue: cheap backoff while spinning on the
    trailer signal."""
    if spins & 0x3F == 0:
        time.sleep(0)


@dataclass
class Context:
    """ucp_context analogue for one process."""

    name: str
    nic: R.Nic = None
    policy: SecurityPolicy = PERMISSIVE
    lib_dir: pathlib.Path | None = None      # target-side library search dir
    link_mode: str = "remote"                # "remote" (GOT reconstruction) |
    #                                          "local" (lib on the target fs)
    flow: object = None                      # continuation hook; not read
    #                       yet: FLAG_CONT frames are REJECTED on any target
    symbol_space: CG.SymbolSpace = field(default_factory=CG.SymbolSpace)
    link_cache: LinkCache = field(default_factory=LinkCache)
    handles: dict[str, "IfuncHandle"] = field(default_factory=dict)
    wait_mem = staticmethod(_default_wait_mem)
    max_trailer_spins: int = 1_000_000
    last_agg_results: list | None = None     # per-sub outcomes of the most
    #                     recent FLAG_AGG frame this ctx consumed (set by
    #                     poll_ifunc, harvested by Mailbox.sweep)
    obs: object = None                       # repro_torch.obs.Obs bundle
    #                     (installed by the dispatcher's add_peer so the
    #                     target's exec spans land in the source's trace)
    _agg_policy_ok: set = field(default_factory=set)   # memoized (name, kind)
    #                     pairs the policy already cleared (pure check)
    stats: dict = field(default_factory=lambda: {
        "executed": 0, "rejected": 0, "links": 0, "bytes_in": 0, "nacks": 0,
        "streams": 0, "stream_chunks": 0, "agg_errors": 0, "flow_errors": 0})
    device: str | torch.device = "cuda"      # where linked HLO and μVM code
    #                                          runs (resolved at link time)

    def __post_init__(self):
        if self.nic is None:
            self.nic = R.Nic(self.name)


@dataclass
class IfuncHandle:
    ctx: Context
    lib: IfuncLibrary

    @property
    def name(self) -> str:
        return self.lib.name

    @property
    def digest(self) -> bytes:
        return self.lib.code_digest


@dataclass
class IfuncMsg:
    handle: IfuncHandle
    frame: bytearray
    slim: bool = False
    corr_id: int = 0       # mirrors the sealed header field
    cont: bytes | None = None   # mirrors the sealed continuation section

    @property
    def nbytes(self) -> int:
        return len(self.frame)

    @property
    def payload_view(self) -> memoryview:
        hdr = F.peek_header(self.frame)
        return memoryview(self.frame)[hdr.payload_offset:hdr.cont_offset]

    @property
    def cont_view(self) -> memoryview | None:
        """The continuation descriptor section, if the frame carries one."""
        return F.frame_cont(self.frame, F.peek_header(self.frame))


# ---------------------------------------------------------------------------
# source side


def register_ifunc(ctx: Context, name: str,
                   search_dir: pathlib.Path | None = None) -> IfuncHandle:
    lib = IfuncLibrary.load(name, search_dir or ctx.lib_dir,
                            hmac_key=ctx.policy.hmac_key)
    h = IfuncHandle(ctx, lib)
    ctx.handles[name] = h
    return h


def deregister_ifunc(ctx: Context, handle: IfuncHandle) -> None:
    ctx.handles.pop(handle.name, None)


def ifunc_msg_create(handle: IfuncHandle, source_args,
                     source_args_size: int | None = None, *,
                     slim: bool = False, corr_id: int = 0,
                     cont: bytes | None = None) -> IfuncMsg:
    """Build a frame.  ``payload_init`` writes directly into the frame
    buffer; a shrinking payload truncates the buffer in place.

    ``slim=True`` elides the code section (header digest only).
    ``corr_id`` nonzero asks the target for a result-return reply;
    ``cont`` appends a packed continuation descriptor."""
    lib = handle.lib
    if source_args_size is None:
        try:
            source_args_size = len(source_args)
        except TypeError:
            source_args_size = 0
    max_size = int(lib.payload_get_max_size(source_args, source_args_size))
    code = b"" if slim else lib.code
    cont_len = 0 if cont is None else len(cont)
    frame = bytearray(F.HEADER_LEN + len(code) + max_size + cont_len
                      + F.TRAILER_LEN)
    pv = F.frame_payload_view(frame, len(code), max_size)
    used = lib.payload_init(pv, max_size, source_args, source_args_size)
    used = max_size if used in (None, 0) else int(used)
    frame_len = F.seal_frame(frame, lib.name, code, lib.kind, used,
                             digest=lib.code_digest, slim=slim,
                             corr_id=corr_id, cont=cont)
    if frame_len < len(frame):       # shrink: truncate, don't re-pack
        try:
            pv.release()
            del frame[frame_len:]
        except BufferError:          # payload_init leaked a view: copy out
            frame = bytearray(memoryview(frame)[:frame_len])
    return IfuncMsg(handle, frame, slim=slim, corr_id=corr_id, cont=cont)


def ifunc_msg_to_full(msg: IfuncMsg) -> IfuncMsg:
    """Rebuild a FULL frame from a SLIM message (same payload, code
    restored from the handle's library) — the NACK_UNCACHED fallback.
    The correlation id and any continuation descriptor survive."""
    if not msg.slim:
        return msg
    lib = msg.handle.lib
    hdr = F.peek_header(msg.frame)
    corr = msg.corr_id or (0 if hdr is None else hdr.corr_id)
    cont = None if hdr is None else F.frame_cont(msg.frame, hdr)
    cont = msg.cont if cont is None else bytes(cont)
    frame = F.pack_frame(lib.name, lib.code, bytes(msg.payload_view),
                         lib.kind, digest=lib.code_digest, corr_id=corr,
                         cont=cont)
    return IfuncMsg(msg.handle, frame, slim=False, corr_id=corr, cont=cont)


def ifunc_msg_free(msg: IfuncMsg) -> None:
    msg.frame = bytearray()


def submit(runtime, peer: str, handle: IfuncHandle, source_args,
           source_args_size: int | None = None, **kw):
    """Dispatch a *result-returning* task: ship ``handle``'s ifunc to
    ``peer`` with a fresh correlation id and get a ``tasks.Future`` back —
    the ucp-style surface over ``repro_torch.tasks.TaskRuntime.submit``.
    The future resolves when the target's reply frame (or device sweep
    result) comes back through the dispatcher's reply demux; if the ifunc
    raised, ``Future.result()`` re-raises a ``RemoteExecutionError``."""
    return runtime.submit(peer, handle, source_args, source_args_size, **kw)


def ifunc_msg_send_nbix(ep, msg: IfuncMsg, remote_addr: int | None = None,
                        rkey: int | None = None, **kw) -> Status:
    """Non-blocking send.  Two forms:

    * legacy: ``ep`` is an ``rdma.Endpoint`` and ``remote_addr``/``rkey``
      address the target region — routed through the transport layer's raw
      RDMA channel;
    * fabric: ``ep`` is a ``transport.Channel`` and ``remote_addr`` is the
      ring slot index (rkey unused).
    """
    from repro_torch.transport import fabric as X

    if isinstance(ep, X.Channel):
        ep.put(msg.frame, 0 if remote_addr is None else remote_addr, **kw)
        return Status.OK
    X.endpoint_channel(ep).put_raw(msg.frame, remote_addr, rkey, **kw)
    return Status.OK


# ---------------------------------------------------------------------------
# target side


@dataclass(slots=True)
class AggSubResult:
    """Outcome of one sub-record of an aggregate container: its own Status
    (OK / NACK_UNCACHED / REJECTED), plus — for corr-carrying records — the
    value the ifunc produced (``target_args["result"]``) or the exception
    it raised.  A raised sub-record is *delivered* (status OK, error set):
    siblings keep executing."""

    status: Status
    name: str
    digest: bytes
    corr_id: int
    value: object = None
    error: BaseException | None = None


#: shared outcome of a fire-and-forget record that executed cleanly: the
#: completion reads only ``.status``/``.value``/``.error``, so one
#: immutable instance serves them all
_AGG_PLAIN_OK = AggSubResult(Status.OK, "", b"", 0)


def _agg_groups(batch):
    """Group record indexes by (name_idx, kind, digest), in key order (the
    order ``np.unique`` gives the reference), each group's first index
    beside its indexes.  A burst of ONE verb is detected with three
    plain-column checks."""
    n = batch.n
    if n > 1:
        kinds = batch.kinds
        k0 = kinds[0]
        digests = batch.digests
        if (len(batch.names) == 1
                and digests == digests[:F.DIGEST_LEN] * n
                and all(k == k0 for k in kinds)):
            return [(0, list(range(n)))]
    by_key: dict = {}
    for i in range(n):
        by_key.setdefault(
            (batch.name_idx[i], batch.kinds[i], batch.digest(i)),
            []).append(i)
    return [(idxs[0], idxs) for _, idxs in sorted(by_key.items())]


def _run_agg(ctx: Context, batch, target_args) -> list[AggSubResult]:
    """Execute every sub-record of a parsed aggregate (an
    :class:`~repro_torch.core.frame.AggBatch`) in one pass.  A digest miss
    NACKs only its records; a policy violation rejects only its records;
    an ifunc exception poisons only that record.  The policy gate and the
    cache lookup run once per (name, kind, digest) group."""
    n = batch.n
    out = [_AGG_PLAIN_OK] * n
    if not n:
        return out
    is_dict = isinstance(target_args, dict)
    policy_ok = ctx._agg_policy_ok
    stats = ctx.stats
    names, name_idx = batch.names, batch.name_idx
    corrs, flags = batch.corrs, batch.flags
    starts, plens = batch.starts, batch.plens
    mv = batch.mv
    # -- per-group gate + lookup --------------------------------------
    fns: list = [None] * n
    for i0, idxs in _agg_groups(batch):
        name = names[name_idx[i0]]
        kind = batch.kind(i0)
        digest = batch.digest(i0)
        gate = (name, kind)
        if gate not in policy_ok:
            try:
                ctx.policy.check_agg_sub(name, kind)
                policy_ok.add(gate)
            except PolicyViolation as e:
                stats["rejected"] += len(idxs)
                stats["last_reject"] = f"{type(e).__name__}: {e}"
                for i in idxs:
                    out[i] = AggSubResult(Status.REJECTED, name, digest,
                                          corrs[i], error=e)
                continue
        fn = ctx.link_cache.lookup(name, digest)
        if fn is None:
            # the aggregate analogue of a SLIM miss: these records are
            # consumed, the source retransmits each as a FULL singleton
            stats["nacks"] += len(idxs)
            stats["last_nack"] = (name, digest)
            for i in idxs:
                out[i] = AggSubResult(Status.NACK_UNCACHED, name, digest,
                                      corrs[i])
            continue
        for i in idxs:
            fns[i] = fn
    # -- execution, in original record order --------------------------
    executed = 0
    i = 0
    while i < n:
        fn = fns[i]
        if fn is None:                  # NACKed / rejected above
            i += 1
            continue
        try:
            if not flags[i] and not corrs[i]:
                # fire-and-forget fast path: run ahead until a record
                # needs capture / flow / a different handle
                while True:
                    s = starts[i]
                    fn(mv[s:s + plens[i]], plens[i], target_args)
                    executed += 1
                    i += 1
                    if (i >= n or fns[i] is not fn or flags[i]
                            or corrs[i]):
                        break
                continue
            s = starts[i]
            pl = plens[i]
            payload = mv[s:s + pl]
            if flags[i] & F.AGG_SUBFLAG_CONT:
                # no flow hook is ported: every target is flow-less
                raise F.FrameError(
                    "continuation sub-record on a flow-less target")
            if corrs[i] and is_dict:
                target_args.pop("result", None)
                fn(payload, pl, target_args)
                executed += 1
                out[i] = AggSubResult(Status.OK, names[name_idx[i]],
                                      batch.digest(i), corrs[i],
                                      value=target_args.get("result"))
            else:
                fn(payload, pl, target_args)
                executed += 1
            i += 1
        except (F.FrameError, PolicyViolation) as e:
            stats["rejected"] += 1
            stats["last_reject"] = f"{type(e).__name__}: {e}"
            out[i] = AggSubResult(Status.REJECTED, names[name_idx[i]],
                                  batch.digest(i), corrs[i], error=e)
            i += 1
        except Exception as e:          # raised *inside* the ifunc: poisoned
            out[i] = AggSubResult(Status.OK, names[name_idx[i]],
                                  batch.digest(i), corrs[i], error=e)
            stats["agg_errors"] += 1
            i += 1
    if executed:
        stats["executed"] += executed
    return out


def _host_copy(payload, dtype) -> np.ndarray:
    """The payload as a numpy array of ``dtype`` that a torch tensor may
    wrap: a view of a writable slot, a copy of a read-only buffer."""
    arr = np.frombuffer(payload, dtype)
    return arr if arr.flags.writeable else arr.copy()


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``arr`` copied out of the slot onto ``dev``, the copy complete when
    this returns: the poll clears the slot right after the ifunc."""
    t = torch.from_numpy(arr)
    return t.clone() if dev.type == "cpu" else t.to(dev)


def _link(ctx: Context, hdr: F.FrameHeader, code: bytes):
    """First-arrival linking — the clear_cache/GOT-reconstruction moment."""
    if hdr.code_kind == F.CodeKind.PYBC:
        if ctx.link_mode == "remote":
            if not ctx.policy.allow_remote_link:
                raise PolicyViolation("remote linking disabled by policy")
            return CG.link_pybc(code, ctx.symbol_space,
                                hmac_key=ctx.policy.hmac_key)
        # paper-prototype mode: auto-register the local library by name and
        # patch to the local GOT (here: use the locally loaded main).
        if not ctx.policy.allow_auto_register:
            raise PolicyViolation("auto-registration disabled by policy")
        lib = IfuncLibrary.load(hdr.name, ctx.lib_dir,
                                hmac_key=ctx.policy.hmac_key)
        return lib.main
    if hdr.code_kind == F.CodeKind.HLO:
        dev = resolve_device(ctx.device)
        call = CG.link_hlo(code, dev)

        def run_hlo(payload, payload_size, target_args, _call=call,
                    _dev=dev):
            out = _call(_to_device(_host_copy(payload, np.uint8), _dev))
            if isinstance(target_args, dict):
                target_args["result"] = out
            return out
        return run_hlo
    if hdr.code_kind == F.CodeKind.UVM:
        prog = CG.deserialize_uvm(code)
        dev = resolve_device(ctx.device)

        def run_uvm(payload, payload_size, target_args, _prog=prog,
                    _dev=dev):
            from repro_torch.kernels import ops as K  # lazy: core must not
            #                                           require kernels
            t = CG.UVM_TILE
            tiles = _to_device(_host_copy(payload, np.float32), _dev)
            ext_map = (target_args.get("externals", {})
                       if isinstance(target_args, dict) else {})
            out = K.uvm_execute(_prog, tiles.reshape(-1, t, t),
                                [ext_map[s] for s in _prog.symbols],
                                device=_dev)
            if isinstance(target_args, dict):
                target_args["result"] = out
                # multi-message collection: same contract as the device
                # fabric's sweep (results accumulate per message)
                target_args.setdefault("results", []).append(out)
            return out
        return run_uvm
    raise PolicyViolation(f"unsupported code kind {hdr.code_kind}")


def poll_ifunc(ctx: Context, buffer, buffer_size: int | None, target_args,
               *, clear: bool = True) -> Status:
    """Poll one frame slot (paper §3.1).  Executes at most one message.

    An exception raised inside the ifunc propagates and leaves the slot
    as it is (the poisoned-slot semantics).  So does a μVM or HLO frame
    on a ``device="cuda"`` context without a card: ``RuntimeError``."""
    buf = buffer if buffer_size is None else memoryview(buffer)[:buffer_size]
    try:
        hdr = F.peek_header(buf, ctx.policy.max_frame_len)
        if hdr is None:
            return Status.NO_MESSAGE
        ctx.last_agg_results = None      # stale outcomes never misattributed
        ctx.policy.check_header(hdr)
        if hdr.is_reply:
            # result-return frames resolve futures via the transport layer's
            # reply demux; one landing on a request ring is a routing bug
            raise F.FrameError("reply frame on a request ring")
        spins = 0
        while not F.trailer_arrived(buf, hdr):
            spins += 1
            if spins > ctx.max_trailer_spins:
                return Status.IN_PROGRESS
            ctx.wait_mem(spins)
        if hdr.is_stream:
            raise F.FrameError("stream frame: FLAG_STREAM streams are not "
                               "ported yet")
        code, payload = F.frame_sections(buf, hdr)
        if hdr.is_agg:
            # coalesced dispatch: ONE container frame carries K cached
            # invocations; per-record outcomes land in ctx.last_agg_results
            batch = F.parse_agg(payload)         # FrameError -> REJECTED
            o = ctx.obs
            if o is not None and o.enabled:
                t0 = time.perf_counter()
                sp = (o.tracer.begin(f"exec:agg@{ctx.name}", cat="exec",
                                     actor=ctx.name, subs=batch.n)
                      if o.tracer.enabled else None)
                try:
                    results = _run_agg(ctx, batch, target_args)
                finally:
                    o.exec_hist.observe((time.perf_counter() - t0) * 1e6)
                    o.tracer.end(sp)
            else:
                results = _run_agg(ctx, batch, target_args)
            ctx.last_agg_results = results
            ctx.stats["bytes_in"] += hdr.frame_len
            if clear:
                F.clear_frame(buf, hdr)
            return Status.OK
        if F.frame_cont(buf, hdr) is not None:
            # a continuation frame needs a forwarding hook installed; none
            # is ported, so every target is flow-less
            raise F.FrameError("continuation frame on a flow-less target")
        # cached dispatch (§3.4): the header digest IS the cache key — a
        # hit costs one dict lookup, no sha256, no code-section read
        fn = ctx.link_cache.lookup(hdr.name, hdr.digest)
        if fn is None:
            if hdr.is_slim:
                # code elided and not cached (eviction/restart): consume
                # the frame, tell the source to retransmit FULL
                ctx.stats["nacks"] += 1
                ctx.stats["last_nack"] = (hdr.name, hdr.digest)
                if clear:
                    F.clear_frame(buf, hdr)
                return Status.NACK_UNCACHED
            code_b = bytes(code)
            if F.compute_digest(code_b) != hdr.digest:
                raise F.FrameError("code digest mismatch (corrupt code "
                                   "section or forged header)")
            fn = _link(ctx, hdr, code_b)
            ctx.link_cache.insert(hdr.name, hdr.digest, fn)
            ctx.stats["links"] += 1
    except (F.FrameError, PolicyViolation, CG.LinkError, CG.CodeVerifyError,
            RegistryError) as e:
        ctx.stats["rejected"] += 1
        ctx.stats["last_reject"] = f"{type(e).__name__}: {e}"
        if clear:
            F.scrub_slot(buf)     # best-effort clear of the bad slot
        return Status.REJECTED
    o = ctx.obs
    if o is not None and o.enabled:
        # exec_us is host time around the ifunc: for a μVM frame on the
        # card, the payload's copy to the card and the kernel's launch,
        # not the kernel's run (no synchronize is added for telemetry)
        t0 = time.perf_counter()
        sp = (o.tracer.begin(f"exec:{hdr.name}@{ctx.name}", cat="exec",
                             actor=ctx.name, corr=hdr.corr_id or None)
              if o.tracer.enabled else None)
        try:
            fn(payload, len(payload), target_args)
        finally:
            # the span closes even when the ifunc raises (poisoned slot)
            o.exec_hist.observe((time.perf_counter() - t0) * 1e6)
            o.tracer.end(sp)
    else:
        fn(payload, len(payload), target_args)
    ctx.stats["executed"] += 1
    ctx.stats["bytes_in"] += hdr.frame_len
    if clear:
        F.clear_frame(buf, hdr)
    return Status.OK


def poll_ring(ctx: Context, ring: R.RingBuffer, target_args) -> Status:
    """Single-slot poll: consume the next ring slot (head advances on
    OK/REJECTED/NACK_UNCACHED).  A shim over the transport layer's mailbox
    sweep — ``transport.ring_mailbox(ring).sweep(...)`` drains many."""
    from repro_torch.transport.fabric import ring_mailbox

    sts = ring_mailbox(ring).sweep(ctx, target_args, budget=1)
    return sts[0] if sts else Status.NO_MESSAGE
