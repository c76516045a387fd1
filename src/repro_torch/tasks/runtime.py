"""TaskRuntime: dispatch ifuncs as *tasks* — result futures over the
transport layer's reply path.

One runtime wraps one :class:`~repro_torch.transport.Dispatcher`:

* ``add_peer`` attaches a peer exactly like the dispatcher does, plus (for
  host fabrics) opens the *reply ring* — a source-owned mailbox of the
  same fabric the target posts FLAG_REPLY frames into;
* ``submit`` allocates a correlation id, sends the ifunc with it, and
  returns a :class:`Future`; the dispatcher's reply demux routes the
  target's reply — value, exception, or device sweep result — back here,
  where the corr-id resolves the matching future (a duplicate or expired
  corr-id is counted and dropped);
* ``run_local`` executes a callable inline and wraps it in an
  already-resolved future, so a local run and a remote one produce the
  same object for the caller to wait on;
* with ``coalesce=True`` the underlying dispatcher aggregates cache-warm
  submits into FLAG_AGG containers (``submit_many`` batches a whole list
  and flushes once), and the targets' results come back coalesced too —
  one ``FLAG_AGG|FLAG_REPLY`` frame resolving many futures — so both
  directions of a small-task storm amortize their per-frame cost.

The placement engine and the graph workload (ROADMAP.md Queue 1 item 4)
sit on this layer.
"""

from __future__ import annotations

import time

from repro_torch.core import frame as F
from repro_torch.tasks import wire
from repro_torch.tasks.future import Future, TaskState, TaskTimeout, wait_all
from repro_torch.transport import (DEFAULT_N_SLOTS, DEFAULT_SLOT_SIZE,
                                   Dispatcher, ProgressEngine, TransportError)


class TaskRuntime:
    """Futures + reply routing over one dispatcher."""

    def __init__(self, ctx, dispatcher: Dispatcher | None = None,
                 engine: ProgressEngine | None = None, *,
                 default_timeout: float | None = 30.0,
                 coalesce: bool = False, agg_max_subs: int = 16):
        self.ctx = ctx
        self.dispatcher = (dispatcher if dispatcher is not None
                           else Dispatcher(ctx, engine))
        if coalesce:
            self.dispatcher.set_coalescing(True, max_subs=agg_max_subs)
        self.dispatcher.reply_router = self._on_reply
        self.dispatcher.reply_codec = wire
        self.futures: dict[int, Future] = {}
        self._corr = 0
        self.generation = 0      # fleet generation stamped into the top 16
        #       bits of every allocated corr_id (frame.make_corr), so a
        #       reply from a peer's previous life is identifiable (and
        #       fenceable) by its corr alone
        self.default_timeout = default_timeout
        self.stats = {"submitted": 0, "resolved": 0, "errors": 0,
                      "orphan_replies": 0, "local_runs": 0}
        self.obs = self.dispatcher.obs
        self.obs.metrics.register_dict("runtime", self.stats)

    # -- topology -----------------------------------------------------------

    def add_peer(self, name: str, fabric, target_ctx, *,
                 n_slots: int = DEFAULT_N_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 replies: bool | None = None,
                 reply_slots: int | None = None,
                 reply_slot_size: int | None = None, **kw):
        """Attach a peer with a result-return path.  ``replies`` defaults
        to True on host fabrics (a reply ring is opened on the *source*
        context) and False on device meshes (sweep results come back
        through the deposit pipeline already)."""
        peer = self.dispatcher.add_peer(name, fabric, target_ctx,
                                        n_slots=n_slots, slot_size=slot_size,
                                        **kw)
        if replies is None:
            replies = fabric.kind != "device"
        if replies:
            mb = fabric.open_mailbox(self.ctx, reply_slots or n_slots,
                                     reply_slot_size or slot_size)
            ch = fabric.connect(target_ctx, mb)
            self.dispatcher.attach_reply_ring(name, mb, ch)
        return peer

    # -- task dispatch ------------------------------------------------------

    def _begin_submit(self, fut: Future, peer: str, name: str):
        """Open the task's submit span (tracing runs only) and arm its
        close on the future's resolution — whichever path resolves it
        (reply, coalesced agg reply, fail_inflight, cancel), the span
        ends, which is what makes the every-submit-span-closed trace
        invariant hold."""
        tr = self.obs.tracer
        if not tr.enabled:
            return None
        sp = tr.begin(f"task:{name}@{peer}", cat="task",
                      actor=getattr(self.ctx, "name", "source"),
                      corr=fut.corr_id)

        def _close(f, _sp=sp, _tr=tr):
            if _sp.dur is None:          # refused submits end theirs early
                _tr.end(_sp, state=f.state.name)
        fut.add_done_callback(_close)
        return sp

    def submit(self, peer: str, handle, source_args,
               source_args_size: int | None = None, *,
               wait_credits: bool = True,
               max_wait_rounds: int = 10_000) -> Future | None:
        """Ship ``handle``'s ifunc to ``peer`` with a fresh corr_id; the
        returned Future resolves when the reply lands.  Out of credits:
        with ``wait_credits`` the runtime drives progress until a slot
        frees (bounded by ``max_wait_rounds``); without, returns None (the
        admission-control backpressure signal).

        A future whose ``result()`` timed out stays registered — a late
        reply still resolves it; a caller done waiting should ``cancel()``
        it so the eventual reply is dropped as an orphan instead of
        accumulating registrations."""
        self._corr += 1
        corr = F.make_corr(self._corr, self.generation)
        fut = Future(self, corr, peer, handle.name)
        self.futures[corr] = fut
        sp = self._begin_submit(fut, peer, handle.name)
        rounds = 0
        try:
            while not self.dispatcher.send_ifunc(
                    peer, handle, source_args, source_args_size,
                    corr_id=corr, future=fut):
                if not wait_credits:
                    del self.futures[corr]
                    if sp is not None and sp.dur is None:
                        self.obs.tracer.end(sp, state="REFUSED")
                    return None
                self.progress()
                rounds += 1
                if rounds > max_wait_rounds:
                    raise TransportError(
                        f"submit to {peer!r}: no credits after "
                        f"{max_wait_rounds} progress rounds")
        except BaseException:
            # nothing went on the wire for this corr (oversized frame,
            # credit starvation, an ifunc error surfacing mid-progress):
            # unregister so the dict cannot accumulate dead futures
            self.futures.pop(corr, None)
            if sp is not None and sp.dur is None:
                self.obs.tracer.end(sp, state="SUBMIT_ERROR")
            raise
        self.stats["submitted"] += 1
        return fut

    def submit_many(self, peer: str, handle, args_list, *,
                    source_args_size=None) -> list[Future]:
        """Submit a batch of same-ifunc tasks and flush once.  With
        coalescing on, the batch rides the dispatcher's bulk enqueue
        (``send_ifunc_many`` — codec and queue state hoisted out of the
        per-record loop) into as few FLAG_AGG containers as the slot
        budget allows, and the results come back coalesced; records the
        bulk path cannot accept (backpressure, an oversized record) fall
        back to per-record ``submit``, which waits for credits or raises
        the record's error.  Without coalescing it degrades gracefully to
        sequential submits."""
        args_list = list(args_list)
        d = self.dispatcher
        if not getattr(d, "_coalesce", False):
            futs = [self.submit(peer, handle, a, source_args_size)
                    for a in args_list]
            self.flush()
            return futs
        futs, corrs = [], []
        for _ in args_list:
            self._corr += 1
            corr = F.make_corr(self._corr, self.generation)
            fut = Future(self, corr, peer, handle.name)
            self.futures[corr] = fut
            futs.append(fut)
            corrs.append(corr)
        sent = d.send_ifunc_many(peer, handle, args_list,
                                 corr_ids=corrs, futures=futs)
        if self.obs.tracer.enabled:
            # spans open only for the accepted prefix — the refused tail's
            # futures are discarded below and would orphan theirs
            for i in range(sent):
                self._begin_submit(futs[i], peer, handle.name)
        self.stats["submitted"] += sent
        # refused tail: unregister ALL the bulk futures first (if a
        # resubmit below raises, nothing stays registered that never went
        # on the wire), then go through the per-record path
        # (credit-waiting, per-record errors)
        for i in range(sent, len(args_list)):
            self.futures.pop(corrs[i], None)
        for i in range(sent, len(args_list)):
            futs[i] = self.submit(peer, handle, args_list[i],
                                  source_args_size)
        self.flush()
        return futs

    def flush(self) -> None:
        """Publish everything handed to submit: coalescing queues pack
        into aggregates, then pending puts complete."""
        self.dispatcher.flush()

    def run_local(self, fn, *args, **kw) -> Future:
        """Execute inline, wrapped in an already-resolved Future — the
        uniform result object for a task run locally."""
        self._corr += 1
        fut = Future(self, F.make_corr(self._corr, self.generation),
                     "local", getattr(fn, "__name__", "fn"))
        fut._mark_sent(None)
        self.stats["local_runs"] += 1
        try:
            fut.set_result(fn(*args, **kw))
        except Exception as e:
            fut.set_exception(e)
            self.stats["errors"] += 1
        return fut

    def cancel(self, fut: Future) -> bool:
        """Forget a future (its late reply, if any, becomes an orphan)."""
        self.futures.pop(fut.corr_id, None)
        return fut.set_exception(TaskTimeout(f"{fut!r} cancelled"))

    # -- progress -----------------------------------------------------------

    def progress(self) -> int:
        """One full turn of the crank: flush queued retransmits and pending
        puts, execute at targets, route replies, resolve futures."""
        d = self.dispatcher
        for p in d.peers.values():
            d._flush_resends(p)
        d.engine.progress()
        return d.poll()          # poll() drains reply rings as a side effect

    def drain(self, max_rounds: int = 64,
              deadline: float | None = None) -> int:
        """Drain the dispatcher; with ``deadline`` set, requests stuck at a
        wedged peer past the deadline resolve their futures with a
        TransportError instead of hanging (the transport liveness floor)."""
        return self.dispatcher.drain(max_rounds, deadline=deadline)

    def pending(self) -> int:
        return sum(1 for f in self.futures.values() if not f.done())

    # -- reply demux (wired as dispatcher.reply_router) ---------------------

    def _on_reply(self, corr: int, name: str, value, is_err: bool,
                  decoded: bool) -> None:
        fut = self.futures.pop(corr, None)
        if fut is None:                      # duplicate / expired corr-id
            self.stats["orphan_replies"] += 1
            return
        o = self.obs
        if o.enabled:
            o.reply_hist.observe(
                (time.monotonic() - fut.submitted_at) * 1e6)
        if not decoded and not isinstance(value, wire.RemoteExecutionError):
            try:
                value = wire.decode(value)
            except Exception as e:           # corrupt reply payload: resolve
                fut.set_exception(e)         # the future, don't crash the
                self.stats["errors"] += 1    # drain loop
                return
        if is_err or isinstance(value, wire.RemoteExecutionError):
            if not isinstance(value, BaseException):
                value = wire.RemoteExecutionError("RemoteError", str(value))
            fut.set_exception(value)
            self.stats["errors"] += 1
        else:
            fut.set_result(value)
            self.stats["resolved"] += 1


__all__ = ["Future", "TaskRuntime", "TaskState", "TaskTimeout", "wait_all"]
