"""Pod controller: the ifunc API as the fleet's control plane, on the
unified transport layer.

The controller owns a :class:`repro_torch.transport.Dispatcher`; attaching a
worker opens a mailbox ring on the worker's NIC through the pluggable
fabric (RDMA by default — pass any other Fabric for DPU/CSD-tier workers)
and *injects* control functions — checkpoint triggers, LR updates, probes,
data-pipeline transforms — as ifunc messages with credit-based flow
control.  Workers sweep their mailbox between train steps.  New control
verbs deploy by dropping a library into the ifunc lib dir: no restart, no
redeploy (the paper's §1 motivation).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core import api as A
from repro_torch.transport import Dispatcher, ProgressEngine, RdmaFabric, TransportError


@dataclass
class WorkerAgent:
    """Target-side agent: a transport mailbox + the runner hooks control
    verbs use.  The mailbox is opened by the controller's dispatcher at
    attach time (the controller is the one mapping remote rings)."""

    name: str
    ctx: A.Context
    slot_size: int = 64 << 10
    n_slots: int = 64
    hooks: dict = field(default_factory=dict)   # exposed to ifunc target_args
    mailbox: object = None

    def __post_init__(self):
        self.hooks.setdefault("acks", [])

    def bind(self, mailbox) -> None:
        self.mailbox = mailbox

    def poll(self, max_msgs: int = 16) -> int:
        """Drain up to max_msgs control messages (called between steps)."""
        if self.mailbox is None:
            return 0
        sts = self.mailbox.sweep(self.ctx, self.hooks, budget=max_msgs)
        return sum(1 for st in sts if st == A.Status.OK)


class PodController:
    def __init__(self, ctx: A.Context, fabric=None,
                 engine: ProgressEngine | None = None):
        self.ctx = ctx
        self.fabric = fabric if fabric is not None else RdmaFabric()
        self.dispatcher = Dispatcher(ctx, engine)
        self.agents: dict[str, WorkerAgent] = {}

    def attach(self, agent: WorkerAgent, fabric=None) -> None:
        peer = self.dispatcher.add_peer(
            agent.name, fabric if fabric is not None else self.fabric,
            agent.ctx, n_slots=agent.n_slots, slot_size=agent.slot_size,
            target_args=agent.hooks)
        agent.bind(peer.rings[0].mailbox)
        self.agents[agent.name] = agent

    def inject(self, name: str, source_args=b"", workers=None) -> int:
        """Send ifunc ``name`` to (all) workers' mailboxes; returns #sent.
        Control messages are urgent: the engine is flushed immediately, so
        trailers are published before the workers' next sweep."""
        h = self.ctx.handles.get(name) or A.register_ifunc(self.ctx, name)
        sent = 0
        refused = []
        for wname in self.dispatcher.peers:
            if workers is not None and wname not in workers:
                continue
            msg = A.ifunc_msg_create(h, source_args)
            if self.dispatcher.send(wname, msg):
                sent += 1
            else:
                refused.append(wname)
        # flush BEFORE reporting refusals: frames already posted to healthy
        # workers must get their trailers published either way.
        self.dispatcher.flush()
        if refused:
            raise TransportError(
                f"worker mailbox(es) out of credits (not polling?): "
                f"{', '.join(refused)}; {sent} other worker(s) still served")
        return sent

    def per_worker_stats(self) -> dict[str, dict]:
        return self.dispatcher.per_peer_stats()

    def broadcast_until_acked(self, name: str, source_args=b"",
                              timeout_s: float = 5.0) -> bool:
        """inject + wait for every worker's ack hook (probe round-trip)."""
        want = {w: len(a.hooks["acks"]) + 1 for w, a in self.agents.items()}
        self.inject(name, source_args)
        t0 = time.time()
        while time.time() - t0 < timeout_s:
            done = all(len(a.hooks["acks"]) >= want[w]
                       for w, a in self.agents.items())
            if done:
                return True
            for a in self.agents.values():
                a.poll()
        return False
