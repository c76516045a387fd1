"""Flow layer: remote continuations, peer-to-peer chaining, and
scatter/gather dataflow over the ifunc transport and task layers (the
reference's ``repro.flow``).

A frame's v2.2 continuation section carries the rest of the plan, so the
peer that *executes* a stage packs the result straight into the next
request frame and forwards it peer-to-peer through its own dispatcher;
the host sees only the final reply.

    from repro_torch.flow import Flow, FlowEngine
"""

from repro_torch.flow.descriptor import (Chain, FlowError, Hop, Scatter,
                                         apply_bind, pack_chain, parse_chain)
from repro_torch.flow.engine import Flow, FlowEngine
from repro_torch.flow.node import FlowNode

__all__ = ["Chain", "Flow", "FlowEngine", "FlowError", "FlowNode", "Hop",
           "Scatter", "apply_bind", "pack_chain", "parse_chain"]
