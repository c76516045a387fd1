"""The paper's primary contribution: the ifunc API (remote function
injection and invocation) plus its UCX-AM baseline, over an emulated RDMA
fabric — and the device-tier analogue (mailbox + μVM)."""

from repro_torch.core.active_message import AmContext, AmEndpoint
from repro_torch.core.api import (AggSubResult, Context, IfuncHandle,
                                  IfuncMsg, Status, deregister_ifunc,
                                  ifunc_msg_create, ifunc_msg_free,
                                  ifunc_msg_send_nbix, ifunc_msg_to_full,
                                  poll_ifunc, poll_ring, register_ifunc,
                                  submit)
from repro_torch.core.codegen import LinkError, SymbolSpace, assemble
from repro_torch.core.frame import CodeKind, FrameError
from repro_torch.core.rdma import Access, AccessDenied, Nic, RingBuffer
from repro_torch.core.security import (DEVICE_ONLY, PERMISSIVE,
                                       SecurityPolicy)

__all__ = ["Access", "AccessDenied", "AggSubResult", "AmContext",
           "AmEndpoint", "CodeKind", "Context", "DEVICE_ONLY", "FrameError",
           "IfuncHandle", "IfuncMsg", "LinkError", "Nic", "PERMISSIVE",
           "RingBuffer", "SecurityPolicy", "Status", "SymbolSpace",
           "assemble", "deregister_ifunc", "ifunc_msg_create",
           "ifunc_msg_free", "ifunc_msg_send_nbix", "ifunc_msg_to_full",
           "poll_ifunc", "poll_ring", "register_ifunc", "submit"]
