"""Frames, the μVM ISA, the ifunc library registry and the source-side API."""

from repro_torch.core.api import (AggSubResult, Context, IfuncHandle,
                                  IfuncMsg, Status, ifunc_msg_create,
                                  register_ifunc)

__all__ = ["AggSubResult", "Context", "IfuncHandle", "IfuncMsg", "Status",
           "ifunc_msg_create", "register_ifunc"]
