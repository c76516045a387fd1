"""Frames, the μVM ISA, the ifunc library registry and the source-side API."""

from repro_torch.core.api import (Context, IfuncHandle, IfuncMsg, Status,
                                  ifunc_msg_create, register_ifunc)

__all__ = ["Context", "IfuncHandle", "IfuncMsg", "Status",
           "ifunc_msg_create", "register_ifunc"]
