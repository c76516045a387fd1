"""Security policy for inbound ifunc frames (paper §3.5 + hardening).

The paper relies on IBTA rkey checks (emulated in rdma.py at the access
level) and acknowledges their weakness (ReDMArk).  Since executing shipped
code is strictly more dangerous than writing memory, the target applies a
frame-level policy *before* linking anything:

* bounds: reject frames longer than ``max_frame_len`` (paper: "messages that
  are ill-formed or too long will be rejected");
* provenance: optional HMAC over the code section (shared-secret signing);
* capability: per-target allowlist of code kinds (e.g. a DPU-like target
  may accept UVM μcode but never PYBC);
* namespace: ifunc names must match ``name_pattern`` (no path tricks).

The policy, its checks and its messages are those of
``repro.core.security``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from repro_torch.core.frame import CodeKind, FrameError, FrameHeader


class PolicyViolation(FrameError):
    pass


#: header-check prediction: ``peek_header``'s memo hands back the SAME
#: (frozen) FrameHeader object in steady state, and policies are frozen
#: too — so one (policy, header) identity pair proves the whole
#: bounds/kind/namespace re-check redundant.  Identity, not equality:
#: a lookalike header from an unvalidated parse can never hit this.
_CHECK_MEMO: list = [None, None]


@dataclass(frozen=True)
class SecurityPolicy:
    max_frame_len: int = 1 << 24
    allowed_kinds: frozenset = frozenset({CodeKind.PYBC, CodeKind.HLO, CodeKind.UVM})
    name_pattern: str = r"^[A-Za-z_][A-Za-z0-9_]{0,30}$"
    hmac_key: bytes | None = None
    allow_auto_register: bool = True   # paper-prototype mode (lib on target fs)
    allow_remote_link: bool = True     # paper future-work mode (no target fs)

    def check_header(self, hdr: FrameHeader) -> None:
        memo = _CHECK_MEMO
        if hdr is memo[1] and self is memo[0]:
            return
        if hdr.frame_len > self.max_frame_len:
            raise PolicyViolation(f"frame too long ({hdr.frame_len})")
        if hdr.code_kind not in self.allowed_kinds:
            raise PolicyViolation(f"code kind {hdr.code_kind.name} not allowed here")
        if not re.match(self.name_pattern, hdr.name):
            raise PolicyViolation(f"bad ifunc name {hdr.name!r}")
        memo[0], memo[1] = self, hdr

    def check_agg_sub(self, name: str, kind: CodeKind) -> None:
        """Per-sub-record policy for aggregate containers: each packed
        invocation clears the same kind/namespace gates a singleton header
        would (frame length was already bounded on the container)."""
        if kind not in self.allowed_kinds:
            raise PolicyViolation(f"code kind {kind.name} not allowed here")
        if not re.match(self.name_pattern, name):
            raise PolicyViolation(f"bad ifunc name {name!r}")


PERMISSIVE = SecurityPolicy()
DEVICE_ONLY = SecurityPolicy(allowed_kinds=frozenset({CodeKind.UVM}))
