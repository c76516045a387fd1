"""Continuation descriptor codec — what rides in a frame's v2.2
continuation section (``FLAG_CONT``).

A descriptor is a packed :class:`Chain`: the originating peer's route +
corr_id, plus the ordered list of entries still to run *after* the frame's
own ifunc completes.  Three entry kinds:

* :class:`Hop` (``KIND_HOP``) — run ``ifunc`` at ``peer``, binding the
  upstream result into its source args via ``bind``;
* :class:`Scatter` (``KIND_SCATTER``) — fan the upstream result out to N
  branch hops, each of which continues into the chain's gather;
* a gather :class:`Hop` (``KIND_GATHER``) — a rendezvous: branch results
  accumulate at ``peer`` until ``expect`` of them arrived (``gid`` keys
  the group, ``idx`` orders the branches), then ``ifunc`` reduces them in
  one shot and the chain continues.

The 16-byte ``digest`` pins each hop to the exact code the flow author
compiled against: a forwarding node whose locally registered library
hashes differently refuses the hop (error short-circuit) rather than
silently running other code under the same name.

Bind specs are small JSON dicts:

    {"mode": "raw"}                         the result IS the next source_args
    {"mode": "kw", "key": k, "static": {}}  source_args = {**static, k: result}
    {"mode": "static", "static": {...}}     result dropped; static args only

Wire layout (little-endian)::

    u16 magic 0xFC22 | u8 version | u8 n_entries
    u64 corr
    u8 origin_len | origin
    entries:
      u8 kind
      HOP/GATHER: u8 peer_len|peer, u8 ifunc_len|ifunc, 16B digest,
                  u16 bind_len|bind_json [, u16 expect, u16 gid, u16 idx]
      SCATTER:    u8 n_branches, then n_branches packed HOP entries

Parse failures raise :class:`FlowError` — a ``FrameError`` subclass, so a
frame with a corrupt descriptor is *rejected* by ``poll_ifunc`` exactly
like any other ill-formed frame.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

from repro_torch.core.frame import DIGEST_LEN, FrameError

FLOW_MAGIC = 0xFC22
FLOW_VERSION = 1
KIND_HOP, KIND_SCATTER, KIND_GATHER = 1, 2, 3
#: wire-only variant of KIND_GATHER stamped on the *final leg* of a branch
#: (the frame carrying a branch RESULT to the rendezvous).  It is what the
#: gather node intercepts pre-execution — keying the interception on an
#: explicit kind instead of (peer, ifunc) heuristics keeps a branch stage
#: that happens to run the gather ifunc AT the gather peer unambiguous.
KIND_GATHER_ARRIVAL = 4

NO_DIGEST = b"\0" * DIGEST_LEN


class FlowError(FrameError):
    """Ill-formed continuation descriptor (or flow-protocol violation)."""


@dataclass(frozen=True)
class Hop:
    """One chain entry: run ``ifunc`` at ``peer``.  ``kind`` KIND_GATHER
    makes it a rendezvous (see module docstring)."""

    peer: str
    ifunc: str
    digest: bytes = NO_DIGEST
    bind: dict | None = None
    expect: int = 0          # gather only: branch arrivals to wait for
    gid: int = 0             # gather only: rendezvous group id
    idx: int = 0             # gather only: this branch's position
    kind: int = KIND_HOP

    @property
    def label(self) -> str:
        return f"{self.ifunc}@{self.peer}"


@dataclass(frozen=True)
class Scatter:
    """Fan-out entry: the upstream result goes to every branch hop; the
    entry after a Scatter must be the gather that joins them."""

    branches: tuple = ()
    kind: int = KIND_SCATTER


@dataclass(frozen=True)
class Chain:
    """A continuation: where the final reply goes (origin, corr) and the
    entries still to run."""

    origin: str
    corr: int
    entries: tuple = field(default=())

    def advanced(self, n: int = 1) -> "Chain":
        return Chain(self.origin, self.corr, self.entries[n:])


# ---------------------------------------------------------------------------
# packing


def _pack_str(s: str, width: str = "B") -> bytes:
    b = s.encode()
    if len(b) >= (1 << (8 * struct.calcsize(width))):
        raise FlowError(f"string too long for descriptor: {s[:32]!r}...")
    return struct.pack("<" + width, len(b)) + b


def _pack_hop(h: Hop) -> bytes:
    if len(h.digest) != DIGEST_LEN:
        raise FlowError(f"hop digest must be {DIGEST_LEN}B")
    bind = b"" if h.bind is None else json.dumps(
        h.bind, sort_keys=True).encode()
    out = (struct.pack("<B", h.kind) + _pack_str(h.peer)
           + _pack_str(h.ifunc) + h.digest
           + struct.pack("<H", len(bind)) + bind)
    if h.kind in (KIND_GATHER, KIND_GATHER_ARRIVAL):
        if not all(0 <= v <= 0xFFFF for v in (h.expect, h.gid, h.idx)):
            raise FlowError(
                f"gather expect/gid/idx out of u16 range: "
                f"({h.expect}, {h.gid}, {h.idx})")
        out += struct.pack("<HHH", h.expect, h.gid, h.idx)
    return out


def pack_chain(chain: Chain) -> bytes:
    if len(chain.entries) > 0xFF:
        raise FlowError("chain too long")
    out = bytearray(struct.pack("<HBB", FLOW_MAGIC, FLOW_VERSION,
                                len(chain.entries)))
    out += struct.pack("<Q", chain.corr)
    out += _pack_str(chain.origin)
    for ent in chain.entries:
        if isinstance(ent, Scatter):
            if not ent.branches:
                raise FlowError("scatter with no branches")
            out += struct.pack("<BB", KIND_SCATTER, len(ent.branches))
            for br in ent.branches:
                if br.kind != KIND_HOP:
                    raise FlowError("scatter branches must be plain hops")
                out += _pack_hop(br)
        elif isinstance(ent, Hop):
            out += _pack_hop(ent)
        else:
            raise FlowError(f"unknown chain entry {type(ent).__name__}")
    return bytes(out)


# ---------------------------------------------------------------------------
# parsing


class _Reader:
    def __init__(self, buf):
        self.buf = bytes(buf)
        self.off = 0

    def take(self, fmt: str):
        try:
            vals = struct.unpack_from("<" + fmt, self.buf, self.off)
        except struct.error as e:
            raise FlowError(f"truncated descriptor: {e}") from e
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_bytes(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise FlowError("truncated descriptor")
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def take_str(self, width: str = "B") -> str:
        n = self.take(width)
        return self.take_bytes(n).decode()


def _parse_hop(r: _Reader, kind: int) -> Hop:
    peer = r.take_str()
    ifunc = r.take_str()
    digest = r.take_bytes(DIGEST_LEN)
    bind_len = r.take("H")
    bind_b = r.take_bytes(bind_len)
    try:
        bind = json.loads(bind_b.decode()) if bind_b else None
    except ValueError as e:
        raise FlowError(f"bad bind spec: {e}") from e
    expect = gid = idx = 0
    if kind in (KIND_GATHER, KIND_GATHER_ARRIVAL):
        expect, gid, idx = r.take("HHH")
    return Hop(peer, ifunc, digest, bind, expect=expect, gid=gid, idx=idx,
               kind=kind)


def parse_chain(view) -> Chain:
    r = _Reader(view)
    magic, version, n = r.take("HBB")
    if magic != FLOW_MAGIC:
        raise FlowError(f"bad descriptor magic {magic:#x}")
    if version != FLOW_VERSION:
        raise FlowError(f"unsupported descriptor version {version}")
    corr = r.take("Q")
    origin = r.take_str()
    entries = []
    for _ in range(n):
        kind = r.take("B")
        if kind == KIND_SCATTER:
            nb = r.take("B")
            branches = []
            for _ in range(nb):
                bk = r.take("B")
                if bk != KIND_HOP:
                    raise FlowError("scatter branch must be a plain hop")
                branches.append(_parse_hop(r, bk))
            entries.append(Scatter(tuple(branches)))
        elif kind in (KIND_HOP, KIND_GATHER, KIND_GATHER_ARRIVAL):
            entries.append(_parse_hop(r, kind))
        else:
            raise FlowError(f"unknown entry kind {kind}")
    if r.off != len(r.buf):
        raise FlowError(f"descriptor trailing bytes ({len(r.buf) - r.off})")
    return Chain(origin, corr, tuple(entries))


# ---------------------------------------------------------------------------
# arg binding


def apply_bind(bind: dict | None, value):
    """Turn an upstream stage's result into the next stage's source_args."""
    mode = (bind or {}).get("mode", "raw")
    if mode == "raw":
        return value
    if mode == "static":
        return dict((bind or {}).get("static") or {})
    if mode == "kw":
        key = bind.get("key")
        if not key:
            raise FlowError("kw bind needs a 'key'")
        args = dict(bind.get("static") or {})
        args[key] = value
        return args
    raise FlowError(f"unknown bind mode {mode!r}")


__all__ = ["Chain", "FlowError", "Hop", "KIND_GATHER",
           "KIND_GATHER_ARRIVAL", "KIND_HOP", "KIND_SCATTER", "NO_DIGEST",
           "Scatter", "apply_bind", "pack_chain", "parse_chain"]
