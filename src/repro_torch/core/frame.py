"""ifunc message frame, v2 — the singleton layout.

Byte-for-byte the layout of ``repro.core.frame`` (little-endian):

    offset  size  field
    0       4     magic            0x1F5C0DE8 (frame format v2.2+)
    4       8     frame_len        total bytes incl. trailer
    12      4     code_offset      start of code section (== HEADER_LEN)
    16      8     payload_offset   start of payload section
    24      4     code_kind        CodeKind enum (pybc | hlo | uvm)
    28      32    ifunc_name       NUL-padded ascii
    60      4     flags            FLAG_SLIM | FLAG_REPLY | FLAG_ERR |
                                   FLAG_CONT | FLAG_AGG | FLAG_STREAM
    64      16    code_digest      truncated sha256 of the FULL code section
    80      8     corr_id          request/reply correlation (0 = none)
    88      8     cont_offset      start of the continuation section
                                   (== end of payload unless FLAG_CONT)
    96      4     header_signal    fletcher32 over bytes [0, 96)
    100     ...   code             serialized code section (empty when SLIM)
    ...     ...   payload
    ...     ...   continuation descriptor (only with FLAG_CONT)
    last 4        trailer_signal   0xD0E1F2A3 — written last; its arrival
                                   means the whole frame has been delivered

The header signal authenticates header integrity (ill-formed frames are
rejected); the trailer is the delivery barrier the target spins on.

This module carries singleton frames (FULL and SLIM packing, header
validation, the trailer check, section views and the slot clear and
scrub a host poll ends with) and the request
direction of aggregate containers (``FLAG_AGG``: ``seal_agg_frame``,
``parse_agg``), byte for byte the reference's.  Reply containers, streams
and replies are parsed by later layers; the flag bits and the header
checks that keep them well-formed are already here, so a frame that this
module accepts is one the reference accepts too.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from enum import IntEnum
from operator import mul as _mul

import numpy as np


MAGIC = 0x1F5C0DE8
TRAILER = 0xD0E1F2A3
HEADER_LEN = 100
NAME_LEN = 32
TRAILER_LEN = 4
DIGEST_LEN = 16
FLAG_SLIM = 0x1
FLAG_REPLY = 0x2
FLAG_ERR = 0x4
FLAG_CONT = 0x8
FLAG_AGG = 0x10
FLAG_STREAM = 0x20
SIGNAL_OFF = 96             # header signal location; fletcher32 over [0, 96)
NO_DIGEST = b"\0" * DIGEST_LEN
AGG_NAME = "__agg__"        # header name of every aggregate container frame
STREAM_DESC_LEN = 28        # a stream frame's payload holds at least this

# corr_id layout: the fleet generation in the top 16 bits, a sequence below
CORR_GEN_SHIFT = 48
CORR_SEQ_MASK = (1 << CORR_GEN_SHIFT) - 1
CORR_GEN_MAX = (1 << 16) - 1


def make_corr(seq: int, gen: int = 0) -> int:
    """Stamp ``gen`` (fleet generation, wraps at 16 bits) into the top word
    of a correlation id.  ``seq`` must be nonzero for replyable frames."""
    return ((gen & CORR_GEN_MAX) << CORR_GEN_SHIFT) | (seq & CORR_SEQ_MASK)


def corr_gen(corr: int) -> int:
    """The fleet generation a corr_id was allocated under."""
    return (corr >> CORR_GEN_SHIFT) & CORR_GEN_MAX


def corr_seq(corr: int) -> int:
    """The per-runtime monotone sequence half of a corr_id."""
    return corr & CORR_SEQ_MASK


_HEADER_FMT = "<IQIQI32sI16sQQ"  # magic, frame_len, code_off, payload_off,
                                 # kind, name, flags, digest, corr_id,
                                 # cont_off
_HEADER_STRUCT = struct.Struct(_HEADER_FMT)
assert _HEADER_STRUCT.size == SIGNAL_OFF
_U32 = struct.Struct("<I")
_HDR_WORDS = struct.Struct(f"<{SIGNAL_OFF // 2}H")
_HDR_M = SIGNAL_OFF // 2                     # 48 header words
_HDR_WEIGHTS = tuple(range(_HDR_M, 0, -1))   # cumsum weight of word i


def _header_fletcher(buf) -> int:
    """fletcher32 over the 96 signed header bytes in closed form: for words
    w_1..w_m from a = b = 0xFFFF, ``a = 0xFFFF + sum(w)`` and
    ``b = 0xFFFF*(m+1) + sum_i (m-i+1)*w_i`` (mod 0xFFFF)."""
    ws = _HDR_WORDS.unpack_from(buf, 0)
    t = sum(map(_mul, ws, _HDR_WEIGHTS))
    a = (0xFFFF + sum(ws)) % 0xFFFF
    b = (0xFFFF * (_HDR_M + 1) + t) % 0xFFFF
    return (b << 16) | a


class CodeKind(IntEnum):
    PYBC = 1       # marshalled CPython bytecode + symbol table (host tier)
    HLO = 2        # exported graph (host tier)
    UVM = 3        # μVM bytecode for the device interpreter (device tier)


_CODE_KIND = {int(k): k for k in CodeKind}


class FrameError(Exception):
    """Ill-formed frame — the target rejects it."""


def fletcher32(data) -> int:
    """fletcher32 over 16-bit little-endian words, an odd trailing byte
    counting as a word with a zero high byte.  Short inputs (ifunc names,
    for the word frame's name hash) take the byte loop; longer ones (an
    aggregate's structural bytes) the closed form of
    :func:`_header_fletcher`, with the word sums in numpy."""
    n = len(data)
    if n < 128:
        a = b = 0xFFFF
        for i in range(0, n - 1, 2):
            a = (a + (data[i] | (data[i + 1] << 8))) % 0xFFFF
            b = (b + a) % 0xFFFF
        if n % 2:
            a = (a + data[-1]) % 0xFFFF
            b = (b + a) % 0xFFFF
        return (b << 16) | a
    w = np.frombuffer(data, "<u2", count=n // 2).astype(np.int64)
    if n % 2:
        w = np.append(w, data[-1])
    a = (0xFFFF + int(w.sum())) % 0xFFFF
    b = (0xFFFF * (len(w) + 1) + int(np.cumsum(w).sum())) % 0xFFFF
    return (b << 16) | a


def compute_digest(code) -> bytes:
    """Truncated sha256 identifying a code section (hashed once per library
    load, never on the dispatch path)."""
    return hashlib.sha256(bytes(code)).digest()[:DIGEST_LEN]


@dataclass(frozen=True)
class FrameHeader:
    frame_len: int
    code_offset: int
    payload_offset: int
    code_kind: CodeKind
    name: str
    flags: int = 0
    digest: bytes = NO_DIGEST
    corr_id: int = 0
    cont_offset: int = 0

    @property
    def is_slim(self) -> bool:
        return bool(self.flags & FLAG_SLIM)

    @property
    def is_reply(self) -> bool:
        return bool(self.flags & FLAG_REPLY)

    @property
    def is_err(self) -> bool:
        return bool(self.flags & FLAG_ERR)

    @property
    def has_cont(self) -> bool:
        return bool(self.flags & FLAG_CONT)

    @property
    def is_agg(self) -> bool:
        return bool(self.flags & FLAG_AGG)

    @property
    def is_stream(self) -> bool:
        return bool(self.flags & FLAG_STREAM)


def _name_bytes(name: str) -> bytes:
    nb = name.encode()
    if len(nb) >= NAME_LEN:
        raise FrameError(f"ifunc name too long (>{NAME_LEN - 1}): {name!r}")
    return nb.ljust(NAME_LEN, b"\0")


def seal_frame(buf, name: str, code, kind: CodeKind, payload_len: int, *,
               digest: bytes | None = None, slim: bool = False,
               corr_id: int = 0, flags: int = 0,
               cont: bytes | None = None) -> int:
    """Write header + code + trailer around a payload already in place
    (see :func:`frame_payload_view`), directly into ``buf``.  Returns the
    frame length.  ``cont`` appends a continuation section after the
    payload and sets ``FLAG_CONT``."""
    nb = _name_bytes(name)
    code_len = 0 if slim else len(code)
    payload_off = HEADER_LEN + code_len
    cont_off = payload_off + payload_len
    cont_len = 0 if cont is None else len(cont)
    frame_len = cont_off + cont_len + TRAILER_LEN
    if len(buf) < frame_len:
        raise FrameError(f"frame {frame_len}B exceeds buffer {len(buf)}B")
    if digest is None:
        digest = compute_digest(code)
    if code_len:
        buf[HEADER_LEN:payload_off] = code
    if cont_len:
        buf[cont_off:cont_off + cont_len] = cont
        flags |= FLAG_CONT
    _HEADER_STRUCT.pack_into(buf, 0, MAGIC, frame_len, HEADER_LEN,
                             payload_off, int(kind), nb,
                             flags | (FLAG_SLIM if slim else 0),
                             digest, corr_id, cont_off)
    _U32.pack_into(buf, SIGNAL_OFF, _header_fletcher(buf))
    _U32.pack_into(buf, frame_len - TRAILER_LEN, TRAILER)
    return frame_len


def frame_payload_view(buf, code_len: int, max_payload: int,
                       *, slim: bool = False) -> memoryview:
    """Writable view of the payload region a frame in ``buf`` will occupy:
    ``payload_init`` writes here, then :func:`seal_frame` wraps it."""
    off = HEADER_LEN + (0 if slim else code_len)
    return memoryview(buf)[off:off + max_payload]


def pack_frame_into(buf, name: str, code, payload, kind: CodeKind, *,
                    digest: bytes | None = None, slim: bool = False,
                    corr_id: int = 0, flags: int = 0,
                    cont: bytes | None = None) -> int:
    """Pack a complete frame into a preallocated buffer (a slab cell).
    Returns frame_len."""
    code_len = 0 if slim else len(code)
    payload_off = HEADER_LEN + code_len
    cont_len = 0 if cont is None else len(cont)
    need = payload_off + len(payload) + cont_len + TRAILER_LEN
    if len(buf) < need:
        raise FrameError(f"frame {need}B exceeds buffer {len(buf)}B")
    buf[payload_off:payload_off + len(payload)] = payload
    return seal_frame(buf, name, code, kind, len(payload), digest=digest,
                      slim=slim, corr_id=corr_id, flags=flags, cont=cont)


def pack_frame(name: str, code: bytes, payload, kind: CodeKind, *,
               digest: bytes | None = None, slim: bool = False,
               corr_id: int = 0, flags: int = 0,
               cont: bytes | None = None) -> bytearray:
    code_len = 0 if slim else len(code)
    cont_len = 0 if cont is None else len(cont)
    buf = bytearray(HEADER_LEN + code_len + len(payload) + cont_len
                    + TRAILER_LEN)
    pack_frame_into(buf, name, code, payload, kind, digest=digest, slim=slim,
                    corr_id=corr_id, flags=flags, cont=cont)
    return buf


def pack_reply(name: str, payload, kind: CodeKind, corr_id: int, *,
               err: bool = False) -> bytearray:
    """A result-return frame: no code section, no continuation, FLAG_REPLY
    set, the request's corr_id echoed; ``err=True`` marks the payload as
    an encoded exception rather than a value."""
    return pack_frame(name, b"", payload, kind, corr_id=corr_id,
                      flags=FLAG_REPLY | (FLAG_ERR if err else 0))


def pack_reply_into(buf, name: str, payload, kind: CodeKind, corr_id: int, *,
                    err: bool = False) -> int:
    """:func:`pack_reply` into a preallocated buffer (a slab cell)."""
    return pack_frame_into(buf, name, b"", payload, kind, corr_id=corr_id,
                           flags=FLAG_REPLY | (FLAG_ERR if err else 0))


def peek_header(buf, max_frame: int | None = None) -> FrameHeader | None:
    """Validate + parse the header at buf[0:].  Returns None if no message
    has arrived (zeroed magic); raises FrameError on corruption/bounds."""
    if len(buf) < HEADER_LEN:
        return None
    (magic,) = _U32.unpack_from(buf, 0)
    if magic == 0:
        return None
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    (sig,) = _U32.unpack_from(buf, SIGNAL_OFF)
    if sig != _header_fletcher(buf):
        raise FrameError("header signal mismatch (corrupt header)")
    (magic, frame_len, code_off, payload_off, kind, name, flags,
     digest, corr_id, cont_off) = _HEADER_STRUCT.unpack_from(buf, 0)
    if max_frame is not None and frame_len > max_frame:
        raise FrameError(f"frame too long ({frame_len} > {max_frame})")
    if not (HEADER_LEN <= code_off <= payload_off <= cont_off
            <= frame_len - TRAILER_LEN):
        raise FrameError("inconsistent offsets")
    if flags & (FLAG_SLIM | FLAG_REPLY | FLAG_AGG) and code_off != payload_off:
        raise FrameError("SLIM/reply/aggregate frame carries a code section")
    if flags & FLAG_AGG and flags & (FLAG_SLIM | FLAG_CONT):
        raise FrameError("aggregate frame with frame-level SLIM/CONT flags "
                         "(both ride per sub-record)")
    if flags & FLAG_STREAM:
        if flags & (FLAG_REPLY | FLAG_AGG | FLAG_CONT):
            raise FrameError("stream frame with reply/aggregate/continuation "
                             "flags (streams are request singletons)")
        if cont_off - payload_off < STREAM_DESC_LEN:
            raise FrameError("stream frame payload smaller than its "
                             "descriptor")
    if flags & FLAG_CONT:
        if flags & FLAG_REPLY:
            raise FrameError("reply frame carries a continuation section")
        if cont_off == frame_len - TRAILER_LEN:
            raise FrameError("FLAG_CONT with empty continuation section")
    elif cont_off != frame_len - TRAILER_LEN:
        raise FrameError("continuation section without FLAG_CONT")
    ck = _CODE_KIND.get(kind)
    if ck is None:
        raise FrameError(f"unknown code kind {kind}")
    try:
        nm = name.rstrip(b"\0").decode(errors="strict")
    except UnicodeDecodeError as e:
        raise FrameError(f"ifunc name is not ascii: {e}") from e
    return FrameHeader(frame_len, code_off, payload_off, ck, nm, flags,
                       bytes(digest), corr_id, cont_off)


def trailer_arrived(buf, hdr: FrameHeader) -> bool:
    end = hdr.frame_len
    if len(buf) < end:
        raise FrameError("frame exceeds buffer")
    (t,) = _U32.unpack_from(buf, end - TRAILER_LEN)
    return t == TRAILER


def frame_sections(buf, hdr: FrameHeader) -> tuple[memoryview, memoryview]:
    """Zero-copy (code, payload) views into ``buf``.  The payload view stops
    at ``cont_offset``: an executing ifunc never sees the continuation."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return (mv[hdr.code_offset:hdr.payload_offset],
            mv[hdr.payload_offset:hdr.cont_offset])


def frame_cont(buf, hdr: FrameHeader) -> memoryview | None:
    """Zero-copy view of the continuation descriptor section, or None when
    the frame carries no continuation (same lifetime as
    :func:`frame_sections`)."""
    if not hdr.has_cont:
        return None
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return mv[hdr.cont_offset:hdr.frame_len - TRAILER_LEN]


def clear_frame(buf, hdr: FrameHeader) -> None:
    """Zero a consumed frame slot so the next poll sees 'empty'."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    mv[:hdr.frame_len] = bytes(hdr.frame_len)


def scrub_slot(buf) -> None:
    """Best-effort clear of a slot in an unknown state (poisoned execution,
    corrupt header): clear the whole frame when the header still parses,
    else zero the header region so the next poll sees 'empty'."""
    try:
        hdr = peek_header(buf)
        if hdr is not None:
            clear_frame(buf, hdr)
            return
    except FrameError:
        pass
    buf[:HEADER_LEN] = bytes(HEADER_LEN)


# ---------------------------------------------------------------------------
# Aggregate container payload (FLAG_AGG), request direction — columnar.
#
#     u16 n_subs | u16 n_names
#     n_names x (u8 len | name bytes)            -- interned name table
#     payload region: every sub-record's payload bytes, then its cont
#                     bytes, concatenated in record order
#     n_subs x (u16 name_idx | u8 kind | u8 sub_flags | 16s digest |
#               u64 corr_id | u32 payload_len | u32 cont_len)
#                                                -- contiguous sub-record TABLE
#     u32 fletcher32 over the STRUCTURAL bytes   -- ONE signal for K records
#
# The name table interns each distinct ifunc name once per container; a
# sub-record references it by index.  The fixed headers sit in ONE table
# at the payload's tail, so a pack streams payload bytes into place before
# the record count is known and a parse reads every record with one numpy
# structured read.  The signal covers the counts, the name table and the
# table — not the payload bytes, which ride on the ordered put and the
# trailer barrier as a singleton's do — so a decode never trusts corrupt
# framing.

_AGG_COUNT = struct.Struct("<HH")
_AGG_SUB = struct.Struct("<HBB16sQII")
AGG_SUB_OVERHEAD = _AGG_SUB.size            # fixed bytes per sub-record
AGG_SUBFLAG_ERR = 0x1                       # reply sub-record carries an error
AGG_SUBFLAG_CONT = 0x2                      # sub-record has a cont section

# one row of the sub-record table; field for field the _AGG_SUB struct
_AGG_DTYPE = np.dtype([("name_idx", "<u2"), ("kind", "u1"),
                       ("flags", "u1"), ("digest", "V16"),
                       ("corr", "<u8"), ("plen", "<u4"), ("clen", "<u4")])
assert _AGG_DTYPE.itemsize == _AGG_SUB.size
_CODE_KIND_LUT = np.zeros(256, dtype=bool)  # kind validity, one fancy index
_CODE_KIND_LUT[list(_CODE_KIND)] = True


@dataclass(slots=True)
class AggSub:
    """One packed invocation inside a FLAG_AGG container."""

    name: str
    kind: CodeKind
    digest: bytes
    corr_id: int
    payload: object                         # bytes-like
    cont: bytes | None = None
    err: bool = False


def _agg_names(subs) -> tuple[list[str], dict]:
    names: list[str] = []
    idx: dict[str, int] = {}
    for s in subs:
        if s.name not in idx:
            idx[s.name] = len(names)
            names.append(s.name)
    return names, idx


def agg_payload_len(subs) -> int:
    """Exact byte length the aggregate payload for ``subs`` will occupy."""
    names, _ = _agg_names(subs)
    n = _AGG_COUNT.size + sum(1 + len(nm.encode()) for nm in names)
    for s in subs:
        n += (_AGG_SUB.size + len(s.payload)
              + (0 if s.cont is None else len(s.cont)))
    return n + 4                            # the aggregate fletcher signal


def agg_frame_len(subs) -> int:
    """Full frame length of the aggregate container carrying ``subs``."""
    return HEADER_LEN + agg_payload_len(subs) + TRAILER_LEN


def begin_agg(view, names: list[str]) -> int:
    """Write a streaming aggregate's prologue into ``view``: a zero
    sub-count (patched by :func:`finish_agg`) and the interned name table.
    Returns the offset where the first sub-record's payload bytes go."""
    _AGG_COUNT.pack_into(view, 0, 0, len(names))
    off = _AGG_COUNT.size
    for nm in names:
        nb = nm.encode()
        if not 0 < len(nb) < 256:
            raise FrameError(f"aggregate ifunc name length {len(nb)}")
        view[off] = len(nb)
        view[off + 1:off + 1 + len(nb)] = nb
        off += 1 + len(nb)
    return off


def agg_sub_hdr(name_idx: int, kind: CodeKind, digest: bytes, corr_id: int,
                payload_len: int, *, cont_len: int = 0,
                err: bool = False) -> tuple:
    """One sub-record's fixed-header row for :func:`finish_agg`."""
    flags = ((AGG_SUBFLAG_ERR if err else 0)
             | (AGG_SUBFLAG_CONT if cont_len else 0))
    return (name_idx, int(kind), flags, digest, corr_id, payload_len,
            cont_len)


def _finish_agg_table(view, prologue_end: int, payload_end: int,
                      hdrs) -> int:
    """Write the contiguous sub-record table at ``payload_end``, patch the
    sub count, and sign prologue + table; returns the aggregate payload
    length.  ``hdrs`` rows are ``_AGG_SUB`` field tuples."""
    n_subs = len(hdrs)
    struct.pack_into("<H", view, 0, n_subs)
    end = payload_end + _AGG_SUB.size * n_subs
    view[payload_end:end] = np.array(hdrs, dtype=_AGG_DTYPE).tobytes()
    _U32.pack_into(view, end, fletcher32(
        b"".join((view[0:prologue_end], view[payload_end:end]))))
    return end + 4


def finish_agg(view, prologue_end: int, payload_end: int, hdrs) -> int:
    """Write the sub-record table (rows from :func:`agg_sub_hdr`) after
    the streamed payload bytes, patch the sub count, sign prologue +
    table, and return the aggregate payload length."""
    return _finish_agg_table(view, prologue_end, payload_end, hdrs)


def pack_agg_into(view, subs) -> int:
    """Pack ``subs`` as a columnar aggregate payload into ``view`` (the
    payload region of a slab cell); returns bytes used.  The caller seals
    the surrounding FLAG_AGG frame."""
    if not subs:
        raise FrameError("empty aggregate")
    if len(subs) > 0xFFFF:
        raise FrameError(f"aggregate of {len(subs)} sub-records (max 65535)")
    names, idx = _agg_names(subs)
    off = prologue_end = begin_agg(view, names)
    cap = len(view)
    tail = _AGG_SUB.size * len(subs) + 4    # table + aggregate signal
    hdrs = []
    for s in subs:
        pl = len(s.payload)
        cl = 0 if s.cont is None else len(s.cont)
        if off + pl + cl + tail > cap:
            raise FrameError(f"aggregate overflows {cap}B buffer")
        if len(s.digest) != DIGEST_LEN:
            raise FrameError(f"sub-record digest length {len(s.digest)}")
        view[off:off + pl] = s.payload
        off += pl
        if cl:
            view[off:off + cl] = s.cont
            off += cl
        hdrs.append((idx[s.name], int(s.kind),
                     (AGG_SUBFLAG_ERR if s.err else 0)
                     | (AGG_SUBFLAG_CONT if s.cont is not None else 0),
                     s.digest, s.corr_id, pl, cl))
    return _finish_agg_table(view, prologue_end, off, hdrs)


class AggBatch:
    """Column view of a decoded aggregate container: the sub-record table
    as plain lists.  ``payload(i)`` is a zero-copy view into the frame,
    valid until the slot is reused."""

    __slots__ = ("mv", "n", "names", "name_idx", "kinds", "flags", "corrs",
                 "digests", "starts", "plens", "clens")

    def payload(self, i: int) -> memoryview:
        s = self.starts[i]
        return self.mv[s:s + self.plens[i]]

    def cont(self, i: int) -> bytes | None:
        if not self.flags[i] & AGG_SUBFLAG_CONT:
            return None
        s = self.starts[i] + self.plens[i]
        return bytes(self.mv[s:s + self.clens[i]])

    def digest(self, i: int) -> bytes:
        return self.digests[DIGEST_LEN * i:DIGEST_LEN * (i + 1)]

    def kind(self, i: int) -> CodeKind:
        return _CODE_KIND[self.kinds[i]]

    def name(self, i: int) -> str:
        return self.names[self.name_idx[i]]

    def subs(self) -> list[AggSub]:
        """Per-record ``AggSub`` objects (payloads are views)."""
        return [AggSub(self.name(i), self.kind(i), self.digest(i),
                       self.corrs[i], self.payload(i), self.cont(i),
                       bool(self.flags[i] & AGG_SUBFLAG_ERR))
                for i in range(self.n)]

    def reply_tuples(self) -> list[tuple]:
        """``(corr_id, name, payload bytes, err)`` per record, the reply
        demux's projection (payloads copied: the reply frame is cleared
        right after the demux)."""
        mv, names, name_idx = self.mv, self.names, self.name_idx
        starts, plens = self.starts, self.plens
        corrs, flags = self.corrs, self.flags
        return [(corrs[i], names[name_idx[i]],
                 bytes(mv[starts[i]:starts[i] + plens[i]]),
                 bool(flags[i] & AGG_SUBFLAG_ERR))
                for i in range(self.n)]


def parse_agg(payload) -> AggBatch:
    """Decode an aggregate payload: one structured read of the sub-record
    table, one bounds check (the payload region must end exactly where the
    table begins), one signal verify over the structural bytes.  A
    mismatch anywhere rejects the WHOLE container."""
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    n = len(mv)
    if n < _AGG_COUNT.size + 4:
        raise FrameError("aggregate payload too short")
    try:
        n_subs, n_names = _AGG_COUNT.unpack_from(mv, 0)
        off = _AGG_COUNT.size
        names = []
        for _ in range(n_names):
            ln = mv[off]
            names.append(bytes(mv[off + 1:off + 1 + ln]).decode())
            off += 1 + ln
    except (IndexError, ValueError, UnicodeDecodeError, struct.error) as e:
        raise FrameError(f"ill-formed aggregate payload: {e}") from e
    prologue_end = off
    limit = n - 4
    tbl_off = limit - _AGG_SUB.size * n_subs
    if tbl_off < prologue_end:
        raise FrameError("aggregate sub-record exceeds payload")
    # the signal verifies BEFORE any table field is trusted
    (sig,) = _U32.unpack_from(mv, limit)
    if sig != fletcher32(b"".join((mv[0:prologue_end], mv[tbl_off:limit]))):
        raise FrameError("aggregate signal mismatch (corrupt sub-records)")
    tbl = np.frombuffer(mv, _AGG_DTYPE, count=n_subs, offset=tbl_off)
    plens = tbl["plen"].astype(np.int64)
    sizes = plens + tbl["clen"]
    ends = prologue_end + np.cumsum(sizes)
    if (int(ends[-1]) if n_subs else prologue_end) != tbl_off:
        raise FrameError("aggregate payload trailing bytes")
    kinds = tbl["kind"]
    if n_subs:
        known = _CODE_KIND_LUT[kinds]
        if not known.all():
            raise FrameError("unknown sub-record code kind "
                             f"{int(kinds[~known][0])}")
        if int(tbl["name_idx"].max()) >= n_names:
            raise FrameError("ill-formed aggregate payload: "
                             "sub-record name index out of range")
    b = AggBatch()
    b.mv, b.n, b.names = mv, n_subs, names
    b.name_idx = tbl["name_idx"].tolist()
    b.kinds = kinds.tolist()
    b.flags = tbl["flags"].tolist()
    b.corrs = tbl["corr"].tolist()
    b.digests = tbl["digest"].tobytes()
    b.starts = (ends - sizes).tolist()
    b.plens = plens.tolist()
    b.clens = tbl["clen"].tolist()
    return b


def unpack_agg(payload) -> list[AggSub]:
    """Decode an aggregate payload into per-record ``AggSub`` objects
    (:func:`parse_agg` plus the per-record projection)."""
    return parse_agg(payload).subs()


def seal_agg_frame(buf, subs, *, reply: bool = False,
                   kind: CodeKind = CodeKind.PYBC) -> int:
    """Pack ``subs`` and seal the FLAG_AGG container around them, in place
    in ``buf`` (a slab cell); returns the frame length.  ``reply=True``
    seals a coalesced reply (``FLAG_AGG|FLAG_REPLY``)."""
    cap = len(buf) - HEADER_LEN - TRAILER_LEN
    if cap <= 0:
        raise FrameError(f"buffer {len(buf)}B cannot hold an aggregate")
    used = pack_agg_into(frame_payload_view(buf, 0, cap), subs)
    return seal_frame(buf, AGG_NAME, b"", kind, used, digest=NO_DIGEST,
                      flags=FLAG_AGG | (FLAG_REPLY if reply else 0))
