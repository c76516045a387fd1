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

This module carries singleton frames only: FULL and SLIM packing, header
validation, the trailer check and section views.  Aggregate containers,
streams and replies are parsed by later layers; the flag bits and the
header checks that keep them well-formed are already here, so a frame
that this module accepts is one the reference accepts too.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass
from enum import IntEnum
from operator import mul as _mul


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
    counting as a word with a zero high byte.  The port checksums only
    short inputs with it (ifunc names, for the word frame's name hash)."""
    a = b = 0xFFFF
    for i in range(0, len(data) - 1, 2):
        a = (a + (data[i] | (data[i + 1] << 8))) % 0xFFFF
        b = (b + a) % 0xFFFF
    if len(data) % 2:
        a = (a + data[-1]) % 0xFFFF
        b = (b + a) % 0xFFFF
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


def clear_frame(buf, hdr: FrameHeader) -> None:
    """Zero a consumed frame slot so the next poll sees 'empty'."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    mv[:hdr.frame_len] = bytes(hdr.frame_len)
