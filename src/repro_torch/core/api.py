"""The ifunc API (paper Listing 1.1), source side.

    register_ifunc(ctx, name)            ~ ucp_register_ifunc
    ifunc_msg_create(handle, args)       ~ ucp_ifunc_msg_create

Registration happens at the *source*; the frame carries the code.  The
target half (``poll_ifunc`` and the host lanes) is not part of this
package yet: the device mesh links its μVM program at mailbox-open time
and reports per-slot :class:`Status` values through its sweep.
"""

from __future__ import annotations

import enum
import pathlib
from dataclasses import dataclass, field

from repro_torch.core import frame as F
from repro_torch.core.registry import IfuncLibrary


class Status(enum.Enum):
    OK = 0
    NO_MESSAGE = 1         # nothing at this address yet
    IN_PROGRESS = 2        # header here, trailer not yet (put in flight)
    REJECTED = 3           # ill-formed (frame cleared)
    NACK_UNCACHED = 4      # SLIM frame, digest not in the link cache


@dataclass
class Context:
    """ucp_context analogue for one process."""

    name: str
    lib_dir: pathlib.Path | None = None      # library search dir override
    handles: dict[str, "IfuncHandle"] = field(default_factory=dict)


@dataclass
class IfuncHandle:
    ctx: Context
    lib: IfuncLibrary

    @property
    def name(self) -> str:
        return self.lib.name

    @property
    def digest(self) -> bytes:
        return self.lib.code_digest


@dataclass
class IfuncMsg:
    handle: IfuncHandle
    frame: bytearray
    slim: bool = False
    corr_id: int = 0       # mirrors the sealed header field
    cont: bytes | None = None   # mirrors the sealed continuation section

    @property
    def nbytes(self) -> int:
        return len(self.frame)

    @property
    def payload_view(self) -> memoryview:
        hdr = F.peek_header(self.frame)
        return memoryview(self.frame)[hdr.payload_offset:hdr.cont_offset]


def register_ifunc(ctx: Context, name: str,
                   search_dir: pathlib.Path | None = None) -> IfuncHandle:
    lib = IfuncLibrary.load(name, search_dir or ctx.lib_dir)
    h = IfuncHandle(ctx, lib)
    ctx.handles[name] = h
    return h


def ifunc_msg_create(handle: IfuncHandle, source_args,
                     source_args_size: int | None = None, *,
                     slim: bool = False, corr_id: int = 0,
                     cont: bytes | None = None) -> IfuncMsg:
    """Build a frame.  ``payload_init`` writes directly into the frame
    buffer; a shrinking payload truncates the buffer in place.

    ``slim=True`` elides the code section (header digest only).
    ``corr_id`` nonzero asks the target for a result-return reply;
    ``cont`` appends a packed continuation descriptor."""
    lib = handle.lib
    if source_args_size is None:
        try:
            source_args_size = len(source_args)
        except TypeError:
            source_args_size = 0
    max_size = int(lib.payload_get_max_size(source_args, source_args_size))
    code = b"" if slim else lib.code
    cont_len = 0 if cont is None else len(cont)
    frame = bytearray(F.HEADER_LEN + len(code) + max_size + cont_len
                      + F.TRAILER_LEN)
    pv = F.frame_payload_view(frame, len(code), max_size)
    used = lib.payload_init(pv, max_size, source_args, source_args_size)
    used = max_size if used in (None, 0) else int(used)
    frame_len = F.seal_frame(frame, lib.name, code, lib.kind, used,
                             digest=lib.code_digest, slim=slim,
                             corr_id=corr_id, cont=cont)
    if frame_len < len(frame):       # shrink: truncate, don't re-pack
        try:
            pv.release()
            del frame[frame_len:]
        except BufferError:          # payload_init leaked a view: copy out
            frame = bytearray(memoryview(frame)[:frame_len])
    return IfuncMsg(handle, frame, slim=slim, corr_id=corr_id, cont=cont)
