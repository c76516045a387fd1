"""Reply-payload codec: how task results travel inside FLAG_REPLY frames.

Pickle-free: the reply direction crosses the same trust boundary as the
request direction, so results keep to a small tagged vocabulary (the
reference's byte layout):

    tag 0  RAW    raw bytes (the value as-is)
    tag 1  JSON   a json-encodable value
    tag 2  NPY    one array: <u4 dtype-str len | dtype | u1 ndim |
                  u4 shape... | data>
    tag 3  ERR    an exception: json {"type": ..., "msg": ...}

``encode`` also takes a ``torch.Tensor``: a μVM result on a ``"cuda"``
target is a tensor on the card, copied to the host once here (the reply's
one D2H copy) and packed as NPY.  A dtype numpy lacks (bf16) raises
:class:`WireError`; it is never upcast.  ``decode`` returns numpy arrays
for NPY, as the reference does.  ``encode_error`` / ``decode`` map
exceptions to :class:`RemoteExecutionError` (the remote type name is kept
in the message, never re-imported).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

TAG_RAW, TAG_JSON, TAG_NPY, TAG_ERR = 0, 1, 2, 3


class WireError(Exception):
    """Malformed reply payload, or a value the codec cannot carry."""


class RemoteExecutionError(Exception):
    """An ifunc raised at the target; re-raised source-side by
    ``Future.result()``.  ``remote_type`` names the original exception;
    ``hop`` (flow chains) names the failing stage as ``ifunc@peer``."""

    def __init__(self, remote_type: str, message: str,
                 hop: str | None = None):
        at = f" at {hop}" if hop else ""
        super().__init__(f"{remote_type}{at}: {message}")
        self.remote_type = remote_type
        self.remote_message = message
        self.hop = hop


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The host copy of a result tensor: one D2H copy for a tensor on the
    card; a dtype without a numpy twin refuses."""
    t = t.detach()
    try:
        return t.cpu().numpy()
    except TypeError as e:
        raise WireError(f"reply tensor dtype {t.dtype} has no numpy dtype "
                        f"(cast it at the target): {e}") from e


def encode(value) -> bytes:
    """Value -> tagged reply payload."""
    if value is None:
        return bytes([TAG_JSON]) + b"null"
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes([TAG_RAW]) + bytes(value)
    if isinstance(value, torch.Tensor):
        value = _tensor_to_numpy(value)
    if isinstance(value, np.ndarray) or hasattr(value, "__array__"):
        arr = np.asarray(value)
        ndim, shape = arr.ndim, arr.shape   # before ascontiguousarray, which
        arr = np.ascontiguousarray(arr)     # promotes 0-d to shape (1,)
        dt = arr.dtype.str.encode()
        head = struct.pack(f"<BI{len(dt)}sB", TAG_NPY, len(dt), dt, ndim)
        packed = struct.pack(f"<{ndim}I", *shape) if ndim else b""
        return head + packed + arr.tobytes()
    try:
        return bytes([TAG_JSON]) + json.dumps(value).encode()
    except (TypeError, ValueError) as e:
        raise WireError(f"unencodable reply value {type(value).__name__}: {e}")


def encode_error(exc, hop: str | None = None) -> bytes:
    """Exception (or message string) -> tagged error payload."""
    if isinstance(exc, BaseException):
        t, m = type(exc).__name__, str(exc)
    else:
        t, m = "RuntimeError", str(exc)
    d = {"type": t, "msg": m}
    if hop:
        d["hop"] = hop
    return bytes([TAG_ERR]) + json.dumps(d).encode()


def decode(payload):
    """Tagged reply payload -> value, or a ``RemoteExecutionError``
    *instance* for ERR payloads (the caller decides to raise it)."""
    if not payload:
        raise WireError("empty reply payload")
    buf = bytes(payload)
    tag, body = buf[0], buf[1:]
    if tag == TAG_RAW:
        return body
    if tag == TAG_JSON:
        return json.loads(body.decode())
    if tag == TAG_NPY:
        (n,) = struct.unpack_from("<I", body, 0)
        dt = body[4:4 + n].decode()
        ndim = body[4 + n]
        off = 5 + n
        shape = struct.unpack_from(f"<{ndim}I", body, off) if ndim else ()
        off += 4 * ndim
        return np.frombuffer(body, dt, offset=off).reshape(shape).copy()
    if tag == TAG_ERR:
        d = json.loads(body.decode())
        return RemoteExecutionError(d.get("type", "Exception"),
                                    d.get("msg", ""), hop=d.get("hop"))
    raise WireError(f"unknown reply tag {tag}")


def pack_chunks(chunks) -> bytes:
    """Frame an ordered list of byte blobs as one payload:
    ``u32 n | (u32 len | bytes) x n``."""
    out = bytearray(struct.pack("<I", len(chunks)))
    for c in chunks:
        b = bytes(c)
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


def unpack_chunks(payload) -> list[bytes]:
    """Inverse of :func:`pack_chunks`."""
    buf = bytes(payload)
    (n,) = struct.unpack_from("<I", buf, 0)
    off, out = 4, []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        out.append(buf[off:off + ln])
        off += ln
    if off != len(buf):
        raise WireError(f"chunk framing trailing bytes ({len(buf) - off})")
    return out


__all__ = ["RemoteExecutionError", "WireError", "decode", "encode",
           "encode_error", "pack_chunks", "unpack_chunks"]
