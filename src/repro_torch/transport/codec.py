"""Per-peer wire codecs for the streamed large-payload path (frame v2.5).

A codec transforms chunk bytes on the wire: the source encodes each chunk
as it packs the chunk header, the target decodes as it consumes.
Negotiation is per peer (``Dispatcher.add_peer(codec=...)``): both ends
commit to one codec id that travels in the stream descriptor, and every
chunk header records the codec *actually used* — a chunk that doesn't
shrink ships ``raw`` regardless of the negotiation, so the worst case
costs one failed encode, never an inflated wire chunk.

The codecs are numpy only, byte for byte the reference's
(``repro.transport.codec``):

* ``raw``    (id 0) — identity; the universal fallback.
* ``rle``    (id 1) — u32 run-length encoding (``nruns u32 | (value,
  count) x nruns``), the ``csd_decompress`` ifunc's format.  Lossless;
  applies to 4-byte-aligned chunks.
* ``quant8`` (id 2) — per-chunk int8 quantization of f32 data
  (``scale f32 | int8 x n``), the error-feedback int8 gradient scheme's
  clip and round without the error carry (the transport is stateless per
  chunk).  Lossy by design: about 4x fewer wire bytes; a value comes back
  within half a quantization step (``max|x| / 254``) of the original, up
  to the f32 rounding of the scale and the product.
"""

from __future__ import annotations

import struct

import numpy as np

RAW = 0
RLE = 1
QUANT8 = 2

_F32 = struct.Struct("<f")


class CodecError(Exception):
    """Decode failure — surfaces as a rejected stream, not a crash."""


# ---------------------------------------------------------------------------
# int8 quantization helpers (the error-feedback int8 scheme's clip/round,
# without the error carry)


def quantize8_np(a: np.ndarray) -> tuple[np.ndarray, float]:
    """f32 array -> (int8 array, scale) with the EF-int8 clip/round rule."""
    a = np.asarray(a, np.float32)
    scale = float(max(np.max(np.abs(a), initial=0.0), 1e-12) / 127.0)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize8_np(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


# ---------------------------------------------------------------------------
# codec implementations


class Codec:
    """One wire codec.  ``encode`` returns the coded bytes or ``None`` when
    the codec doesn't apply / doesn't shrink (the chunk ships raw);
    ``decode`` must return exactly ``raw_len`` bytes or raise CodecError."""

    id: int = RAW
    name: str = "raw"
    #: a lossy codec does not restore chunk bytes bit-exact.  The stream
    #: sender ships chunk 0 RAW under a lossy codec: streamed payloads
    #: commonly open with a structured prefix (magic and routing fields an
    #: execute-on-arrival ifunc peeks at), and that prefix must survive
    #: the wire exactly.
    lossy: bool = False

    def encode(self, data) -> bytes | None:
        return None                      # raw never re-encodes

    def decode(self, data, raw_len: int) -> bytes:
        if len(data) != raw_len:
            raise CodecError(f"raw chunk length {len(data)} != {raw_len}")
        return bytes(data)


class RleCodec(Codec):
    id = RLE
    name = "rle"

    def encode(self, data) -> bytes | None:
        if len(data) % 4 or len(data) == 0:
            return None                  # u32 runs need 4-byte alignment
        a = np.frombuffer(data, "<u4")
        change = np.flatnonzero(np.diff(a)) + 1
        starts = np.concatenate(([0], change))
        counts = np.diff(np.concatenate((starts, [a.size])))
        out = np.empty(1 + 2 * starts.size, "<u4")
        out[0] = starts.size
        out[1::2] = a[starts]
        out[2::2] = counts
        coded = out.tobytes()
        return coded if len(coded) < len(data) else None

    def decode(self, data, raw_len: int) -> bytes:
        if len(data) < 4 or len(data) % 4:
            raise CodecError("rle chunk not u32-aligned")
        a = np.frombuffer(data, "<u4")
        nruns = int(a[0])
        if a.size != 1 + 2 * nruns:
            raise CodecError(f"rle run table truncated ({a.size - 1} words "
                             f"for {nruns} runs)")
        out = np.repeat(a[1::2], a[2::2]).astype("<u4").tobytes()
        if len(out) != raw_len:
            raise CodecError(f"rle expanded to {len(out)}B, expected "
                             f"{raw_len}B")
        return out


class Quant8Codec(Codec):
    id = QUANT8
    name = "quant8"
    lossy = True

    def encode(self, data) -> bytes | None:
        if len(data) % 4 or len(data) < 8:
            return None
        q, scale = quantize8_np(np.frombuffer(data, "<f4"))
        coded = _F32.pack(scale) + q.tobytes()
        return coded if len(coded) < len(data) else None

    def decode(self, data, raw_len: int) -> bytes:
        if len(data) < 4 or (len(data) - 4) * 4 != raw_len:
            raise CodecError(f"quant8 chunk {len(data)}B inconsistent with "
                             f"raw {raw_len}B")
        (scale,) = _F32.unpack_from(data, 0)
        q = np.frombuffer(data, np.int8, offset=4)
        return dequantize8_np(q, scale).astype("<f4").tobytes()


CODECS: dict[int, Codec] = {c.id: c for c in (Codec(), RleCodec(),
                                              Quant8Codec())}
_BY_NAME = {c.name: c for c in CODECS.values()}


def get_codec(which) -> Codec:
    """Resolve a codec by id, name, or instance (``None`` -> raw)."""
    if which is None:
        return CODECS[RAW]
    if isinstance(which, Codec):
        return which
    if isinstance(which, str):
        c = _BY_NAME.get(which)
    else:
        c = CODECS.get(which)
    if c is None:
        raise CodecError(f"unknown codec {which!r}")
    return c


__all__ = ["Codec", "CodecError", "CODECS", "QUANT8", "Quant8Codec", "RAW",
           "RLE", "RleCodec", "dequantize8_np", "get_codec", "quantize8_np"]
