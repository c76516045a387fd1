"""KV-cache slab wire format: one prefilled sequence's cache as a single
contiguous byte payload, streamable chunk-by-chunk into a decode peer.

The slab is what crosses the prefill->decode wire as a ``FLAG_STREAM``
payload (chunked pipelined puts).  Layout::

    u32 magic 'KVS1' | u32 rid | u32 slot | u32 pos0 | u32 first_tok
    u32 n_entries | u32 header_len | per entry: u16 name_len | name | u8 ndim | u32*ndim
    zero pad to 4-byte boundary
    f32 little-endian entry data, concatenated in header order

Design points:

* **All-f32 body.**  Cache tensors ship as float32 regardless of the
  model's act dtype (bf16->f32 is exact, f32->bf16 on install restores
  the original bits), so the whole body is a homogeneous f32 region the
  wire codecs understand — ``quant8`` can quantize any chunk of it
  without tripping over embedded integer metadata.
* **No ``slot_pos`` on the wire.**  A prefill's slot occupancy is fully
  determined by ``pos0`` (positions ``0..pos0-1`` sit in ring slots
  ``0..pos0-1``); the decode side reconstructs it exactly.  Shipping it
  would embed int32s in the f32 body and break lossy-codec negotiation.
* **Peekable prefix.**  ``rid`` and ``slot`` live at fixed offsets 4 and
  8, so the streaming ``kv_install`` ifunc routes the *first chunk* to
  the right landing slab without waiting for reassembly.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAGIC = 0x4B565331          # 'KVS1'
_FIXED = struct.Struct("<IIIIIII")  # magic, rid, slot, pos0, first, n_entries, header_len


def _entry_names(shapes: dict) -> list[str]:
    """Deterministic wire order: sorted keys, ``slot_pos`` entries elided
    (reconstructed from pos0 at install time)."""
    return sorted(n for n in shapes if not n.endswith("slot_pos"))


def _host_f32(x) -> np.ndarray:
    """One entry as a contiguous f32 host array.  A tensor of any type on
    any device widens to f32 on its own device and crosses to the host in
    one copy (numpy has no bf16, so ``np.asarray`` of a bf16 tensor would
    fail; bf16 -> f32 is exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x).astype(np.float32, copy=False))


def pack_kv(entries: dict, rid: int, slot: int, pos0: int,
            first_token: int = 0) -> bytes:
    """Serialize one sequence's cache entries (f32-castable arrays or
    tensors of any type on any device; ``slot_pos`` keys ignored) into a
    slab."""
    names = _entry_names(entries)
    arrs = [_host_f32(entries[n]) for n in names]
    head = bytearray(_FIXED.size)
    for n, a in zip(names, arrs):
        nb = n.encode()
        head += struct.pack("<H", len(nb)) + nb + struct.pack("<B", a.ndim)
        head += struct.pack(f"<{a.ndim}I", *a.shape)
    pad = (-len(head)) % 4
    head += b"\x00" * pad
    _FIXED.pack_into(head, 0, MAGIC, rid, slot, pos0, first_token,
                     len(names), len(head))
    return bytes(head) + b"".join(a.tobytes() for a in arrs)


def peek_kv(buf) -> tuple[int, int]:
    """(rid, slot) from the first 12 bytes — all the streaming installer
    needs to pick a landing slab before the rest of the slab arrives."""
    magic, rid, slot = struct.unpack_from("<III", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad KV slab magic {magic:#x}")
    return rid, slot


def unpack_kv(buf) -> dict:
    """Deserialize a slab -> ``{"rid", "slot", "pos0", "entries"}`` with
    f32 ndarray views into ``buf`` (zero-copy; cast on install)."""
    buf = memoryview(buf)
    (magic, rid, slot, pos0, first_token, n_entries,
     header_len) = _FIXED.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad KV slab magic {magic:#x}")
    off = _FIXED.size
    metas = []
    for _ in range(n_entries):
        (name_len,) = struct.unpack_from("<H", buf, off)
        off += 2
        name = bytes(buf[off:off + name_len]).decode()
        off += name_len
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
        off += 4 * ndim
        metas.append((name, shape))
    off = header_len
    entries = {}
    for name, shape in metas:
        count = int(np.prod(shape)) if shape else 1
        entries[name] = np.frombuffer(buf, np.float32, count, off).reshape(shape)
        off += 4 * count
    return {"rid": rid, "slot": slot, "pos0": pos0,
            "first_token": first_token, "entries": entries}


def slab_bytes(shapes: dict) -> int:
    """Exact packed size for a cache with the given ``{name: shaped}``
    layout (``TensorSpec``s, tensors or arrays: only ``.shape`` is read) —
    the landing-slab
    preallocation bound when computed at the full cache width."""
    names = _entry_names(shapes)
    n = _FIXED.size
    for name in names:
        shp = tuple(shapes[name].shape)
        n += 2 + len(name.encode()) + 1 + 4 * len(shp)
    n += (-n) % 4
    for name in names:
        n += 4 * int(np.prod(shapes[name].shape))
    return n


__all__ = ["MAGIC", "pack_kv", "peek_kv", "unpack_kv", "slab_bytes"]
