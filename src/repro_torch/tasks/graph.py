"""Source-side helpers for the sharded-graph workload: the CSR shard
codec and the local relax mirror of ``ifunc_libs/graph_relax.py``.

Shard layout (little-endian) — indexed by source vertex so one relax
round reads only the frontier's edge runs (O(frontier degree)), while a
*fetch* of the shard always moves every byte (O(edges)).  That asymmetry
is the whole migrate-vs-fetch trade the placement engine prices:

    base(u32) | nv(u32) | offsets[(nv+1) x u32] | (dst u32, w f32) x ne

``offsets[i]..offsets[i+1]`` bound the out-edges of vertex ``base + i``.

The shipped ifunc main (``graph_relax_main`` in
``repro_torch/ifunc_libs/graph_relax.py``) inlines the same walk —
shipped code cannot import this module; keeping the two in lockstep is
what ``tests/test_torch_graph.py::test_graph_relax_future_roundtrip``
checks.  Standard library only: the packed bytes are the reference's
(``repro.tasks.graph``) for the same edges.
"""

from __future__ import annotations

import struct


def pack_csr_shard(base: int, nv: int, edges) -> bytes:
    """``edges``: iterable of (src, dst, w) with src in [base, base+nv)."""
    adj: list[list[tuple[int, float]]] = [[] for _ in range(nv)]
    for u, v, w in edges:
        if not base <= u < base + nv:
            raise ValueError(f"src {u} outside shard [{base}, {base + nv})")
        adj[u - base].append((v, float(w)))
    offsets = [0]
    flat: list[tuple[int, float]] = []
    for lst in adj:
        flat.extend(lst)
        offsets.append(len(flat))
    out = bytearray(struct.pack("<II", base, nv))
    out += struct.pack(f"<{nv + 1}I", *offsets)
    for v, w in flat:
        out += struct.pack("<If", v, w)
    return bytes(out)


def local_relax(shard: bytes, frontier) -> dict[int, float]:
    """Relax the frontier against one CSR shard; returns the best candidate
    distance per touched destination (the ifunc reply, decoded form)."""
    base, nv = struct.unpack_from("<II", shard, 0)
    edges_off = 8 + 4 * (nv + 1)
    best: dict[int, float] = {}
    for v, d in frontier:
        if not base <= v < base + nv:
            continue
        o0, o1 = struct.unpack_from("<II", shard, 8 + 4 * (v - base))
        for k in range(o0, o1):
            dst, w = struct.unpack_from("<If", shard, edges_off + 8 * k)
            cand = d + w
            if dst not in best or cand < best[dst]:
                best[dst] = cand
    return best


def decode_updates(reply: bytes) -> dict[int, float]:
    """Unpack a graph_relax reply: ``nu(u32) | (vid u32, dist f32) x nu``."""
    (n,) = struct.unpack_from("<I", reply, 0)
    return {v: d for v, d in struct.iter_unpack("<If", reply[4:4 + 8 * n])}


__all__ = ["decode_updates", "local_relax", "pack_csr_shard"]
