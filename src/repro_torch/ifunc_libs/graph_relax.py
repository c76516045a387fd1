"""Graph verb: one delta-stepping-style relax round over one CSR shard.

The paper's semantic-graph-analysis scenario, migrate-code-to-data form:
the *edges stay put* (resident at the owning peer as
``target_args["shards"][sid]`` in the CSR layout of
``repro_torch.tasks.graph`` — ``base | nv | offsets | (dst, w) runs``)
and the *frontier travels* — the payload carries the shard id plus the
(vertex, tentative-distance) pairs that changed last round.  Because the
shard is indexed by source vertex, the relax touches only the frontier's
edge runs; a *fetch* of the same shard moves every byte — the asymmetry
the placement engine's cost model prices.

Payload:  ``sid(u32) | nf(u32) | (vid u32, dist f32) x nf``
Reply:    ``nu(u32) | (vid u32, dist f32) x nu``   (via target_args["result"])

Like every shipped verb, the main leans only on resident symbols
(``struct``) — it relinks on a target that never imported this module.
An unknown shard id raises, which travels back as an exception future.
"""


def graph_relax_main(payload, payload_size, target_args):
    sid, nf = struct.unpack_from("<II", payload, 0)          # noqa: F821
    shards = target_args.get("shards") or {}
    if sid not in shards:
        raise ValueError("shard " + repr(sid) + " not resident here")
    shard = shards[sid]
    base, nv = struct.unpack_from("<II", shard, 0)           # noqa: F821
    edges_off = 8 + 4 * (nv + 1)
    best = {}
    for i in range(nf):
        v, d = struct.unpack_from("<If", payload, 8 + 8 * i)  # noqa: F821
        if not base <= v < base + nv:
            continue
        o0, o1 = struct.unpack_from("<II", shard, 8 + 4 * (v - base))  # noqa: F821
        for k in range(o0, o1):
            dst, w = struct.unpack_from("<If", shard, edges_off + 8 * k)  # noqa: F821
            cand = d + w
            if dst not in best or cand < best[dst]:
                best[dst] = cand
    out = bytearray(struct.pack("<I", len(best)))            # noqa: F821
    for v in sorted(best):
        out += struct.pack("<If", v, best[v])                # noqa: F821
    target_args["result"] = bytes(out)


def graph_relax_payload_get_max_size(source_args, source_args_size):
    return 8 + 8 * len(source_args["frontier"])


def graph_relax_payload_init(payload, payload_size, source_args,
                             source_args_size):
    import struct

    frontier = source_args["frontier"]
    struct.pack_into("<II", payload, 0, source_args["sid"], len(frontier))
    for i, (v, d) in enumerate(frontier):
        struct.pack_into("<If", payload, 8 + 8 * i, v, d)
    return 8 + 8 * len(frontier)
