"""Graph verb: count edges above a weight threshold in one resident CSR
shard — the scatter/gather analytics query of
``examples/storage_pipeline.py``.

Scatter form: every shard owner gets this verb with a per-branch static
bind (``{"mode": "static", "static": {"sid": k, "wmin": w}}``); each
branch's count then rendezvouses at the gather peer, where
``flow_reduce`` sums the partials — partial aggregation at the gather
peer, not the host.

Payload: ``sid(u32) | wmin(f32)``
Result:  the edge count (int, ``target_args["result"]``).
"""


def graph_count_main(payload, payload_size, target_args):
    sid, wmin = struct.unpack_from("<If", payload, 0)    # noqa: F821
    shards = target_args.get("shards") or {}
    if sid not in shards:
        raise ValueError("shard " + repr(sid) + " not resident here")
    shard = shards[sid]
    base, nv = struct.unpack_from("<II", shard, 0)       # noqa: F821
    edges_off = 8 + 4 * (nv + 1)
    n_edges = (len(shard) - edges_off) // 8
    count = 0
    for k in range(n_edges):
        _, w = struct.unpack_from("<If", shard,          # noqa: F821
                                  edges_off + 8 * k)
        if w >= wmin:
            count += 1
    target_args["result"] = count


def graph_count_payload_get_max_size(source_args, source_args_size):
    return 8


def graph_count_payload_init(payload, payload_size, source_args,
                             source_args_size):
    import struct

    struct.pack_into("<If", payload, 0, int(source_args["sid"]),
                     float(source_args["wmin"]))
    return 8
