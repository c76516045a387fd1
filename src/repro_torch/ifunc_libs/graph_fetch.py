"""Graph verb: fetch-data-to-host — the migrate-code-to-data inverse.

When the placement engine prices shipping the shard cheaper than queueing
behind a hot owner, the source injects this verb and the shard's packed
edge list comes back as the reply payload (RAW-tagged through the task
wire codec).  The source then runs the relax locally and registers a
local replica with the data directory, so later rounds can go LOCAL for
free.

Payload: ``sid(u32)``.  Reply: the shard's edge bytes.
"""


def graph_fetch_main(payload, payload_size, target_args):
    (sid,) = struct.unpack_from("<I", payload, 0)       # noqa: F821
    shards = target_args.get("shards") or {}
    if sid not in shards:
        raise ValueError("shard " + repr(sid) + " not resident here")
    target_args["result"] = bytes(shards[sid])


def graph_fetch_payload_get_max_size(source_args, source_args_size):
    return 4


def graph_fetch_payload_init(payload, payload_size, source_args,
                             source_args_size):
    import struct

    struct.pack_into("<I", payload, 0, int(source_args["sid"]))
    return 4
