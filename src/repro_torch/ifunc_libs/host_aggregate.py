"""Storage verb: aggregate u32 records — the ETL chain's terminal stage.

Receives the filtered records from the DPU hop and reduces them to
summary statistics; with an empty remaining chain, the flow layer packs
this result into the final OK reply to the origin — the only frame the
submitting host ever sees for the whole chain.

Streaming-aware (``IFUNC_STREAM``): on a FLAG_STREAM frame the main runs
once per arrived chunk (``target_args["stream"]`` carries the chunk
coordinates) and folds each chunk into a running accumulator — the
payload is reduced as it lands, never assembled.  Chunk boundaries are
arbitrary byte offsets, so a partial trailing record carries into the
next chunk.

Payload: ``record u32 x n``  (raw bind: the upstream result as-is)
Result:  ``{"count": n, "sum": s, "min": lo, "max": hi}``
"""

IFUNC_STREAM = True


def host_aggregate_main(payload, payload_size, target_args):
    st = target_args.get("stream") if isinstance(target_args, dict) else None
    if st is None:
        n = payload_size // 4
        vals = struct.unpack_from("<%dI" % n, payload, 0)    # noqa: F821
        target_args["result"] = {
            "count": n,
            "sum": sum(vals),
            "min": min(vals) if vals else 0,
            "max": max(vals) if vals else 0,
        }
        return
    state = target_args.setdefault("_agg_state", {})
    acc = state.get(st["key"])
    if acc is None:
        acc = state[st["key"]] = {"count": 0, "sum": 0, "min": None,
                                  "max": None, "tail": b""}
    data = acc["tail"] + bytes(payload[:payload_size])
    n = len(data) // 4
    vals = struct.unpack_from("<%dI" % n, data, 0)           # noqa: F821
    acc["tail"] = data[4 * n:]
    acc["count"] += n
    acc["sum"] += sum(vals)
    if vals:
        lo, hi = min(vals), max(vals)
        acc["min"] = lo if acc["min"] is None else min(acc["min"], lo)
        acc["max"] = hi if acc["max"] is None else max(acc["max"], hi)
    if st["last"]:
        state.pop(st["key"], None)
        target_args["result"] = {
            "count": acc["count"],
            "sum": acc["sum"],
            "min": acc["min"] if acc["min"] is not None else 0,
            "max": acc["max"] if acc["max"] is not None else 0,
        }


def host_aggregate_payload_get_max_size(source_args, source_args_size):
    return max(len(source_args), 1)


def host_aggregate_payload_init(payload, payload_size, source_args,
                                source_args_size):
    data = bytes(source_args)
    payload[:len(data)] = data
    return max(len(data), 1)
