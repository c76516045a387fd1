"""Storage verb: predicate-filter u32 records *on the DPU* — stage two of
the ETL chain in ``examples/storage_pipeline.py``.

Receives the decompressed records forwarded peer-to-peer by the CSD stage
(a ``kw`` bind: ``{"mode": "kw", "key": "data", "static": {"threshold":
T}}``), keeps the records ``>= threshold``, and hands the survivors to
the next hop.  Only the filtered subset continues down the chain — the
bandwidth asymmetry in-network filtering exists for.

Streaming-aware (``IFUNC_STREAM``): on a FLAG_STREAM frame the main runs
once per arrived chunk, reads the threshold from the stream's first four
bytes, and filters records as they land (partial trailing records carry
into the next chunk) — the survivors accumulate and publish as the
result on the final chunk.

Payload: ``threshold(u32) | record u32 x n``
Result:  the surviving records, one u32 each (``target_args["result"]``).
"""

IFUNC_STREAM = True


def dpu_filter_main(payload, payload_size, target_args):
    st = target_args.get("stream") if isinstance(target_args, dict) else None
    if st is None:
        (threshold,) = struct.unpack_from("<I", payload, 0)  # noqa: F821
        n = (payload_size - 4) // 4
        vals = struct.unpack_from("<%dI" % n, payload, 4)    # noqa: F821
        kept = [v for v in vals if v >= threshold]
        target_args["result"] = struct.pack(                 # noqa: F821
            "<%dI" % len(kept), *kept)
        return
    state = target_args.setdefault("_dpu_state", {})
    s = state.get(st["key"])
    if s is None:
        s = state[st["key"]] = {"buf": b"", "thr": None, "out": bytearray()}
    buf = s["buf"] + bytes(payload[:payload_size])
    off = 0
    if s["thr"] is None and len(buf) >= 4:
        (s["thr"],) = struct.unpack_from("<I", buf, 0)       # noqa: F821
        off = 4
    if s["thr"] is not None:
        n = (len(buf) - off) // 4
        vals = struct.unpack_from("<%dI" % n, buf, off)      # noqa: F821
        kept = [v for v in vals if v >= s["thr"]]
        s["out"] += struct.pack("<%dI" % len(kept), *kept)   # noqa: F821
        off += 4 * n
    s["buf"] = buf[off:]
    if st["last"]:
        state.pop(st["key"], None)
        target_args["result"] = bytes(s["out"])


def dpu_filter_payload_get_max_size(source_args, source_args_size):
    return 4 + len(source_args["data"])


def dpu_filter_payload_init(payload, payload_size, source_args,
                            source_args_size):
    import struct

    data = bytes(source_args["data"])
    struct.pack_into("<I", payload, 0, int(source_args["threshold"]))
    payload[4:4 + len(data)] = data
    return 4 + len(data)
