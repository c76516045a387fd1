"""Serving data verb: land a migrating KV-cache slab in a decode peer's
cache slot, chunk by chunk, as the stream arrives.

``IFUNC_STREAM``: the transport calls the main once per arriving chunk
with ``target_args["stream"]`` describing the chunk's place in the
payload — each chunk is written straight into the reserved slot's
landing slab at its final offset.  No assembly buffer ever exists on the
decode peer; the slab IS the destination (sPIN-style execute-on-arrival,
PR 7).  The slab's first 12 bytes carry ``magic | rid | slot`` (kv.py),
so the first chunk routes the whole stream to its landing slab and later
chunks follow via per-stream rx state.

A plain (store-and-forward) frame is also accepted — the whole slab in
one call — but counted in ``target_args["counters"]["buffered_installs"]``:
the serving fabric asserts this stays ZERO, i.e. every migration
streamed.

target_args (shared ingress view, one per mailbox):
  slabs        {slot: bytearray}  preallocated landing slabs
  kv_arrivals  [slot, ...]        completed installs, consumed by pump()
  counters     {"buffered_installs": n}
Result (the stream's corr reply -> the prefill peer's install-ack
future): ``{rid, slot, streamed, bytes}``.
"""

IFUNC_STREAM = True


def kv_install_main(payload, payload_size, target_args):
    st = target_args.get("stream") if isinstance(target_args, dict) else None
    slabs = target_args["slabs"]
    if st is None:
        # store-and-forward fallback: whole slab in one frame.  Works, but
        # it means the payload was materialized twice — counted so the
        # fabric can assert the streamed path carried everything.
        rid, slot = struct.unpack_from("<II", payload, 4)  # noqa: F821
        slabs[slot][:payload_size] = payload[:payload_size]
        c = target_args.get("counters")
        if c is None:
            c = target_args["counters"] = {}
        c["buffered_installs"] = c.get("buffered_installs", 0) + 1
        target_args["kv_arrivals"].append(slot)
        target_args["result"] = {"rid": rid, "slot": slot,
                                 "streamed": False, "bytes": payload_size}
        return
    rx = target_args.get("_kv_rx")
    if rx is None:
        rx = target_args["_kv_rx"] = {}
    slot = rx.get(st["key"])
    if slot is None:
        # first chunk: the slab prefix names its landing slot
        slot = struct.unpack_from("<I", payload, 8)[0]   # noqa: F821
        rx[st["key"]] = slot
    off = st["offset"]
    slabs[slot][off:off + payload_size] = payload[:payload_size]
    if st["last"]:
        rx.pop(st["key"], None)
        rid = struct.unpack_from("<I", slabs[slot], 4)[0]  # noqa: F821
        target_args["kv_arrivals"].append(slot)
        target_args["result"] = {"rid": rid, "slot": slot,
                                 "streamed": True, "bytes": st["total_len"]}


def kv_install_payload_get_max_size(source_args, source_args_size):
    return len(source_args)


def kv_install_payload_init(payload, payload_size, source_args,
                            source_args_size):
    data = bytes(source_args)
    payload[:len(data)] = data
    return len(data)
