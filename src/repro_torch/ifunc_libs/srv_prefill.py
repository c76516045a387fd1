"""Serving control verb: hand a prefill peer a routed generation job.

Payload::

    rid(u32) | slot(u32) | max_new(u32)
    | n_codecs(u8) | [len(u8) name ...]      decode peer's advertisement
    | dlen(u8) dpeer_name                    KV stream destination
    | n_tokens(u32) | tokens(i32 x n)        the prompt

The prefill peer's poll loop exposes ``target_args["jobs"]``; the main
appends the decoded job dict and acks with the queue depth.  The codec
advertisement rides along so the prefill worker can negotiate its wire
codec toward ``dpeer`` before the KV slab streams out.
"""


def srv_prefill_main(payload, payload_size, target_args):
    rid, slot, max_new = struct.unpack_from("<III", payload, 0)  # noqa: F821
    off = 12
    n_codecs = payload[off]
    off += 1
    codecs = []
    for _ in range(n_codecs):
        ln = payload[off]
        off += 1
        codecs.append(bytes(payload[off:off + ln]).decode("ascii"))
        off += ln
    dlen = payload[off]
    off += 1
    dpeer = bytes(payload[off:off + dlen]).decode("ascii")
    off += dlen
    n = struct.unpack_from("<I", payload, off)[0]               # noqa: F821
    off += 4
    prompt = list(struct.unpack_from(f"<{n}i", payload, off))   # noqa: F821
    jobs = target_args.get("jobs")
    if jobs is None:
        jobs = target_args["jobs"] = []
    jobs.append({"rid": rid, "slot": slot, "max_new": max_new,
                 "dpeer": dpeer, "codecs": codecs, "prompt": prompt})
    target_args["result"] = {"rid": rid, "accepted": True,
                             "depth": len(jobs)}


def srv_prefill_payload_get_max_size(source_args, source_args_size):
    base = 12 + 1 + sum(1 + len(c) for c in source_args["codecs"])
    base += 1 + len(source_args["dpeer"])
    return base + 4 + 4 * len(source_args["prompt"])


def srv_prefill_payload_init(payload, payload_size, source_args,
                             source_args_size):
    import struct

    import numpy as np

    struct.pack_into("<III", payload, 0, source_args["rid"],
                     source_args["slot"], source_args["max_new"])
    off = 12
    codecs = list(source_args["codecs"])
    payload[off] = len(codecs)
    off += 1
    for c in codecs:
        raw = c.encode("ascii")
        payload[off] = len(raw)
        off += 1
        payload[off:off + len(raw)] = raw
        off += len(raw)
    draw = source_args["dpeer"].encode("ascii")
    payload[off] = len(draw)
    off += 1
    payload[off:off + len(draw)] = draw
    off += len(draw)
    toks = np.ascontiguousarray(np.asarray(source_args["prompt"], np.int32))
    struct.pack_into("<I", payload, off, len(toks))
    off += 4
    raw = toks.tobytes()
    payload[off:off + len(raw)] = raw
    return off + len(raw)
