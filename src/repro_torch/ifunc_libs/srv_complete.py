"""Serving control verb: report a finished sequence back to the router.

Payload: ``rid(u32) | wlen(u8) worker_name | n(u32) | tokens(i32 x n)``.
Sent by a decode peer when a sequence's token budget is exhausted — the
*decode-side completion path*: a request is done when this frame lands
in the router's ``target_args["completions"]``, never at admission.
"""


def srv_complete_main(payload, payload_size, target_args):
    rid = struct.unpack_from("<I", payload, 0)[0]       # noqa: F821
    wlen = payload[4]
    off = 5
    worker = bytes(payload[off:off + wlen]).decode("ascii")
    off += wlen
    n = struct.unpack_from("<I", payload, off)[0]       # noqa: F821
    off += 4
    toks = list(struct.unpack_from(f"<{n}i", payload, off))  # noqa: F821
    comps = target_args.get("completions")
    if comps is None:
        comps = target_args["completions"] = []
    comps.append({"rid": rid, "worker": worker, "tokens": toks})
    target_args["result"] = {"rid": rid, "ok": True}


def srv_complete_payload_get_max_size(source_args, source_args_size):
    return 9 + len(source_args["worker"]) + 4 * len(source_args["tokens"])


def srv_complete_payload_init(payload, payload_size, source_args,
                              source_args_size):
    import struct

    import numpy as np

    struct.pack_into("<I", payload, 0, source_args["rid"])
    raw = source_args["worker"].encode("ascii")
    payload[4] = len(raw)
    off = 5
    payload[off:off + len(raw)] = raw
    off += len(raw)
    toks = np.ascontiguousarray(np.asarray(source_args["tokens"], np.int32))
    struct.pack_into("<I", payload, off, len(toks))
    off += 4
    traw = toks.tobytes()
    payload[off:off + len(traw)] = traw
    return off + len(traw)
