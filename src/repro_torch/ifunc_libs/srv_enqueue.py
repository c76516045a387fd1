"""Serving control verb: enqueue a generation request at the server.

Payload: ``rid(u32) | max_new(u32) | n_tokens(u32) | tokens(i32 x n)``.
The server's poll loop exposes ``target_args["queue"]``; requests appended
here are admitted into the continuous batcher.  Because the codec ships
with the frame, a frontend can evolve the request schema without
redeploying the server (the paper's §3.3 hot-upgrade property).

The main routine leans only on the target's *resident* symbols
(``struct`` — the libc of this world): it travels as code and relinks on
a target that never imported this module.
"""


def srv_enqueue_main(payload, payload_size, target_args):
    rid, max_new, n = struct.unpack_from("<III", payload, 0)  # noqa: F821
    toks = list(struct.unpack_from(f"<{n}i", payload, 12))    # noqa: F821
    q = target_args.get("queue")
    if q is None:
        q = target_args["queue"] = []
    q.append({"rid": rid, "max_new": max_new, "prompt": toks})
    # admission ack: travels back as the reply frame resolving the
    # frontend's submit() future (request/response serving)
    target_args["result"] = {"rid": rid, "queued": True, "depth": len(q)}


def srv_enqueue_payload_get_max_size(source_args, source_args_size):
    return 12 + 4 * len(source_args["prompt"])


def srv_enqueue_payload_init(payload, payload_size, source_args, source_args_size):
    import struct

    import numpy as np

    toks = np.ascontiguousarray(np.asarray(source_args["prompt"], np.int32))
    struct.pack_into("<III", payload, 0, source_args["rid"],
                     source_args["max_new"], len(toks))
    raw = toks.tobytes()
    payload[12:12 + len(raw)] = raw
    return 12 + len(raw)
