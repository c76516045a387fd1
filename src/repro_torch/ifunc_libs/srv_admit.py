"""Serving control verb: reserve a decode slot for an incoming sequence.

Payload: ``rid(u32) | max_new(u32) | prompt_len(u32)``.  The decode
peer's poll loop exposes its :class:`~repro.serving.workers.DecodeWorker`
as ``target_args["worker"]``; the main asks it to reserve a batcher slot
(the landing address the KV stream will write into) and replies with the
slot plus the peer's *advertised wire codecs* in preference order — the
PR 9 negotiation path: the prefill tier arms its per-peer codec from
this ack instead of a constructor argument, so a decode peer can change
its accepted codecs without redeploying any sender.

``slot < 0`` in the ack means the decode tier refused (full, or the
prompt would not fit the cache window) — the router requeues.
"""


def srv_admit_main(payload, payload_size, target_args):
    rid, max_new, plen = struct.unpack_from("<III", payload, 0)  # noqa: F821
    worker = target_args["worker"]
    slot = worker.reserve(rid, plen, max_new)
    # admission ack -> the router's future: the slot is the stream's
    # landing address; the codec list is the negotiation advertisement
    target_args["result"] = {"rid": rid, "slot": slot,
                             "codecs": list(worker.codecs),
                             "queued": slot >= 0}


def srv_admit_payload_get_max_size(source_args, source_args_size):
    return 12


def srv_admit_payload_init(payload, payload_size, source_args,
                           source_args_size):
    import struct

    struct.pack_into("<III", payload, 0, source_args["rid"],
                     source_args["max_new"], source_args["prompt_len"])
    return 12
