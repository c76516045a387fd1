"""Flow verb: integer-sum reduce at a gather rendezvous.

A gather ifunc has a two-sided contract:

* ``payload_init`` encodes ONE branch's contribution (here: the branch
  result as a signed 64-bit int) — this is what each branch frame
  carries to the gather peer;
* ``main`` runs ONCE, on the chunk-framed collection of all ``expect``
  contributions (``u32 k | (u32 len | contribution) x k`` — the
  ``tasks.wire.pack_chunks`` layout), after the rendezvous fills.

Result: the sum of the branch ints (``target_args["result"]``).
"""


def flow_reduce_main(payload, payload_size, target_args):
    (k,) = struct.unpack_from("<I", payload, 0)          # noqa: F821
    off = 4
    total = 0
    for _ in range(k):
        (ln,) = struct.unpack_from("<I", payload, off)   # noqa: F821
        off += 4
        if ln != 8:
            raise ValueError("flow_reduce chunk must be one <q int")
        (v,) = struct.unpack_from("<q", payload, off)    # noqa: F821
        off += ln
        total += v
    target_args["result"] = total


def flow_reduce_payload_get_max_size(source_args, source_args_size):
    return 8


def flow_reduce_payload_init(payload, payload_size, source_args,
                             source_args_size):
    import struct

    struct.pack_into("<q", payload, 0, int(source_args))
    return 8
