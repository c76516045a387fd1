"""Storage verb: RLE-decompress a record blob *at the CSD* — stage one of
the ETL chain in ``examples/storage_pipeline.py``.

The computational-storage move: the compressed blob never crosses to the
host — it is injected to (or already resident at) the bus-attached
target, decompresses there, and the flow layer forwards the expanded
records straight to the next hop (the DPU filter) via the frame's
continuation descriptor.

Streaming-aware (``IFUNC_STREAM``): on a FLAG_STREAM frame the main runs
once per arrived chunk and expands complete ``(value, count)`` runs as
they land — the 4-byte count header and any partial trailing run carry
into the next chunk, so arbitrary chunk boundaries are safe.  This is
also the decode half of the transport's ``rle`` wire codec (same run
format), so an rle-negotiated stream can feed this verb chunk-for-chunk.

Payload: ``nruns(u32) | (value u32, count u32) x nruns``  (RLE runs)
Result:  the expanded records, one u32 each (``target_args["result"]``).

Like every shipped verb, the main leans only on resident symbols
(``struct``) — it relinks on a target that never imported this module.
"""

IFUNC_STREAM = True


def csd_decompress_main(payload, payload_size, target_args):
    st = target_args.get("stream") if isinstance(target_args, dict) else None
    if st is None:
        (nruns,) = struct.unpack_from("<I", payload, 0)      # noqa: F821
        out = bytearray()
        off = 4
        for _ in range(nruns):
            v, c = struct.unpack_from("<II", payload, off)   # noqa: F821
            out += struct.pack("<I", v) * c                  # noqa: F821
            off += 8
        target_args["result"] = bytes(out)
        return
    state = target_args.setdefault("_csd_state", {})
    s = state.get(st["key"])
    if s is None:
        s = state[st["key"]] = {"buf": b"", "out": bytearray(), "hdr": False}
    buf = s["buf"] + bytes(payload[:payload_size])
    off = 0
    if not s["hdr"] and len(buf) >= 4:
        off = 4                      # the nruns header: the run walk below
        s["hdr"] = True              # consumes the actual run list
    while len(buf) - off >= 8:
        v, c = struct.unpack_from("<II", buf, off)           # noqa: F821
        s["out"] += struct.pack("<I", v) * c                 # noqa: F821
        off += 8
    s["buf"] = buf[off:]
    if st["last"]:
        state.pop(st["key"], None)
        target_args["result"] = bytes(s["out"])


def csd_decompress_payload_get_max_size(source_args, source_args_size):
    return max(len(source_args), 4)


def csd_decompress_payload_init(payload, payload_size, source_args,
                                source_args_size):
    n = len(source_args)
    payload[:n] = bytes(source_args)
    return max(n, 4)
