"""Bench verb: minimal streaming consumer — counts the bytes of each
chunk as it lands (``IFUNC_STREAM``), publishing the running total as the
result on the final chunk.  Exists so the ``fig_stream`` benchmark
measures the *transport's* streamed delivery rate, not the cost of a real
reduction; it also accepts plain (non-stream) frames for the
store-and-forward comparison cells.

Payload: opaque bytes
Result:  total payload bytes observed (int)
"""

IFUNC_STREAM = True


def stream_sink_main(payload, payload_size, target_args):
    st = target_args.get("stream") if isinstance(target_args, dict) else None
    if st is None:
        target_args["result"] = payload_size
        return
    total = target_args.get("_sink", 0) + payload_size
    if st["last"]:
        target_args.pop("_sink", None)
        target_args["result"] = total
    else:
        target_args["_sink"] = total


def stream_sink_payload_get_max_size(source_args, source_args_size):
    return max(len(source_args), 1)


def stream_sink_payload_init(payload, payload_size, source_args,
                             source_args_size):
    data = bytes(source_args)
    payload[:len(data)] = data
    return max(len(data), 1)
