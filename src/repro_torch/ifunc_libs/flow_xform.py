"""Flow verb: byte-reversing relay — the ``fig_flow`` benchmark's stage.

A deliberately cheap, verifiable transform (result = payload reversed) so
the benchmark measures the *plumbing* difference between an N-stage
continuation chain and N host-coordinated round-trips, not the stages'
compute.  Chaining it N times returns the original bytes for even N.

Payload: raw bytes.  Result: the bytes reversed (``target_args["result"]``).
"""


def flow_xform_main(payload, payload_size, target_args):
    target_args["result"] = bytes(payload[:payload_size])[::-1]


def flow_xform_payload_get_max_size(source_args, source_args_size):
    return max(len(source_args), 1)


def flow_xform_payload_init(payload, payload_size, source_args,
                            source_args_size):
    data = bytes(source_args)
    payload[:len(data)] = data
    return max(len(data), 1)
