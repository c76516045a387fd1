"""Control verb: liveness/telemetry probe. Appends an ack with the payload."""

def ctl_probe_payload_get_max_size(source_args, source_args_size):
    return max(source_args_size, 1)


def ctl_probe_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:source_args_size] = source_args[:source_args_size]
    return max(source_args_size, 1)


def ctl_probe_main(payload, payload_size, target_args):
    target_args["acks"].append(bytes(payload[:payload_size]))
