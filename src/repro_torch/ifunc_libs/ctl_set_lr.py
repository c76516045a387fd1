"""Control verb: hot-update the learning-rate scale without restart."""
import struct


def ctl_set_lr_payload_get_max_size(source_args, source_args_size):
    return 8


def ctl_set_lr_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:8] = source_args[:8]
    return 8


def ctl_set_lr_main(payload, payload_size, target_args):
    (scale,) = struct.unpack("<d", bytes(payload[:8]))
    target_args["lr_scale"] = scale
    target_args["acks"].append(b"lr")
