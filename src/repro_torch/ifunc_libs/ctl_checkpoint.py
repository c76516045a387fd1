"""Control verb: trigger an async checkpoint on the worker."""

def ctl_checkpoint_payload_get_max_size(source_args, source_args_size):
    return 8


def ctl_checkpoint_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:8] = int(source_args_size and int.from_bytes(source_args[:8], 'little')).to_bytes(8, 'little')
    return 8


def ctl_checkpoint_main(payload, payload_size, target_args):
    step = int.from_bytes(bytes(payload[:8]), 'little')
    ckpt = target_args.get("checkpoint")
    if ckpt is not None:
        ckpt(step)
    target_args["acks"].append(b"ckpt:%d" % step)
