"""Benchmark ifunc (paper §4.1): bumps a counter on the target."""

def counter_bump_payload_get_max_size(source_args, source_args_size):
    return source_args_size


def counter_bump_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:source_args_size] = source_args[:source_args_size]
    return source_args_size


def counter_bump_main(payload, payload_size, target_args):
    target_args["count"] = target_args.get("count", 0) + 1
    target_args["last_bytes"] = payload_size
