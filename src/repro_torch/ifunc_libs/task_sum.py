"""Result-returning test verb: sum the payload bytes and reply.

The minimal future-path ifunc: payload is raw bytes, the main puts the sum
in ``target_args["result"]`` (the reply convention) — unless the payload
starts with the poison marker 0xFF, in which case it raises, exercising
the exception-future path end to end.
"""

POISON = 0xFF


def task_sum_main(payload, payload_size, target_args):
    data = bytes(payload[:payload_size])
    if data and data[0] == 255:
        raise ValueError("poisoned payload")
    target_args["result"] = sum(data)


def task_sum_payload_get_max_size(source_args, source_args_size):
    return max(source_args_size, 1)


def task_sum_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:source_args_size] = source_args[:source_args_size]
    return max(source_args_size, 1)
