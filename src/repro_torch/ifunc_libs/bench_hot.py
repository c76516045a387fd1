"""Cached-invocation benchmark ifunc (fig5_cached): a deliberately *heavy*
code section behind a trivial main.

``BLOB`` is inlined into the shipped code section as a module constant
(the serializer's ``.rodata``), so every FULL frame re-injects ~256 KiB of
code while a SLIM frame ships only the 84-byte header + payload.  That is
the paper's §3.4 scenario: big ifunc bodies whose injection cost must be
paid once, not per invocation.
"""

BLOB = b"\xa5\x5a\xc3\x3c" * (64 << 10)     # 256 KiB of .rodata


def bench_hot_payload_get_max_size(source_args, source_args_size):
    return source_args_size


def bench_hot_payload_init(payload, payload_size, source_args, source_args_size):
    payload[:source_args_size] = source_args[:source_args_size]
    return source_args_size


def bench_hot_main(payload, payload_size, target_args):
    target_args["count"] = target_args.get("count", 0) + 1
    target_args["code_bytes"] = len(BLOB)
