"""Paper §3.2 usage example analogue: the target 'database' doesn't know the
compression; the ifunc ships both the codec and the insert logic.
(run-length coding stands in for paq8px)."""


def _rle_encode(data):
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 255 and data[j] == data[i]:
            j += 1
        out += bytes((j - i, data[i]))
        i = j
    return bytes(out)


def _rle_decode(data):
    out = bytearray()
    for k in range(0, len(data), 2):
        out += bytes([data[k + 1]]) * data[k]
    return bytes(out)


def rle_insert_payload_get_max_size(source_args, source_args_size):
    return 2 * source_args_size + 2  # worst case RLE


def rle_insert_payload_init(payload, payload_size, source_args, source_args_size):
    enc = _rle_encode(bytes(source_args))
    payload[:len(enc)] = enc
    return len(enc)


def rle_insert_main(payload, payload_size, target_args):
    record = _rle_decode(bytes(payload[:payload_size]))
    target_args["db"].append(record)
