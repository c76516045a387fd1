"""Control-ring ifunc for the elastic fleet (see runtime/elastic.py).

Two payload modes share one library (one digest, one link):

* mode 0 — **beat**: a monotone sequence number plus the sender's worker
  id.  Executing it is the proof of liveness: the ElasticController
  sweeps each member's control mailbox, and only a live member's sweep
  advances ``target_args["hb"]`` — the controller then folds the beat
  into ``FleetState.heartbeat``.
* mode 1 — **manifest**: the source peer's view of the target's warm
  link-cache (name, digest) pairs, sent ONCE at re-admission so a
  restarted peer relinks from its local libraries instead of
  NACK-storming every SLIM frame.  Entries are handed to the
  ``target_args["relink"]`` callable the controller installs on the
  control ring (the restore must insert under the *manifest* digest —
  see ElasticController.readmit); without one they are stashed under
  ``target_args["hb"]["manifest"]``.

Wire layout (little-endian):

    mode 0:  u8 mode | u64 seq | u8 name_len | name bytes
    mode 1:  u8 mode | u16 count | count x (u8 name_len | name | 16B digest)
"""


def hb_beat_payload_get_max_size(source_args, source_args_size):
    if "manifest" in source_args:
        return 3 + sum(1 + len(n.encode()) + 16
                       for n, _ in source_args["manifest"])
    return 1 + 8 + 1 + len(source_args["worker"].encode())


def hb_beat_payload_init(payload, payload_size, source_args, source_args_size):
    if "manifest" in source_args:
        entries = source_args["manifest"]
        payload[0] = 1
        payload[1:3] = len(entries).to_bytes(2, "little")
        off = 3
        for name, digest in entries:
            nb = name.encode()
            payload[off] = len(nb)
            payload[off + 1:off + 1 + len(nb)] = nb
            off += 1 + len(nb)
            payload[off:off + 16] = digest
            off += 16
        return off
    nb = source_args["worker"].encode()
    payload[0] = 0
    payload[1:9] = int(source_args["seq"]).to_bytes(8, "little")
    payload[9] = len(nb)
    payload[10:10 + len(nb)] = nb
    return 10 + len(nb)


def hb_beat_main(payload, payload_size, target_args):
    mv = memoryview(payload)[:payload_size]
    if mv[0] == 0:
        nlen = mv[9]
        hb = target_args.get("hb")
        if hb is None:
            hb = target_args["hb"] = {}
        hb["seq"] = int.from_bytes(bytes(mv[1:9]), "little")
        hb["worker"] = bytes(mv[10:10 + nlen]).decode()
        hb["beats"] = hb.get("beats", 0) + 1
        return
    count = int.from_bytes(bytes(mv[1:3]), "little")
    off = 3
    entries = []
    for _ in range(count):
        nlen = mv[off]
        name = bytes(mv[off + 1:off + 1 + nlen]).decode()
        off += 1 + nlen
        digest = bytes(mv[off:off + 16])
        off += 16
        entries.append((name, digest))
    relink = target_args.get("relink")
    if relink is not None:
        for name, digest in entries:
            relink(name, digest)
    else:
        hb = target_args.get("hb")
        if hb is None:
            hb = target_args["hb"] = {}
        hb["manifest"] = entries
