"""Graph verb, device tier: frontier-expansion counts as a μVM matmul.

The device mesh holds the adjacency tiles (the graph's device-resident
shard: ``A[u, v] = 1`` for edges u->v, bound per mesh shard as external
0 at mailbox-open time — the device GOT).  The payload tile broadcasts
the frontier indicator ``f`` across rows, so the tensor cores compute

    (F @ A)[i, v] = sum_u f[u] * A[u, v]   (every row identical)

— per vertex ``v``, the number of frontier edges entering it: the
frontier-expansion / shard-hotness signal the placement engine routes
relax tasks with.  A device-mesh target runs the shipped program inside
its lane's fused sweep (``ring_sweep_*_kernel``), a host target through
one ``ifunc_vm`` launch: no kernel of its own.
"""

import numpy as np

from repro_torch.core.codegen import assemble

IFUNC_KIND = "uvm"

UVM_PROGRAM = assemble([
    ("loadp", 0),            # r0 <- frontier tile F (indicator in every row)
    ("loade", 1, 0),         # r1 <- external 0 ("A": this shard's adjacency)
    ("matmul", 2, 0, 1),     # expansion counts per column vertex
    ("store", 0, 2),
], symbols=("A",))


def graph_degree_main(payload, payload_size, target_args):
    """Host-side execution (targets normally link the shipped program
    instead of calling this).  Runs where ``target_args["device"]`` says,
    the card by default."""
    from repro_torch.kernels import ops as K

    tiles = np.frombuffer(payload, np.float32).reshape(-1, 128, 128)
    ext = [np.asarray(target_args["externals"]["A"], np.float32)]
    out = K.uvm_execute(UVM_PROGRAM, tiles, ext,
                        device=target_args.get("device", "cuda"))
    target_args["result"] = out
    return out


def graph_degree_payload_get_max_size(source_args, source_args_size):
    return np.asarray(source_args, np.float32).nbytes


def graph_degree_payload_init(payload, payload_size, source_args,
                              source_args_size):
    raw = np.ascontiguousarray(np.asarray(source_args, np.float32)).tobytes()
    payload[:len(raw)] = raw
    return len(raw)
