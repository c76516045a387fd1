"""The port's CUDA kernels and its device lane on a card, each held against
its plain PyTorch version on the same inputs.  Every test here is marked
``cuda`` and skips without a card.  The file imports nothing of the JAX
package, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Context, ifunc_msg_create, register_ifunc
from repro_torch.core.codegen import assemble, deserialize_uvm
from repro_torch.kernels.ifunc_vm import ifunc_vm, ifunc_vm_plain
from repro_torch.kernels.ring_poll import (HDR_WORDS, MAGIC, TRAILER,
                                           ring_poll, ring_poll_plain)
from repro_torch.transport import DeviceMeshFabric, Dispatcher, ProgressEngine

T = 128

PROGRAMS = {
    "affine_relu": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1), ("loade", 3, 1),
         ("add", 2, 2, 3), ("relu", 2, 2), ("store", 0, 2)], ("W", "b")),
    "gelu_scale": (
        [("loadp", 0), ("gelu", 1, 0), ("scale", 1, 1, 0, 0.25),
         ("store", 0, 1)], ()),
    "double_matmul": (
        [("loadp", 0), ("loade", 1, 0), ("matmul", 2, 0, 1),
         ("matmul", 3, 2, 1), ("sub", 3, 3, 0), ("store", 0, 3)], ("W",)),
    "fma_chain": (
        [("loadp", 0), ("copy", 1, 0), ("fma", 1, 0, 0), ("tanh", 1, 1),
         ("addi", 1, 1, 0, 0.5), ("store", 0, 1)], ()),
    "loade_past_the_table": (                  # reads ext[min(5, n_ext-1)]
        [("loadp", 0), ("loade", 1, 5), ("mul", 2, 0, 1), ("store", 0, 2)],
        ("W",)),
    "halt_rsqrt_max_matmul_in_place": (
        [("loadp", 0), ("halt",), ("rsqrt", 1, 0), ("max", 2, 0, 1),
         ("exp", 3, 0), ("muli", 3, 3, 0, 0.5), ("zero", 4),
         ("mul", 5, 2, 3), ("matmul", 5, 5, 0), ("store", 0, 5)], ()),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ring(n: int, W: int) -> np.ndarray:
    """A uint32 ring cycling through EMPTY (zeros, and garbage behind magic
    0), READY, INFLIGHT and each kind of BAD: bad magic, bad check word,
    fw = 0xFFFFFFF0 (negative as int32) and fw one word too long."""
    rng = np.random.default_rng(0)
    ring = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    for i in range(n):
        kind = i % 8
        fw = int(rng.integers(0, W - HDR_WORDS))
        hdr = [MAGIC, fw, 3, int(rng.integers(0, 2 ** 32))]
        if kind < 2:                     # all zero, or garbage behind magic 0
            ring[i, :W if kind == 0 else 1] = 0
            continue
        hdr[1] = {6: 0xFFFFFFF0, 7: W - HDR_WORDS}.get(kind, fw)
        chk = hdr[0] ^ hdr[1] ^ hdr[2] ^ hdr[3]
        if kind == 4:
            hdr[0] ^= 0x100
        if kind == 5:
            chk ^= 1
        ring[i, :HDR_WORDS] = hdr + [chk]
        ring[i, HDR_WORDS + fw] = TRAILER if kind == 2 else 0
    return ring


@pytest.mark.cuda
def test_ring_poll_kernel_matches_plain(cuda):
    ring = torch.from_numpy(_ring(512, 4 * T + 6).view(np.int32)).to(cuda)
    before = ring_poll.launches
    got = ring_poll(ring)
    torch.cuda.synchronize()
    assert ring_poll.launches == before + 1
    want = ring_poll_plain(ring)
    assert torch.equal(got, want)
    assert torch.bincount(want.cpu(), minlength=4).tolist() == [128, 64, 64,
                                                                256]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_ifunc_vm_kernel_matches_plain(cuda, name):
    instrs, symbols = PROGRAMS[name]
    rng = np.random.default_rng(0)
    pay = torch.from_numpy(rng.standard_normal((16, T, T)).astype(
        np.float32)).to(cuda)
    ext = torch.from_numpy((rng.standard_normal(
        (4, max(len(symbols), 1), T, T)) * 0.1).astype(np.float32)).to(cuda)
    prog = assemble(instrs, symbols)
    before = ifunc_vm.launches
    out = ifunc_vm(prog, pay, ext)
    torch.cuda.synchronize()
    assert ifunc_vm.launches == before + 1
    torch.testing.assert_close(out, ifunc_vm_plain(prog, pay, ext),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_device_lane_on_the_card_matches_the_cpu(cuda):
    """Dispatcher -> DeviceMeshFabric(8 shards, shift 1) on the card and on
    the CPU, the same frames: equal statuses, results within 1e-5."""
    handle = register_ifunc(Context("src"), "uvm_affine")
    rng = np.random.default_rng(1)
    W = (rng.standard_normal((8, 1, T, T)) * 0.05).astype(np.float32)
    pays = rng.standard_normal((16, 2, T, T)).astype(np.float32)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        d = Dispatcher(handle.ctx, ProgressEngine(inflight_window="trailer"))
        d.add_peer("mesh", DeviceMeshFabric(8, shift=1, device=dev), None,
                   n_slots=2, slot_size=(2 * T * T + 6) * 4,
                   prog=deserialize_uvm(handle.lib.code), n_tiles=2,
                   externals=W)
        before = (ring_poll.launches, ifunc_vm.launches)
        for p in pays:
            assert d.send("mesh", ifunc_msg_create(handle, p))
        assert d.drain() == len(pays)
        if dev.type == "cuda":
            assert ring_poll.launches > before[0]
            assert ifunc_vm.launches > before[1]
        runs[dev.type] = (d.per_peer_stats()["mesh"],
                          d.peers["mesh"].target_args["results"])
    assert runs["cuda"][0] == runs["cpu"][0]
    for g, w in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
