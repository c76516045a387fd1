"""``bench_hot``, the cached-invocation verb of ``fig5_cached`` (the
paper's §3.4: about 256 KiB of code behind a trivial main), in the port:
its copy in ``src/repro_torch/ifunc_libs/`` is the reference's byte for
byte, the port's registry finds it there with no environment variable
set, and ``chip_smoke.py`` phase 27 (c)'s scenario (one FULL invocation,
then 64 SLIM ones, through a ``Dispatcher`` to a host peer) ends the same
through both packages.  That comparison loads ``ifunc_libs/bench_hot.py``
into both registries: a PYBC code section holds its file's name.
"""

import pathlib

import chip_smoke
import repro_torch.core as PC
from test_torch_transport import PKGS, same_run

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_LIB = REPO / "ifunc_libs" / "bench_hot.py"
PORT_LIB = REPO / "src" / "repro_torch" / "ifunc_libs" / "bench_hot.py"


def test_copy_is_the_reference_byte_for_byte():
    assert PORT_LIB.read_bytes() == REF_LIB.read_bytes()


def test_port_registry_finds_its_copy(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_IFUNC_LIB_DIR", raising=False)
    h = PC.register_ifunc(PC.Context("probe", device="cpu"), "bench_hot")
    assert h.lib.main.__code__.co_filename == str(PORT_LIB)
    args = {}
    h.lib.main(b"x", 1, args)
    assert args == {"count": 1, "code_bytes": 256 << 10}
    assert len(h.lib.code) > 256 << 10


def test_cached_invocation_same_run(lib_dir):
    """One FULL invocation links the code once; the 64 SLIM ones after it
    ship no code: the same stats, bytes and target state through both
    packages."""
    runs = [chip_smoke.cached_invocation(pkg, lib_dir=lib_dir)
            for pkg in PKGS]
    (ref_d, ref_t, ref_first), (port_d, port_t, port_first) = runs
    same_run(ref_d, port_d)
    assert port_first == ref_first
    for d, first in ((ref_d, ref_first), (port_d, port_first)):
        peer = d.peers["hot"]
        assert peer.target_ctx.stats["links"] == 1
        assert peer.stats["slim_sent"] == chip_smoke.CACHED_SLIM
        assert peer.target_args == {"count": 1 + chip_smoke.CACHED_SLIM,
                                    "code_bytes": 256 << 10}
        assert first > 256 << 10
        assert peer.stats["bytes"] - first < chip_smoke.CACHED_SLIM * 1024
    assert len(ref_t) == len(port_t) == 1 + chip_smoke.CACHED_SLIM
