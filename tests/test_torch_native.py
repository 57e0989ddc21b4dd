"""The port's native runtime (tensorforth_tpu_torch/runtime/native.py)
against the JAX package's, on the CPU: the TLSF accounting of
csrc/t4alloc, the native inner interpreter of csrc/t4core against the
port's Python loop and against the JAX package's REPL, and `mstat`'s
lines.  The port builds csrc/ into build/torch_native/ on first use (g++).
"""
import ctypes
import os
import re

import pytest

from tests.test_torch_repl import (  # noqa: F401  (fixtures)
    ROOT, run_lines, script_lines, t4p)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _alloc():
    from tensorforth_tpu_torch.runtime.native import get_alloc
    lib = get_alloc()
    assert lib is not None, "libt4alloc did not build"
    return lib


def test_libraries_build_into_the_ports_own_directory():
    """the port loads csrc/ built into build/torch_native/, not the JAX
    package's build/lib*.so (whose TLSF state is another one)"""
    from tensorforth_tpu_torch.runtime import native
    want = os.path.realpath(os.path.join(ROOT, "build", "torch_native"))
    for get in (native.get_core, native.get_alloc, native.get_io,
                native.get_tb):
        lib = get()
        assert lib is not None, get.__name__
        assert os.path.dirname(os.path.realpath(lib._name)) == want
    from tensorforth_tpu.runtime.native import get_alloc as jax_alloc
    assert jax_alloc() is not native.get_alloc()


def test_tlsf_alloc_free_coalesce():
    lib = _alloc()
    lib.t4_tlsf_init(1 << 20)
    offs = [lib.t4_tlsf_malloc(1000) for _ in range(100)]
    assert len(set(offs)) == 100                    # distinct blocks
    st = (ctypes.c_uint64 * 5)()
    lib.t4_tlsf_status(st)
    assert st[1] >= 100 * 1000
    for o in offs:
        assert lib.t4_tlsf_free(o) == 0
    lib.t4_tlsf_status(st)
    assert st[1] == 0                               # fully coalesced
    assert lib.t4_tlsf_check() == 0
    big = lib.t4_tlsf_malloc((1 << 20) - 64)        # whole arena again
    assert big != (1 << 64) - 1


def test_tlsf_exhaustion():
    lib = _alloc()
    lib.t4_tlsf_init(1 << 12)
    assert lib.t4_tlsf_malloc(1 << 13) == (1 << 64) - 1


def test_tlsf_reuse_after_free():
    lib = _alloc()
    lib.t4_tlsf_init(1 << 16)
    a = lib.t4_tlsf_malloc(4096)
    lib.t4_tlsf_free(a)
    assert lib.t4_tlsf_malloc(4096) == a            # best-fit reuse


def _python_loop(inst, monkeypatch):
    """make inst's VM run the Python inner interpreter from now on"""
    from tensorforth_tpu_torch.runtime import native
    monkeypatch.setattr(native, "get_core", lambda: None)
    inst.vm._engine = None


ACID = (": acid 0 100 for dup 3 + swap 2 * fmod "
        "dup 0> if 1 + else 1 - then next ;")


def test_engine_runs_and_matches_python(t4p, monkeypatch):
    """the same colon word leaves the same stack on the native engine
    and on the Python loop"""
    t4p.forth(ACID)
    out_native = t4p.forth("abort acid .s")
    assert t4p.vm._engine is not None, "the native engine did not load"
    _python_loop(t4p, monkeypatch)
    out_py = t4p.forth("abort acid .s")
    assert t4p.vm._engine is None
    assert out_native == out_py


def test_engine_object_words(t4p):
    """tensor words trampoline through the callback"""
    out = t4p.forth(": mkm 2 2 matrix ones 2 *= ; mkm .")
    assert t4p.vm._engine is not None
    assert "+2.0000" in out


def test_engine_callback_error_keeps_the_repl_alive(t4p):
    """an exception raised in a word the C loop called back reaches
    perr, and the REPL goes on"""
    out = t4p.forth(": bad 2 3 matrix ones 3 reshape2 ; bad")
    assert "ERROR in 'reshape2'" in out
    assert t4p.forth("abort 1 2 + .").strip().startswith("3")


# scripts through three interpreters: the JAX package's REPL (its native
# engine), the port's on its native engine and the port's on its Python
# loop.  t4_20a's benchmark loop is cut to 10 cycles and its time masked;
# the off-diagonal of A @ inverse(A) is rounding noise whose sign differs
_MSEC = re.compile(r"=> \S+  msec/cycle")
_NEG_ZERO = re.compile(r"-0\.0000\b")
SCRIPTS = {
    "t4_10a": lambda: script_lines("t4_10a.4th", stop_at="### 5."),
    "t4_20a": lambda: [ln.replace("999 mx", "9 mx")
                       for ln in script_lines("t4_20a.4th")],
    "loops": lambda: [ACID, "acid .s", ": dl 10 0 do i . loop ; dl",
                      ": ql 0 ?do i . loop ; 3 ql 0 ql",
                      ": bu 5 begin dup . 1 - dup 0= until drop ; bu",
                      ": wh 3 begin dup while dup . 1 - repeat drop ; wh",
                      "0 0 / . 1 0 / . -1 0 / .", "7 3 /mod . . -7 2 mod .",
                      "$ff . %101 . 3.5 f>s . hex 255 . decimal", "bye"],
}


def _mask(out):
    return _NEG_ZERO.sub("+0.0000", _MSEC.sub("=> T  msec/cycle", out))


def _fresh_port_repl():
    """a new REPL of the port on the CPU: (instance, run_line output)"""
    import io
    from tensorforth_tpu_torch.cli import TensorForth
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device="cpu")

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    inst.forth = run
    return inst


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_engine_transcripts_match_python_and_jax(t4, t4p, monkeypatch,
                                                 name):
    lines = SCRIPTS[name]()
    want = _mask(run_lines(t4, lines))
    assert t4.vm._engine is not None, "the JAX package's engine is off"
    got = _mask(run_lines(t4p, lines))
    assert t4p.vm._engine is not None
    assert got == want
    t4p.teardown()
    py = _fresh_port_repl()
    try:
        _python_loop(py, monkeypatch)
        got = _mask(run_lines(py, lines))
        assert py.vm._engine is None
    finally:
        py.teardown()
    assert got == want


def _jax_to_port(out: str) -> str:
    """the JAX package's payload owner is XLA; the port's is PyTorch"""
    return out.replace("xla-owned[", "torch-owned[")


def test_mstat_lines_match_jax(t4, t4p):
    """mstat's lines byte for byte: the dictionary and pmem header, the
    object pool, the TLSF accounting and the payloads' owner"""
    script = ["abort 2 3 matrix ones 4 vector 5 5 1 2 tensor randn mstat",
              "drop drop mstat", "mstat", ": w 3 3 matrix ones ; w w mstat",
              "drop mstat"]
    got = run_lines(t4p, script)
    want = _jax_to_port(run_lines(t4, script))
    assert "Ostore(TLSF:accounting) arena[2147483648] used[" in got
    assert got == want


def test_mstat_without_the_native_library(t4p, monkeypatch):
    """with no libt4alloc (T4_NO_NATIVE=1, no compiler) the MMU counts
    in Python and prints the plain Ostore line"""
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.runtime import native
    monkeypatch.setattr(native, "get_alloc", lambda: None)
    mmu = MMU(device="cpu")
    assert mmu._tlsf is None
    t = mmu.tensor(2, 3)
    assert mmu._alloc_bytes == 24 and not mmu._offs
    mmu.free_obj(t)
    assert mmu._alloc_bytes == 0


def test_tlsf_follows_register_rebind_and_free(t4p):
    """register takes an arena offset for a tensor (none for a model or
    a future), rebind re-takes it at the new size, free gives it back"""
    mmu = t4p.sys.mu
    st = (ctypes.c_uint64 * 5)()

    def used():
        mmu._tlsf.t4_tlsf_status(st)
        return st[1]

    base = used()
    t = mmu.tensor(4, 5)
    assert t.oid in mmu._offs and used() == base + 80
    t.shape = (6, 5)
    mmu.rebind(t)
    assert used() == base + 120
    f = mmu.future(None, [])
    assert f.oid not in mmu._offs
    mmu.free_obj(t)
    mmu.free_obj(f)
    assert used() == base and t.oid not in mmu._offs
