"""test_fuzz.py's REPL cases pointed at the port's REPL, and the cases of
test_real_idx.py and test_real_photos.py through both packages, on the
CPU.  Each fuzz case runs the reference's own function, with its own
asserts, on a REPL of each package that records what it prints; the
transcripts are equal but where stated.  The chunk-probe case is not
here: it needs the JAX package's trace-chunk internals
(tests/test_chunk.py); test_torch_chunk.py holds the port's."""
import ctypes
import re

import numpy as np
import pytest

import tests.test_fuzz as fuzz
from tests.test_real_idx import _write_cifar, _write_mnist
from tests.test_torch_repl import t4p  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401


class Recording:
    """a REPL whose `forth` keeps what it prints (the rest passes through)"""

    def __init__(self, inst):
        self.inst, self.out = inst, []

    def __getattr__(self, k):
        return getattr(self.inst, k)

    def forth(self, line):
        out = self.inst.forth(line)
        self.out.append(out)
        return out

    def text(self):
        return "".join(self.out)


def _both(t4, t4p, case):
    a, b = Recording(t4), Recording(t4p)
    case(a)
    case(b)
    return b.text(), a.text()


@pytest.mark.parametrize("name", [
    "test_fuzz_colon_control_flow", "test_fuzz_model_builder",
    "test_fuzz_muldiv_underflow_bounded", "test_hostile_input_survives"])
def test_fuzz_case_transcripts_match_jax(t4, t4p, name):
    got, want = _both(t4, t4p, getattr(fuzz, name))
    assert got == want


# an uncaught error's traceback names each package's own files and lines
TRACE_FILE = (re.compile(r'File "[^"]*", line \d+,'), 'File #, line #,')
OWNER = (re.compile(r"xla-owned"), "torch-owned")     # mstat's payload owner


@pytest.fixture()
def same_clock(monkeypatch):
    """`clock` reads the host's clock in both packages: both read one
    sequence of values here"""
    from tensorforth_tpu.system import System as JSystem
    from tensorforth_tpu_torch.system import System
    for cls in (JSystem, System):
        ticks = iter(range(1000, 10 ** 6, 37))
        monkeypatch.setattr(cls, "clock", staticmethod(lambda t=ticks:
                                                       float(next(t))))


@pytest.fixture()
def no_trace_left():
    """a soup may leave a `prof.start` trace running; each package keeps
    one a process, so it is stopped for the tests that follow"""
    yield
    import jax
    from tensorforth_tpu_torch.runtime import prof
    for stop in (jax.profiler.stop_trace, prof.stop_trace):
        try:
            stop()
        except RuntimeError:
            pass


@pytest.mark.parametrize("name", [
    "test_fuzz_scalar_words_keep_repl_alive",
    "test_fuzz_tensor_words_keep_repl_alive"])
def test_fuzz_soup_keeps_the_ports_repl_alive(t4, t4p, same_clock,
                                              no_trace_left, name):
    """the word-soup fuzz over each package's dictionary (the port's order
    is the JAX package's), with the reference's asserts.  The transcripts
    are equal once both read one clock, but for the traceback's file
    paths and line numbers and mstat's payload owner (ROADMAP C9: the
    one differing scalar was `clock`)"""
    from tests.test_torch_repl import _mask
    got, want = _both(t4, t4p, getattr(fuzz, name))
    assert "ERROR" not in got.split("\n")[-1]
    assert _mask(got, TRACE_FILE, OWNER) == _mask(want, TRACE_FILE, OWNER)


def test_clock_is_the_soups_differing_scalar(t4, t4p, same_clock):
    """the soup's line `2 2 matrix ones clock 1 fill broadcast` prints the
    same in both packages once both read one clock (it printed 8095.71
    and 2554.98, the two processes' clocks)"""
    line = "2 2 matrix ones clock 1 fill broadcast"
    got, want = t4p.forth(line), t4.forth(line)
    assert got == want and "op=11?" in got and "T2[2,2] 1000 -> ok" in got


def test_native_fault_containment(t4p):
    """test_fuzz's crash containment on the port's native engine: a
    SIGSEGV inside the engine's C code is trapped, the line aborted, and
    the REPL keeps working"""
    from tensorforth_tpu_torch.runtime.native import get_core
    lib = get_core()
    if lib is None or not hasattr(lib, "t4_crash_test"):
        pytest.skip("native core unavailable (no C compiler)")
    t4p.forth("1 2 +")
    eng = t4p.vm._engine
    assert eng is not None
    lib.t4_crash_test.restype = ctypes.c_int32
    for kind in (0, 1):
        assert lib.t4_crash_test(ctypes.byref(eng.st), kind) in (11, 7)
        assert eng.st.py_flags & eng.PYF_FAULT
        assert eng._check_fault()
        assert not (eng.st.py_flags & eng.PYF_FAULT)
    assert "42" in t4p.forth("41 1 + . cr")
    assert "24" in t4p.forth("3 4 matrix ones 2 * sum . cr")


# --- test_real_idx / test_real_photos ---------------------------------------
@pytest.fixture()
def data_root(tmp_path, monkeypatch):
    """both packages read corpora only under tmp_path"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu.io.loader import Loader as JLoader
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.io.loader import Loader
    monkeypatch.setenv("T4_DATA", str(tmp_path))
    for cfg, ldr in ((JConfig, JLoader), (Config, Loader)):
        monkeypatch.setattr(cfg, "DATA_ROOTS", [str(tmp_path)])
        monkeypatch.setattr(ldr, "_map", {})
    return tmp_path


def _corpora(name):
    from tensorforth_tpu.io.loader import Loader as JLoader
    from tensorforth_tpu_torch.io.loader import Loader
    out = []
    for ldr in (JLoader, Loader):
        cp = ldr.get(None, name)
        cp.init()
        out.append(cp)
    return out


@pytest.mark.parametrize("kind", ["mnist", "cifar"])
def test_idx_readers_match_jax(data_root, kind):
    if kind == "mnist":
        _write_mnist(str(data_root))
        jcp, cp = _corpora("mnist_train")
        assert type(cp).__name__ == "Mnist" and cp.size == 64
        n = 10
    else:
        _write_cifar(str(data_root))
        jcp, cp = _corpora("cifar10_train")
        assert type(cp).__name__ == "Cifar10" and cp.C == 3
        n = 4
    assert (cp.size, cp.H, cp.W, cp.C) == (jcp.size, jcp.H, jcp.W, jcp.C)
    for a, b in zip(cp._read(0, n), jcp._read(0, n)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mnist_idx_bad_magic_is_refused(data_root):
    import os
    import struct
    d = os.path.join(str(data_root), "MNIST", "raw")
    os.makedirs(d, exist_ok=True)
    for nm, payload in (("train-images-idx3-ubyte",
                         struct.pack(">IIII", 0xBAD, 1, 28, 28)),
                        ("train-labels-idx1-ubyte",
                         struct.pack(">II", 0x801, 1) + b"\0")):
        with open(os.path.join(d, nm), "wb") as f:
            f.write(payload)
    from tensorforth_tpu_torch.io.loader import Loader
    with pytest.raises(AssertionError):
        Loader.get(None, "mnist_train").init()


def test_real_idx_trains_through_words_as_jax(data_root, t4, t4p,
                                               monkeypatch):
    _write_mnist(str(data_root))
    monkeypatch.setenv("T4_MAX_BATCH", "2")
    monkeypatch.setenv("T4_NO_FUSE", "1")
    monkeypatch.setenv("T4_NO_MACRO", "1")
    lines = ["0 trace",
             "16 28 28 1 nn.model flatten 16 linear relu 10 linear "
             "softmax constant rm",
             "rm batchsize dataset mnist_train constant rds",
             "rm rds forward loss.ce . backprop 0.01 nn.adam drop drop"]
    got = "".join(t4p.forth(ln) for ln in lines)
    want = "".join(t4.forth(ln) for ln in lines)
    assert "synthetic" not in got
    assert got == want


def test_photo_records_match_jax(data_root):
    pytest.importorskip("sklearn.datasets")
    jcp, cp = _corpora("photos_train")
    assert type(cp).__name__ == "Photos"
    np.testing.assert_array_equal(cp._data, jcp._data)
    np.testing.assert_array_equal(cp._lbl, jcp._lbl)
    p = data_root / "PHOTOS/raw/data_batch.bin"
    assert p.stat().st_size == cp.size * 3073
    jte, te = _corpora("photos_test")
    assert te.size == jte.size == 50
    np.testing.assert_array_equal(te._lbl, jte._lbl)


def test_real_photo_training_gate_as_jax(t4, t4p, data_root, monkeypatch):
    """test_real_photos's gate through both REPLs: the held-out hits are
    equal and at least 45 of 50"""
    pytest.importorskip("sklearn.datasets")
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    hits = []
    for inst in (t4, t4p):
        inst.forth("0 trace\n10 32 32 3 nn.model\n0.5 8 conv2d relu maxpool\n"
                   "flatten 32 linear relu 2 linear softmax\nconstant pm\n"
                   "pm batchsize dataset photos_train constant ptr")
        inst.forth("variable h variable l\n: pep 0 h ! for forward loss.ce "
                   "l ! nn.hit h +! backprop 0.01 nn.adam next ;")
        for _ in range(4):
            inst.forth("ptr rewind drop pm ptr pep drop")
        inst.forth("pm batchsize dataset photos_test constant pte")
        monkeypatch.setenv("T4_MAX_BATCH", "5")
        inst.forth("variable g\n: pev 0 g ! for forward nn.hit g +! next ;")
        inst.forth("pte rewind drop pm pte pev drop")
        hits.append(int(float(inst.forth("g @ . cr").split()[0])))
        monkeypatch.delenv("T4_MAX_BATCH")
    assert hits[0] == hits[1] and hits[1] >= 45, hits
