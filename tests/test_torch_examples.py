"""The examples that test_scripts.py runs and no other port test holds,
through both REPLs on the CPU, cut as test_scripts.py cuts them:
t4_30d (per-word and default paths), t4_42a, t4_51_attn, t4_54_rope, and
the tensor words' reductions.  The transcripts are equal but for the
clock lines and `mstat`'s payload owner (`torch-owned` where the JAX
package says `xla-owned`), and one sign in t4_30d (below).  The
`sum`/`norm` lines below hold the CPU reductions (ROADMAP C7) with no
tolerance; t4_32a and t4_40b are in test_torch_examples_gan.py."""
import re

import pytest

from tests.test_torch_repl import (_MSEC, _mask, run_lines,  # noqa: F401
                                   script_lines, t4p)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# `epoch=0 done, 1.23 sec` and `time=3.52459` are the host's clock
CLOCK = [(_MSEC, "=> #  msec/cycle"),
         (re.compile(r"\b\d+\.?\d*(?:e[-+]?\d+)? sec\b"), "# sec"),
         (re.compile(r"time=[-+\d.e]+"), "time=#"),
         (re.compile(r"xla-owned"), "torch-owned")]


@pytest.fixture(autouse=True)
def same_data_roots(monkeypatch):
    """the JAX package searches the port's data roots (it also names an
    absolute one of its own), so both print the same corpus WARN line"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu_torch.config import Config
    monkeypatch.setattr(JConfig, "DATA_ROOTS", list(Config.DATA_ROOTS))


def both(t4, t4p, lines):
    got, want = run_lines(t4p, lines), run_lines(t4, lines)
    return _mask(got, *CLOCK), _mask(want, *CLOCK)


@pytest.mark.parametrize("path", ["per_word", "default"])
def test_t4_30d_matches_jax(t4, t4p, monkeypatch, path):
    if path == "per_word":
        monkeypatch.setenv("T4_NO_FUSE", "1")
        monkeypatch.setenv("T4_NO_MACRO", "1")
    got, want = both(t4, t4p, script_lines("t4_30d.4th"))
    # the second conv's f32 GEMM sums in another order than XLA's
    # (ROADMAP, deliberate deviations), so one of 8 softmax outputs
    # differs in its last bit, and the backprop trace's Σ/n of that
    # layer, -3e-08 in the JAX package, is 0 in the port; the sums
    # themselves are XLA's bits on the same inputs (test_torch_reduce.py)
    sign = (re.compile(r"softmax \[ 2, 1, 4, 1\] Σ/n= -0\.00"),
            "softmax [ 2, 1, 4, 1] Σ/n=  0.00")
    assert _mask(got, sign) == _mask(want, sign)
    assert "NN Model[12/128]" in got and "rate=50%" in got
    assert "11> softmax [ 2, 1, 4, 1] Σ/n=" in got


@pytest.mark.parametrize("name,max_batch", [
    ("t4_42a.4th", "1"), ("t4_51_attn.4th", None), ("t4_54_rope.4th", None)])
def test_example_matches_jax(t4, t4p, monkeypatch, name, max_batch):
    if max_batch:
        monkeypatch.setenv("T4_MAX_BATCH", max_batch)
    got, want = both(t4, t4p, script_lines(name))
    assert got == want
    assert "ERROR" not in got


@pytest.mark.parametrize("line,jax_value", [
    ("64 64 1 1 tensor rand norm .", "37.2021"),
    ("100 10 1 1 tensor randn dup avg -= sum .", "2.09808e-05")])
def test_reduction_words_print_jaxs_digits(t4, t4p, line, jax_value):
    """ROADMAP C7's two tensor lines: the port printed 37.202 and
    1.38283e-05 before its sums took XLA CPU's order"""
    lines = ([line] if "randn" in line else ["64 64 1 1 tensor rand", line])
    got, want = both(t4, t4p, lines)
    assert got == want and jax_value in got
