"""The two GAN examples through both REPLs on the CPU, per-word path:
t4_32a whole and t4_40b cut to one epoch of two batches
(`D ds0 1 gan`).  Their `Dr`/`Df` and `Loss G` lines are sums of the
losses (ROADMAP C7), held with no tolerance; only the clock lines
differ."""
import pytest

from tests.test_torch_examples import CLOCK, both, same_data_roots  # noqa
from tests.test_torch_repl import script_lines, t4p  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def per_word_path(monkeypatch):
    monkeypatch.setenv("T4_NO_FUSE", "1")
    monkeypatch.setenv("T4_NO_MACRO", "1")


def test_t4_32a_matches_jax(t4, t4p):
    got, want = both(t4, t4p, script_lines("t4_32a.4th"))
    assert got == want
    assert "G=" in got and "Dr=" in got and "Df=" in got


def test_t4_40b_cut_matches_jax(t4, t4p, monkeypatch):
    monkeypatch.setenv("T4_MAX_BATCH", "2")
    lines = [ln.replace("D ds0 99 gan", "D ds0 1 gan")
             for ln in script_lines("t4_40b.4th")]
    assert "D ds0 1 gan" in lines
    got, want = both(t4, t4p, lines)
    assert got == want
    assert "Loss G, Dr, Df=(0.929111, 0.73001, 0.989648)" in got
    assert "0.654628" in got
