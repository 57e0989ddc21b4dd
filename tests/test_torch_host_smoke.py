"""chip_smoke.py's `host` phase at a tiny size on the CPU: the same code
the card runs, cut (t4_40a for 2 epochs of 2 batches, the word loops to
10 cycles, the tasks' loops to 20 products of 32 x 32), with every check
of the phase in force but the held-out gate, which a cut run does not
reach, and those that need the card (graph captures, kernel names in the
profiler's trace)."""
import json

import pytest

import chip_smoke as cs

from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def no_batch_cut(monkeypatch):
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)


def test_host_phase_runs_cut_on_the_cpu(capsys):
    rec = cs.phase_host(device="cpu", epochs=1, max_batch=2, cycles=9,
                        task_n=32, task_iters=20, batches=6, chunk=3)
    out = capsys.readouterr().out
    assert "host: cut to 1 epochs of 20, T4_MAX_BATCH=2" in out
    assert "host: native libraries t4core=" in out
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith('{"phase": "host"')]
    checks = json.loads(line)["checks"]
    assert checks and all(checks.values())
    assert "held_out_accuracy" not in checks     # the gate: full depth
    assert rec["t4_40a"]["epochs_run"] == 2
    assert rec["tb"]["summaries"] > 0
    assert rec["engines"]["native"]["engine_used"]


def test_see_mx_is_the_jax_packages(t4):
    """SEE_MX, the listing the host phase holds both engines to, is what
    the JAX package's REPL prints"""
    out = t4.forth(": mx dup >r clock >r for @ drop next clock r> - r> 1+ "
                   '/ ." => " . ."  msec/cycle" cr ;\nsee mx')
    assert cs.SEE_MX in out
