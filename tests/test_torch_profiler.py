"""The port's `prof.start`/`prof.stop` (torch.profiler, runtime/prof.py)
on the CPU: test_profiler.py's cases, the trace under the TensorBoard
run directory with -t, and T4_PROFILE around a whole CLI run.
"""
import glob
import json
import os

from tests.test_torch_repl import t4p  # noqa: F401  (fixture)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _traces(root):
    return glob.glob(os.path.join(root, "plugins", "profile", "*",
                                  "*.pt.trace.json"))


def test_prof_words_capture_trace(t4p, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t4p.forth("prof.start")
    t4p.forth("3 3 matrix rand dup @ drop drop")
    out = t4p.forth("prof.stop")
    assert "\\ profile -> t4_profile" in out
    root = os.path.join(tmp_path, "t4_profile", "plugins", "profile")
    assert os.path.isdir(root) and os.listdir(root), \
        "no profiler output written"
    (path,) = _traces(os.path.join(tmp_path, "t4_profile"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names               # the `@` word's product


def test_prof_stop_without_start_keeps_repl_alive(t4p):
    out = t4p.forth("prof.stop")
    assert "prof.stop failed (No profile started)" in out
    assert t4p.forth("1 2 + . cr").strip().startswith("3")


def test_prof_start_twice_is_refused(t4p, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t4p.forth("prof.start")
    out = t4p.forth("prof.start")
    # jax.profiler's own words (ROADMAP C9)
    assert ("prof.start failed (Profile has already been started. Only "
            "one profile may be run at a time.)") in out
    assert "profile ->" in t4p.forth("prof.stop")
    assert len(_traces(os.path.join(tmp_path, "t4_profile"))) == 1


def test_prof_writes_under_the_tensorboard_run(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    t4p.sys.tb = Summary(str(tmp_path), "rp")
    t4p.forth("prof.start")
    t4p.forth("2 2 matrix ones dup + drop")
    out = t4p.forth("prof.stop")
    assert f"profile -> {tmp_path / 'rp'}" in out
    assert _traces(str(tmp_path / "rp"))


def test_t4_profile_traces_a_cli_run(tmp_path, monkeypatch, capsys):
    """T4_PROFILE=<dir> traces the whole REPL session (the JAX package's
    cli.py hook, on torch.profiler)"""
    import io
    import sys
    from tensorforth_tpu_torch import cli
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()                   # main() as in a process of its own
    monkeypatch.setenv("T4_PROFILE", str(tmp_path / "p"))
    monkeypatch.setattr(sys, "stdin", io.StringIO("2 3 + .\nbye\n"))
    assert cli.main(["--device", "cpu"]) == 0
    assert "5 " in capsys.readouterr().out
    assert _traces(str(tmp_path / "p"))
