"""The port's REPL (tensorforth_tpu_torch: eForth + TensorVM) against the
JAX package's, on the CPU: the same Forth lines go through both
interpreters in one process and the printed output is compared byte for
byte.  With the same T4_SEED the two packages draw the same `rand` and
`randn` numbers, so seeded scripts compare too.
"""
import ast
import io
import os
import re

import pytest

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
EXAMPLES = os.path.join(ROOT, "examples")
GOLDEN = os.path.join(HERE, "golden")


@pytest.fixture()
def t4p():
    """fresh TensorForth of the port on the CPU, writing to a capture
    buffer (the counterpart of the `t4` fixture)"""
    from tensorforth_tpu_torch.cli import TensorForth
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System

    os.environ.setdefault("T4_SEED", "42")   # deterministic RNG for goldens
    System.free_sys()
    MMU.free_mmu()
    Debug.free_db()
    AIO.free_io()

    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device="cpu")
    inst.capture = buf

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    inst.forth = run
    yield inst
    inst.teardown()


def script_lines(name, stop_at=None):
    out = []
    with open(os.path.join(EXAMPLES, name)) as f:
        for line in f:
            line = line.rstrip("\n")
            if stop_at and stop_at in line:
                break
            out.append(line)
    return out


def run_lines(inst, lines):
    """feed lines until the VM stops (`bye`); the whole transcript"""
    out = []
    for line in lines:
        out.append(inst.forth(line))
        if inst.vm.state == 0:               # VMState.STOP in both packages
            break
    return "".join(out)


# `see` prints each compiled word's dictionary index.  The JAX package
# registers its multitasking words between the eForth and the tensor
# words, so a tensor word's index differs there; the listing is compared
# with the index field blanked.
_SEE_IDX = re.compile(r"^(  \( [0-9a-f]{4} \[)[ 0-9a-f]{3}(\] \))", re.M)
_MSEC = re.compile(r"=> \S+  msec/cycle")
# an off-diagonal of A @ inverse(A) is rounding noise around zero (1e-8),
# and its sign depends on the order of the LU's operations
_NEG_ZERO = re.compile(r"-0\.0000\b")


def _mask(out, *patterns):
    for pat, repl in patterns:
        out = pat.sub(repl, out)
    return out


def test_t4_10a_matches_jax(t4, t4p):
    lines = script_lines("t4_10a.4th", stop_at="### 5.")
    got, want = run_lines(t4p, lines), run_lines(t4, lines)
    assert got == want
    assert "too cold!, about right." in got
    assert "     sun     mon     tue     wed     thu     fri     sat" in got


def test_t4_20a_matches_jax(t4, t4p):
    """the tensor tier's tour, `rand`/`randn` tensors included; the
    benchmark loop is cut to 10 cycles and its time masked"""
    lines = [ln.replace("999 mx", "9 mx")
             for ln in script_lines("t4_20a.4th")]
    masks = ((_SEE_IDX, r"\1 ..\2"), (_MSEC, "=> T  msec/cycle"),
             (_NEG_ZERO, "+0.0000"))
    got = _mask(run_lines(t4p, lines), *masks)
    want = _mask(run_lines(t4, lines), *masks)
    assert got == want
    assert "=> T  msec/cycle" in got
    assert "+6.0000 +6.0000" in got and "+15.0000 +15.0000" in got
    assert "+9.0000 +9.0000" in got and "+4.5000 +4.5000" in got
    assert "? " not in got.replace("-> ok", "")      # no unknown words
    assert "ERROR" not in got and "WARN" not in got


def test_t4_22a_matches_jax_and_golden(t4, t4p):
    lines = script_lines("t4_22a.4th")
    got = run_lines(t4p, lines)
    assert got == run_lines(t4, lines)
    with open(os.path.join(GOLDEN, "t4_22a.out")) as f:
        assert got == f.read()


# ---------------------------------------------------------------------------
# the Forth lines of the JAX package's own word tests, through both
# ---------------------------------------------------------------------------
WORD_TEST_FILES = ("test_tensor.py", "test_eforth.py", "test_eforth2.py")
# test functions whose lines are left out, and why
LEFT_OUT = {
    "test_gemm_fallback_is_loud":
        "the port has no fallback to warn about (gemm cases below)",
    "test_gemm_variants":
        "the JAX words print a WARN line on the CPU (gemm cases below)",
}
# single lines left out: `words` lists the task and NN words, which the
# port does not have yet (test_words_lists_both_tiers covers the port's)
LEFT_OUT_LINES = ("words",)


def _forth_calls(path):
    """{test function: [script, ...]}: the constant-string arguments of
    its `t4.forth(...)` calls, in order"""
    with open(path) as f:
        tree = ast.parse(f.read())
    cases = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        scripts = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "forth" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                scripts.append((node.lineno, node.col_offset,
                                node.args[0].value))
        if scripts:
            cases[fn.name] = [s for _, _, s in sorted(scripts)
                              if s not in LEFT_OUT_LINES]
    return cases


def _word_cases():
    out = []
    for fname in WORD_TEST_FILES:
        for name, scripts in _forth_calls(os.path.join(HERE, fname)).items():
            if name not in LEFT_OUT:
                out.append(pytest.param(scripts, id=f"{fname[5:-3]}-{name}"))
    return out


@pytest.mark.parametrize("scripts", _word_cases())
def test_word_lines_match_jax(t4, t4p, scripts):
    for script in scripts:
        got, want = t4p.forth(script), t4.forth(script)
        assert got == want, script
        assert "ERROR" not in got, script


GEMM_SETUP = ("abort 1.0 0.0 "
              "2 3 matrix{ 1 2 3 4 5 6 } "
              "3 2 matrix{ 1 0 0 1 1 1 } "
              "2 2 matrix zeros")


@pytest.mark.parametrize("word", ["gemm", "gemm1", "gemm2", "gemm3", "gemm4"])
def test_gemm_words(t4, t4p, word):
    """gemm..gemm4 give the product and print no warning: on a CPU
    tensor gemm2..4 use their kernels' plain versions.  gemm and gemm1
    print what the JAX package prints."""
    t4p.forth(GEMM_SETUP)
    out = t4p.forth(f"{word} .")
    assert "+4.0000 +5.0000" in out and "+10.0000 +11.0000" in out
    assert "WARN" not in out and "ERROR" not in out
    if word in ("gemm", "gemm1"):
        t4.forth(GEMM_SETUP)
        assert out == t4.forth(f"{word} .")


def test_gemm_alpha_beta(t4, t4p):
    script = ("abort 2.0 0.5 2 3 matrix{ 1 2 3 4 5 6 } "
              "3 2 matrix{ 1 0 0 1 1 1 } 2 2 matrix ones gemm . "
              "gemm3 . gemm4 .")
    got = t4p.forth(script)
    assert got.count("+8.5000 +10.5000") == 3
    assert got.count("+20.5000 +22.5000") == 3


def test_tensor_save_load_round_trip(t4, t4p, tmp_path):
    outs = []
    for inst, tag in ((t4p, "p"), (t4, "j")):
        npy = tmp_path / f"{tag}.npy"
        txt = tmp_path / f"{tag}.txt"
        inst.forth(f'2 2 matrix{{ 1 2 3 4 }} s" {txt}" save')
        inst.forth(f's" {npy}" save drop')
        outs.append(inst.forth(f'2 2 matrix s" {npy}" load .')
                    + txt.read_text())
    assert outs[0] == outs[1]
    assert "+3.0000 +4.0000" in outs[0]


def test_mstat_counts_objects(t4p):
    out = t4p.forth("abort 2 3 matrix ones 4 vector mstat")
    assert "Mpool obj#used[2]" in out
    assert "Ostore used[40] peak[40] alloc#[2]" in out
    out = t4p.forth("drop drop mstat")       # marked, swept after the line
    out = t4p.forth("mstat")
    assert "obj#used[0]" in out and "used[0] peak[40]" in out


def test_words_lists_both_tiers(t4p):
    out = t4p.forth("words")
    for w in ("Forth::", "Tensor::", "dup", "gemm4", "inverse", "randn"):
        assert w in out
    assert "nn.model" not in out and "task" not in out.split()


def test_see_decompiles(t4p):
    out = t4p.forth(": sq dup * ;\nsee sq")
    assert ": sq" in out and "dup" in out and "*" in out and ";" in out


def test_word_error_keeps_the_repl_alive(t4p):
    out = t4p.forth("abort 2 3 matrix ones 4 4 matrix ones + .s")
    assert "dim?" in out
    out = t4p.forth("abort 3 reshape2")      # a raised exception
    assert "ERROR in 'reshape2'" in out
    assert "5 " in t4p.forth("abort 2 3 + .")


def test_no_device_means_cuda_and_raises_here():
    import torch
    from tensorforth_tpu_torch.cli import TensorForth, main
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorForth(fin=io.StringIO(""), fout=io.StringIO())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


def test_net_level_is_not_there_yet(t4p):
    from tensorforth_tpu_torch.vm.vm import vm_factory
    with pytest.raises(ValueError):
        vm_factory("net", 1, t4p.sys)


def test_cli_pipes_a_script(tmp_path):
    """the launcher surface: `python ten4_torch -d cpu < script` runs
    every line to `bye`, a top-level colon-word call included"""
    import subprocess
    import sys as _sys
    script = ": sq dup * ;\n5 sq .\n6 sq .\n2 2 matrix ones 3 *= .\nbye\n"
    r = subprocess.run([_sys.executable, os.path.join(ROOT, "ten4_torch"),
                        "--device", "cpu"],
                       input=script, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "25 " in r.stdout and "36 " in r.stdout
    assert "+3.0000 +3.0000" in r.stdout


def test_cli_bench_and_list_devices(capsys):
    from tensorforth_tpu_torch.cli import main
    assert main(["--device", "cpu", "--bench", "64", "32", "16"]) == 0
    assert "GEMM [64,32]@[32,16]" in capsys.readouterr().out
    assert main(["--list-devices"]) == 0


def test_port_imports_no_jax():
    """no module of the port, nor chip_smoke.py, nor the launcher,
    imports jax or anything of the JAX package"""
    bad = re.compile(r"^\s*(import|from)\s+(jax|tensorforth_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "ten4_torch")]
    for d, _, names in os.walk(os.path.join(ROOT, "tensorforth_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hit = bad.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()}"
