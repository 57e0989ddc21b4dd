"""The err-bit NaN sentinel of the port's REPL (nn/model.py _fin_check,
mu/future.NAN_HOOK): a non-finite batch stops the loop at the exact
faulting batch on every path: fused cycles, trace chunks detected lazily
when a value reaches the host, and detected eagerly at chunk boundaries
(T4_NAN_GUARD=eager).  test_nan_guard.py's cases on the port, each as in
tests/test_torch_fusion.py: `per_word` holds the port's chunked runs
against its own per-batch control, the fused cycles without chunks (the
same messages, hits and weights bit for bit), and against the per-word
path, traced (it has no sentinel; its traced forward stops at the
faulting batch with the same weights), `jax` against the JAX package
run alike (the tolerances below).

The fault: SGD at 3e3 on a purely linear model; the first non-finite loss
lands at corpus offset 32 under T4_SEED=42, inside the first chunk.
"""
import math
import re

import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    DEFAULT, MODES, PER_WORD, first_word, fresh_jax_chunk_programs, models,
    pin, same_data_roots, set_env, snap, t4p, weights)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODEL = """0 trace
8 28 28 1 nn.model
flatten 16 linear 10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d
"""
# `dup .` reads every batch's loss on the host (the lazy sentinel's
# detection point); the eager runs drop it
LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
        ": {v}ep for forward loss.ce {probe}{v}l ! nn.hit {v}h +! "
        "backprop 3.0e3 nn.sgd next ;")
# against the JAX package: the printed numbers within a relative 1e-4
# (the two packages' f32 GEMMs sum in another order; a loss prints in its
# sixth digit apart from the first batch on), and the exploded weights
# within a relative 1e-3 (the divergence compounds an f32 last-bit
# difference geometrically: 1.4e-4 measured at 1e18)
RTOL_PRINTED = 1e-4
RTOL_EXPLODED = 1e-3
AT_32 = "ERROR: nn#forward non-finite at corpus offset 32"
IN_CHUNK = ("nn#forward non-finite at corpus offset 32 "
            "(batch 2 of the chunk at 16)")


def explode(inst, monkeypatch, name, s, chunk, probe, guard=""):
    """one run of the exploding loop from the weights s: (transcript,
    model, hit count, weights)"""
    set_env(monkeypatch, DEFAULT)
    monkeypatch.setenv("T4_CHUNK", chunk)
    monkeypatch.setenv("T4_NAN_GUARD", guard)
    inst.forth(MODEL.format(name=name))
    m = models(inst)[-1]
    pin(m, s)
    inst.forth(LOOP.format(v=name, probe=probe))
    out = inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
    return out, m, first_word(inst.forth(f"{name}h @ . cr")), weights(m)


def close(mode, wa, wb):
    for i, (a, b) in enumerate(zip(wa, wb)):
        if mode == "per_word":
            np.testing.assert_array_equal(b, a, err_msg=f"param {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL_EXPLODED, atol=0,
                                       err_msg=f"param {i}")


_NUM = re.compile(r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)")


def same_transcript(a, b):
    """equal but for the numbers, which agree within RTOL_PRINTED (a NaN
    with a NaN)"""
    assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
    for x, y in zip(_NUM.findall(a), _NUM.findall(b)):
        fx, fy = float(x), float(y)
        assert (fx == fy or (math.isnan(fx) and math.isnan(fy))
                or abs(fx - fy) <= RTOL_PRINTED * max(abs(fx), abs(fy))), \
            (x, y)


def initial(t4p):
    """the weights every run starts from (the model is dropped, so both
    REPLs' stacks print alike)"""
    t4p.forth(MODEL.format(name="n0") + "drop")
    return snap(models(t4p)[-1])


@pytest.mark.parametrize("mode", MODES)
def test_chunked_fault_stops_at_same_batch_as_per_batch(t4, t4p,
                                                        monkeypatch, mode):
    """per-batch fused cycles, a lazily detected chunk and an eagerly
    detected chunk all stop at the fault of offset 32, with the same hit
    count and the same rolled-back weights (finite: before the faulting
    step)"""
    monkeypatch.setenv("T4_MAX_BATCH", "9")
    s = initial(t4p)
    runs = {}
    for tag, chunk, probe, guard in (("control", "0", "dup . ", ""),
                                     ("lazy", "8", "dup . ", ""),
                                     ("eager", "3", "", "eager")):
        insts = [t4p] if mode == "per_word" else [t4, t4p]
        for inst in insts:
            name = f"n{tag[0]}{'j' if inst is t4 else 'p'}"
            runs[tag, inst is t4] = explode(inst, monkeypatch, name, s,
                                            chunk, probe, guard)
    for (tag, _jax), (out, m, _h, w) in runs.items():
        assert AT_32 in out, (tag, out[-400:])
        if tag != "control":
            assert IN_CHUNK in out, (tag, out[-400:])
        assert m.err == 1
        assert all(np.isfinite(x).all() for x in w), tag
    hits = {h for (_o, _m, h, _w) in runs.values()}
    assert len(hits) == 1, runs.keys()
    base = runs["control", False][3]
    for key, (_o, _m, _h, w) in runs.items():
        close(mode if key[1] is False else "jax", base, w)
    if mode == "per_word":
        # the per-word path has no sentinel; traced (`1 trace`), its
        # forward's NaN check stops the loop at the same batch, before
        # that batch's step: the weights the sentinel rolled back to
        set_env(monkeypatch, PER_WORD)
        t4p.forth(MODEL.format(name="nw"))
        m = models(t4p)[-1]
        pin(m, s)
        t4p.forth(LOOP.format(v="nw", probe=""))
        out = t4p.forth("1 trace nwd rewind drop nw nwd nwep drop 0 trace")
        assert "ERROR: nn#forward NaN in linear" in out
        assert (out.count("Model::forward trace") - 1) * 8 == 32
        close("per_word", base, weights(m))


@pytest.mark.parametrize("mode", MODES)
def test_single_cycle_fault_attributed_from_log(t4, t4p, monkeypatch,
                                                mode):
    """chunks off and nothing read mid-loop: the whole epoch runs on
    speculation; the consumed cycles' log still names offset 32 when the
    first non-finite value reaches the host, and says that the state has
    moved on"""
    monkeypatch.setenv("T4_MAX_BATCH", "9")
    s = initial(t4p)
    insts = [t4p] if mode == "per_word" else [t4, t4p]
    outs = []
    for inst in insts:
        name = "ndj" if inst is t4 else "ndp"
        out, m, _h, _w = explode(inst, monkeypatch, name, s, "0", "")
        assert "ERROR" not in out and m.err == 0
        out = inst.forth(f"{name}l @ . cr")      # the NaN loss is read
        assert AT_32 in out
        assert "state has advanced past the faulting batch" in out
        assert m.err == 1
        outs.append(out.replace(name, "nd"))
    if mode == "jax":
        same_transcript(*outs)


@pytest.mark.parametrize("mode", MODES)
def test_healthy_run_stays_silent(t4, t4p, monkeypatch, mode):
    """a sane rate: per-batch reads and chunks print no sentinel output
    and leave err clear; the run lands where the reference's does"""
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    s = initial(t4p)
    insts = [t4p] if mode == "per_word" else [t4, t4p]
    got = []
    for inst in insts:
        name = "nej" if inst is t4 else "nep"
        set_env(monkeypatch, DEFAULT)
        monkeypatch.setenv("T4_CHUNK", "3")
        inst.forth(MODEL.format(name=name))
        m = models(inst)[-1]
        pin(m, s)
        inst.forth(LOOP.format(v=name, probe="dup . ").replace("3.0e3",
                                                               "0.01"))
        out = inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        assert "ERROR" not in out and "non-finite" not in out
        assert m.err == 0
        w = weights(m)
        assert all(np.isfinite(x).all() for x in w)
        got.append((out.replace(name, "ne"), w))
    if mode == "jax":
        same_transcript(got[0][0], got[1][0])
        for a, b in zip(got[0][1], got[1][1]):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
