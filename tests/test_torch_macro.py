"""The macro serve of the port's REPL (vm/netvm.py _macro_serve): while a
trace chunk is in flight, a loop body of the canonical grammar is served
at the dataset NEXT in one host loop with no interpreter dispatch.
test_macro.py's cases, each as in tests/test_torch_fusion.py: `per_word`
against the port with T4_NO_FUSE=1 T4_NO_MACRO=1, `jax` against the JAX
package at its defaults, both from the same weights and RNG state; the
port at its defaults must have served (or, for a foreign word, not).
Printed hits and losses are equal and the RNG state is the same; the
weights equal bit for bit against the port's per-word path and within
JAX_ATOL (tests/test_torch_fusion.py) against the JAX package.
"""
import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    JAX_ATOL, MODEL, MODES, first_word, fresh_jax_chunk_programs, models,
    paired_runs, pin, same_data_roots, set_env, snap, t4p, weights)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CANON = ("variable {v}h 0 {v}h ! variable {v}l\n"
         ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
         "backprop 0.001 nn.adam next ;")


def train(inst, name, loop, epochs):
    inst.vm.sys._rng_seed = 0x5EED          # a comparable burn sequence
    inst.forth(loop)
    for _ in range(epochs):
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
    return (first_word(inst.forth(f"{name}h @ . cr")),
            first_word(inst.forth(f"{name}l @ . cr")),
            weights(models(inst)[-1]), inst.vm.sys._rng_seed)


def ab(mode, t4, t4p, monkeypatch, loop, drop="", epochs=2, served=True):
    """the loop on the reference, then on the port at its defaults (a
    window of 9 batches, chunks of 8); returns the batches macro-served"""
    monkeypatch.setenv("T4_MAX_BATCH", "9")
    monkeypatch.setenv("T4_CHUNK", "8")
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "ma" if n == 0 else "mb"
        inst.vm._macro_count = 0
        inst.forth(MODEL.format(name=name, drop=drop))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        got.append(train(inst, name, loop.format(v=name), epochs))
    count = t4p.vm._macro_count
    if served:
        assert count > 0, "the macro serve never engaged"
    else:
        assert count == 0, "a foreign body was macro-served"
    (ha, la, wa, ra), (hb, lb, wb, rb) = got
    assert ha == hb and la == lb, (ha, hb, la, lb)
    assert ra == rb, "the RNG state diverged"
    for i, (a, b) in enumerate(zip(wa, wb)):
        if mode == "per_word":
            np.testing.assert_array_equal(b, a, err_msg=f"param {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=JAX_ATOL,
                                       err_msg=f"param {i}")
    return count


@pytest.mark.parametrize("mode", MODES)
def test_macro_canonical_adam(t4, t4p, monkeypatch, mode):
    """the t4_30e cycle with a literal rate"""
    ab(mode, t4, t4p, monkeypatch, CANON)


@pytest.mark.parametrize("mode", MODES)
def test_macro_dropout_seed_burn(t4, t4p, monkeypatch, mode):
    """a dropout layer: every served forward burns one key, as per word"""
    ab(mode, t4, t4p, monkeypatch, CANON, drop="0.3 dropout ")


@pytest.mark.parametrize("mode", MODES)
def test_macro_sgd_two_literals(t4, t4p, monkeypatch, mode):
    """`lr momentum nn.sgd`: the two-value arity of the plan"""
    ab(mode, t4, t4p, monkeypatch, CANON.replace("0.001 nn.adam",
                                                 "0.01 0.9 nn.sgd"))


@pytest.mark.parametrize("mode", MODES)
def test_macro_constant_hyper_with_decay(t4, t4p, monkeypatch, mode):
    """`lr nn.adam` with lr a value decayed by `to` between epochs: the
    plan reads the value's cell every chunk"""
    loop = ("variable {v}h 0 {v}h ! variable {v}l 0.002 value {v}r\n"
            ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
            "backprop {v}r nn.adam next "
            "  {v}r 0.5 * to {v}r ;")
    ab(mode, t4, t4p, monkeypatch, loop, epochs=3)


@pytest.mark.parametrize("mode", MODES)
def test_macro_loss_drop_and_plus_sinks(t4, t4p, monkeypatch, mode):
    """a loss summed with +!, the hit stored with !, a loss dropped"""
    loop = ("variable {v}h 0 {v}h ! variable {v}l 0 {v}l !\n"
            ": {v}ep for forward loss.ce {v}l +! loss.ce drop "
            "nn.hit {v}h ! backprop 0.001 nn.adam next ;")
    ab(mode, t4, t4p, monkeypatch, loop)


@pytest.mark.parametrize("mode", MODES)
def test_macro_rejects_foreign_word(t4, t4p, monkeypatch, mode):
    """a body with one more word (t4_30e's `hint` shape) is not served"""
    loop = ("variable {v}h 0 {v}h ! variable {v}l\n"
            ": {v}nop ;\n"
            ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
            "backprop 0.001 nn.adam {v}nop next ;")
    ab(mode, t4, t4p, monkeypatch, loop, served=False)


@pytest.mark.parametrize("mode", MODES)
def test_macro_serves_bulk_of_epoch(t4, t4p, monkeypatch, mode):
    """a window of 9 and chunks of 8 over 2 epochs: the macro serves the
    chunks' inner batches"""
    assert ab(mode, t4, t4p, monkeypatch, CANON) >= 8


@pytest.mark.parametrize("mode", MODES)
def test_macro_midloop_probe_still_exact(t4, t4p, monkeypatch, mode):
    """a weight read after an epoch served by the macro sees the
    reference's weights"""
    monkeypatch.setenv("T4_MAX_BATCH", "9")
    monkeypatch.setenv("T4_CHUNK", "8")
    probes, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "mp" if n == 0 else "mq"
        inst.forth(MODEL.format(name=name, drop=""))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        inst.forth(CANON.format(v=name))
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        probes.append(first_word(inst.forth(f"{name} 1 nn.w sum . cr")))
    assert probes[0] == probes[1], probes
