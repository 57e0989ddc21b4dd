"""Trace chunks of the port's REPL (nn/model.py): once the canonical cycle
was seen and one fused cycle consumed, a forward dispatches K batches at
once (K runs of one Cycle, K graph replays on the card) and the words
serve per-batch loss and hit values as LazyIdx futures; introspection
mid-chunk rolls back to the exact per-batch state.  test_chunk.py's
cases, each as in tests/test_torch_fusion.py: `per_word` against the
port's own T4_NO_FUSE=1 path (printed values equal, weights bit for bit),
`jax` against the JAX package at its defaults (test_chunk.py's
tolerances: losses 2e-5, weights 1e-5).
"""
import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    DEFAULT, MODEL, MODES, PER_WORD, first_word, fresh_jax_chunk_programs,
    models, paired_runs, pin, same_data_roots, set_env, snap, t4p, weights)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
        ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
        "backprop 0.001 nn.adam next ;")


def run_epochs(inst, name, epochs):
    for _ in range(epochs):
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
    return (first_word(inst.forth(f"{name}h @ . cr")),
            first_word(inst.forth(f"{name}l @ . cr")),
            weights(models(inst)[-1]))


def ab(mode, t4, t4p, monkeypatch, loop, chunk, epochs, drop="",
       seed=None, extra=None):
    """the loop from the same weights on the reference and on the port at
    its defaults with T4_CHUNK=chunk: [(hit, loss, weights, extra)]"""
    from tensorforth_tpu_torch.nn import cycle
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        monkeypatch.setenv("T4_CHUNK", chunk if env is DEFAULT else "0")
        name = "ca" if n == 0 else "cb"
        inst.forth(MODEL.format(name=name, drop=drop))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        inst.forth(loop.format(v=name))
        if seed is not None:
            inst.vm.sys.seed(seed)
        cycle.reset_counts()
        h, lv, w = run_epochs(inst, name, epochs)
        got.append((h, lv, w, extra(inst, name) if extra else None))
    if int(chunk) > 1:
        assert cycle.COUNTS["chunks"] >= 1, "no chunk was dispatched"
    assert m._chunk is None               # the epoch's end drains it
    return got


def check(mode, got, loss_tol=2e-5, w_tol=1e-5):
    (ha, la, wa, _), (hb, lb, wb, _) = got
    assert ha == hb, (ha, hb)
    for i, (a, b) in enumerate(zip(wa, wb)):
        if mode == "per_word":
            np.testing.assert_array_equal(b, a, err_msg=f"param {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=w_tol,
                                       err_msg=f"param {i}")
    if mode == "per_word":
        assert la == lb, (la, lb)
    else:
        assert abs(float(la) - float(lb)) < loss_tol, (la, lb)


@pytest.mark.parametrize("mode", MODES)
def test_chunk_matches_unfused_word_loop(t4, t4p, monkeypatch, mode):
    """a 7-batch window with T4_CHUNK=3: chunks of 3 and 3 and a single
    tail batch an epoch"""
    monkeypatch.setenv("T4_MAX_BATCH", "7")
    check(mode, ab(mode, t4, t4p, monkeypatch, LOOP, "3", 3))


@pytest.mark.parametrize("mode", MODES)
def test_chunk_midloop_introspection_rolls_back(t4, t4p, monkeypatch,
                                                mode):
    """a weight read (nn.w) inside the loop body rolls back every cycle;
    the end state and the probe still match"""
    monkeypatch.setenv("T4_MAX_BATCH", "5")
    probe = ("variable {v}h 0 {v}h ! variable {v}l variable {v}w\n"
             ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! backprop "
             "dup 1 nn.w sum {v}w ! drop 0.001 nn.adam next ;")
    got = ab(mode, t4, t4p, monkeypatch, probe, "4", 2,
             extra=lambda inst, v: first_word(inst.forth(f"{v}w @ . cr")))
    check(mode, got)
    pa, pb = got[0][3], got[1][3]
    if mode == "per_word":
        assert pa == pb
    else:
        assert abs(float(pa) - float(pb)) < 2e-4, (pa, pb)


@pytest.mark.parametrize("mode", MODES)
def test_chunk_eval_loop_after_training(t4, t4p, monkeypatch, mode):
    """an eval-only loop after chunked training counts the reference's
    hits and leaves the weights alone"""
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    ev = ("variable {v}g 0 {v}g !\n"
          ": {v}ev for forward nn.hit {v}g +! next ;")

    def evaluate(inst, v):
        inst.forth(ev.format(v=v))
        w = weights(models(inst)[-1])
        inst.forth(f"{v}d rewind drop {v} {v}d {v}ev drop")
        for a, b in zip(w, weights(models(inst)[-1])):
            np.testing.assert_array_equal(a, b)
        return first_word(inst.forth(f"{v}g @ . cr"))

    got = ab(mode, t4, t4p, monkeypatch, LOOP, "3", 1, extra=evaluate)
    check(mode, got)
    assert got[0][3] == got[1][3], "eval hit counts differ"


@pytest.mark.parametrize("mode", MODES)
def test_chunk_respects_t4_chunk_env(t4, t4p, monkeypatch, mode):
    """T4_CHUNK=0 turns chunks off: the cycles stay fused, one by one"""
    from tensorforth_tpu_torch.nn import cycle
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    got = ab(mode, t4, t4p, monkeypatch, LOOP, "0", 2)
    assert cycle.COUNTS["chunks"] == 0 and cycle.COUNTS["fused"] > 0
    m = models(t4p)[-1]
    assert m._chunk is None and m._fuse_sig is not None
    check(mode, got)


@pytest.mark.parametrize("mode", MODES)
def test_peek_keys_matches_next_key_run(t4, t4p, mode):
    """System.peek_keys gives the seeds next_key() then gives (per_word),
    and the JAX package's (jax): the chunk's dropout-key contract"""
    sys_ = t4p.vm.sys
    peek = sys_.peek_keys(5)
    if mode == "jax":
        assert peek == t4.vm.sys.peek_keys(5)
    assert peek == [sys_.next_key() for _ in range(5)]


DROP = "0.5 dropout "


@pytest.mark.parametrize("mode", MODES)
def test_chunk_dropout_model_matches_unfused(t4, t4p, monkeypatch, mode):
    """a dropout model chunks too: the chunk takes the seed run the served
    forwards burn, one key a batch: masks, hits, losses and weights
    match"""
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    check(mode, ab(mode, t4, t4p, monkeypatch, LOOP, "3", 2, drop=DROP,
                   seed=777))


@pytest.mark.parametrize("mode", MODES)
def test_chunk_lazyidx_future_resolution(t4, t4p, mode):
    """LazyIdx futures: sums over one vector collapse into one reduction,
    the whole vector into its sum; the values are the JAX package's"""
    import torch
    from tensorforth_tpu_torch.mu.future import Future, LazyIdx
    vec = torch.tensor([1.0, 2.0, 4.0, 8.0])
    got = [Future(None, pending=[LazyIdx(vec, 0), LazyIdx(vec, 2), 3.0]),
           Future(None, pending=[LazyIdx(vec, i) for i in range(4)]),
           Future(LazyIdx(vec, 3))]
    want = [8.0, 15.0, 8.0]
    if mode == "jax":
        import jax.numpy as jnp
        from tensorforth_tpu.mu.future import Future as JF, LazyIdx as JL
        jv = jnp.asarray([1.0, 2.0, 4.0, 8.0], jnp.float32)
        want = [JF(None, pending=[JL(jv, 0), JL(jv, 2), 3.0]).value(),
                JF(None, pending=[JL(jv, i) for i in range(4)]).value(),
                JF(JL(jv, 3)).value()]
    assert [f.value() for f in got] == want


@pytest.mark.parametrize("mode", MODES)
def test_chunk_dropout_with_stray_rng_consumer_rolls_back(t4, t4p,
                                                         monkeypatch, mode):
    """`randn` inside the loop body shifts the seeds the chunk took: the
    seed check rolls back, and the end state still matches"""
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    stray = ("variable {v}h 0 {v}h ! variable {v}l\n"
             ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
             "4 4 matrix randn drop backprop 0.001 nn.adam next ;")
    check(mode, ab(mode, t4, t4p, monkeypatch, stray, "3", 2, drop=DROP,
                   seed=555))


@pytest.mark.parametrize("layers", [
    "48 linear batchnorm relu 24 linear batchnorm relu 10 linear softmax",
    "0.5 4 conv2d 0.5 dropout 2 maxpool relu flatten 16 linear 0.5 dropout "
    "10 linear softmax"], ids=["nn_bn", "nn_f"])
def test_chunk_other_layer_kinds_match_per_word(t4p, monkeypatch, layers):
    """t4_30e's nn_bn and nn_f shapes (batchnorm's statistics, conv,
    pooling, two dropout layers) through chunks with a weight read
    mid-loop: the port's default path lands its per-word path's values
    bit for bit"""
    monkeypatch.setenv("T4_MAX_BATCH", "5")
    model = ("0 trace\n8 28 28 1 nn.model\n" + layers + "\nconstant {v}\n"
             "{v} batchsize dataset mnist_train constant {v}d drop")
    loop = ("variable {v}h 0 {v}h ! variable {v}l variable {v}w\n"
            ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! backprop "
            "dup 0 nn.w sum {v}w ! drop 0.001 nn.adam next ;")
    got, s = [], None
    for name, env in (("oa", dict(PER_WORD, T4_CHUNK="0")),
                      ("ob", dict(DEFAULT, T4_CHUNK="3"))):
        set_env(monkeypatch, env)
        t4p.forth(model.format(v=name))
        m = models(t4p)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        t4p.forth(loop.format(v=name))
        t4p.vm.sys.seed(99)
        got.append(run_epochs(t4p, name, 2)
                   + (first_word(t4p.forth(f"{name}w @ . cr")),))
    check("per_word", [g[:3] + (None,) for g in got])
    assert got[0][3] == got[1][3]
