"""The port's training slice (tensorforth_tpu_torch: tiny_lm forward ->
loss -> backprop -> sgd/adam/adamw) held against the JAX package, value
by value.  CPU only: both models get the same numpy weights
(weights.load_jax_params), the same token ids and the same one-hot
targets, and every layer output, input gradient, weight gradient, weight
and optimizer moment is compared after each word."""
import numpy as np
import pytest

import torch

from tensorforth_tpu_torch import weights
from tensorforth_tpu_torch.nn.ntypes import Loss

LM = dict(batch=2, seq=8, vocab=8, dim=16, heads=4)
TOL = 1e-5      # f32 sums in another order (XLA on the CPU against ATen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """tiny CPU matmuls: one thread, so the suite's other workers keep
    their cores"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=3, **lm):
    lm = dict(LM, **lm)
    n, s, v = lm["batch"], lm["seq"], lm["vocab"]
    ids = np.random.RandomState(seed).randint(0, v, (n, s))
    hot = np.eye(v, dtype=np.float32)[np.roll(ids, -1, axis=1)]
    return (ids.reshape(n, s, 1, 1).astype(np.float32),
            hot.reshape(n, s, v, 1))


def _pair(layers, rope, **lm):
    """(JAX tiny_lm, port tiny_lm with its weights, JAX inputs, port
    inputs).  Call with the t4 fixture active: it resets the JAX
    package's singletons."""
    from tensorforth_tpu.models import tiny_lm as jax_lm
    from tensorforth_tpu.mu.mmu import MMU as JMMU
    from tensorforth_tpu_torch.models import tiny_lm as torch_lm
    from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
    lm = dict(LM, **lm)
    mj = jax_lm(**lm, layers=layers, rope=rope)
    mt = torch_lm(**lm, layers=layers, rope=rope, device="cpu")
    weights.load_jax_params(
        mt, [tuple(np.asarray(a) for a in lp) for lp in mj._params()],
        program=mj._program())
    ids, hot = _data(**lm)
    io = []
    for mmu, kw in ((JMMU.get_mmu(), {}), (TMMU.get_mmu(),
                                           {"device": "cpu"})):
        inp = mmu.tensor(*ids.shape, **kw)
        inp.set_numpy(ids)
        tgt = mmu.tensor(*hot.shape, **kw)
        tgt.set_numpy(hot)
        io.append((inp, tgt))
    return mj, mt, io[0], io[1]


def _np(t):
    """payload of a Tensor object of either package, flat"""
    return np.asarray(t.ensure_data()).reshape(-1)


def _layers_close(mj, mt, what):
    assert mj.numel == mt.numel
    for i in range(mj.numel):
        np.testing.assert_allclose(_np(mt[i]), _np(mj[i]), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}: layer {i}")


def _jax_state(mj):
    """the JAX model's training state in weights.dump_state's layout"""
    def arr(x):
        return None if x is None else np.asarray(x.ensure_data())
    out = []
    for t, s in mj._trainables():
        m = t.mtum[s]
        out.append({"w": arr(t.grad[s]), "dw": arr(t.grad[s + 2]),
                    "m": None if m is t.grad[s] else arr(m),
                    "v": arr(t.mtum[s + 2])})
    return out


def _state_close(mj, mt, what, keys=weights.STATE_KEYS, adam_grads=None):
    """adam_grads: the gradients the Adam step just consumed.  Adam's
    update m/(sqrt(v)+1e-6) is ill-conditioned where |g| is near its eps:
    there d(update)/dg reaches 0.1/eps = 1e5, so the 1e-8 by which the
    two packages' f32 gradients differ moves a weight by lr*1e-3.  Weights
    whose gradient lies within 100 eps of zero are held to 1e-4, all
    others to 1e-5."""
    sj, st = _jax_state(mj), weights.dump_state(mt)
    assert len(sj) == len(st)
    for j, (a, b) in enumerate(zip(sj, st)):
        for k in keys:
            assert (a[k] is None) == (b[k] is None), f"{what}: {j} {k}"
            if a[k] is None:
                continue
            got, want = b[k].reshape(-1), a[k].reshape(-1)
            if k == "w" and adam_grads is not None:
                near0 = np.abs(adam_grads[j].reshape(-1)) < 1e-4
                np.testing.assert_allclose(
                    got[near0], want[near0], rtol=1e-4, atol=1e-4,
                    err_msg=f"{what}: trainable {j} 'w' (gradient near 0)")
                got, want = got[~near0], want[~near0]
            np.testing.assert_allclose(
                got, want, rtol=TOL, atol=TOL,
                err_msg=f"{what}: trainable {j} '{k}'")


@pytest.mark.parametrize("layers,rope", [(1, False), (1, True), (2, False),
                                         (2, True)])
def test_train_step_matches_jax_word_by_word(t4, layers, rope):
    """forward: every layer output; loss(CE): the value; backprop: every
    dx, dw, db; adam(0.01): every weight, m and v.  Each within 1e-5
    (weights whose gradient is near zero: 1e-4, see _state_close)."""
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(layers, rope)
    mj.forward(inp_j)
    mt.forward(inp_t)
    _layers_close(mj, mt, "forward")
    lj, lt = mj.loss(Loss.CE, hot_j), mt.loss(Loss.CE, hot_t)
    assert abs(lj - lt) <= TOL * max(1.0, abs(lj)), (lj, lt)
    mj.backprop(hot_j)
    mt.backprop(hot_t)
    _layers_close(mj, mt, "backprop dx")
    _state_close(mj, mt, "backprop", keys=("w", "dw"))
    grads = [e["dw"] for e in _jax_state(mj)]
    mj.adam(0.01)
    mt.adam(0.01)
    _state_close(mj, mt, "adam", adam_grads=grads)
    assert all(not e["dw"].any() for e in weights.dump_state(mt))


@pytest.mark.parametrize("opt", ["adam", "sgd", "sgdm", "adamw"])
def test_five_steps_loss_sequence_matches_jax(t4, opt):
    """five steps of forward/loss/backprop/optimizer: the loss sequence
    within 1e-4 (relative to the first loss), the final state within
    1e-4"""
    step = {"adam": lambda m: m.adam(0.01),
            "sgd": lambda m: m.sgd(0.05),
            "sgdm": lambda m: m.sgd(0.05, 0.9),
            "adamw": lambda m: m.adamw(0.01, 0.1)}[opt]
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(2, True)
    seq = []
    for m, inp, hot in ((mj, inp_j, hot_j), (mt, inp_t, hot_t)):
        losses = []
        for _ in range(5):
            m.forward(inp)
            losses.append(m.loss(Loss.CE, hot))
            m.backprop(hot)
            step(m)
        seq.append(losses)
    np.testing.assert_allclose(seq[1], seq[0], rtol=1e-4)
    assert seq[1][-1] < seq[1][0]
    sj, st = _jax_state(mj), weights.dump_state(mt)
    for a, b in zip(sj, st):
        for k in weights.STATE_KEYS:
            assert (a[k] is None) == (b[k] is None), (opt, k)
            if a[k] is not None:
                np.testing.assert_allclose(b[k].reshape(-1),
                                           a[k].reshape(-1), rtol=1e-4,
                                           atol=1e-4, err_msg=f"{opt} {k}")


def test_backprop_without_train_keeps_gradients_empty(t4):
    """train = 0: input gradients only, as the reference's backward"""
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(1, False)
    mj.train = mt.train = 0
    mj.forward(inp_j).backprop(hot_j)
    mt.forward(inp_t).backprop(hot_t)
    _layers_close(mj, mt, "backprop dx, train=0")
    assert all(not e["dw"].any() for e in weights.dump_state(mt))


def test_loss_kinds_and_hit_match_jax(t4):
    from tensorforth_tpu.nn import funcs as jfuncs
    from tensorforth_tpu_torch.nn import funcs as tfuncs
    import jax.numpy as jnp
    rs = np.random.RandomState(9)
    out = rs.rand(3, 4, 5, 1).astype(np.float32)
    out /= out.sum(axis=2, keepdims=True)
    tgt = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (3, 4))].reshape(
        3, 4, 5, 1)
    for op in ("mse", "bce", "ce", "nll"):
        want = float(jfuncs.loss_fn(op, jnp.asarray(out), jnp.asarray(tgt)))
        got = float(tfuncs.loss_fn(op, torch.from_numpy(out),
                                   torch.from_numpy(tgt)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (op, got, want)
    assert int(tfuncs.hit_fn(torch.from_numpy(out), torch.from_numpy(tgt))) \
        == int(jfuncs.hit_fn(jnp.asarray(out), jnp.asarray(tgt)))
    lab = rs.randint(0, 5, (7,))
    np.testing.assert_array_equal(
        tfuncs.onehot_fn(torch.from_numpy(lab), 5).numpy(),
        np.asarray(jfuncs.onehot_fn(jnp.asarray(lab), 5)))


def test_onehot_word_sets_target_and_hit(t4):
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(1, False)
    mj.forward(inp_j)
    mt.forward(inp_t)
    mj.onehot(hot_j)
    assert mt.onehot(hot_t) is hot_t and mt.onehot() is hot_t
    assert mt.hit() == mj.hit()
    assert abs(mt.loss(Loss.CE) - mj.loss(Loss.CE)) <= 1e-5 * mj.loss(Loss.CE)
    mj.backprop()
    mt.backprop()                      # the target set with onehot()
    _state_close(mj, mt, "backprop with onehot", keys=("dw",))


def test_backward_raises_on_a_layer_not_ported():
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.ntypes import Layer
    x = torch.zeros(1, 2, 3, 1)
    with pytest.raises(NotImplementedError, match="maxpool"):
        funcs.backward_segment(((Layer.MAXPOOL, (2,), x.shape),), True, x, x,
                               (x,), ((),), (None,), (None,), (None,))


def _train(m, inp, hot, steps, use_loss):
    losses = []
    for _ in range(steps):
        m.forward(inp)
        if use_loss:
            losses.append(m.loss(Loss.CE, hot))
        m.backprop(hot)
        m.adam(0.01)
    return losses


def test_lm_word_path_memorizes():
    """the port's test_lm.py::test_lm_word_path_memorizes: train a tiny LM
    on one fixed sequence batch through the word path"""
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(42)
    mmu = MMU.get_mmu()
    m = tiny_lm(batch=2, seq=8, vocab=8, dim=16, heads=4, layers=1,
                device="cpu")
    ids, hot = _data()
    inp = mmu.tensor(2, 8, 1, 1, device="cpu").set_numpy(ids)
    hott = mmu.tensor(2, 8, 8, 1, device="cpu").set_numpy(hot)
    losses = _train(m, inp, hott, 30, use_loss=True)
    assert losses[-1] < losses[0] * 0.5, \
        f"LM not learning: {losses[:3]}...{losses[-3:]}"


def test_memorized_lm_generates_pattern():
    """the port's test_lm.py::test_memorized_lm_generates_pattern: train
    on a repeating cycle in the port, then the port's KV-cache decode
    reproduces it exactly"""
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(42)
    mmu = MMU.get_mmu()
    m = tiny_lm(batch=1, seq=8, vocab=4, dim=16, heads=2, layers=1,
                device="cpu")
    ids = np.array([[0, 1, 2, 3, 0, 1, 2, 3]])
    hot = np.eye(4, dtype=np.float32)[np.roll(ids, -1, 1)].reshape(1, 8, 4, 1)
    inp = mmu.tensor(1, 8, 1, 1, device="cpu").set_numpy(
        ids.reshape(1, 8, 1, 1).astype(np.float32))
    ht = mmu.tensor(1, 8, 4, 1, device="cpu").set_numpy(hot)
    _train(m, inp, ht, 100, use_loss=False)
    out = generate(m, np.array([0, 1, 2, 3]), n_new=8, temp=0.0)
    np.testing.assert_array_equal(out, np.array([0, 1, 2, 3] * 3),
                                  err_msg=f"LM did not continue cycle: {out}")


def test_state_round_trips_and_rejects_mismatch():
    """dump_state -> load_state into a fresh model reproduces the state
    (moments are allocated on load) and the next step; a wrong shape or
    count raises and writes nothing"""
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    lm = dict(LM, layers=1, rope=True, device="cpu")
    a, b = tiny_lm(**lm), tiny_lm(**lm)
    ids, hot = _data()
    inp = mmu.tensor(*ids.shape, device="cpu").set_numpy(ids)
    tgt = mmu.tensor(*hot.shape, device="cpu").set_numpy(hot)
    a.forward(inp).backprop(tgt).adam(0.01)
    a.forward(inp).backprop(tgt)          # non-zero dw, m and v
    state = weights.dump_state(a)
    assert all(e[k] is not None and e[k].any() for e in state
               for k in ("dw", "m", "v"))
    weights.load_state(b, state)
    for ea, eb in zip(state, weights.dump_state(b)):
        for k in weights.STATE_KEYS:
            np.testing.assert_array_equal(eb[k], ea[k])
    a.adam(0.01)
    b.adam(0.01)
    for ea, eb in zip(weights.dump_state(a), weights.dump_state(b)):
        for k in weights.STATE_KEYS:
            np.testing.assert_array_equal(eb[k], ea[k])

    before = weights.dump_state(b)
    bad = [dict(e) for e in state]
    bad[-1]["m"] = bad[-1]["m"][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        weights.load_state(b, bad)
    with pytest.raises(ValueError, match="entries"):
        weights.load_state(b, state[:-1])
    wide = tiny_lm(**dict(lm, dim=32))
    with pytest.raises(ValueError):
        weights.load_state(wide, state)
    for ea, eb in zip(before, weights.dump_state(b)):
        np.testing.assert_array_equal(eb["w"], ea["w"])


def test_load_state_carries_a_jax_training_state(t4):
    """a JAX model's state after a step, loaded into the port: the next
    step agrees"""
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(1, True)
    mj.forward(inp_j).backprop(hot_j).adam(0.01)
    mj.forward(inp_j).backprop(hot_j)
    state = _jax_state(mj)
    weights.load_state(mt, state)
    _state_close(mj, mt, "loaded")
    mj.adam(0.01)
    mt.adam(0.01)
    _state_close(mj, mt, "adam after load",
                 adam_grads=[e["dw"] for e in state])
