"""The port's NN layer tier (tensorforth_tpu_torch/nn/funcs.py: conv2d,
dconv2d, linear, the pools, batchnorm, dropout, upsample, logsmax, and
each one's backward) against the JAX package's functions, on the CPU:
the same numpy inputs through both.  On a CPU tensor the port's dots are
exact f32, as XLA CPU's are, so sums differ only in their order.
Tolerance 1e-5 relative and absolute unless a case says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.nn import funcs as jf
from tensorforth_tpu.nn.ntypes import Layer
from tensorforth_tpu_torch.nn import funcs as tf
from tensorforth_tpu_torch.ops import rng

from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# (name, x shape [N,H,W,C], K, S, P, C0): the conv shapes of t4_30e, the
# zoo's nets and the coverage net, stride 2, 'valid' and 5x5 filters
CONV = [("mnist_3x3", (2, 28, 28, 1), 3, 1, 1, 10),
        ("stride2", (2, 12, 12, 2), 3, 2, 1, 4),
        ("stride2_odd", (2, 11, 9, 3), 3, 2, 1, 5),
        ("k5_same", (2, 9, 9, 3), 5, 1, 2, 4),
        ("k1", (3, 5, 5, 4), 1, 1, 0, 6),
        ("valid", (2, 8, 8, 2), 3, 1, 0, 3)]


@pytest.mark.parametrize("name,shape,k,s,p,c0", CONV, ids=[c[0] for c in CONV])
def test_conv_forward_matches_jax(name, shape, k, s, p, c0):
    x = _rand(*shape, seed=1)
    w = _rand(shape[3], k, k, c0, seed=2)
    b = _rand(c0, seed=3)
    want = jf._conv_fwd(J(x), J(w), J(b), s, p)
    close(tf._conv_fwd(T(x), T(w), T(b), s, p), want, 2e-5)


# dconv K 4: (H1, S, P).  At an even H1 with S 2 and P 1 the output is
# 2 H1; at S 1 any H1
DCONV = [(4, 2, 1), (6, 2, 1), (5, 1, 1), (4, 1, 2), (3, 2, 0)]


@pytest.mark.parametrize("h1,s,p", DCONV, ids=str)
def test_dconv_forward_matches_jax(h1, s, p):
    x = _rand(2, h1, h1 + 1, 3, seed=4)
    w = _rand(3, 4, 4, 5, seed=5)
    b = _rand(5, seed=6)
    want = jf._dconv_fwd(J(x), J(w), J(b), s, p)
    close(tf._dconv_fwd(T(x), T(w), T(b), s, p), want, 2e-5)


@pytest.mark.parametrize("h1", [5, 6, 7, 8])
def test_dconv_model_sizes_odd_and_even(h1):
    """the factory sizes a dconv's output (H1-1)S - 2P + K + P0 with
    P0 = (H1 + 2P - K) % S (reference model.py:262-264).  The conv itself
    gives (H1-1)S - 2P + K, so at an odd H1 (P0 = 1) the forward's
    reshape to the layer's shape fails in both packages; at an even H1
    both compute the same values"""
    from tensorforth_tpu.mu.mmu import MMU as JMMU
    from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
    mj = JMMU.get_mmu().model()
    mj.npush(JMMU.get_mmu().tensor(2, h1, h1, 3))
    mj.add(Layer.DCONV, 4, 0.0, [4, 2, 1, 1])
    mt = TMMU.get_mmu().model(device="cpu")
    mt.npush(TMMU.get_mmu().tensor(2, h1, h1, 3, device="cpu"))
    mt.add(Layer.DCONV, 4, 0.0, [4, 2, 1, 1])
    assert mt._program() == mj._program()
    assert mt[1].shape == mj[1].shape == (2, 2 * h1 + h1 % 2,
                                          2 * h1 + h1 % 2, 4)
    x = _rand(2, h1, h1, 3, seed=h1)
    params = [tuple(np.asarray(a) for a in lp) for lp in mj._params()]
    tparams = [tuple(T(a) for a in lp) for lp in params]
    jparams = tuple(tuple(J(a) for a in lp) for lp in params)
    if h1 % 2:
        with pytest.raises(TypeError):
            jf.forward_pure(mj._program(), J(x), jparams,
                            jax.random.PRNGKey(0))
        with pytest.raises(RuntimeError):
            tf.forward_pure(mt._program(), T(x), tparams)
        return
    want, _ = jf.forward_pure(mj._program(), J(x), jparams,
                              jax.random.PRNGKey(0))
    got, _ = tf.forward_pure(mt._program(), T(x), tparams)
    close(got[0], want[0], 2e-5)


@pytest.mark.parametrize("e1,e0", [(1960, 100), (100, 10), (7, 3)])
def test_linear_forward_matches_jax(e1, e0):
    x = _rand(4, 1, e1, 1, seed=7)
    w = _rand(e0, e1, seed=8) / np.sqrt(e1)
    b = _rand(e0, seed=9)
    close(tf._linear_fwd(T(x), T(w), T(b)),
          jf._linear_fwd(J(x), J(w), J(b)), 2e-5)


POOL = [(Layer.MAXPOOL, 2), (Layer.MAXPOOL, 3), (Layer.MINPOOL, 2),
        (Layer.MINPOOL, 3), (Layer.AVGPOOL, 2), (Layer.AVGPOOL, 3)]


@pytest.mark.parametrize("kind,k", POOL, ids=str)
@pytest.mark.parametrize("hw", [(8, 8), (7, 5)], ids=str)
def test_pool_forward_matches_jax(kind, k, hw):
    """ceil mode: odd sizes pad the last window"""
    x = _rand(2, *hw, 3, seed=10)
    close(tf._pool_fwd(kind, T(x), k), jf._pool_fwd(kind, J(x), k))


def test_avgpool_edges_on_ones():
    """the avg pool divides the padded sum by k*k: on 5x5 ones the edge
    windows hold 2 of 4 ones (0.5) and the corner 1 (0.25), as the
    reference prints; torch's own ceil-mode avg_pool2d would give 1.0"""
    x = np.ones((1, 5, 5, 1), np.float32)
    got = tf._pool_fwd(Layer.AVGPOOL, T(x), 2).numpy()[0, :, :, 0]
    want = np.asarray(jf._pool_fwd(Layer.AVGPOOL, J(x), 2))[0, :, :, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 1, 0.5], [1, 1, 0.5],
                                        [0.5, 0.5, 0.25]])


@pytest.mark.parametrize("kind", [Layer.MAXPOOL, Layer.MINPOOL])
def test_pool_gradient_goes_to_the_first_tie(kind):
    """JAX's vjp of reduce_window max/min sends a window's whole
    gradient to its first extreme element in row-major order; on 4x4
    ones that is each window's top-left"""
    x = np.ones((1, 4, 4, 1), np.float32)
    dy = np.ones((1, 2, 2, 1), np.float32)
    _, vjp = jax.vjp(lambda a: jf._pool_fwd(kind, a, 2), J(x))
    want = np.asarray(vjp(J(dy))[0])[0, :, :, 0]
    got = tf._pool_bwd(kind, T(x), 2, T(dy)).numpy()[0, :, :, 0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 0, 1, 0], [0, 0, 0, 0],
                                        [1, 0, 1, 0], [0, 0, 0, 0]])


@pytest.mark.parametrize("kind,k", POOL, ids=str)
def test_pool_gradient_with_ties_matches_jax(kind, k):
    """integers in [0, 3) make many ties in every window, odd sizes pad"""
    x = np.random.RandomState(11).randint(0, 3, (2, 7, 5, 2)).astype(
        np.float32)
    ho, wo = -(-7 // k), -(-5 // k)
    dy = _rand(2, ho, wo, 2, seed=12)
    _, vjp = jax.vjp(lambda a: jf._pool_fwd(kind, a, k), J(x))
    close(tf._pool_bwd(kind, T(x), k, T(dy)), vjp(J(dy))[0])


@pytest.mark.parametrize("k", [2, 3])
def test_upsample_forward_and_backward_match_jax(k):
    x = _rand(2, 3, 4, 2, seed=13)
    dy = _rand(2, 3 * k, 4 * k, 2, seed=14)
    y, vjp = jax.vjp(lambda a: jf._upsample_fwd(a, k), J(x))
    close(tf._upsample_fwd(T(x), k), y)
    close(tf._upsample_bwd(k, T(dy)), vjp(J(dy))[0])


@pytest.mark.parametrize("shape", [(4, 6, 6, 3), (8, 1, 10, 1)], ids=str)
def test_batchnorm_forward_matches_jax(shape):
    """rvar = 1/(sqrt(mean(x^2) - mean^2) + 1e-6); after a linear layer
    ([N,1,E,1]) one channel spans the batch and the features"""
    x = _rand(*shape, seed=15) * 2 + 0.5
    g = _rand(shape[3], seed=16)
    b = _rand(shape[3], seed=17)
    want = jf._batchnorm_fwd(J(x), J(g), J(b))
    got = tf._batchnorm_fwd(T(x), T(g), T(b))
    for a, w in zip(got, want):
        close(a, w, 2e-5)


def test_logsoftmax_and_softmax_match_jax():
    x = _rand(3, 2, 7, 1, seed=18) * 4
    close(tf._logsoftmax_fwd(T(x)), jf._logsoftmax_fwd(J(x)))
    close(tf._softmax_fwd(T(x)), jf._softmax_fwd(J(x)))


@pytest.mark.parametrize("seed", [0, 42, 1258627373665771185])
@pytest.mark.parametrize("j", [0, 3, 9])
def test_dropout_masks_are_bit_equal(seed, j):
    """the mask of layer j under a forward's seed: uniform(fold_in(
    PRNGKey(seed), j)) > rate, bit for bit"""
    x = _rand(4, 6, 5, 3, seed=19)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), j)
    yj, mj = jf._dropout_fwd(J(x), 0.3, kj)
    yt, mt = tf._dropout_fwd(T(x), 0.3, rng.fold_in(rng.PRNGKey(seed), j))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    assert 0.5 < mt.numpy().mean() < 0.9


def test_forward_pure_folds_the_key_per_layer():
    """two dropout layers of one program draw fold_in(key, j) each: the
    masks match the JAX package's and differ from each other"""
    prog = ((Layer.DROPOUT, (0.5,), (2, 4, 4, 1)),
            (Layer.DROPOUT, (0.5,), (2, 4, 4, 1)))
    x = np.ones((2, 4, 4, 1), np.float32)
    _, mj = jf.forward_pure(prog, J(x), ((), ()), jax.random.PRNGKey(7))
    _, mt = tf.forward_pure(prog, T(x), ((), ()), rng.PRNGKey(7))
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (mt[0] != mt[1]).any()


# one-layer programs for backward_segment: (name, kind, opts, x shape,
# parameter shapes, out shape)
ONE = [
    ("conv", Layer.CONV, (1, 1), (2, 6, 6, 2), [(2, 3, 3, 4), (4,)],
     (2, 6, 6, 4)),
    ("conv_s2", Layer.CONV, (2, 1), (2, 7, 7, 3), [(3, 3, 3, 2), (2,)],
     (2, 4, 4, 2)),
    ("conv_k5", Layer.CONV, (1, 2), (2, 6, 6, 2), [(2, 5, 5, 3), (3,)],
     (2, 6, 6, 3)),
    ("dconv", Layer.DCONV, (2, 1), (2, 4, 4, 3), [(3, 4, 4, 2), (2,)],
     (2, 8, 8, 2)),
    ("linear", Layer.LINEAR, (), (3, 2, 5, 1), [(4, 10), (4,)],
     (3, 1, 4, 1)),
    ("batchnorm", Layer.BATCHNM, (), (4, 3, 3, 2), [(2,), (2,)],
     (4, 3, 3, 2)),
    ("maxpool", Layer.MAXPOOL, (2,), (2, 5, 5, 2), [], (2, 3, 3, 2)),
    ("minpool", Layer.MINPOOL, (3,), (2, 5, 7, 2), [], (2, 2, 3, 2)),
    ("avgpool", Layer.AVGPOOL, (2,), (2, 5, 5, 2), [], (2, 3, 3, 2)),
    ("upsample", Layer.USAMPLE, (2,), (2, 3, 3, 2), [], (2, 6, 6, 2)),
    ("flatten", Layer.FLATTEN, (), (2, 3, 3, 2), [], (2, 1, 18, 1)),
    ("dropout", Layer.DROPOUT, (0.4,), (2, 3, 3, 2), [], (2, 3, 3, 2)),
    ("logsmax", Layer.LOGSMAX, (), (2, 1, 6, 1), [], (2, 1, 6, 1)),
    ("relu", Layer.RELU, (0.0,), (2, 3, 3, 2), [], (2, 3, 3, 2)),
    ("selu", Layer.SELU, (0.0,), (2, 3, 3, 2), [], (2, 3, 3, 2)),
    ("elu", Layer.ELU, (1.0,), (2, 3, 3, 2), [], (2, 3, 3, 2)),
    ("leakyrelu", Layer.LEAKYRL, (0.2,), (2, 3, 3, 2), [], (2, 3, 3, 2)),
]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,kind,opts,xs,ps,out", ONE,
                         ids=[c[0] for c in ONE])
def test_one_layer_backward_segment_matches_jax(name, kind, opts, xs, ps,
                                                out, train):
    """the layer's forward, then backward_segment on a random cotangent:
    dx, and (train) the accumulated dw and db"""
    x = _rand(*xs, seed=20)
    params = [_rand(*s, seed=21 + i) for i, s in enumerate(ps)]
    dy = _rand(*out, seed=30)
    acc = [_rand(*s, seed=40 + i) for i, s in enumerate(ps)] or [
        np.zeros(1, np.float32)] * 2
    prog = ((kind, opts, out),)
    key = 5
    jo, jm = jf.forward_pure(prog, J(x), (tuple(J(a) for a in params),),
                             jax.random.PRNGKey(key))
    to, tm = tf.forward_pure(prog, T(x), (tuple(T(a) for a in params),),
                             rng.PRNGKey(key))
    close(to[0], jo[0], 2e-5)
    jr = jf.backward_segment(prog, train, J(dy), J(x), jo,
                             (tuple(J(a) for a in params),), jm,
                             (J(acc[0]),), (J(acc[1]),))
    tmask = tm if kind != Layer.BATCHNM else ((tm[0][0], tm[0][1]),)
    tr = tf.backward_segment(prog, train, T(dy), T(x), to,
                             (tuple(T(a) for a in params),), tmask,
                             (T(acc[0]),), (T(acc[1]),))
    close(tr[0], jr[0], 2e-5)
    if ps:
        close(tr[2][0], jr[2][0], 2e-5)
        close(tr[3][0], jr[3][0], 2e-5)


@pytest.mark.parametrize("final", [Layer.LINEAR, Layer.SIGMOID,
                                   Layer.SOFTMAX, Layer.LOGSMAX,
                                   Layer.TANH])
def test_backward_pure_loss_prep_and_final_linear(final):
    """dLoss = out - tgt after a final linear, sigmoid, softmax or
    logsmax (tgt itself after any other layer); a final linear passes
    dy through with no weight gradient (the tail quirk).  The final
    linear maps 6 to 6 features so its pass-through keeps the shape."""
    prog = [(Layer.LINEAR, (), (3, 1, 6, 1))]
    params = [(_rand(6, 8, seed=50), _rand(6, seed=51))]
    if final == Layer.LINEAR:
        prog.append((Layer.LINEAR, (), (3, 1, 6, 1)))
        params.append((_rand(6, 6, seed=52), _rand(6, seed=53)))
    else:
        prog.append((final, (0.0,), (3, 1, 6, 1)))
        params.append(())
    prog = tuple(prog)
    x = _rand(3, 1, 8, 1, seed=54)
    tgt = _rand(3, 1, 6, 1, seed=55)
    zeros = [(np.zeros((6, 8), np.float32), np.zeros(6, np.float32)),
             (np.zeros((6, 6), np.float32), np.zeros(6, np.float32))]
    jo, jm = jf.forward_pure(prog, J(x), tuple(tuple(J(a) for a in p)
                                               for p in params),
                             jax.random.PRNGKey(0))
    to, tm = tf.forward_pure(prog, T(x), tuple(tuple(T(a) for a in p)
                                               for p in params))
    jr = jf.backward_pure(prog, True, J(tgt), J(x), jo,
                          tuple(tuple(J(a) for a in p) for p in params), jm,
                          tuple(J(z[0]) for z in zeros),
                          tuple(J(z[1]) for z in zeros))
    tr = tf.backward_pure(prog, True, T(tgt), T(x), to,
                          tuple(tuple(T(a) for a in p) for p in params), tm,
                          tuple(T(z[0]) for z in zeros),
                          tuple(T(z[1]) for z in zeros))
    for a, b in zip(tr[:2], jr[:2]):
        for g, w in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            close(g, w, 2e-5)
    for a, b in zip(tr[2] + tr[3], jr[2] + jr[3]):
        close(a, b, 2e-5)
    if final == Layer.LINEAR:          # no weight gradient at the tail
        assert not tr[2][1].any() and not tr[3][1].any()


# the reference's functional oracles (tests/test_oracle.py), through the
# port's functions: the same inputs, the JAX package's values
def test_oracle_conv_dconv_linear_pool_bn_lnorm_forwards():
    x = _rand(2, 8, 8, 3, seed=1)
    w = _rand(3, 3, 3, 5, seed=2)
    b = _rand(5, seed=3)
    close(tf._conv_fwd(T(x), T(w), T(b), 1, 1),
          jf._conv_fwd(J(x), J(w), J(b), 1, 1), 2e-5)
    x = _rand(2, 4, 4, 3, seed=4)
    w = _rand(3, 4, 4, 6, seed=5)
    b = np.zeros(6, np.float32)
    close(tf._dconv_fwd(T(x), T(w), T(b), 2, 1),
          jf._dconv_fwd(J(x), J(w), J(b), 2, 1), 2e-5)
    x, w, b = _rand(4, 16, seed=6), _rand(8, 16, seed=7), _rand(8, seed=8)
    close(tf._linear_fwd(T(x), T(w), T(b)),
          jf._linear_fwd(J(x), J(w), J(b)))
    x = _rand(2, 8, 8, 4, seed=9)
    close(tf._pool_fwd(Layer.MAXPOOL, T(x), 2),
          jf._pool_fwd(Layer.MAXPOOL, J(x), 2))
    x, g, b = _rand(4, 6, 6, 3, seed=10), _rand(3, seed=11), _rand(3, seed=12)
    close(tf._batchnorm_fwd(T(x), T(g), T(b))[0],
          jf._batchnorm_fwd(J(x), J(g), J(b))[0], 2e-5)
    x, g, b = _rand(2, 4, 8, 1, seed=11), _rand(8, seed=12), _rand(8, seed=13)
    close(tf._lnorm_fwd(T(x), T(g), T(b), 1e-5),
          jf._lnorm_fwd(J(x), J(g), J(b), 1e-5))


def test_oracle_linear_and_conv_grads():
    """test_oracle's linear and conv gradients: the port's layer backward
    against the JAX package's vjp"""
    x, w, dy = _rand(4, 1, 8, 1, seed=13), _rand(5, 8, seed=14), _rand(
        4, 1, 5, 1, seed=15)
    z = (np.zeros((5, 8), np.float32), np.zeros(5, np.float32))
    prog = ((Layer.LINEAR, (), (4, 1, 5, 1)),)
    jr = jf.backward_segment(prog, True, J(dy), J(x), (None,),
                             ((J(w), J(z[1])),), (None,), (J(z[0]),),
                             (J(z[1]),))
    tr = tf.backward_segment(prog, True, T(dy), T(x), (None,),
                             ((T(w), T(z[1])),), (None,), (T(z[0]),),
                             (T(z[1]),))
    for a, b in zip((tr[0], tr[2][0], tr[3][0]), (jr[0], jr[2][0], jr[3][0])):
        close(a, b)
    x, w = _rand(2, 6, 6, 2, seed=16), _rand(2, 3, 3, 4, seed=17)
    dy = _rand(2, 6, 6, 4, seed=18)
    _, vjp = jax.vjp(lambda a, b_, c: jf._conv_fwd(a, b_, c, 1, 1), J(x),
                     J(w), J(np.zeros(4, np.float32)))
    want = vjp(J(dy))
    got = tf._conv_grads(T(x), T(w), T(dy), 1, 1)
    for a, b in zip(got, want):
        close(a, b, 2e-5)


def test_class_dot_is_exact_f32_on_the_cpu():
    """on a CPU tensor the class is exact f32 whatever Config.PRECISION
    says; the bf16 classes are for the card"""
    from tensorforth_tpu_torch.config import Config
    a, b = T(_rand(5, 7, seed=60)), T(_rand(7, 3, seed=61))
    kept = Config.PRECISION
    try:
        for cls in ("fast", "strict", "bogus"):
            Config.PRECISION = cls
            np.testing.assert_array_equal(tf.class_dot(tf._mm, a, b).numpy(),
                                          (a @ b).numpy())
    finally:
        Config.PRECISION = kept
