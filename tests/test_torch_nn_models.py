"""The port's NN model API on the tensor-input path (Model.add -> forward
-> loss -> backprop -> sgd | sgdm | adam | adamw) against the JAX
package's, on the CPU, for the zoo's mnist_cnn, gan_mnist and
tiny_transformer and for chip_smoke.py's coverage net (every layer kind
mnist_cnn does not run).  Both models hold the same weights
(weights.load_jax_params) and draw the same dropout masks (the two
packages' System seeds are set alike); every layer tensor and the whole
training state are compared after each word.  Also the reference's
REPL-free test_nn cases through both Python APIs, MM_DEBUG's constant
weights, and the zoo's default device.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from tensorforth_tpu_torch import weights
from tensorforth_tpu_torch.nn.ntypes import Layer, Loss

# f32 sums in another order: 1e-5 of a tensor's largest value on the
# first step.  After an optimizer step the two packages' weights differ
# in their last bits, and Adam turns that into more: it divides by
# sqrt(v) + 1e-6, so a gradient near 0 (a conv bias under a batchnorm,
# whose gradient is rounding noise) moves its weight by up to 3.17 lr in
# either direction.  Later steps: 1e-3 of the largest value, and such
# weights within 2 * 3.17 lr.
TOL = 1e-5
TOL_LATER = 1e-3
ADAM_MOVE = 2 * 3.17


@pytest.fixture(autouse=True)
def _fresh():
    """fresh singletons of both packages; one torch thread"""
    from tensorforth_tpu.mu.mmu import MMU as JMMU
    from tensorforth_tpu.system import System as JSystem
    from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
    from tensorforth_tpu_torch.system import System as TSystem
    for c in (JSystem, TSystem):
        c.free_sys()
    for c in (JMMU, TMMU):
        c.free_mmu()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed(s):
    from tensorforth_tpu.system import System as JSystem
    from tensorforth_tpu_torch.system import System as TSystem
    JSystem.get_sys().seed(s)
    TSystem.get_sys().seed(s)


def _net(pkg, shape, layers):
    """a model of `pkg` ('jax' or 'torch') on `shape` with `layers`
    (chip_smoke.NN_COVERAGE's form)"""
    if pkg == "jax":
        from tensorforth_tpu.mu.mmu import MMU
        kw = {}
    else:
        from tensorforth_tpu_torch.mu.mmu import MMU
        kw = {"device": "cpu"}
    mmu = MMU.get_mmu()
    m = mmu.model(**kw)
    m.npush(mmu.tensor(*shape, **kw))
    for kind, n, bias, opt in layers:
        m.add(kind, n, bias, opt)
    return m


def _zoo(pkg, name, **kw):
    if pkg == "jax":
        from tensorforth_tpu.models import zoo
    else:
        from tensorforth_tpu_torch.models import zoo
        kw["device"] = "cpu"
    return getattr(zoo, name)(**kw)


def _build(pkg, which):
    if which == "mnist_cnn":
        return _zoo(pkg, "mnist_cnn", batch=4)
    if which in ("gan_g", "gan_d"):
        g, d = _zoo(pkg, "gan_mnist", batch=8)
        return g if which == "gan_g" else d
    if which == "tiny_transformer":
        return _zoo(pkg, "tiny_transformer", batch=4, seq=8, dim=16,
                    heads=4, classes=5, layers=2)
    return _net(pkg, chip_smoke.NN_COVERAGE_IN, chip_smoke.NN_COVERAGE)


# the loss each net trains with, and its target: one-hot classes, or for
# G (a final tanh) a dLoss given directly
NETS = {"mnist_cnn": Loss.CE, "gan_g": Loss.MSE, "gan_d": Loss.BCE,
        "tiny_transformer": Loss.CE, "coverage": Loss.NLL}
OPTS = {"sgd": lambda m: m.sgd(0.05), "sgdm": lambda m: m.sgd(0.05, 0.9),
        "adam": lambda m: m.adam(1e-3), "adamw": lambda m: m.adamw(1e-3)}


def _io(mj, mt, seed):
    """the same input and target in both packages' tensors"""
    from tensorforth_tpu.mu.mmu import MMU as JMMU
    from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
    rs = np.random.RandomState(seed)
    x = rs.rand(*mj[0].shape).astype(np.float32)
    out = mj[-1].shape
    n, e = out[0], int(np.prod(out[1:]))
    if e == 1:
        tgt = rs.randint(0, 2, (n, 1)).astype(np.float32)
    else:
        tgt = np.eye(e, dtype=np.float32)[rs.randint(0, e, n)]
    tgt = tgt.reshape(out)
    res = []
    for mmu, kw in ((JMMU.get_mmu(), {}), (TMMU.get_mmu(),
                                           {"device": "cpu"})):
        a = mmu.tensor(*x.shape, **kw)
        a.set_numpy(x)
        b = mmu.tensor(*out, **kw)
        b.set_numpy(tgt)
        res.append((a, b))
    return res


def _np(t):
    return np.asarray(t.ensure_data()).reshape(-1)


def _close(got, want, tol, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of the largest value"


def _layers_close(mj, mt, what, tol=TOL):
    for i in range(mj.numel):
        _close(_np(mt[i]), _np(mj[i]), tol, f"{what}: layer {i}")


def _state_close(mj, mt, what, tol=TOL, adam=None):
    """the whole training state, each key of the largest value it takes
    in the model; adam=(lr, the gradients the step consumed): weights
    whose gradient was within 1e-3 of the largest one of 0 are held to
    ADAM_MOVE lr"""
    sj = [{"w": _np(t.grad[s]), "dw": _np(t.grad[s + 2]),
           "m": None if t.mtum[s] is None or t.mtum[s] is t.grad[s]
           else _np(t.mtum[s]),
           "v": None if t.mtum[s + 2] is None else _np(t.mtum[s + 2])}
          for t, s in mj._trainables()]
    st = weights.dump_state(mt)
    assert len(sj) == len(st)
    for k in weights.STATE_KEYS:
        assert [a[k] is None for a in sj] == [b[k] is None for b in st], k
        pairs = [(b[k].reshape(-1), a[k]) for a, b in zip(sj, st)
                 if a[k] is not None]
        if not pairs:
            continue
        top = max(np.abs(w).max() for _, w in pairs)
        if adam is not None and k == "w":
            gtop = max(np.abs(g).max() for g in adam[1])
        for j, (got, want) in enumerate(pairs):
            room = np.full(want.shape, tol * max(top, 1e-30))
            if adam is not None and k == "w":
                room[np.abs(adam[1][j]) <= 1e-3 * gtop] = ADAM_MOVE * adam[0]
            bad = np.abs(got - want) > room
            assert not bad.any(), (f"{what}: trainable {j} '{k}' "
                                   f"{np.abs(got - want).max()}")


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("net", list(NETS))
def test_three_steps_match_jax(net, opt):
    _seed(11)
    mj = _build("jax", net)
    mt = _build("torch", net)
    assert mt._program() == mj._program()
    weights.load_jax_params(
        mt, [tuple(np.asarray(a) for a in lp) for lp in mj._params()],
        program=mj._program())
    (ij, tj), (it, tt) = _io(mj, mt, 5)
    lr = 1e-3 if opt.startswith("adam") else None
    for step in range(3):
        tol = TOL if step == 0 else TOL_LATER
        what = f"{net} {opt} step {step}"
        _seed(100 + step)              # the dropout masks' seed
        mj.forward(ij)
        mt.forward(it)
        _layers_close(mj, mt, f"{what} forward", tol)
        lj, lt = mj.loss(NETS[net], tj), mt.loss(NETS[net], tt)
        assert abs(lt - lj) <= tol * abs(lj), (what, lt, lj)
        mj.backprop(tj)
        mt.backprop(tt)
        _layers_close(mj, mt, f"{what} backprop", tol)
        _state_close(mj, mt, f"{what} backprop", tol)
        grads = [_np(t.grad[s + 2]) for t, s in mj._trainables()]
        OPTS[opt](mj)
        OPTS[opt](mt)
        _state_close(mj, mt, f"{what} {opt}", tol,
                     None if lr is None else (lr, grads))


def test_mm_debug_constant_weights():
    """T4_MM_DEBUG's fills: conv filters 0.5 and biases -0.5, linear
    weights 0.5 with a 1.0 at (numel/2 - 1) and zero biases; the
    forward of mnist_cnn on them agrees"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu_torch.config import Config as TConfig
    kept = JConfig.MM_DEBUG, TConfig.MM_DEBUG
    JConfig.MM_DEBUG = TConfig.MM_DEBUG = True
    try:
        mj = _build("jax", "mnist_cnn")
        mt = _build("torch", "mnist_cnn")
    finally:
        JConfig.MM_DEBUG, TConfig.MM_DEBUG = kept
    for pj, pt in zip(mj._params(), mt._params()):
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    f, b = mt._params()[0]
    assert (f == 0.5).all() and (b == -0.5).all()
    w = mt._params()[4][0].reshape(-1)
    assert w[w.numel() // 2 - 1] == 1.0 and (w == 0.5).sum() == w.numel() - 1
    (ij, _), (it, _) = _io(mj, mt, 1)
    mj.forward(ij)
    mt.forward(it)
    _layers_close(mj, mt, "MM_DEBUG forward")


# --- the reference's test_nn.py cases that need no REPL, through both
#     Python APIs
MAZUR = (np.array([[0.15, 0.2], [0.25, 0.3]], np.float32),
         np.array([0.35, 0.35], np.float32),
         np.array([[0.4, 0.45], [0.5, 0.55]], np.float32),
         np.array([0.6, 0.6], np.float32))


def _both(layers, shape):
    return _net("jax", shape, layers), _net("torch", shape, layers)


def _load(ms, params):
    """the same weights into the JAX model ms[0] and the port's ms[1]"""
    for lp, t in zip(params, ms[0].data):
        for i, a in enumerate(lp):
            t.grad[i].set_numpy(np.asarray(a))
    weights.load_jax_params(ms[1], params)


def _tensor(pkg, a):
    if pkg == "jax":
        from tensorforth_tpu.mu.mmu import MMU
        t = MMU.get_mmu().tensor(*a.shape)
    else:
        from tensorforth_tpu_torch.mu.mmu import MMU
        t = MMU.get_mmu().tensor(*a.shape, device="cpu")
    t.set_numpy(a)
    return t


def test_linear_forward_exact():
    ms = _both([(Layer.LINEAR, 3, 0.0, None)], (1, 1, 2, 1))
    _load(ms, [(np.arange(1, 7, dtype=np.float32).reshape(3, 2) * 0.1,
                np.array([1, 2, 3], np.float32))])
    x = np.array([10, 20], np.float32).reshape(1, 1, 2, 1)
    for m, pkg in zip(ms, ("jax", "torch")):
        m.forward(_tensor(pkg, x))
        np.testing.assert_allclose(_np(m[-1]), [6, 13, 20], rtol=1e-6)


def test_mazur_backprop_exact():
    """t4_30c's values: the sigmoid passes dy through, SGD divides the
    weight gradient by its leading dim (1)"""
    ms = _both([(Layer.LINEAR, 2, 0.0, None), (Layer.SIGMOID, 0, 0.0, None),
                (Layer.LINEAR, 2, 0.0, None), (Layer.SIGMOID, 0, 0.0, None)],
               (3, 1, 2, 1))
    _load(ms, [MAZUR[:2], (), MAZUR[2:], ()])
    x = np.array([0.05, 0.1] * 3, np.float32).reshape(3, 1, 2, 1)
    tgt = np.array([0.01, 0.99] * 3, np.float32).reshape(3, 1, 2, 1)
    for m, pkg in zip(ms, ("jax", "torch")):
        m.forward(_tensor(pkg, x))
        np.testing.assert_allclose(_np(m[-1])[:2], [0.7514, 0.7729],
                                   atol=5e-5)
        t = _tensor(pkg, tgt)
        assert abs(m.loss(Loss.MSE, t) - 0.596742) < 1e-6
        m.backprop(t)
        np.testing.assert_allclose(_np(m[0].grad[3]), [0.5640, 0.6427],
                                   atol=5e-5)
        np.testing.assert_allclose(_np(m[2]), _np(m[1]))   # pass-through
        m.sgd(0.5, 0.0)
        np.testing.assert_allclose(_np(m[0].grad[0]),
                                   [0.1359, 0.1718, 0.2339, 0.2679],
                                   atol=5e-5)
        np.testing.assert_allclose(_np(m[0].grad[1]), [0.0680, 0.0287],
                                   atol=5e-5)
        assert not _np(m[0].grad[2]).any()
    _state_close(*ms, "mazur")


def test_conv_pool_shapes():
    shapes = [t.shape for t in _build("torch", "mnist_cnn").data]
    assert shapes == [t.shape for t in _build("jax", "mnist_cnn").data]
    assert shapes[1] == (4, 28, 28, 10) and shapes[2] == (4, 14, 14, 10)
    assert shapes[5] == (4, 1, 100, 1) and shapes[7] == (4, 1, 10, 1)


def test_forward_backward_adam_cnn():
    ms = _both([(Layer.CONV, 4, 0.5, None), (Layer.MAXPOOL, 2, 0.0, None),
                (Layer.RELU, 0, 0.0, None), (Layer.FLATTEN, 0, 0.0, None),
                (Layer.LINEAR, 10, 0.0, None), (Layer.SOFTMAX, 0, 0.0, None)],
               (2, 8, 8, 1))
    _load(ms, [tuple(np.asarray(a) for a in lp) for lp in ms[0]._params()])
    x = np.random.RandomState(0).randn(2, 8, 8, 1).astype(np.float32)
    hot = np.eye(10, dtype=np.float32)[[0, 1]].reshape(2, 1, 10, 1)
    for m, pkg in zip(ms, ("jax", "torch")):
        m.forward(_tensor(pkg, x))
        assert abs(_np(m[-1]).sum() - 2.0) < 1e-5    # rows sum to 1
        t = _tensor(pkg, hot)
        m.loss(Loss.CE, t)
        m.backprop(t)
        m.adam(0.001)
        assert not _np(m[0].grad[2]).any()            # zeroed after adam
        m.adam(0.001)                                  # zero grads: ok
    _state_close(*ms, "cnn")


def test_trainable_gate():
    """train=0: backprop accumulates no dW"""
    ms = _both([(Layer.LINEAR, 3, 0.0, None), (Layer.SIGMOID, 0, 0.0, None)],
               (1, 1, 2, 1))
    for m, pkg in zip(ms, ("jax", "torch")):
        m.train = 0
        m.forward(_tensor(pkg, np.array([1, 2], np.float32).reshape(
            1, 1, 2, 1)))
        m.backprop(_tensor(pkg, np.array([1, 0, 0], np.float32).reshape(
            1, 1, 3, 1)))
        assert not _np(m[0].grad[2]).any()


def test_batchnorm_forward_sums_to_zero():
    ms = _both([(Layer.BATCHNM, 0, 0.0, None)], (4, 4, 4, 2))
    x = np.random.RandomState(1).randn(4, 4, 4, 2).astype(np.float32)
    for m, pkg in zip(ms, ("jax", "torch")):
        m.forward(_tensor(pkg, x))
        assert abs(_np(m[-1]).sum()) < 1e-2
    _layers_close(*ms, "batchnorm")
    np.testing.assert_allclose(_np(ms[1][0].mtum[4]), _np(ms[0][0].mtum[4]),
                               rtol=TOL)


def test_dconv_upsample_shapes():
    ms = _both([(Layer.DCONV, 6, 0.0, [4, 2, 1, 1])], (2, 8, 8, 3))
    assert ms[0][1].shape == ms[1][1].shape == (2, 16, 16, 6)
    ms = _both([(Layer.USAMPLE, 2, 0.0, None)], (2, 4, 4, 2))
    assert ms[0][1].shape == ms[1][1].shape == (2, 8, 8, 2)


def test_onehot_and_hit():
    ms = _both([(Layer.LINEAR, 2, 0.0, None), (Layer.SOFTMAX, 0, 0.0, None)],
               (2, 1, 2, 1))
    _load(ms, [tuple(np.asarray(a) for a in lp) for lp in ms[0]._params()])
    x = np.array([10, 1, 1, 10], np.float32).reshape(2, 1, 2, 1)
    hot = np.array([1, 0, 0, 1], np.float32).reshape(2, 1, 2, 1)
    hits = []
    for m, pkg in zip(ms, ("jax", "torch")):
        m.forward(_tensor(pkg, x))
        m.onehot(_tensor(pkg, hot))
        hits.append(m.hit())
    assert hits[0] == hits[1]


def test_weights_carry_the_new_layers():
    """load_jax_params and dump_state/load_state carry conv filters
    [C1,K,K,C0], linear weights [1,E0,E1,1] and batchnorm gamma/beta"""
    mt = _build("torch", "coverage")
    kinds = [k for k, _o, _s in mt._program()]
    tr = mt._trainables()
    assert [t.grad_fn for t, s in tr if s == 0] == [
        k for k in kinds if k in (Layer.CONV, Layer.BATCHNM, Layer.DCONV,
                                  Layer.LINEAR)]
    st = weights.dump_state(mt)
    shapes = [e["w"].shape for e in st]
    assert (4, 1, 1, 1) not in shapes and (2, 3, 3, 4) in shapes
    assert (10,) in shapes and (1, 10, 48, 1) in shapes and (4,) in shapes
    m2 = _build("torch", "coverage")
    weights.load_state(m2, st)
    for a, b in zip(weights.dump_state(m2), st):
        np.testing.assert_array_equal(a["w"], b["w"])


@pytest.mark.parametrize("name", ["mnist_cnn", "gan_mnist",
                                  "tiny_transformer", "tiny_lm"])
def test_zoo_entry_points_default_to_cuda(name):
    """no device given: the CUDA card, and no card here raises"""
    from tensorforth_tpu_torch import models
    if torch.cuda.is_available():
        m = getattr(models, name)()
        m = m[0] if isinstance(m, tuple) else m
        assert m.device.type == "cuda" and m[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(models, name)()
