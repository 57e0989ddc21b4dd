"""The CPU f32 dots in XLA CPU's order (tensorforth_tpu_torch/ops/xla_dot.py)
against `jnp.dot` under `jax.jit` on the CPU, bit for bit.

The order is the host's (its ISA and caches); on the host it was probed on
(`xla_dot.PROBED_HOST`) every class that `xla_dot.order` names is held bit
for bit here: a hypothesis-drawn grid of (m, k, n) in each class and
layout, and the linear layers' products that the example twins reach
(t4_40b's D and G forward and backward, t4_32a's, the 784 -> 10 epoch of
test_future).  On another host the replay stands down, and these tests
check that it does.  Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import HealthCheck, given, settings, strategies as st

from tensorforth_tpu_torch.nn import funcs
from tensorforth_tpu_torch.ops import xla_dot, xla_reduce

from tests.test_torch_threads import one_torch_thread  # noqa: F401

GRID = settings(max_examples=12, deadline=None, derandomize=True,
                database=None, suppress_health_check=list(HealthCheck))
_JIT = {}


def _jax_dot(a, b, a_t, b_t):
    """jnp.dot under jax.jit of a [m, k] and b [k, n], each passed in the
    layout XLA sees (a_t: a stored [k, m]; b_t: b stored [n, k])"""
    key = (a_t, b_t)
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda x, y: jnp.dot(x.T if a_t else x,
                                                 y.T if b_t else y))
    x = np.ascontiguousarray(a.T) if a_t else a
    y = np.ascontiguousarray(b.T) if b_t else b
    return np.asarray(_JIT[key](x, y))


def _jax_fused_dot(a, b):
    """a row a [1, k] times b [k, n] as XLA runs it inside a program: the
    row reaches the dot as the transpose of an [k, 1, 1, 1] cotangent, b
    as a reshape of a 4-d activation (the JAX package's dW of a layer of
    width 1), so XLA fuses the dot into a loop (`bitcast_dot_fusion`)"""
    k, n = b.shape
    if "fused" not in _JIT:
        _JIT["fused"] = jax.jit(lambda x, y: jnp.dot(
            x.reshape(x.shape[0], -1).T, y.reshape(y.shape[0], -1)))
    return np.asarray(_JIT["fused"](a.T.reshape(k, 1, 1, 1),
                                    b.reshape(k, 1, n, 1)))


def _torch_operand(x, t):
    """the operand as the port holds it: a transposed view where XLA sees
    a transposed layout"""
    return torch.from_numpy(np.ascontiguousarray(x.T)).T if t else \
        torch.from_numpy(x)


def _check(m, k, n, a_t=False, b_t=False, seed=0):
    """the replay of one dot against XLA's, on randn from a numpy seed;
    off the probed host the replay must stand down"""
    rs = np.random.RandomState(seed)
    a = rs.randn(m, k).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    got = xla_dot.mm(_torch_operand(a, a_t), _torch_operand(b, b_t))
    if not xla_dot.host_matches():
        assert got is None
        return
    assert xla_dot.order(m, k, n, a_t, b_t) is not None, (m, k, n)
    assert got is not None and got.shape == (m, n)
    want = _jax_dot(a, b, a_t, b_t)
    assert np.array_equal(got.numpy(), want), (m, k, n, a_t, b_t)


# ---------------------------------------------------------------------------
# (a) each class on a drawn grid
# ---------------------------------------------------------------------------
@GRID
@given(m=st.integers(51, 160), n=st.integers(2, 300), k4=st.integers(1, 200),
       b_t=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_wide_rows_by_n_mod_64(m, n, k4, b_t, seed):
    """m > 50 (any m with b transposed: the forward x @ w.T): 4, 2 or 1
    chains by n mod 64, k a multiple of the chain count, blocks of 512
    times the chains"""
    nch = xla_dot.order(m, 4 * k4, n, False, b_t)[1]
    _check(m, 4 * k4 if nch == 4 else 4 * k4 + (k4 % 2) * (nch == 1),
           n, False, b_t, seed)


@GRID
@given(m=st.integers(2, 50), n=st.integers(2, 300), k4=st.integers(1, 150),
       seed=st.integers(0, 2 ** 16))
def test_transposed_b_at_few_rows(m, n, k4, seed):
    """b transposed at 2 <= m <= 50: the same rule as wide rows"""
    _check(m, 4 * k4, n, False, True, seed)


@GRID
@given(m=st.integers(2, 50), n=st.integers(2, 16), k=st.integers(1, 1200),
       seed=st.integers(0, 2 ** 16))
def test_few_rows_few_columns_four_chains(m, n, k, seed):
    """a and b row-major, m <= 50, n <= 16: four chains over the whole
    multiples of four, the last k % 4 products rounded and summed apart"""
    _check(m, k, n, False, False, seed)


@GRID
@given(m=st.integers(2, 50), n=st.integers(17, 512), k=st.integers(1, 64),
       seed=st.integers(0, 2 ** 16))
def test_few_rows_many_columns_one_chain(m, n, k, seed):
    """a and b row-major, m <= 50, n >= 17: one chain"""
    _check(m, k, n, False, False, seed)


@GRID
@given(m=st.integers(2, 400), n=st.integers(2, 600), k=st.integers(2, 128),
       seed=st.integers(0, 2 ** 16))
def test_transposed_a_one_chain(m, n, k, seed):
    """a transposed (the backward dy.T @ x; k >= 2, or the layout is
    moot): one chain"""
    if n % 48 == 1:
        n += 1
    _check(m, k, n, True, False, seed)


@GRID
@given(m8=st.integers(1, 40), k8=st.integers(1, 200),
       seed=st.integers(0, 2 ** 16))
def test_matrix_times_vector_eight_lanes(m8, k8, seed):
    """n = 1: eight chains (the gemv's lanes), folded in adjacent pairs"""
    _check(8 * m8, 8 * k8, 1, False, False, seed)


# ---------------------------------------------------------------------------
# (b) the products the example twins reach
# ---------------------------------------------------------------------------
GAN = [  # t4_40b: D 784-512-256-1, G 128-256-512-784, batch 256
    (256, 784, 512, False, True), (256, 512, 256, False, True),
    (256, 256, 1, False, False), (256, 128, 256, False, True),
    (256, 256, 512, False, True), (256, 512, 784, False, True),
    (512, 256, 784, True, False), (256, 256, 512, True, False),
    (256, 256, 128, True, False), (512, 256, 256, True, False),
    (784, 256, 512, True, False), (256, 512, 784, False, False),
    (256, 256, 512, False, False), (256, 512, 256, False, False),
    (256, 256, 128, False, False), (256, 784, 512, False, False)]
SMALL = [  # t4_32a's dW products; test_future's 784 -> 10 epoch
    (5, 64, 2, True, False), (3, 64, 5, True, False),
    (2, 64, 2, True, False), (16, 784, 10, False, True),
    (10, 16, 784, True, False)]


@pytest.mark.parametrize("m,k,n,a_t,b_t", GAN + SMALL, ids=str)
def test_example_products_match_xla(m, k, n, a_t, b_t):
    _check(m, k, n, a_t, b_t, seed=m + k + n)


# ---------------------------------------------------------------------------
# (c) the order itself, the classes left to torch, the wiring
# ---------------------------------------------------------------------------
BIG = np.float32(2.0 ** 40)


def _lca_sizes(dot, m, k, n):
    """for each pair (i, j) of products: how many of the k ones were
    absorbed with them, i.e. the size of the smallest subtree of the sum
    of an output element that holds both (+-2^40 at i and j, ones
    elsewhere: the result counts the ones summed outside that subtree)"""
    out = {}
    for i in range(k):
        for j in range(i + 1, k):
            a = np.ones((m, k), np.float32)
            a[:, i], a[:, j] = BIG, -BIG
            out[i, j] = k - int(dot(a, np.ones((k, n), np.float32))[0, 0])
    return out


def test_probe_reads_the_tree_the_replay_sums_in():
    """the probe that read the order, at [16, 19] x [19, 10]: four chains
    over k mod 4 for the first 16 products, folded (c0 + c1) + (c2 + c3),
    then the last three apart; XLA's sums and the replay's give the same
    tree"""
    if not xla_dot.host_matches():
        pytest.skip("the order is this host's only where it was probed")
    replay = _lca_sizes(lambda a, b: xla_dot.mm(torch.from_numpy(a),
                                                torch.from_numpy(b)).numpy(),
                        16, 19, 10)
    assert replay == _lca_sizes(lambda a, b: _jax_dot(a, b, False, False),
                                16, 19, 10)
    assert replay[0, 4] == 2 and replay[0, 8] == 3      # chain 0: 0, 4, 8
    assert replay[0, 1] == 8 and replay[0, 2] == 16     # the fold's pairs
    assert replay[0, 16] == 19 and replay[16, 17] == 2  # the tail apart


def _forced_where_read(monkeypatch):
    """the small dots of READ were read on an AVX-512 host (their order is
    the ISA's kernels', not the caches' blocks): held with the replay
    forced on wherever the host has that ISA; False elsewhere"""
    if xla_dot._isa() != "avx512f":
        return False
    monkeypatch.setattr(xla_dot, "host_matches", lambda: True)
    return True


@pytest.mark.parametrize("m,k,n,a_t,b_t", sorted(xla_dot.READ), ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_dots_read_one_by_one_match_xla(m, k, n, a_t, b_t, seed,
                                              monkeypatch):
    """t4_32a's forward (64, 5, 3) with b transposed and (64, 5, 2) (the
    runtime's dot: four chains, the fifth product apart) and its backward
    dx (64, 3, 5) (an elemental loop: columns 0 to 3 rounded products
    summed from +0, column 4 a fused multiply-add chain from +0), bit for
    bit against the jitted dot on randn; no other plan gives those bits
    (torch's product, one chain, the plain rounded sum)"""
    if not _forced_where_read(monkeypatch):
        assert xla_dot.mm(torch.ones(m, k), torch.ones(k, n)) is None
        return
    rs = np.random.RandomState(seed + 31)
    a = rs.randn(m, k).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    assert xla_dot.order(m, k, n, a_t, b_t) is None
    got = xla_dot.mm(_torch_operand(a, a_t), _torch_operand(b, b_t))
    want = _jax_dot(a, b, a_t, b_t)
    assert got is not None and np.array_equal(got.numpy(), want)
    lib = xla_dot._lib()
    others = []
    for kc, nch in ((k, 1), (k, 8)):
        c = torch.empty((m, n))
        bc = torch.from_numpy(np.ascontiguousarray(b))
        lib.t4_xla_dot(torch.from_numpy(a).data_ptr(), bc.data_ptr(),
                       c.data_ptr(), m, k, n, kc, nch)
        others.append(c.numpy())
    others.append((torch.from_numpy(a) @ torch.from_numpy(b)).numpy())
    assert not any(np.array_equal(o, want) for o in others)


@pytest.mark.parametrize("m,k,n,a_t,b_t,want", [
    # four chains of one product each, folded, the fifth apart
    (64, 5, 3, False, True, {(0, 1): 2, (2, 3): 2, (0, 2): 4, (1, 3): 4,
                             (0, 4): 5, (3, 4): 5}),
    (64, 5, 2, False, False, {(0, 1): 2, (2, 3): 2, (0, 2): 4, (1, 3): 4,
                              (0, 4): 5, (3, 4): 5}),
    # the dW products of those layers: one chain (the transposed-a class)
    (3, 64, 5, True, False, {(0, 1): 2, (0, 8): 9, (20, 21): 22,
                             (0, 63): 64}),
    (5, 64, 2, True, False, {(0, 1): 2, (0, 8): 9, (20, 21): 22,
                             (0, 63): 64}),
])
def test_pair_probe_reads_the_runtime_dots_trees(m, k, n, a_t, b_t, want,
                                                monkeypatch):
    """the pair probe (+2^40 and -2^40 at two products, ones
    elsewhere) on standalone jitted dots of t4_32a's runtime classes: the
    trees it prints, which the replay sums in"""
    probe = _lca_sizes(lambda a, b: _jax_dot(a, b, a_t, b_t), m, k, n)
    assert {key: probe[key] for key in want} == want
    if _forced_where_read(monkeypatch):
        replay = _lca_sizes(lambda a, b: xla_dot.mm(
            _torch_operand(a, a_t), _torch_operand(b, b_t)).numpy(),
            m, k, n)
        assert replay == probe


@pytest.mark.parametrize("m,k,n,a_t,b_t", [
    (1, 128, 256, False, False),   # a row whose fused loop was not read
    (256, 3, 30, False, True),     # k not a multiple of the chains
    (64, 3000, 100, False, False),  # four chains past k 2048
    (2, 64, 64, True, True),       # both transposed
    (63, 64, 1, False, False),     # a matrix times a vector, m % 8
    (4, 300, 40, False, False),    # one chain past k 64 at m <= 50
    (50, 300, 49, True, False),    # a transposed, n % 48 == 1
])
def test_unprobed_classes_are_left_to_torch(m, k, n, a_t, b_t):
    """where no class was probed the replay declines, and the port's dot
    is torch's own"""
    assert xla_dot.order(m, k, n, a_t, b_t) is None
    rs = np.random.RandomState(3)
    a = _torch_operand(rs.randn(m, k).astype(np.float32), a_t)
    b = _torch_operand(rs.randn(k, n).astype(np.float32), b_t)
    assert xla_dot.mm(a, b) is None
    assert torch.equal(funcs.class_dot(funcs._mm, a, b), a @ b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_vector_dots_match_the_programs_loop(seed):
    """t4_40b's dW of D's 256 -> 1 layer, a row (1, 256, 256), inside a
    program is XLA's fused loop (read from the dumped LLVM IR and its
    object code): the replay of that loop against the jitted dot that XLA
    fuses the same way, bit for bit, wherever the host has the ISA the
    loop was read on (AVX-512: eight lanes of 32 bytes, the same loop on
    the probed host and on others); torch's own order is not the same
    bits"""
    rs = np.random.RandomState(seed + 257)
    a = rs.randn(1, 256).astype(np.float32)
    b = rs.randn(256, 256).astype(np.float32)
    if xla_dot._isa() != "avx512f":
        assert xla_dot.mm(torch.from_numpy(a), torch.from_numpy(b)) is None
        return
    got = xla_dot.fused_mm(torch.from_numpy(a), torch.from_numpy(b))
    want = _jax_fused_dot(a, b)
    assert got is not None and np.array_equal(got.numpy(), want)
    assert not np.array_equal(
        (torch.from_numpy(a) @ torch.from_numpy(b)).numpy(), want)


def test_fused_loop_is_replayed_only_where_it_was_read():
    """four accumulators at (1, 256, 256); t4_32a's (1, 64, 3) and D's
    forward (256, 256, 1), whose unrolled loops the code generator
    reassociated into a chain of its own, and every other shape are not
    this replay's (the matrix-vector product keeps the standalone
    gemv's eight lanes)"""
    assert xla_dot.fused_order(1, 256, 256) == 4
    for shape in ((1, 64, 3), (256, 256, 1), (1, 128, 256), (2, 256, 256)):
        assert xla_dot.fused_order(*shape) is None
    assert xla_dot.order(256, 256, 1) == (256, 8)


def test_linear_layers_take_the_replay_on_the_cpu():
    """the linear layer's products, forward (x @ w.T) and backward (dy.T @
    x, dy @ w), go through the replay where it has the class; the conv's
    patch products (XLA's convolution is no dot), the LM tier's
    class_matmul and class_dot(_mm) keep torch's; a named bf16 class keeps
    its own products"""
    from tensorforth_tpu_torch.nn.ntypes import Layer
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(256, 784).astype(np.float32))
    w = torch.from_numpy(rs.randn(512, 784).astype(np.float32))
    b = torch.zeros(512)
    dy = torch.from_numpy(rs.randn(256, 512).astype(np.float32))

    def replay(p, q):
        y = xla_dot.mm(p, q)
        assert (y is None) == (not xla_dot.host_matches())
        return p @ q if y is None else y

    assert torch.equal(funcs._linear_fwd(x, w, b), replay(x, w.T) + b)
    dx, dw, db = funcs._split_grads(None, Layer.LINEAR, x, w, dy, (),
                                    (256, 1, 512, 1))
    assert torch.equal(dw, replay(dy.T, x))
    assert torch.equal(dx, replay(dy, w))
    assert torch.equal(funcs.class_matmul(x, w.T), x @ w.T)
    assert torch.equal(funcs.class_dot(funcs._mm, x, w.T), x @ w.T)
    ah, bh = funcs._bf16(x), funcs._bf16(w.T)
    assert torch.equal(funcs.class_dot(funcs._linear_mm, x, w.T, "fast"),
                       replay(ah, bh))


# the bias gradients' column sums of t4_40b's backward (N 256: D's 512,
# 256 and 1 features, G's 256, 512, 784) and t4_32a's (N 64: 5, 3, 1, 2),
# rows padded into windows (100), two rounds of windows (2000), one row
COL_SUMS = [(256, 512), (256, 256), (256, 1), (256, 784), (64, 5), (64, 3),
            (64, 1), (64, 2), (100, 7), (2000, 33), (1, 5)]


@pytest.mark.parametrize("r,c", COL_SUMS, ids=str)
def test_bias_column_sums_match_the_programs_reduce(r, c):
    """jnp.sum(dy, axis=0) under jax.jit, alone and fused with the
    gradient's accumulation as the backward fuses it (db + the sum: the
    rewriter's reduce-windows of 32 rows, then the partials, each column
    one row after another from +0, read from t4_40b's and t4_32a's dumped
    programs): xla_reduce.col_sum's bits, on values of mixed magnitude
    (subnormals among them); at t4_40b's widths torch's sum is not the
    same bits"""
    rs = np.random.RandomState(r + c)
    dy = (rs.randn(r, c) * rs.choice([1.0, 1e3, 1e-3, 1e-39],
                                     size=(r, c))).astype(np.float32)
    db = rs.randn(c).astype(np.float32)
    got = xla_reduce.col_sum(torch.from_numpy(dy))
    assert np.array_equal(got.numpy(),
                          np.asarray(jax.jit(lambda x: jnp.sum(x, 0))(dy)))
    fused = jax.jit(lambda b, x: b + jnp.sum(x, axis=0))(db, dy)
    assert np.array_equal((torch.from_numpy(db) + got).numpy(),
                          np.asarray(fused))
    if (r, c) in ((256, 512), (256, 256)):
        assert not torch.equal(got, torch.from_numpy(dy).sum(dim=0))


def test_the_replay_stands_down_off_the_probed_host(monkeypatch):
    """another ISA or other caches: no replay, torch's product"""
    xla_dot.host_matches.cache_clear()
    monkeypatch.setattr(xla_dot, "PROBED_HOST", ("avx2", (1, 2, 3)))
    try:
        a = torch.ones(64, 64)
        assert not xla_dot.host_matches()
        assert xla_dot.mm(a, a) is None
    finally:
        xla_dot.host_matches.cache_clear()


def test_the_host_is_read_as_the_probe_read_it():
    """the ISA from the CPU's flags, the data caches from sysfs"""
    isa, caches = xla_dot._isa(), xla_dot._cache_bytes()
    assert isa in ("avx512f", "avx2", "other")
    assert len(caches) == 3 and all(c >= 0 for c in caches)
    assert xla_dot.host_matches() == (
        (isa, caches) == xla_dot.PROBED_HOST)
