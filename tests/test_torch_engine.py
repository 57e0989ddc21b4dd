"""The port's op engine, linalg and object layer (tensorforth_tpu_torch/
ops/engine.py, ops/linalg.py, mu/, io/aio.py) against the JAX package's,
on the CPU: the same numpy inputs through both, one case per op.
Tolerance 1e-5 unless a case says otherwise (f32 on both sides; sums and
transcendentals may differ in their last bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.io.aio import AIO as JAIO
from tensorforth_tpu.mu.tensor import Tensor as JTensor
from tensorforth_tpu.ops import engine as jengine
from tensorforth_tpu.ops import linalg as jlinalg
from tensorforth_tpu_torch.io.aio import AIO as TAIO
from tensorforth_tpu_torch.mu.mmu import MMU
from tensorforth_tpu_torch.mu.tensor import Tensor as TTensor
from tensorforth_tpu_torch.ops import engine, linalg

TOL = 1e-5
MAP_OPS = ["abs", "neg", "exp", "ln", "log", "tanh", "relu", "sigm", "sqrt",
           "rcp", "sat", "fill", "gfill", "scale", "pow", "sin", "cos",
           "add", "sub", "mul", "div"]
BIN_OPS = ["add", "sub", "mul", "div", "max", "min"]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("op", MAP_OPS)
def test_map_op(op):
    rs = np.random.RandomState(MAP_OPS.index(op))
    x = rs.standard_normal((2, 3, 4, 2)).astype(np.float32)
    x.flat[:3] = (0.0, -1e-20, 1e-13)          # the ln/log/sqrt clamps
    if op == "pow":
        x = np.abs(x) + 0.1
    if op == "rcp":
        x.flat[:3] = 1.0
    v = 1.7
    close(engine.map_op(op, T(x), v).numpy(),
          jengine.map_op(op, jnp.asarray(x), v))


def test_map_op_rejects_an_unknown_name():
    with pytest.raises(ValueError):
        engine.map_op("cbrt", torch.ones(2))
    with pytest.raises(ValueError):
        engine.ten_op_ts("pow", torch.ones(2), 2.0)


@pytest.mark.parametrize("shape", [(3, 5), (4, 4), (2, 4, 3, 2)], ids=str)
def test_identity(shape):
    x = np.zeros(shape, np.float32)
    close(engine.identity(T(x)).numpy(), jengine.identity(jnp.asarray(x)))


@pytest.mark.parametrize("op", BIN_OPS)
def test_ten_op_scalar_forms(op):
    x = np.random.RandomState(1).standard_normal((3, 4)).astype(np.float32)
    close(engine.ten_op_ts(op, T(x), 0.3).numpy(),
          jengine.ten_op_ts(op, jnp.asarray(x), 0.3))
    close(engine.ten_op_st(op, 0.3, T(x)).numpy(),
          jengine.ten_op_st(op, 0.3, jnp.asarray(x)))


@pytest.mark.parametrize("op", BIN_OPS)
@pytest.mark.parametrize("sa,sb,so", [
    ((2, 3), (2, 3), (2, 3)),
    ((4, 2, 3, 2), (1, 2, 3, 2), (4, 2, 3, 2)),       # N-broadcast of b
    ((1, 2, 3, 2), (4, 2, 3, 2), (4, 2, 3, 2)),       # and of a
    ((2, 3), (6,), (2, 3))], ids=str)
def test_ten_op_tt(op, sa, sb, so):
    rs = np.random.RandomState(2)
    a = rs.standard_normal(sa).astype(np.float32)
    b = rs.standard_normal(sb).astype(np.float32) + 3.0
    close(engine.ten_op_tt(op, T(a), T(b), so).numpy(),
          jengine.ten_op_tt(op, jnp.asarray(a), jnp.asarray(b), so))


@pytest.mark.parametrize("sa,sb", [
    ((4, 5), (5,)), ((4, 5), (5, 3)),
    ((3, 4, 5, 2), (1, 5, 6, 2)), ((1, 4, 5, 2), (3, 5, 6, 2)),
    ((4, 5), (2, 5, 3, 1))], ids=str)
def test_matmul_by_rank(sa, sb):
    rs = np.random.RandomState(3)
    a = rs.standard_normal(sa).astype(np.float32)
    b = rs.standard_normal(sb).astype(np.float32)
    close(engine.matmul(T(a), sa, T(b), sb).numpy(),
          jengine.matmul(jnp.asarray(a), sa, jnp.asarray(b), sb))


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_gemm_plain_variants(variant, ta, tb):
    rs = np.random.RandomState(4)
    a = rs.standard_normal((6, 5) if ta else (5, 6)).astype(np.float32)
    b = rs.standard_normal((4, 6) if tb else (6, 4)).astype(np.float32)
    c = rs.standard_normal((5, 4)).astype(np.float32)
    close(engine.gemm(T(a), T(b), T(c), 0.5, 2.0, ta, tb, variant).numpy(),
          jengine._gemm_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                            jnp.float32(0.5), jnp.float32(2.0), ta, tb))


def test_transpose_is_contiguous():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = engine.transpose(T(x))
    assert t.is_contiguous()
    close(t.numpy(), jengine.transpose(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["t_sum", "t_avg", "t_std", "t_norm",
                                  "t_max", "t_min"])
def test_reductions(name):
    x = np.random.RandomState(5).standard_normal((4, 6, 5)).astype(
        np.float32)
    got = getattr(engine, name)(T(x))
    want = getattr(jengine, name)(jnp.asarray(x))
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


def test_std_keeps_the_reference_quirk():
    """sqrt(sum((x - mu)^2)) / numel, not the textbook deviation"""
    x = np.array([1, 2, 3, 4, 5, 6], np.float32)
    assert engine.t_std(T(x)) == pytest.approx(np.sqrt(17.5) / 6, rel=1e-6)
    assert engine.t_std(T(x)) == pytest.approx(
        jengine.t_std(jnp.asarray(x)), rel=1e-6)


def test_dot_and_has_nan():
    rs = np.random.RandomState(6)
    a = rs.standard_normal(33).astype(np.float32)
    b = rs.standard_normal(33).astype(np.float32)
    assert engine.t_dot(T(a), T(b)) == pytest.approx(
        jengine.t_dot(jnp.asarray(a), jnp.asarray(b)), rel=TOL, abs=TOL)
    x = np.array([1.0, np.nan, np.inf, -np.inf, 0.0], np.float32)
    assert engine.has_nan(T(x)) == jengine.has_nan(jnp.asarray(x)) == 3
    assert engine.has_nan(T(a)) == 0


def test_sync_is_a_no_op_on_the_cpu():
    engine.sync("cpu")


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------
def well_conditioned(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6, 17])
def test_inverse(n):
    a = well_conditioned(n, n)
    got = linalg.inverse(T(a)).numpy()
    close(got, jlinalg.inverse(jnp.asarray(a)))
    close(got @ a, np.eye(n), 2e-5)


@pytest.mark.parametrize("n", [3, 6, 17])
def test_plu(n):
    a = np.random.RandomState(n).standard_normal((n, n)).astype(np.float32)
    p, lu = (x.numpy() for x in linalg.plu(T(a)))
    jp, jlu = jlinalg.plu(jnp.asarray(a))
    close(p, jp)                     # the same orientation: A = P L U
    close(lu, jlu, 1e-4)
    lo = linalg.tri_lower(T(lu)).numpy()
    up = linalg.tri_upper(T(lu)).numpy()
    close(lo, jlinalg.tri_lower(jnp.asarray(lu)))
    close(up, jlinalg.tri_upper(jnp.asarray(lu)))
    close(p @ lo @ up, a, 1e-5 * n)


@pytest.mark.parametrize("n", [3, 6, 17])
def test_det_and_solve(n):
    a = well_conditioned(n, 10 + n) / n
    b = np.random.RandomState(n).standard_normal(n).astype(np.float32)
    assert linalg.det(T(a)) == pytest.approx(
        jlinalg.det(jnp.asarray(a)), rel=1e-4)
    got = linalg.solve(T(a), T(b)).numpy()
    close(got, jlinalg.solve(jnp.asarray(a), jnp.asarray(b)))
    close(a @ got, b, 2e-5)


def test_solve_prints_integer_exact_systems_as_integers():
    a = np.array([[5, 7, 4], [3, -1, 3], [6, 7, 5]], np.float32)
    x = linalg.solve(T(a), T(np.ones(3, np.float32))).numpy()
    assert np.abs(x - np.array([8, -1, -8])).max() < 2e-5


# ---------------------------------------------------------------------------
# the object layer: Tensor, MMU, the tensor printer
# ---------------------------------------------------------------------------
@pytest.fixture()
def mmu():
    MMU.free_mmu()
    m = MMU.get_mmu()
    m.device = "cpu"
    yield m
    MMU.free_mmu()


def test_tensor_header_and_views(mmu):
    t = mmu.tensor(2, 3)
    assert (t.is_tensor(), t.is_model(), t.is_future()) == (True, False,
                                                            False)
    assert (t.N(), t.H(), t.W(), t.C(), t.HWC()) == (1, 2, 3, 1, 6)
    assert t.data is None and t.numpy().sum() == 0      # lazy zeros
    t.set_numpy(np.arange(6))
    a = t.numpy()
    a[0, 0] = 99.0                                      # a copy, no alias
    assert t.numpy()[0, 0] == 0.0
    t.reshape(3, 2)
    assert t.shape == (3, 2) and t.rank == 2
    assert t.numpy().tolist() == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError):
        t.reshape(4, 2)
    with pytest.raises(ValueError):
        t.set_numpy(np.zeros(5))
    assert t.is_same_shape(mmu.tensor(3, 2))


def test_replace_data_copies(mmu):
    t = mmu.tensor(4)
    src = torch.ones(4)
    t.replace_data(src)
    src += 1.0
    assert t.numpy().tolist() == [1.0] * 4


def test_mmu_copy_slice_free_and_accounting(mmu):
    t = mmu.tensor(3, 3).set_numpy(np.arange(9))
    c = mmu.copy(t)
    c.replace_data(c.ensure_data() * 2)
    assert t.numpy()[2, 2] == 8 and c.numpy()[2, 2] == 16
    s = mmu.slice(t, 0, 2, 1, 3)
    assert s.shape == (2, 2) and s.numpy().tolist() == [[3, 4], [6, 7]]
    assert mmu.du2obj(mmu.obj2du(c)) is c
    assert mmu._alloc_bytes == (9 + 9 + 4) * 4
    mmu.mark_free(mmu.obj2du(c))
    mmu.mark_free(mmu.obj2du(s))
    mmu.sweep()
    assert mmu.du2obj(mmu.obj2du(c)) is None and c.data is None
    assert mmu._alloc_bytes == 36 and mmu._peak_bytes == 88
    g = mmu.tensor(2)
    t.grad[2] = g
    mmu.free_obj(t)                                     # frees the chain
    assert not mmu._objs and mmu._alloc_bytes == 0


@pytest.mark.parametrize("shape", [(5,), (12,), (2, 3), (12, 14),
                                   (2, 3, 4, 2), (11, 2, 2, 1)], ids=str)
def test_tensor_printer_matches(shape, mmu):
    x = np.random.RandomState(8).standard_normal(shape).astype(np.float32)
    jt, tt = JTensor(*shape), TTensor(*shape, device="cpu")
    jt.set_numpy(x)
    tt.set_numpy(x)
    JAIO.free_io()
    TAIO.free_io()
    jio, tio = JAIO(None), TAIO(None)
    assert tio.marshall(tt) == jio.marshall(jt)
    assert tio.to_s_obj(tt) == jio.to_s_obj(jt)
    assert tio.to_s_obj(tt, view=True) == jio.to_s_obj(jt, view=True)
    assert tio.marshall(None) == "(null)"
