"""Faults of the port against the JAX package, each repaired and held here
on the CPU by running the same call through both packages:

  C3  inverse / luinv of a singular matrix print NaN and leave A A'
  C4  det takes jnp.linalg.det's route: its bits at 2, 3, 4 and 6, and
      +0 for a singular 2x2
  C5  exp, log, log10, tanh and the logistic are XLA CPU's f32 routines,
      bit for bit (ops/xla_math.py), and the words print the same digits
  C6  forward, backprop and loss given bad input print through _err and
      carry on (tests/test_torch_model_errors.py)

  C9  the relu layer and the relu word give XLA's +0 for -0, negatives,
      NaN (the layer) and subnormals, bit for bit, sign included

C2, the sampled tokens of generate, is in tests/test_torch_serve.py.
"""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.ops import linalg as jlinalg
from tensorforth_tpu_torch.ops import linalg as tlinalg
from tensorforth_tpu_torch.ops import xla_math

from tests.test_torch_threads import one_torch_thread  # noqa: F401

F32_MIN = np.float32(1.17549435e-38)


@pytest.fixture()
def t4p():
    """the port's REPL on the CPU, writing to a capture buffer"""
    from tensorforth_tpu_torch.cli import TensorForth
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    os.environ.setdefault("T4_SEED", "42")
    System.free_sys()
    MMU.free_mmu()
    Debug.free_db()
    AIO.free_io()
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device="cpu")

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    inst.forth = run
    yield inst
    inst.teardown()


# --- C3 ---------------------------------------------------------------------
@pytest.mark.parametrize("word", ["inverse", "luinv"])
@pytest.mark.parametrize("mat", ["1 2 2 4", "0 0 0 0"])
def test_singular_inverse_prints_nan_and_keeps_both(t4, t4p, word, mat):
    line = f"2 2 matrix{{ {mat} }} {word} ."
    want = t4.forth(line)
    got = t4p.forth(line)
    assert got == want
    assert "nan" in got and "ERROR" not in got
    # the stack keeps A (the printed A' was dropped): the same depth
    assert t4p.forth(".s") == t4.forth(".s")


def test_inverse_of_a_singular_matrix_is_nan_and_does_not_raise():
    for a in ([[1.0, 2.0], [2.0, 4.0]], [[0.0, 0.0], [0.0, 0.0]]):
        x = tlinalg.inverse(torch.tensor(a))
        want = np.asarray(jlinalg.inverse(jnp.asarray(a, jnp.float32)))
        assert torch.isnan(x).all() and np.isnan(want).all()


# --- C4 ---------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 3, 4, 6])
def test_det_is_bit_equal(n):
    """2000 randn matrices a size: the closed forms at 2 and 3 with XLA
    CPU's fused multiply-adds, the LU route above (sgetrf, the row of
    logs summed in order, sign * exp)"""
    a = np.random.RandomState(n).randn(2000, n, n).astype(np.float32)
    want = np.array([np.float32(jlinalg.det(jnp.asarray(m))) for m in a])
    got = np.array([np.float32(tlinalg.det(torch.from_numpy(m))) for m in a])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mat,n", [("1 2 2 4", 2), ("1 2 3 4", 2),
                                   ("1 2 3 4 5 6 7 8 10", 3),
                                   ("2 0 0 0 0 3 0 0 0 0 4 0 0 0 0 5", 4)])
def test_det_word_prints_as_the_reference(t4, t4p, mat, n):
    """a singular 2x2 prints 0 (torch.linalg.det gave -0)"""
    line = f"{n} {n} matrix{{ {mat} }} det ."
    assert t4p.forth(line) == t4.forth(line)
    if mat == "1 2 2 4":
        assert "-0" not in t4p.forth(line)


# --- C5 ---------------------------------------------------------------------
def _inputs(n=120_000, seed=0):
    """randn and wide uniforms, all bit patterns at random (NaNs,
    infinities and subnormals among them), and the edges: signed zeros,
    subnormals, infinities, NaN, exp's overflow and underflow thresholds,
    tanh's clamp and small-argument switch"""
    rs = np.random.RandomState(seed)
    parts = [rs.randn(n // 4).astype(np.float32) * 3,
             rs.uniform(-100, 100, n // 4).astype(np.float32),
             rs.randint(0, 2 ** 32, n // 4, dtype=np.uint64).astype(
                 np.uint32).view(np.float32),
             rs.uniform(0, 2, n // 4).astype(np.float32)]
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40,
            -1e-40, F32_MIN, -F32_MIN, 88.72, 88.7228, 88.73, 88.8, 89.0,
            -87.33, -87.34, -87.8, -88.0, -103.9, -104.0, 7.99, -7.99,
            7.9998, 8.0, 9.0, 0.0004, -0.0004, 0.00039, 20.0, -20.0, 1.0,
            -1.0, 3.4e38, -3.4e38]
    around = np.array(edge[11:], np.float32)
    near = np.concatenate([np.nextafter(around, np.float32(np.inf)),
                           np.nextafter(around, np.float32(-np.inf))])
    return np.concatenate(parts + [np.array(edge, np.float32), near])


OPS = {"exp": (xla_math.exp, jnp.exp), "log": (xla_math.log, jnp.log),
       "log10": (xla_math.log10, jnp.log10),
       "tanh": (xla_math.tanh, jnp.tanh),
       "logistic": (xla_math.logistic, jax.nn.sigmoid),
       "sqrt": (xla_math.sqrt, jnp.sqrt), "sin": (xla_math.sin, jnp.sin),
       "cos": (xla_math.cos, jnp.cos)}


def _pow_inputs(x, seed=1):
    """exponents for the bases `x`: randn, small integers (negative
    bases with integer exponents among them), all bit patterns at
    random, the edges; then subnormal bases of both signs against
    randn, integer and edge exponents"""
    rs = np.random.RandomState(seed)
    n = x.size
    y = np.concatenate([
        rs.randn(n // 3).astype(np.float32) * 4,
        rs.randint(-8, 9, n // 3).astype(np.float32),
        rs.randint(0, 2 ** 32, n - 2 * (n // 3), dtype=np.uint64).astype(
            np.uint32).view(np.float32)])
    rs.shuffle(y)
    y[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 2.0 ** 24, 0.5]
    sub = np.concatenate([
        rs.randint(1, 0x800000, 3000).astype(np.uint32),
        rs.randint(0x80000001, 0x80800000, 3000).astype(np.uint32)]
    ).view(np.float32)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 3e38,
                     -3e38, 2.0 ** 24, 2.0 ** 24 + 2, 0.5, 3.0], np.float32)
    ys = np.concatenate([rs.randn(2000).astype(np.float32) * 3,
                         rs.randint(-9, 10, 2000).astype(np.float32),
                         np.resize(edge, 2000)])
    return np.concatenate([x, sub]), np.concatenate([y, ys])


@pytest.mark.parametrize("op", list(OPS) + ["pow"])
def test_transcendentals_are_xla_cpu_bits(op):
    x = _inputs()
    assert x.size >= 100_000
    if op == "pow":
        x, y = _pow_inputs(x)
        with np.errstate(invalid="ignore"):
            assert ((x < 0) & (y == np.trunc(y)) & (y != 0)).sum() > 10_000
        got = xla_math.pow(torch.from_numpy(x.copy()),
                           torch.from_numpy(y.copy())).numpy()
        want = np.asarray(jax.jit(jnp.power)(x, y))
    else:
        mine, ref = OPS[op]
        got = mine(torch.from_numpy(x.copy())).numpy()
        want = np.asarray(jax.jit(ref)(x))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fma_rounds_once():
    """xla_math.fma against exact rational arithmetic, halfway cases of
    the f64 sum included"""
    from fractions import Fraction
    rs = np.random.RandomState(3)
    a = rs.randn(3000).astype(np.float32)
    b = rs.randn(3000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)   # cancellation
    c[::2] = rs.randn(1500).astype(np.float32) * 1e-3
    got = xla_math.fma(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a[:400], b[:400], c[:400], got[:400]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.uint32)) & 1))
        assert g == best or abs(Fraction(float(g)) - exact) == abs(
            Fraction(float(best)) - exact)


def test_cuda_tensors_take_the_torch_ops():
    """off the CPU (and for other dtypes) each function is the torch op"""
    x = torch.linspace(-3, 3, 11, dtype=torch.float64)
    for op, f in (("exp", torch.exp), ("log", torch.log),
                  ("tanh", torch.tanh), ("logistic", torch.sigmoid),
                  ("sqrt", torch.sqrt), ("sin", torch.sin),
                  ("cos", torch.cos)):
        arg = x.abs() + 0.1 if op in ("log", "sqrt") else x
        torch.testing.assert_close(OPS[op][0](arg), f(arg), rtol=0, atol=0)
    torch.testing.assert_close(xla_math.pow(x.abs(), x), torch.pow(
        x.abs(), x), rtol=0, atol=0)


@pytest.mark.parametrize("word", ["exp", "ln", "log", "tanh", "sigm",
                                  "sqrt", "sin", "cos"])
def test_words_print_the_references_digits(t4, t4p, word):
    """e^4 printed +54.5981 in the port before"""
    line = f"2 3 matrix{{ 1 2 3 4 0.5 7.25 }} {word} ."
    assert t4p.forth(line) == t4.forth(line)
    line = f"4 3 matrix randn {word} ."
    assert t4p.forth(line) == t4.forth(line)


@pytest.mark.parametrize("v", [2.0, 3.0, -1.0, 0.5, 0.0, 1.7, -3.0])
def test_engine_pow_is_the_references(v):
    """the tensor map op `pow` (no word reaches it; the `pow` word is the
    scalar ALU's) against the JAX package's engine, bit for bit"""
    from tensorforth_tpu.ops import engine as jengine
    from tensorforth_tpu_torch.ops import engine as pengine
    x = _inputs(20_000, seed=5)
    got = pengine.map_op("pow", torch.from_numpy(x.copy()), v).numpy()
    want = np.asarray(jengine.map_op("pow", x, v))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _relu_inputs():
    rs = np.random.RandomState(9)
    x = rs.standard_normal(256).astype(np.float32)
    x[:16] = [-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-40, -1e-40,
              F32_MIN, -F32_MIN, 1.0, -1.0, 3e-39, -3e-39, 0.5, -0.5]
    return x.reshape(4, 8, 8, 1)


def test_relu_layer_is_xlas_bits_sign_included():
    """C9: the port's x * (x > 0) gave -0 where XLA's select gives +0 (t4_30d
    layer 3: 112 of 256 values); the mask stays (x > 0)"""
    from tensorforth_tpu.nn import funcs as jf
    from tensorforth_tpu.nn.ntypes import Layer
    from tensorforth_tpu_torch.nn import funcs as pf
    x = _relu_inputs()
    jy, jm = jax.jit(lambda v: jf._activate_fwd(Layer.RELU, v, 0.0))(
        jnp.asarray(x))
    py, pm = pf._activate_fwd(Layer.RELU, torch.from_numpy(x), 0.0)
    np.testing.assert_array_equal(py.numpy().view(np.uint32),
                                  np.asarray(jy).view(np.uint32))
    assert not np.signbit(py.numpy()).any()
    np.testing.assert_array_equal(pm.numpy(), (x > 0).astype(np.float32))


def test_relu_word_is_xlas_bits_sign_included():
    """C9: the `relu` word is jnp.maximum(x, 0): NaN passes, -0 and
    subnormals give +0"""
    from tensorforth_tpu.ops import engine as jengine
    from tensorforth_tpu_torch.ops import engine as pengine
    x = _relu_inputs()
    want = np.asarray(jengine._map_op("relu", jnp.asarray(x), 0.0))
    got = pengine._MAP["relu"](torch.from_numpy(x), 0.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
