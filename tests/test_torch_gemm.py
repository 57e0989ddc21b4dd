"""The GEMM wrappers of the port (tensorforth_tpu_torch/ops/gemm.py)
against the JAX package's Pallas GEMM kernels, on the CPU.

On CPU tensors the port's wrappers use their kernels' plain versions; the
CUDA kernels themselves are held against those plain versions on the card
by chip_smoke.py.  The JAX side runs as its own tests run it on the CPU:
`_mm_pallas(..., interpret=True)` for the f32-I/O kernel; the manual-DMA
kernels (`_mm_pallas_v8`, `_mm_pallas_db`) cannot run here at all, and in
interpret mode a `default` dot is a full f32 dot, so the bf16 classes are
held against the oracle the reference names for them:
`jnp.dot(a.astype(bf16), b.astype(bf16), preferred_element_type=f32)`.
Tolerances are relative to the largest value of an f64 product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.ops import engine as jengine
from tensorforth_tpu.ops.gemm_pallas import _mm_pallas
from tensorforth_tpu_torch.config import Config
from tensorforth_tpu_torch.ops import gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(300, 200, 260), (128, 256, 128), (37, 53, 29), (2, 3, 2),
          (1, 1, 1)]                                     # m, k, n
TOL_BF16 = 1e-5      # only the order of the f32 sums differs
TOL_3PASS = 2e-5     # the classes' accuracy against f64
TOL_HIGHEST = 5e-6   # (tests/test_gemm_prec.py)


def operands(m, k, n, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.standard_normal((m, k)).astype(np.float32)
    b = rs.standard_normal((k, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return a, b, ref, np.abs(ref).max()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def bf16_oracle(a, b):
    return np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.bfloat16),
                              jnp.asarray(b).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("prec,tol", [("3pass", TOL_3PASS),
                                      ("highest", TOL_HIGHEST)])
def test_mm_f32_classes_match_pallas_interpret(shape, prec, tol):
    a, b, ref, top = operands(*shape, seed=1)
    got = gemm._mm(T(a), T(b), prec=prec).numpy()
    want = np.asarray(_mm_pallas(jnp.asarray(a), jnp.asarray(b),
                                 128, 128, 128, prec=prec, interpret=True))
    assert got.shape == want.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * top
    assert np.abs(want - ref).max() <= tol * top
    assert np.abs(got - want).max() <= TOL_3PASS * top


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("which", ["default", "bf16", "v8", "db"])
def test_bf16_classes_match_the_bf16_dot(shape, which):
    a, b, _, top = operands(*shape, seed=2)
    scale = 1.0 / max(shape)
    got = {"default": lambda: gemm._mm(T(a), T(b), prec="default"),
           "bf16": lambda: gemm._mm(T(a), T(b), bf16=True, prec="highest"),
           "v8": lambda: gemm._mm_v8(T(a), T(b), scale),
           "db": lambda: gemm._mm_db(T(a), T(b))}[which]().numpy()
    want = bf16_oracle(a, b) * (scale if which == "v8" else 1.0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL_BF16 * top * (
        scale if which == "v8" else 1.0)


def test_mm_bf16_matches_pallas_bf16_kernel_on_exact_inputs():
    """on operands that bf16 holds exactly, the interpreted bf16 kernel
    rounds nothing away and both sides are the same sums"""
    rs = np.random.RandomState(3)
    a = rs.randint(-8, 9, (200, 160)).astype(np.float32) / 4
    b = rs.randint(-8, 9, (160, 136)).astype(np.float32) / 4
    got = gemm._mm(T(a), T(b), bf16=True).numpy()
    want = np.asarray(_mm_pallas(jnp.asarray(a), jnp.asarray(b), 128, 128,
                                 128, bf16=True, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_default_class_really_rounds_to_bf16():
    """guards the plain version against becoming a full f32 product"""
    a, b, ref, top = operands(256, 384, 256, seed=4)
    err = np.abs(gemm._mm(T(a), T(b), prec="default").numpy() - ref).max()
    err3 = np.abs(gemm._mm(T(a), T(b), prec="3pass").numpy() - ref).max()
    assert err > 1e-4 * top and err > 20 * err3


@pytest.mark.parametrize("variant", [2, 3, 4])
@pytest.mark.parametrize("precision", ["fast", "strict"])
def test_mm_variants(monkeypatch, variant, precision):
    monkeypatch.setattr(Config, "PRECISION", precision)
    a, b, ref, top = operands(130, 70, 90, seed=5)
    got = gemm.mm(T(a), T(b), variant, scale=0.25).numpy()
    if variant == 4 or precision == "fast":
        assert np.abs(got - 0.25 * bf16_oracle(a, b)).max() <= TOL_BF16 * top
    else:
        assert np.abs(got - 0.25 * ref).max() <= TOL_3PASS * top
    with pytest.raises(ValueError):
        gemm.mm(T(a), T(b), 5)


@pytest.mark.parametrize("variant", [2, 3, 4])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_epilogue_and_transposes(monkeypatch, variant, ta, tb):
    """alpha * op(A) @ op(B) + beta * C against engine._gemm_xla of the
    JAX package; gemm2 and gemm3 in the strict class, which is f32-class
    on both sides, gemm4 on bf16-exact operands"""
    monkeypatch.setattr(Config, "PRECISION", "strict")
    rs = np.random.RandomState(6)
    m, k, n = 50, 34, 42
    a = rs.randint(-8, 9, (k, m) if ta else (m, k)).astype(np.float32) / 4
    b = rs.randint(-8, 9, (n, k) if tb else (k, n)).astype(np.float32) / 4
    c = rs.standard_normal((m, n)).astype(np.float32)
    got = gemm.gemm(T(a), T(b), T(c), 0.5, -1.5, ta, tb, variant).numpy()
    want = np.asarray(jengine._gemm_xla(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.float32(0.5),
        jnp.float32(-1.5), ta, tb))
    assert np.abs(got - want).max() <= TOL_3PASS * np.abs(want).max()


def test_prec_class_resolution(monkeypatch):
    """'fast' keeps the bf16 class and 'strict' asks for the 3-pass
    split, as T4_PRECISION=strict resolves in the JAX package (its
    'high' default maps onto '3pass')"""
    from tensorforth_tpu.ops.gemm_pallas import _prec_class
    monkeypatch.setattr(Config, "PRECISION", "fast")
    assert gemm.prec_class() == _prec_class() == "default"
    monkeypatch.setattr(Config, "PRECISION", "strict")
    with jax.default_matmul_precision("high"):
        assert gemm.prec_class() == _prec_class() == "3pass"
    with pytest.raises(ValueError):
        gemm._mm(torch.ones(2, 2), torch.ones(2, 2), prec="high")


def test_launch_counters_stay_zero_on_the_cpu():
    gemm.reset_launches()
    a = torch.ones(4, 4)
    gemm._mm(a, a), gemm._mm(a, a, bf16=True), gemm._mm_v8(a, a)
    gemm._mm_db(a, a)
    assert gemm.launches == {"mm_f32io": 0, "mm_bf16": 0, "mm_v8": 0,
                             "mm_db": 0, "mm_round": 0}


def test_pad_to_tile_multiples():
    x = torch.arange(6.0).reshape(2, 3)
    p = gemm._pad_to(x, 4, 4)
    assert p.shape == (4, 4) and torch.equal(p[:2, :3], x)
    assert p.sum() == x.sum()
    assert gemm._pad_to(x, 2, 3) is x
