"""The port's threefry generator (tensorforth_tpu_torch/ops/rng.py) and
seed stream against the JAX package's: uniform numbers bit for bit,
normal numbers within 2 ulp (the port follows XLA's erfinv to its last
bits almost everywhere; log and log1p differ in rare last bits).
"""
import numpy as np
import pytest

from tensorforth_tpu.ops import rng as jrng
from tensorforth_tpu.system import System as JSystem
from tensorforth_tpu_torch.ops import rng as trng
from tensorforth_tpu_torch.system import System as TSystem

from tests.test_torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 42, 2280545969, 1258627373665771185, 0x7FFFFFFFFFFFFFFF]
SHAPES = [(1,), (7,), (3, 5), (2, 3, 5, 7), (1025,), (64, 33)]


def ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_is_bit_equal(seed, shape):
    for bias, scale in ((0.0, 1.0), (-0.5, 0.37)):
        want = np.asarray(jrng.fill(shape, "uniform", bias, scale, seed))
        got = trng.fill(shape, "uniform", bias, scale, seed).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_within_2_ulp(seed, shape):
    want = np.asarray(jrng.fill(shape, "normal", 0.0, 1.0, seed))
    got = trng.fill(shape, "normal", 0.0, 1.0, seed).numpy()
    assert got.shape == want.shape
    assert ulps(got, want).max() <= 2


def test_normal_over_many_draws():
    want = np.asarray(jrng.fill((1 << 16,), "normal", 0.0, 1.0, 7))
    got = trng.fill((1 << 16,), "normal", 0.0, 1.0, 7).numpy()
    d = ulps(got, want)
    assert d.max() <= 2 and (d > 0).mean() < 1e-3
    assert abs(got.mean()) < 0.02 and abs(got.std() - 1.0) < 0.02


def test_key_keeps_the_low_word_of_a_63_bit_seed():
    import jax
    seed = 1258627373665771185
    assert trng.key_of(seed) == (0, 2280545969)
    assert tuple(int(x) for x in np.asarray(jax.random.PRNGKey(seed))) \
        == trng.key_of(seed)
    # two seeds with the same low word draw the same numbers
    a = trng.fill((5,), "uniform", 0.0, 1.0, seed).numpy()
    b = trng.fill((5,), "uniform", 0.0, 1.0, 2280545969).numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_scalar_and_mask(dist):
    assert trng.scalar(dist, 9) == jrng.scalar(dist, 9)
    np.testing.assert_array_equal(
        trng.uniform_mask((4, 6), 11).numpy(),
        np.asarray(jrng.uniform_mask((4, 6), 11)))
    with pytest.raises(ValueError):
        trng.fill((2,), "cauchy", 0.0, 1.0, 1)


def test_seed_streams_are_equal():
    js, ts = JSystem(), TSystem()
    for s in (42, 0, 0x7FFFFFFF, 123456789012):
        js.seed(s)
        ts.seed(s)
        assert ts.peek_keys(5) == js.peek_keys(5)
        keys = [ts.next_key() for _ in range(5)]
        assert keys == [js.next_key() for _ in range(5)]
        assert ts.peek_keys(1) == js.peek_keys(1)
        assert all(0 <= k < 1 << 63 for k in keys)
        assert ts.rand_scalar("normal") == js.rand_scalar("normal")


def test_rand_fill_gives_the_jax_tensor():
    from tensorforth_tpu.mu.tensor import Tensor as JTensor
    from tensorforth_tpu_torch.mu.tensor import Tensor as TTensor
    js, ts = JSystem(), TSystem()
    js.seed(5)
    ts.seed(5)
    jt, tt = JTensor(6, 10), TTensor(6, 10, device="cpu")
    js.rand_fill(jt, "uniform", bias=-0.5, scale=0.25)
    ts.rand_fill(tt, "uniform", bias=-0.5, scale=0.25)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt.data))
