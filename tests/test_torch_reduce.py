"""The port's CPU reductions against XLA CPU's, bit for bit: `t_sum`,
`t_avg`, `t_std`, `t_norm` (`engine._sum`, `_nvar`), the losses of
`funcs.loss_fn` and the lazy sums of `mu/future.py`, all through
`ops/xla_reduce.py`.  The shapes are the words' and the losses' own:
vectors, rank-4 [N,H,W,C] batches of the t4 scripts, sizes of 32 and
below (one fused loop), and shapes the tree-reduction rewriter cuts into
windows of 32 once or twice.  Each shape draws its tensors from a seed
in three scales and in [0, 1)."""
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401

SUM_SHAPES = [
    (8,), (32,), (33,), (100,), (1000,), (10000,), (2, 3), (2, 1, 4, 1),
    (4, 4), (8, 8), (10, 10), (16, 2), (17, 24), (28, 4), (2, 32, 2),
    (6, 8, 2), (4, 20, 3), (9, 30, 2), (31, 29, 5), (16, 16, 16),
    (24, 4, 4, 4), (2, 3, 4, 5), (64, 64), (100, 10), (40, 40), (128, 128),
    (33, 2, 4), (96, 2, 2), (256, 8), (100, 784), (17, 33, 65),
    (1, 28, 28, 1), (4, 28, 28, 8), (2, 14, 14, 16), (8, 7, 7, 32),
    (64, 3, 3, 2), (50, 1, 1, 10), (32, 16, 16, 1), (100, 28, 28, 1),
    (100, 1, 1, 1)]
# tensors per shape: 330 where a tensor is cheap to replay, fewer where
# the fused (x - mu) ** 2 loop is long; 10,160 in all
_HEAVY = {(10000,): 60, (100, 784): 40, (100, 28, 28, 1): 20,
          (4, 28, 28, 8): 40, (32, 16, 16, 1): 40, (16, 16, 16): 60,
          (17, 33, 65): 60, (128, 128): 60, (8, 7, 7, 32): 60,
          (2, 14, 14, 16): 60, (31, 29, 5): 120}


def _tensors(shape, n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        if i % 4 == 3:
            yield rng.random(shape).astype(np.float32)
        else:
            scale = (1e-3, 1.0, 100.0)[i % 4]
            yield (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits(v):
    return np.float32(v).view(np.int32)


def test_the_shapes_and_counts_cover_the_stated_ground():
    counts = [_HEAVY.get(s, 330) for s in SUM_SHAPES]
    assert len(SUM_SHAPES) == 40 and sum(counts) >= 10_000


@pytest.mark.parametrize("shape", SUM_SHAPES,
                         ids=["x".join(map(str, s)) for s in SUM_SHAPES])
def test_sum_and_nvar_are_xla_cpu_bits(shape):
    import jax.numpy as jnp
    from tensorforth_tpu.ops import engine as je
    from tensorforth_tpu_torch.ops import engine as pe
    bad = []
    for i, x in enumerate(_tensors(shape, _HEAVY.get(shape, 330),
                                   len(shape) * 1000 + int(np.prod(shape)))):
        t, j = torch.from_numpy(x), jnp.asarray(x)
        mu = np.float32(pe.t_avg(t))
        pairs = [(pe.t_sum(t), je._sum(j)),
                 (pe._nvar(t, mu), je._nvar(j, mu))]
        for k, (got, want) in enumerate(pairs):
            if _bits(got) != _bits(want):
                bad.append((i, ("sum", "nvar")[k], got, float(want)))
    assert not bad, bad[:5]


@pytest.mark.parametrize("word", ["sum", "avg", "std", "norm"])
def test_the_words_functions_match_jax(word):
    """t_avg/t_std/t_norm are t_sum/_nvar taken on the host as the JAX
    package takes them"""
    import jax.numpy as jnp
    from tensorforth_tpu.ops import engine as je
    from tensorforth_tpu_torch.ops import engine as pe
    for shape in [(64, 64), (1, 100, 10, 1), (2, 1, 4, 1), (3, 5)]:
        for x in _tensors(shape, 20, 7):
            got = getattr(pe, f"t_{word}")(torch.from_numpy(x))
            want = getattr(je, f"t_{word}")(jnp.asarray(x))
            assert got == want, (word, shape, got, want)


LOSS_SHAPES = [(2, 4), (2, 1, 4, 1), (4, 10), (100, 10), (3,), (1, 1),
               (5, 3), (8, 1), (10, 1), (16, 1), (24, 1), (32, 1), (33, 1),
               (64, 1), (100, 1), (16, 2), (4, 8), (12, 2), (2, 10),
               (4, 4, 2), (2, 4, 4), (4, 2, 4), (8, 28, 28, 1),
               (2, 28, 28, 1), (32,), (25, 1), (26, 1), (27, 1)]


@pytest.mark.parametrize("shape", LOSS_SHAPES,
                         ids=["x".join(map(str, s)) for s in LOSS_SHAPES])
def test_loss_fn_is_xla_cpu_bits(shape):
    """every loss over one-hot, 0/1 and [0, 1) targets and outputs that
    are [0, 1) or rows that sum to 1"""
    import jax.numpy as jnp
    from tensorforth_tpu.nn import funcs as jf
    from tensorforth_tpu_torch.nn import funcs as pf
    rng = np.random.default_rng(sum(shape) * 31 + len(shape))
    bad = []
    for i in range(12):
        o = rng.random(shape).astype(np.float32)
        if i % 2:
            rows = o.reshape(shape[0], -1)
            o = (rows / rows.sum(-1, keepdims=True)).reshape(shape).astype(
                np.float32)
        if i % 3 == 0:
            flat = np.zeros((shape[0], int(np.prod(shape[1:]))), np.float32)
            flat[np.arange(shape[0]), rng.integers(0, flat.shape[1],
                                                   shape[0])] = 1
            t = flat.reshape(shape)
        elif i % 3 == 1:
            t = (rng.random(shape) > 0.5).astype(np.float32)
        else:
            t = rng.random(shape).astype(np.float32)
        for op in ("mse", "bce", "ce", "nll"):
            got = pf.loss_fn(op, torch.from_numpy(o), torch.from_numpy(t))
            want = jf.loss_fn(op, jnp.asarray(o), jnp.asarray(t))
            if _bits(got) != _bits(want):
                bad.append((i, op, float(got), float(want)))
    assert not bad, bad[:5]


@pytest.mark.parametrize("n", range(1, 41))
def test_bce_is_xla_cpu_bits_for_1_to_40_elements(n):
    """loss.bce over n = 1..40 elements, as a column [n, 1] and a vector,
    bit for bit (ROADMAP C9: 28 to 31 are the unrolled loop's 4 lanes)"""
    import jax.numpy as jnp
    from tensorforth_tpu.nn import funcs as jf
    from tensorforth_tpu_torch.nn import funcs as pf
    rng = np.random.default_rng(1000 + n)
    bad = []
    for shape in ((n, 1), (n,)):
        for i in range(10):
            o = rng.random(shape).astype(np.float32)
            t = ((rng.random(shape) > 0.5).astype(np.float32) if i % 2
                 else rng.random(shape).astype(np.float32))
            got = pf.loss_fn("bce", torch.from_numpy(o), torch.from_numpy(t))
            want = jf.loss_fn("bce", jnp.asarray(o), jnp.asarray(t))
            if _bits(got) != _bits(want):
                bad.append((shape, i, float(got), float(want)))
    assert not bad, bad[:5]


def test_lazy_sums_are_xla_cpu_bits():
    """a Future's lazy sum of per-batch losses collapses in XLA's order
    (the JAX package sums the same vector with jnp.sum)"""
    import jax.numpy as jnp
    from tensorforth_tpu_torch.mu import future
    for n in (5, 32, 33, 100, 600):
        for x in _tensors((n,), 10, n):
            lz = [future.LazyIdx(torch.from_numpy(x), i) for i in range(n)]
            got = future._collapse_lazy(0.0, [], lz)
            assert _bits(got) == _bits(jnp.sum(jnp.asarray(x)))


def test_cuda_tensors_keep_the_torch_ops():
    """the replay is for CPU tensors; on the card `xla_sum` is torch.sum
    (checked on a `meta` tensor, which reaches the same branch)"""
    from tensorforth_tpu_torch.ops import xla_reduce
    x = torch.empty(4, 4, device="meta")
    assert xla_reduce.xla_sum(x).device.type == "meta"
