"""Ring attention over the 'sp' axis (parallel/ring.py) on gloo ranks on
the CPU: test_ring.py's three cases against the JAX package's full
attention (`funcs._sdpa_ref`) on the same seeded inputs, under that
test's own bounds (outputs 2e-5, gradients 2e-4).  On the CPU a chunk
takes the einsum branch, as in the JAX package (the flash kernels need a
card: chip_smoke.py's `parallel` phase runs them).  The three cases share
one start of 4 ranks; the dp axis case runs (dp2, sp2) on them where the
JAX test runs (dp2, sp4) on 8 devices."""
import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401

# test_ring.py's bounds
TOL_OUT = dict(rtol=2e-5, atol=2e-5)
TOL_GRAD = dict(rtol=2e-4, atol=2e-4)


def _data(b, s, dh, seed):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal((b, s, dh)).astype(np.float32)
                 for _ in range(3))


def _rank_cases(rank, world):
    """every case on this rank: its shards in, the whole results out"""
    import torch
    from tensorforth_tpu_torch.parallel.mesh import COUNTS, Mesh
    from tensorforth_tpu_torch.parallel.ring import ring_attention
    out = {}
    sp4 = Mesh(("sp",), (4,))
    ch = lambda m, t: m.chunk(torch.from_numpy(t), 1, "sp").contiguous()  # noqa
    for causal in (False, True):
        q, k, v = _data(4, 32, 16, 0)
        before = dict(COUNTS)
        o = ring_attention(ch(sp4, q), ch(sp4, k), ch(sp4, v), sp4, causal)
        hops = {key: COUNTS[key] - before[key] for key in COUNTS}
        out[causal] = (sp4.all_gather(o, 1, "sp"), tuple(o.shape), hops)
    # a dp axis as well: the batch over dp, the sequence over sp
    m = Mesh(("dp", "sp"), (2, 2))
    q, k, v = _data(8, 16, 8, 3)
    part = lambda t: m.chunk(ch(m, t), 0, "dp")  # noqa: E731
    o = ring_attention(part(q), part(k), part(v), m, causal=True)
    out["dp"] = (m.all_gather(m.all_gather(o, 1, "sp"), 0, "dp"),
                 tuple(o.shape))
    # grad through the ring (the hop's transpose is the reverse hop)
    q, k, v = _data(2, 16, 8, 5)
    ql = ch(sp4, q).requires_grad_(True)
    kl = ch(sp4, k).requires_grad_(True)
    vl = ch(sp4, v).requires_grad_(True)
    before = COUNTS["hops"]
    (ring_attention(ql, kl, vl, sp4, True) ** 2).sum().backward()
    out["grad"] = tuple(sp4.all_gather(t.grad, 1, "sp") for t in (ql, kl, vl))
    out["grad_hops"] = COUNTS["hops"] - before
    return out


@pytest.fixture(scope="module")
def ring_runs():
    from tensorforth_tpu_torch.parallel import launch
    return launch.run(_rank_cases, 4)


def _full(q, k, v, causal):
    import jax.numpy as jnp
    from tensorforth_tpu.nn.funcs import _sdpa_ref
    return np.asarray(_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_full(ring_runs, causal):
    """sp4 on [4, 32, 16]: the ranks' outputs put together equal the JAX
    package's attention over the whole sequence; each rank holds its
    [4, 8, 16]; K and V each make 3 hops a rank (the last step keeps its
    chunk) and nothing is gathered"""
    got, shape, hops = ring_runs[causal]
    np.testing.assert_allclose(got.numpy(), _full(*_data(4, 32, 16, 0),
                                                  causal), **TOL_OUT)
    assert shape == (4, 8, 16)
    assert hops["hops"] == 2 * 3 and hops["all_gather"] == 0
    assert hops["hop_bytes"] == 2 * 3 * 4 * 8 * 16 * 4


def test_ring_with_dp_axis(ring_runs):
    """(dp2, sp2): the batch split too; the output keeps the input's
    split (no gather: each rank holds its [4, 8, 8] block)"""
    got, shape = ring_runs["dp"]
    np.testing.assert_allclose(got.numpy(), _full(*_data(8, 16, 8, 3),
                                                  True), **TOL_OUT)
    assert shape == (4, 8, 8)


def test_ring_is_differentiable(ring_runs):
    """autograd through the ring: dq, dk, dv of sum(o^2) against the JAX
    package's gradients of the full attention"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.nn.funcs import _sdpa_ref
    q, k, v = (jnp.asarray(t) for t in _data(2, 16, 8, 5))
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        _sdpa_ref(q_, k_, v_, True) ** 2), argnums=(0, 1, 2))(q, k, v)
    for got, w in zip(ring_runs["grad"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL_GRAD)
    assert ring_runs["grad_hops"] == 2 * 3 * 2   # and each hop's reverse
