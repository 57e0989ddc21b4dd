"""The port's dp/tp mesh (parallel/mesh.py, parallel/trainer.py) on gloo
ranks on the CPU, against one rank and against the JAX package:
test_parallel.py's dp/tp cases (its `nn.train` case and the word path
under T4_MESH are in test_torch_word_mesh.py).  Each case starts its ranks with
parallel/launch.py (4 processes at most, small shapes); a rank's result
comes back from rank 0.  The sharded step is held to the one-rank step
within TOL_STEP: the dp ranks sum their gradients in another order than
one rank sums the batch, and nothing else differs (the tp shards are
all-gathered exactly)."""
import numpy as np
import pytest
import torch

from tests.test_torch_threads import one_torch_thread  # noqa: F401

# gradients and updated weights of a dp/tp step against one rank's, and
# one rank's against the JAX package's step (f32 sums in other orders)
TOL_STEP = dict(rtol=2e-5, atol=2e-6)


def _mnist(batch):
    """t4_30e's model with weights from a seed (every rank makes the same)"""
    from tensorforth_tpu_torch.models import zoo
    m = zoo.mnist_cnn(batch=batch, device="cpu")
    rs = np.random.RandomState(0)
    for pl in m._params():
        for w in pl:
            fan_in = int(np.prod(w.shape[:-1] if w.dim() == 4 else
                                 w.shape[1:])) if w.dim() > 1 else 1
            v = 0.1 * rs.standard_normal(tuple(w.shape)) / np.sqrt(fan_in)
            w.copy_(torch.from_numpy(v.astype(np.float32)))
    return m


def _batch(n, seed):
    x = np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)
    y = np.zeros((n, 1, 10, 1), np.float32)
    y[np.arange(n), 0, np.arange(n) % 10, 0] = 1.0
    return torch.from_numpy(x), torch.from_numpy(y)


def _rank_mesh(rank, world):
    from tensorforth_tpu_torch.parallel import mesh as pm
    m = pm.make_mesh()
    return dict(shape=m.shape, axes=m.axis_names, at=(m.dp_idx, m.tp_idx),
                over=pm.mesh_from_spec("dp8"), none=pm.mesh_from_spec(""),
                dp4=pm.mesh_from_spec("dp4").shape,
                dp2tp2=pm.mesh_from_spec("dp2,tp2").shape)


def test_mesh_shapes():
    """make_mesh on 4 ranks: dp 2, tp 2 (tp the largest power of two <=
    sqrt(n)); a spec needing more ranks than the group has is None"""
    from tensorforth_tpu_torch.parallel import launch, mesh as pm
    r = launch.run(_rank_mesh, 4)
    assert r["shape"] == (2, 2) and r["axes"] == ("dp", "tp")
    assert r["at"] == (0, 0)
    assert r["over"] is None and r["none"] is None
    assert r["dp4"] == (4, 1) and r["dp2tp2"] == (2, 2)
    assert pm.mesh_from_spec("dp2") is None      # one process, no group


def _rank_learn(rank, world, spec):
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    tr = ShardedTrainer(_mnist(16), pm.mesh_from_spec(spec), loss="ce",
                        lr=1e-2)
    x, y = _batch(16, 0)
    return [tr.step(x, y, seed=i) for i in range(8)]


def test_sharded_train_step_runs_and_learns():
    from tensorforth_tpu_torch.parallel import launch
    losses = launch.run(_rank_learn, 4, "dp2,tp2")
    assert losses[-1] < losses[0], f"no learning: {losses}"


def _rank_forward(rank, world, spec):
    """the forward on the rank's dp rows with the all-gathered tp shards"""
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.trainer import _forward_pure
    model = _mnist(8)
    mesh = pm.mesh_from_spec(spec)
    prog = model._program()
    local = pm.shard_params(model._params(), prog, mesh)
    x, _ = _batch(8, 1)
    out = _forward_pure(prog, pm.shard_batch(x, mesh),
                        pm.gather_params(local, prog, mesh), rng.PRNGKey(0))
    return mesh.all_gather(out, 0, axis="dp")


@pytest.mark.parametrize("spec", ["dp2", "dp2,tp2"])
def test_sharded_matches_single_device(spec):
    """the dp/tp forward equals the one-rank forward"""
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import launch
    from tensorforth_tpu_torch.parallel.trainer import _forward_pure
    model = _mnist(8)
    x, _ = _batch(8, 1)
    ref = _forward_pure(model._program(), x, model._params(),
                        rng.PRNGKey(0))
    out = launch.run(_rank_forward, 4 if "tp" in spec else 2, spec)
    # test_parallel's bounds: a GEMM over 4 rows sums in another order
    # than over 8 on the CPU
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL_STEP)


def _rank_step(rank, world, spec, remat):
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    tr = ShardedTrainer(_mnist(8), pm.mesh_from_spec(spec), remat=remat)
    x, y = _batch(8, 3)
    lval, grads = tr.grads(x, y, rng.PRNGKey(0))
    tr.step(x, y)
    return float(lval), grads, tr.full_params()


def _one_rank_step(remat=False):
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel.trainer import (_grads,
                                                        init_opt_state,
                                                        make_train_step)
    model = _mnist(8)
    prog, params = model._program(), model._params()
    x, y = _batch(8, 3)
    lval, grads = _grads(prog, params, x, y, rng.PRNGKey(0), "ce", remat)
    p, _s, _l = make_train_step(prog, remat=remat)(
        params, init_opt_state(params), x, y, rng.PRNGKey(0))
    return float(lval), grads, p


@pytest.mark.parametrize("spec", ["dp2", "dp2,tp2"])
def test_sharded_step_matches_one_rank(spec):
    """a dp/tp step: the global loss, the gradient summed over dp and the
    updated (all-gathered) weights against one rank's step"""
    from tensorforth_tpu_torch.parallel import launch
    l1, g1, p1 = _one_rank_step()
    l2, g2, p2 = launch.run(_rank_step, 4 if "tp" in spec else 2, spec,
                            False)
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for a, b in zip([w for gl in g1 for w in gl], [w for gl in g2 for w in gl]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL_STEP)
    for a, b in zip([w for pl in p1 for w in pl], [w for pl in p2 for w in pl]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL_STEP)


def test_remat_train_step_matches():
    """torch.utils.checkpoint's step makes the same update, and the
    one-rank step is the JAX package's make_train_step within TOL_STEP"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.parallel.trainer import (
        init_opt_state as j_init, make_train_step as j_step)
    l1, _g, p1 = _one_rank_step(remat=False)
    l2, _g, p2 = _one_rank_step(remat=True)
    assert l1 == l2
    for a, b in zip([w for pl in p1 for w in pl], [w for pl in p2 for w in pl]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    model = _mnist(8)
    params = tuple(tuple(jnp.asarray(w.detach().numpy()) for w in pl)
                   for pl in model._params())
    x, y = _batch(8, 3)
    jp, _s, jl = j_step(model._program(), jit=False)(
        params, j_init(params), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jl), l1, rtol=1e-6)
    for a, b in zip([w for pl in jp for w in pl], [w for pl in p1 for w in pl]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL_STEP)
