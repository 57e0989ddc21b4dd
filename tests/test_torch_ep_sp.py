"""The ep and sp mesh axes and the word path's partition (C10) on gloo
ranks on the CPU, against the JAX package on the same seeded inputs:

* test_pipeline.py's expert-parallel case and test_moe_pipe.py's
  dispatch one: `moe_fwd` and `moe_fwd_dispatch` over `make_ep_mesh` (a
  rank's experts, the whole gates, the partial outputs summed) against
  the JAX package's replicated functions, under those tests' bounds;
* test_moe_pipe.py's `nn.train` under T4_MESH=dp2,ep4, here ep4 on four
  ranks (the JAX test's eight need eight processes), against the JAX
  package's unsharded run from the same weights, under its bounds; a
  rank holds a quarter of the experts' bytes;
* test_parallel.py's sequence-parallel forward: tiny_transformer over
  make_mesh3(dp1, sp2, tp2) against the JAX package's forward on one
  device, and a (dp2, sp2) step's loss and gradients against one rank;
* C10: inside a dp2,tp2 rank of the word loop, the split layers'
  weights, gradients and Adam moments are the rank's tp shards and the
  stashed outputs and masks its dp rows, gathered whole where a word
  reads them.

The cases share one start of 4 ranks."""
import os

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401

# test_pipeline.py's expert-parallel bounds
TOL_EP_FWD = dict(rtol=2e-5, atol=2e-6)
TOL_EP_GRAD = dict(rtol=5e-4, atol=5e-5)
TOL_DISPATCH = dict(rtol=2e-5, atol=2e-5)     # test_moe_pipe.py's
# test_moe_pipe.py's nn.train under ep: the loss and the weights
EP_LOSS_RTOL, TOL_EP_W = 1e-4, dict(rtol=2e-4, atol=2e-5)
TOL_SP = dict(rtol=2e-5, atol=2e-6)           # test_parallel.py's
# a (dp2, sp2) step against one rank: the sums over ranks in another order
TOL_SP_STEP = dict(rtol=2e-5, atol=2e-6)


def _moe_rand(seed, n=4, t=16, d=8, e=4, f=16):
    """test_moe_pipe.py's _moe_rand on numpy"""
    rs = np.random.RandomState(seed)
    return (rs.randn(n, t, d).astype(np.float32),
            (rs.randn(e, d) * 0.3).astype(np.float32),
            (rs.randn(e, d, f) * 0.2).astype(np.float32),
            (rs.randn(e, f, d) * 0.2).astype(np.float32))


def _ep_case():
    rng = np.random.RandomState(7)
    n, t, d, f, e = 4, 6, 8, 16, 8
    return (rng.randn(n, t, d).astype(np.float32),
            (rng.randn(e, d) * 0.3).astype(np.float32),
            (rng.randn(e, d, f) * 0.3).astype(np.float32),
            (rng.randn(e, f, d) * 0.3).astype(np.float32))


def _moe_data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(16, 8, 16, 1).astype(np.float32), rs.randint(0, 4, 16))


JAX_TEST_SEED = 42
# the seed whose run changes one token's top-2 route in its 4th step
ROUTE_SEED = 2


def _excess(got, want, rtol):
    """the largest |got - want| - rtol |want| over every weight (what
    test_moe_pipe's bound holds to its atol)"""
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(c))
                            - rtol * np.abs(np.asarray(c))))
               for gl, wl in zip(got, want) for a, c in zip(gl, wl))


def _ep_train(params, data, labels):
    """nn.train over tiny_moe from `params` under T4_MESH=ep4: (loss,
    weights)"""
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn.train import train_epochs
    os.environ["T4_MESH"] = "ep4"
    m = zoo.tiny_moe(batch=8, device="cpu")
    weights.load_jax_params(m, params)
    loss = train_epochs(m, _DS(data, labels, 8), lr=0.01, epochs=2)
    os.environ.pop("T4_MESH")
    return loss, [tuple(w.clone() for w in pl) for pl in m._params()]


def _gather_backward_without_its_sum(ctx, g):
    """mesh._Gather's backward with its sum over the axis left out: a
    fault (each rank keeps its own cotangent of the gathered router
    scores)"""
    return (ctx.mesh.chunk(g.contiguous(), ctx.dim, ctx.axis).contiguous(),
            None, None, None)


class _Corpus:
    def __init__(self, data, labels):
        self._d, self._l = data, labels
        self.size = data.shape[0]

    def _read(self, s, n):
        return self._d[s:s + n], self._l[s:s + n]


class _DS:
    def __init__(self, data, labels, batch):
        self._corpus = _Corpus(data, labels)
        self.batch_sz = batch
        self._mean, self._scale = 0.0, 1.0


C10_NET = """0 trace
8 28 28 1 nn.model
flatten 16 linear relu 10 linear softmax
constant cm
cm batchsize dataset mnist_train constant cmd
variable cmh 0 cmh ! variable cml
: cmep for forward loss.ce cml ! nn.hit cmh +! backprop 0.001 nn.adam next ;
cmd rewind drop cm cmd cmep drop"""


def _rank_cases(rank, world, moe_params, tr_params, route_params):
    import torch
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel import moe
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    out = {}
    # --- moe_fwd and the dispatch route over ep4
    mesh = moe.make_ep_mesh(4)
    x, wr, w1, w2 = (torch.from_numpy(a) for a in _ep_case())
    swr, sw1, sw2 = moe.shard_experts(mesh, wr, w1, w2)
    sw1.requires_grad_(True)
    y = moe.moe_fwd(x, swr, sw1, sw2, mesh=mesh)
    (y ** 2).sum().backward()
    out["ep"] = (y.detach(), mesh.all_gather(sw1.grad, 0, "ep"))
    x, wr, w1, w2 = (torch.from_numpy(a) for a in
                     _moe_rand(4, n=8, t=32, d=16, e=8, f=32))
    out["dispatch"] = moe.moe_fwd_dispatch(
        x, *moe.shard_experts(mesh, wr, w1, w2), top_k=2,
        capacity_factor=2.0, mesh=mesh)
    # --- nn.train over tiny_moe under T4_MESH=ep4
    os.environ["T4_MESH"] = "ep4"
    m = zoo.tiny_moe(batch=8, device="cpu")
    weights.load_jax_params(m, moe_params)
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.train import train_epochs
    data, labels = _moe_data()
    import chip_smoke as cs
    with cs._routing_margins() as route:
        loss = train_epochs(m, _DS(data, labels, 8), lr=0.01, epochs=2)
    out["ep_train_margins"] = route.margins
    j = next(i for i, (k, _o, _s) in enumerate(m._program())
             if k == funcs.Layer.MOE)
    part = m._params(True)[j]
    out["ep_train"] = (loss, [tuple(w.clone() for w in pl)
                              for pl in m._params()],
                       sum(w.numel() * 4 for w in part),
                       sum(w.numel() * 4 for w in m._params()[j]))
    os.environ.pop("T4_MESH")
    # --- the same from ROUTE_SEED's weights and corpus, and from the
    # test's with the fault injected
    import chip_smoke as cs
    with cs._routing_margins() as route:
        out["ep_route"] = _ep_train(route_params, *_moe_data(ROUTE_SEED))
    out["ep_route_margins"] = route.margins
    saved = pm._Gather.backward
    pm._Gather.backward = staticmethod(_gather_backward_without_its_sum)
    try:
        out["ep_fault"] = _ep_train(moe_params, *_moe_data())
    finally:
        pm._Gather.backward = saved
    # --- the sp forward over (dp1, sp2, tp2), and a (dp2, sp2) step
    t = zoo.tiny_transformer(batch=4, seq=8, dim=16, heads=4, classes=4,
                             layers=1, device="cpu")
    weights.load_jax_params(t, tr_params)
    xs = torch.from_numpy(np.random.RandomState(5).rand(4, 8, 16, 1)
                          .astype(np.float32))
    ys = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
                          .reshape(4, 1, 4, 1))
    out["sp"] = ShardedTrainer(t, pm.make_mesh3(4, 1, 2, 2)).forward(xs)
    lval, grads = ShardedTrainer(t, pm.make_mesh3(4, 2, 2, 1)).grads(
        xs, ys, rng.PRNGKey(0))
    out["sp_step"] = (float(lval), grads)
    # --- C10: a dp2,tp2 rank of the word loop holds shards
    from tests.test_torch_word_mesh import _port_repl
    from tests.test_torch_fusion import models
    os.environ.update({"T4_MESH": "dp2,tp2", "T4_MAX_BATCH": "3",
                       "T4_CHUNK": "2"})
    inst = _port_repl()
    inst.forth(C10_NET)
    cm = models(inst)[-1]
    lin = cm[1]                            # flatten -> linear 16
    shape = lambda t: None if t._shard is None else tuple(  # noqa: E731
        t._shard[0].shape)
    out["c10"] = {
        "w": shape(lin.grad[0]), "b": shape(lin.grad[1]),
        "dw": shape(lin.grad[2]), "db": shape(lin.grad[3]),
        "m": shape(lin.mtum[0]), "v": shape(lin.mtum[2]),
        "outs": [shape(cm[i]) for i in range(1, cm.numel)],
        "mask": shape(cm[2].grad[4])}
    inst.forth("cm 1 nn.w sum drop")       # a word reads the weight
    out["c10"]["read"] = (shape(lin.grad[0]), tuple(lin.grad[0].data.shape))
    os.environ.pop("T4_MESH")
    return out


def _jax_params(model):
    return [tuple(np.asarray(w) for w in pl) for pl in model._params()]


@pytest.fixture(scope="module")
def runs():
    from tensorforth_tpu.models import tiny_moe, tiny_transformer
    from tensorforth_tpu.system import System
    from tensorforth_tpu_torch.parallel import launch
    # the JAX tests' seed (conftest's T4_SEED): the draws do not depend
    # on which tests ran before in the process, or on the clock
    System.get_sys().seed(JAX_TEST_SEED)
    moe_params = _jax_params(tiny_moe(batch=8))
    tr_params = _jax_params(tiny_transformer(batch=4, seq=8, dim=16, heads=4,
                                             classes=4, layers=1))
    System.get_sys().seed(ROUTE_SEED)
    route_params = _jax_params(tiny_moe(batch=8))
    return launch.run(_rank_cases, 4, moe_params, tr_params,
                      route_params), moe_params, tr_params, route_params


def test_expert_parallel_matches_replicated(runs):
    """moe_fwd over ep4 (two of eight experts a rank) and the gradient of
    sum(y^2) in w1 against the JAX package's replicated moe_fwd"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.parallel.moe import moe_fwd
    x, wr, w1, w2 = (jnp.asarray(a) for a in _ep_case())
    y, g = runs[0]["ep"]
    np.testing.assert_allclose(y.numpy(), np.asarray(moe_fwd(x, wr, w1, w2)),
                               **TOL_EP_FWD)
    want = jax.grad(lambda w: jnp.sum(moe_fwd(x, wr, w, w2) ** 2))(w1)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL_EP_GRAD)


def test_moe_dispatch_ep_sharded_matches_replicated(runs):
    import jax.numpy as jnp
    from tensorforth_tpu.parallel.moe import moe_fwd_dispatch
    x, wr, w1, w2 = (jnp.asarray(a) for a in
                     _moe_rand(4, n=8, t=32, d=16, e=8, f=32))
    want = moe_fwd_dispatch(x, wr, w1, w2, top_k=2, capacity_factor=2.0)
    np.testing.assert_allclose(runs[0]["dispatch"].numpy(),
                               np.asarray(want), **TOL_DISPATCH)


def test_moe_expert_parallel_matches_replicated(runs, monkeypatch):
    """nn.train's engine over tiny_moe under T4_MESH=ep4 lands on the JAX
    package's unsharded run: the loss and every weight; the weights moved;
    a rank holds a quarter of the MoE layer's bytes"""
    import jax.numpy as jnp
    from tensorforth_tpu.models import tiny_moe
    from tensorforth_tpu.nn.train import train_epochs
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    monkeypatch.delenv("T4_MESH", raising=False)
    r, p0, _t, _route = runs
    a = tiny_moe(batch=8)
    for j in range(a.numel - 1):
        for k, w in enumerate(p0[j]):
            g = a[j].grad[k]
            g.replace_data(jnp.asarray(w).reshape(g.shape))
    data, labels = _moe_data()
    la = train_epochs(a, _DS(data, labels, 8), lr=0.01, epochs=2)
    lb, pb, part, whole = r["ep_train"]
    np.testing.assert_allclose(lb, la, rtol=EP_LOSS_RTOL)
    changed = False
    for j, (x, y) in enumerate(zip(a._params(), pb)):
        for k, (w1, w2) in enumerate(zip(x, y)):
            np.testing.assert_allclose(
                w2.numpy(), np.asarray(w1), **TOL_EP_W,
                err_msg=f"layer {j} param {k}: ep-sharded != replicated")
            changed |= not np.allclose(np.asarray(w1), p0[j][k])
    assert changed
    assert part * 4 == whole


def _jax_train_moe(params, data, labels, mesh_spec):
    """the JAX package's nn.train over tiny_moe from `params`, unsharded
    or under T4_MESH=mesh_spec: (loss, weights)"""
    import jax.numpy as jnp
    from tensorforth_tpu.models import tiny_moe
    from tensorforth_tpu.nn.train import train_epochs
    a = tiny_moe(batch=8)
    for j in range(a.numel - 1):
        for k, w in enumerate(params[j]):
            g = a[j].grad[k]
            g.replace_data(jnp.asarray(w).reshape(g.shape))
    if mesh_spec:
        os.environ["T4_MESH"] = mesh_spec
    try:
        loss = train_epochs(a, _DS(data, labels, 8), lr=0.01, epochs=2)
    finally:
        os.environ.pop("T4_MESH", None)
    return loss, _jax_params(a)


# the JAX package's nn.train over tiny_moe from the params in argv[1],
# unsharded and under T4_MESH=dp2,ep4, on 8 CPU devices of its own (the
# test process's JAX has the devices it was started with): both weights
JAX_EP_RUN = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[3])
import numpy as np
from tests.test_torch_ep_sp import _jax_train_moe, _moe_data
z = np.load(sys.argv[1])
n = int(z["n"])
params = [tuple(z[f"{j}_{k}"] for k in range(int(z[f"{j}_n"])))
          for j in range(n)]
data, labels = _moe_data(int(z["seed"]))
out = {}
for name, spec in (("one", None), ("ep", "dp2,ep4")):
    _l, w = _jax_train_moe(params, data, labels, spec)
    for j, pl in enumerate(w):
        for k, a in enumerate(pl):
            out[f"{name}_{j}_{k}"] = a
np.savez(sys.argv[2], **out)
"""


def _jax_runs_on_8_devices(params, seed, tmp_path):
    """(unsharded, dp2,ep4) weights of the JAX package's nn.train"""
    import subprocess
    import sys
    src, dst = tmp_path / "params.npz", tmp_path / "weights.npz"
    arrays = {"n": len(params), "seed": seed}
    for j, pl in enumerate(params):
        arrays[f"{j}_n"] = len(pl)
        for k, a in enumerate(pl):
            arrays[f"{j}_{k}"] = a
    np.savez(src, **arrays)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("T4_MESH", "T4_MAX_BATCH", "XLA_FLAGS")}
    subprocess.run([sys.executable, "-c", JAX_EP_RUN, str(src), str(dst),
                    root], check=True, env=env, cwd=root, timeout=600)
    z = np.load(dst)
    return tuple([tuple(z[f"{name}_{j}_{k}"] for k in range(len(pl)))
                  for j, pl in enumerate(params)] for name in ("one", "ep"))


def test_moe_route_change_departs_as_in_the_jax_package(runs, tmp_path):
    """where one token's top-2 route changes (ROUTE_SEED's 4th step: two
    gates 7e-7 apart), ep4 departs from the unsharded run far past
    test_moe_pipe's bound, by what the JAX package's own dp2,ep4 run
    departs from its replicated one (a unit's first gradient takes the
    other sign, and Adam's first step is lr * sqrt(10) each way); the
    bound holds where no route changes, as at the test's seed"""
    r, _p0, _t, route = runs
    one, jax_ep = _jax_runs_on_8_devices(route, ROUTE_SEED, tmp_path)
    port_ep = [[w.numpy() for w in pl] for pl in r["ep_route"][1]]
    jax_excess = _excess(jax_ep, one, TOL_EP_W["rtol"])
    port_excess = _excess(port_ep, one, TOL_EP_W["rtol"])
    assert min(r["ep_route_margins"]) < 1e-6
    assert jax_excess > 1e3 * TOL_EP_W["atol"]
    np.testing.assert_allclose(port_excess, jax_excess, rtol=1e-3)
    assert min(r["ep_train_margins"]) > 1e-5


def test_ep_weights_bound_sees_a_dropped_cotangent_sum(runs, monkeypatch):
    """the ep check's bound (test_moe_pipe's) against a fault: the router
    scores' all-gather transposed without its sum over ep lands the ep4
    run over 1e3 times the bound's atol from the unsharded run"""
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    monkeypatch.delenv("T4_MESH", raising=False)
    r, p0, _t, _route = runs
    _l, one = _jax_train_moe(p0, *_moe_data(), None)
    fault = [[w.numpy() for w in pl] for pl in r["ep_fault"][1]]
    assert _excess(fault, one, TOL_EP_W["rtol"]) > 1e3 * TOL_EP_W["atol"]


def test_seq_parallel_transformer_matches(runs):
    """tiny_transformer's forward over make_mesh3(dp1, sp2, tp2): each
    rank's half of the sequence, an attention layer's input all-gathered
    over sp (the one-rank layer on it, the rank's positions kept), the
    parameters over tp; against the JAX package's forward on one
    device"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.models import tiny_transformer
    from tensorforth_tpu.parallel.trainer import _forward_pure
    m = tiny_transformer(batch=4, seq=8, dim=16, heads=4, classes=4,
                         layers=1)
    params = tuple(tuple(jnp.asarray(w) for w in pl) for pl in runs[2])
    x = jnp.asarray(np.random.RandomState(5).rand(4, 8, 16, 1), jnp.float32)
    ref = _forward_pure(m._program(), x, params, jax.random.PRNGKey(0))
    np.testing.assert_allclose(runs[0]["sp"].numpy(), np.asarray(ref),
                               **TOL_SP)


def test_seq_parallel_step_matches_one_rank(runs):
    """a (dp2, sp2) gradient: the loss and every gradient, summed over the
    ranks, against one rank's over the whole batch (the dryrun's step
    over dp x sp x tp)"""
    import torch
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel.trainer import _grads
    t = zoo.tiny_transformer(batch=4, seq=8, dim=16, heads=4, classes=4,
                             layers=1, device="cpu")
    weights.load_jax_params(t, runs[2])
    xs = torch.from_numpy(np.random.RandomState(5).rand(4, 8, 16, 1)
                          .astype(np.float32))
    ys = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
                          .reshape(4, 1, 4, 1))
    l1, g1 = _grads(t._program(), t._params(), xs, ys, rng.PRNGKey(0), "ce",
                    False)
    l2, g2 = runs[0]["sp_step"]
    np.testing.assert_allclose(l2, float(l1), rtol=1e-6)
    for a, b in zip([w for gl in g1 for w in gl], [w for gl in g2 for w in gl]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL_SP_STEP)


def test_word_mesh_rank_holds_shards(runs):
    """C10: after the word loop under dp2,tp2 a rank holds its tp shard of
    the linear layer's weight, bias, gradients and both Adam moments
    (8 of 16 output features) and its dp rows of every stashed output
    and mask (4 of 8); a word that reads the weight (`sum`) reads it
    whole"""
    c = runs[0]["c10"]
    assert c["w"] == c["dw"] == c["m"] == c["v"] == (1, 8, 784, 1)
    assert c["b"] == c["db"] == (8,)
    assert c["outs"] == [(4, 1, 784, 1), (4, 1, 16, 1), (4, 1, 16, 1),
                         (4, 1, 10, 1), (4, 1, 10, 1)]
    assert c["mask"] == (4, 1, 16, 1)
    assert c["read"] == (None, (1, 16, 784, 1))
