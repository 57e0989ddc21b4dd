"""Pipeline parallelism (parallel/pipeline.py) on gloo ranks on the CPU,
against the JAX package on the same seeded inputs:

* test_pipeline.py's two pipeline cases: the GPipe schedule over pp4
  against the stages applied in turn by the JAX package (its `_mha_fwd`
  and tanh), values and gradients, under that test's bounds; its
  expert-parallel case is in test_torch_ep_sp.py;
* test_moe_pipe.py's `nn.pipe` cases: `train_pipeline` against the JAX
  package's word-path step (`make_ref_batch_step`) under that test's
  bounds, the word from the REPL (weights written back, the usage error
  and the final line), a segment's dropout keys per ridx (against the
  JAX package's segment), dropout trained through the pipe, batchnorm
  refused with the JAX package's message, and the streaming schedule
  against fill-drain: the same outputs in fewer ticks (the JAX test
  times the two on a host; here the ticks are counted).

The JAX package's own pipeline needs as many devices as stages; the
references here run on one.  The schedule and engine cases share one
start of 4 ranks; the `nn.pipe` word starts its own, as it does from a
REPL."""
import numpy as np
import pytest

from tests.test_torch_repl import t4p  # noqa: F401  (fixture)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# test_pipeline.py's bounds
TOL_VALUES = dict(rtol=2e-5, atol=2e-6)
TOL_GRADS = dict(rtol=5e-4, atol=5e-5)
# test_moe_pipe.py's: the pipelined step against the word path's
TOL_STEP = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4


def _make(n_stages=4, n_micro=8, mb=2, s=4, e=8, seed=0):
    rng = np.random.RandomState(seed)
    stacked = ((rng.randn(n_stages, 3 * e, e) * 0.2).astype(np.float32),
               (rng.randn(n_stages, e, e) * 0.2).astype(np.float32))
    x = rng.randn(n_micro, mb, s, e, 1).astype(np.float32)
    return stacked, x


def _stage_fn(p, x):
    """one MHA block and tanh, test_pipeline.py's stage"""
    import torch
    from tensorforth_tpu_torch.nn.funcs import _mha_fwd
    (wqkv, wo), = p
    return torch.tanh(_mha_fwd(x, wqkv, wo, 2, flash=False))


def _serve_stage(p, x):
    import torch
    return torch.tanh(x @ p[0][0])


SERVE = dict(S=4, R=8, NM=4, D=16)


def _rank_schedule(rank, world):
    import torch
    from tensorforth_tpu_torch.parallel import pipeline as pl
    mesh = pl.make_pp_mesh(world)
    out = {}
    for seed in (0, 3):
        stacked, x = _make(seed=seed)
        p = [tuple(torch.from_numpy(w[rank]).requires_grad_(True)
                   for w in stacked)]
        ys = pl.pipeline_apply(_stage_fn, mesh, world)(p, torch.from_numpy(x))
        (ys ** 2).sum().backward()
        out[seed] = (ys.detach(), [mesh.all_gather(w.grad[None], 0, "pp")
                                   for w in p[0]])
    # serving: one stream against a fill/drain pass per request
    rs = np.random.RandomState(0)
    w = torch.from_numpy((rs.randn(SERVE["S"], SERVE["D"], SERVE["D"])
                          * 0.05).astype(np.float32))
    reqs = torch.from_numpy(rs.randn(SERVE["R"], SERVE["NM"], 8,
                                     SERVE["D"]).astype(np.float32))
    ticks = []
    for serve in (pl.pipeline_serve, pl.pipeline_serve_filldrain):
        t0 = pl.COUNTS["ticks"]
        with torch.no_grad():
            y = serve(_serve_stage, mesh, world)([(w[rank],)], reqs)
        ticks.append((y, pl.COUNTS["ticks"] - t0))
    out["serve"] = ticks
    out["nn_pipe"] = _engine_case(mesh)
    out["dropout"] = _dropout_case(rank)
    return out


def _tiny_transformer4():
    """test_moe_pipe's model: 4 attention blocks, weights from a seed"""
    import torch
    from tensorforth_tpu_torch.models import zoo
    m = zoo.tiny_transformer(batch=8, seq=8, dim=16, heads=4, classes=4,
                             layers=4, device="cpu")
    w0 = np.random.RandomState(2)
    for pl in m._params():
        for w in pl:
            w.copy_(torch.from_numpy(
                ((w0.rand(*w.shape) - 0.5) * 0.4).astype(np.float32)))
    return m


def _engine_data():
    rs = np.random.RandomState(1)
    return rs.rand(8, 8, 16, 1).astype(np.float32), rs.randint(0, 4, 8)


def _engine_case(mesh):
    """train_pipeline's body over pp4: one batch, 8 microbatches of 1"""
    import torch
    from tensorforth_tpu_torch.parallel.pipeline import pipe_train
    m = _tiny_transformer4()
    data, labels = _engine_data()
    loss, full, _l = pipe_train(mesh, m._program(), m._params(),
                                torch.from_numpy(data),
                                torch.from_numpy(labels), 8, 0.0, 1.0,
                                (8, 8, 16, 1), 4, 0.01, 1, 1)
    return loss, [tuple(w.numpy() for w in pl) for pl in full]


def _dropout_case(rank):
    """a stem, two blocks of linear, relu and dropout over pp2 (ranks 0
    and 1 of the four), a head: 2 epochs of 3 batches"""
    import torch
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn.ntypes import Layer
    from tensorforth_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                         pipe_train)
    mesh = make_pp_mesh(2)                 # every rank makes its groups
    if rank >= 2:
        return None
    torch.manual_seed(0)
    m = zoo._new_model(16, 28, 28, 1, device="cpu")
    m.add(Layer.FLATTEN)
    for _ in range(3):
        m.add(Layer.LINEAR, 64)
        m.add(Layer.RELU)
        if _:
            m.add(Layer.DROPOUT, 0, 0.3)
    m.add(Layer.LINEAR, 10)
    m.add(Layer.SOFTMAX)
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.rand(48, 28, 28, 1).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 48))
    before = [w.clone() for pl in m._params() for w in pl]
    loss, full, losses = pipe_train(mesh, m._program(), m._params(), x, y,
                                    16, 0.0, 1.0, (16, 28, 28, 1), 10,
                                    0.005, 2, 3)
    return losses, before, [w for pl in full for w in pl]


@pytest.fixture(scope="module")
def schedule_runs():
    from tensorforth_tpu_torch.parallel import launch
    return launch.run(_rank_schedule, 4)


def _sequential(stacked, x):
    """the JAX package's stages in turn over each microbatch"""
    import jax.numpy as jnp
    from tensorforth_tpu.nn.funcs import _mha_fwd

    def seq(p):
        ys = []
        for j in range(x.shape[0]):
            h = jnp.asarray(x[j])
            for i in range(p[0].shape[0]):
                h = jnp.tanh(_mha_fwd(h, p[0][i], p[1][i], 2, flash=False))
            ys.append(h)
        return jnp.stack(ys)
    return seq


def test_pipeline_matches_sequential(schedule_runs):
    import jax.numpy as jnp
    stacked, x = _make(seed=0)
    import jax
    want = jax.jit(_sequential(stacked, x))(
        tuple(jnp.asarray(w) for w in stacked))
    np.testing.assert_allclose(schedule_runs[0][0].numpy(), np.asarray(want),
                               **TOL_VALUES)


def test_pipeline_gradients_match(schedule_runs):
    """each stage's gradient of sum(ys^2) against jax.grad of the stages
    in turn"""
    import jax
    import jax.numpy as jnp
    stacked, x = _make(seed=3)
    seq = _sequential(stacked, x)
    want = jax.jit(jax.grad(lambda p: jnp.sum(seq(p) ** 2)))(
        tuple(jnp.asarray(w) for w in stacked))
    for got, w in zip(schedule_runs[3][1], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL_GRADS)


def test_pipeline_serve_steady_state_beats_filldrain(schedule_runs):
    """one stream of R*NM microbatches pays the S-1 tick bubble once:
    R*NM + S - 1 = 35 ticks a rank against R*(NM + S - 1) = 56, the same
    outputs, both equal to the stages in turn"""
    (ys, t_stream), (yf, t_fill) = schedule_runs["serve"]
    S, R, NM = SERVE["S"], SERVE["R"], SERVE["NM"]
    np.testing.assert_allclose(ys.numpy(), yf.numpy(), rtol=1e-5, atol=1e-5)
    assert (t_stream, t_fill) == (R * NM + S - 1, R * (NM + S - 1))
    rs = np.random.RandomState(0)
    w = (rs.randn(S, SERVE["D"], SERVE["D"]) * 0.05).astype(np.float32)
    h = rs.randn(R, NM, 8, SERVE["D"]).astype(np.float32)
    for i in range(S):
        h = np.tanh(h @ w[i])
    np.testing.assert_allclose(ys.numpy(), h, rtol=1e-5, atol=1e-5)


# --- nn.pipe: train_pipeline ------------------------------------------------
def test_nn_pipe_matches_sequential(schedule_runs):
    """test_moe_pipe's pin: train_pipeline's body over pp4 (tiny_transformer
    of 4 attention blocks, 8 microbatches of 1) takes the word path's
    step: the loss and every weight against the JAX package's
    make_ref_batch_step from the same weights"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.nn.train import make_ref_batch_step
    m = _tiny_transformer4()
    data, labels = _engine_data()
    hot = np.eye(4, dtype=np.float32)[labels].reshape(8, 1, 4, 1)
    params = tuple(tuple(jnp.asarray(w.numpy()) for w in pl)
                   for pl in m._params())
    zm = tuple(tuple(jnp.zeros_like(w) for w in pl) for pl in params)
    new_p, _m, _v, lval = jax.jit(make_ref_batch_step(m._program(), 0.01))(
        params, zm, zm, jnp.asarray(data), jnp.asarray(hot),
        jax.random.PRNGKey(0))
    lp, got = schedule_runs["nn_pipe"]
    np.testing.assert_allclose(lp, float(lval), rtol=LOSS_RTOL)
    for j, (gl, want) in enumerate(zip(got, new_p)):
        for k, (a, b) in enumerate(zip(gl, want)):
            np.testing.assert_allclose(
                a, np.asarray(b), **TOL_STEP,
                err_msg=f"layer {j} param {k}: pipelined != word path")


PIPE_NET = """0 trace
16 28 28 1 nn.model
flatten 64 linear relu {mid}64 linear relu {mid}64 linear relu
10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d"""


def test_nn_pipe_word(t4, t4p, monkeypatch):
    """test_moe_pipe's word case from the port's REPL: a stem and repeated
    linear blocks train over pp2 on 3 batches of the dataset, the
    weights are written back, the final line is the JAX package's; then
    the usage error on a missing dataset, as the JAX package prints it,
    and the REPL goes on"""
    monkeypatch.setenv("T4_MAX_BATCH", "3")
    t4p.forth(PIPE_NET.format(name="pmdl", mid=""))
    before = float(t4p.forth("pmdl 1 nn.w sum . cr").strip().split()[0])
    out = t4p.forth("pmdl pmdld 0.005 2 2 nn.pipe")
    assert "nn.pipe 2 epochs over pp2 done, final loss=" in out, out[-300:]
    after = float(t4p.forth("1 nn.w sum . cr").strip().split()[0])
    assert before != after, "pipeline training did not write back weights"
    line = "abort pmdl 0.01 1 4 nn.pipe"
    t4.forth(PIPE_NET.format(name="pmdl", mid=""))
    got, want = t4p.forth(line), t4.forth(line)
    assert "nn.pipe?" in got and got == want
    assert "3 " in t4p.forth("1 2 + . cr")


def test_nn_pipe_dropout_trains(schedule_runs):
    """dropout inside the pipelined blocks (test_moe_pipe's model: masks
    per microbatch and stage through ridx): the loss is finite and the
    weights move"""
    losses, before, after = schedule_runs["dropout"]
    assert all(np.isfinite(v) for v in losses) and len(losses) == 2
    assert any(not np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(before, after))


def test_nn_pipe_refusals_are_the_jax_packages(t4p, monkeypatch):
    """batchnorm stays refused (per-microbatch statistics would diverge),
    a body of no repeated blocks and a batch that does not divide into
    microbatches raise, each with the JAX package's words (pipeline.py:
    234-250, 82-84), before any rank starts"""
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.parallel.pipeline import (_check,
                                                         split_stages)
    monkeypatch.setenv("T4_MAX_BATCH", "3")
    t4p.forth(PIPE_NET.format(name="bnm", mid="0.1 batchnorm "))
    out = t4p.forth("bnm bnmd 0.005 1 2 nn.pipe")
    assert ("ERROR in 'nn.pipe': nn.pipe: batchnorm layers are not "
            "supported (per-microbatch stats would diverge; use "
            "layernorm)") in out
    m = zoo.mnist_cnn(batch=8, device="cpu")
    with pytest.raises(ValueError, match="not 4 repeated blocks"):
        split_stages(m._program(), m._params(), 4)
    t = zoo.tiny_transformer(batch=6, seq=4, dim=8, heads=2, classes=2,
                             layers=4, device="cpu")
    with pytest.raises(ValueError, match="batch 6 not divisible into 4"):
        _check(t._program(), t._params(), 6, 4)


def test_pipe_segment_dropout_varies_with_ridx():
    """a segment's dropout mask comes from fold_in(fold_in(PRNGKey(0),
    ridx), key_base + layer): the same ridx the same mask, another ridx
    another, each the JAX package's segment's bit for bit"""
    import jax.numpy as jnp
    import torch
    from tensorforth_tpu.nn.ntypes import Layer
    from tensorforth_tpu.parallel.pipeline import (
        make_wordpath_segment as jax_segment)
    from tensorforth_tpu_torch.parallel.pipeline import make_wordpath_segment
    prog = ((Layer.DROPOUT, (0.5,), (4, 16)),)
    seg, jseg = make_wordpath_segment(prog, 0), jax_segment(prog, 0)
    x = torch.ones((4, 16))
    y0, y0b, y1 = (seg([()], x, r).numpy() for r in (0, 0, 1))
    np.testing.assert_array_equal(y0, y0b)
    assert np.any(y0 != y1), "dropout mask frozen across ridx"
    for r, y in ((0, y0), (1, y1)):
        np.testing.assert_array_equal(
            y, np.asarray(jseg(((),), jnp.ones((4, 16)), jnp.int32(r))))
