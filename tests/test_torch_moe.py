"""The port's mixture-of-experts layer (parallel/moe.py, nn/funcs.py
_moe_fwd, Model's MoE layer, the `nn.moe` word, the zoo's tiny_moe)
against the JAX package, on the CPU: the routing functions forward and
backward on both paths with the same dropped assignments, the
counterparts of tests/test_moe_pipe.py's single-device cases, tiny_moe
through three optimizer steps, examples/t4_52_moe.4th through both
REPLs, model files across the packages, and the fused paths (fused
cycle, trace chunks, `nn.train`) over the MoE net against the port's own
per-word path, bit for bit.

A gate an ulp off between the packages can pick another expert and move
the output by O(1), so every case that compares the packages states the
least gap between the k-th and the (k+1)-th gate of its tokens and
checks it (GATE_MARGIN) instead of loosening a tolerance.
"""
import json
import math

import numpy as np
import pytest
import torch

from tests.test_torch_fusion import (  # noqa: F401
    DEFAULT, PER_WORD, first_word, fresh_jax_chunk_programs, models, pin,
    same_data_roots, set_env, snap, t4p, weights)
from tests.test_torch_nn_models import (TOL, TOL_LATER, _io, _layers_close,
                                        _seed, _state_close, _zoo)
from tests.test_torch_repl import run_lines, script_lines
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# the two packages' f32 sums run in another order: outputs and gradients
# lie within 1e-5 of their largest value (1.4e-7 and 8.9e-7 seen at the
# test's shapes)
TOL_MOE = 1e-5
# the least gap between a token's k-th and (k+1)-th gate that a case may
# hold: the router's softmax is XLA CPU's in both packages, so its gates
# differ by at most a few ulps of ~0.3 (≈ 1e-7) where the scores' sums
# differ in their last bit
GATE_MARGIN = 1e-5


def _moe_rand(seed, n=4, t=16, d=8, e=4, f=16):
    """test_moe_pipe.py's inputs"""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, t, d).astype(np.float32)
    wr = (rs.randn(e, d) * 0.3).astype(np.float32)
    w1 = (rs.randn(e, d, f) * 0.2).astype(np.float32)
    w2 = (rs.randn(e, f, d) * 0.2).astype(np.float32)
    return x, wr, w1, w2


def _gate_margin(x, wr, k):
    """the least gap between the k-th and (k+1)-th gate over the tokens
    (the JAX package's gates)"""
    import jax
    import jax.numpy as jnp
    g = np.asarray(jax.nn.softmax(jnp.einsum(
        "...d,ed->...e", jnp.asarray(x), jnp.asarray(wr)), axis=-1))
    g = -np.sort(-g.reshape(-1, g.shape[-1]), axis=-1)
    return float((g[:, k - 1] - g[:, k]).min()) if k < g.shape[-1] else 1.0


def _jax_plan(x, wr, top_k, cf):
    """the JAX package's dispatch assignments: (flat row of each in the
    [E*(C+1), D] buffer, the overflow row where dropped; C)"""
    import jax
    import jax.numpy as jnp
    s, e = x.shape[0] * x.shape[1], wr.shape[0]
    k = min(top_k, e)
    gates = jax.nn.softmax(jnp.einsum("sd,ed->se", jnp.asarray(
        x.reshape(s, -1)), jnp.asarray(wr)), axis=-1)
    _, idx = jax.lax.top_k(gates, k)
    cap = max(1, int(np.ceil(k * s / e * cf)))
    ef = np.asarray(idx).T.reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[ef]
    pf = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return ef * (cap + 1) + np.minimum(pf, cap), cap


CASES = {                      # path, top_k, capacity factor, seed
    "soft_k2": ("soft", 2, None, 0),
    "soft_k1": ("soft", 1, None, 1),
    "soft_k3": ("soft", 3, None, 2),
    "dispatch_k2_drops": ("dispatch", 2, 1.0, 3),
    "dispatch_k2_whole": ("dispatch", 2, 2.0, 4),
    "dispatch_k1_drops": ("dispatch", 1, 0.5, 5),
    "dispatch_k3": ("dispatch", 3, 1.25, 6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_functions_match_jax(case):
    """forward and the gradients of x, wr, w1 and w2 of sum(y²), within
    TOL_MOE of each one's largest value; on the dispatch path the same
    assignments are dropped"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.parallel import moe as jmoe
    from tensorforth_tpu_torch.parallel import moe
    path, k, cf, seed = CASES[case]
    arrs = _moe_rand(seed)
    assert _gate_margin(arrs[0], arrs[1], k) >= GATE_MARGIN
    kw = {} if cf is None else {"capacity_factor": cf}
    jfn = jmoe.moe_fwd if path == "soft" else jmoe.moe_fwd_dispatch
    tfn = moe.moe_fwd if path == "soft" else moe.moe_fwd_dispatch

    def jloss(*a):
        return jnp.sum(jfn(*a, top_k=k, **kw) ** 2)

    ja = [jnp.asarray(a) for a in arrs]
    want = np.asarray(jfn(*ja, top_k=k, **kw))
    gwant = jax.grad(jloss, argnums=(0, 1, 2, 3))(*ja)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y = tfn(*leaves, top_k=k, **kw)
    ggot = torch.autograd.grad((y ** 2).sum(), leaves)
    pairs = [("y", y.detach().numpy(), want)] + [
        (f"d{n}", g.numpy(), np.asarray(r))
        for n, g, r in zip(("x", "wr", "w1", "w2"), ggot, gwant)]
    top = {name: np.abs(ref).max() for name, _got, ref in pairs}
    if k == 1:
        # one expert a token: its renormalized gate is g / g = 1, so the
        # router's gradient is rounding noise in both packages; it is
        # held against the experts' gradient scale
        top["dwr"] = top["dw1"]
    for name, got, ref in pairs:
        err = np.abs(got - ref).max() / top[name]
        assert err <= TOL_MOE, (case, name, err)
    if path == "dispatch":
        x, wr = torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1])
        _k, cap, _gf, flat = moe.dispatch_plan(
            moe._gates(x.reshape(-1, x.shape[-1]), wr), k, cf)
        jflat, jcap = _jax_plan(arrs[0], arrs[1], k, cf)
        assert cap == jcap
        np.testing.assert_array_equal(flat.numpy(), jflat)
        dropped = int((flat.numpy() % (cap + 1) == cap).sum())
        assert (dropped > 0) == case.endswith("drops"), dropped


@pytest.mark.parametrize("seed", [0, 7])
def test_moe_layer_matches_jax_both_routes(monkeypatch, seed):
    """funcs._moe_fwd on the packed w1aug [E,D,F+1] and its vjp, soft and
    under T4_MOE_DISPATCH=1 (T4_MOE_CAP 1.0: some assignments drop)"""
    import jax
    import jax.numpy as jnp
    from tensorforth_tpu.nn import funcs as jfuncs
    from tensorforth_tpu_torch.nn import funcs
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 16, 8, 1).astype(np.float32)
    w1 = (rs.randn(4, 8, 17) * 0.3).astype(np.float32)
    w2 = (rs.randn(4, 16, 8) * 0.3).astype(np.float32)
    dy = rs.randn(2, 16, 8, 1).astype(np.float32)
    assert _gate_margin(x[..., 0], w1[:, :, 16], 2) >= GATE_MARGIN
    monkeypatch.setenv("T4_MOE_CAP", "1.0")
    for env in ("0", "1"):
        monkeypatch.setenv("T4_MOE_DISPATCH", env)
        ja = [jnp.asarray(a) for a in (x, w1, w2)]
        y, vjp = jax.vjp(lambda a, b, c: jfuncs._moe_fwd(a, b, c, 2), *ja)
        gj = vjp(jnp.asarray(dy))
        got = funcs._moe_fwd(*map(torch.from_numpy, (x, w1, w2)), 2)
        gt = funcs._vjp(lambda a, b, c: funcs._moe_fwd(a, b, c, 2),
                        tuple(map(torch.from_numpy, (x, w1, w2))),
                        torch.from_numpy(dy))
        for name, a, b in [("y", got, y)] + list(zip("xwv", gt, gj)):
            b = np.asarray(b)
            err = np.abs(a.numpy() - b).max() / np.abs(b).max()
            assert err <= TOL_MOE, (env, name, err)


# --- test_moe_pipe.py's single-device cases ------------------------------------
def test_moe_dispatch_matches_soft_when_undropped():
    """(test_moe_pipe.py:301) cf = E/k makes C = S: no expert overflows"""
    from tensorforth_tpu_torch.parallel.moe import moe_fwd, moe_fwd_dispatch
    x, wr, w1, w2 = map(torch.from_numpy, _moe_rand(0))
    soft = moe_fwd(x, wr, w1, w2, top_k=2)
    disp = moe_fwd_dispatch(x, wr, w1, w2, top_k=2, capacity_factor=2.0)
    np.testing.assert_allclose(disp.numpy(), soft.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_moe_dispatch_grads_match_soft():
    """(test_moe_pipe.py:315)"""
    from tensorforth_tpu_torch.parallel.moe import moe_fwd, moe_fwd_dispatch
    arrs = _moe_rand(1)
    grads = []
    for fn, kw in ((moe_fwd, {}), (moe_fwd_dispatch,
                                   {"capacity_factor": 2.0})):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
        y = fn(*leaves, top_k=2, **kw)
        grads.append(torch.autograd.grad((y ** 2).sum(), leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=3e-4,
                                   atol=3e-4)


def test_moe_dispatch_capacity_drops_tokens():
    """(test_moe_pipe.py:334) a router that sends every token to expert
    0: the first C tokens are served, the rest contribute exactly zero"""
    from tensorforth_tpu_torch.parallel.moe import moe_fwd_dispatch
    x, _, w1, w2 = _moe_rand(2)
    x = np.abs(x) + 0.1
    e, d = w1.shape[0], w1.shape[1]
    wr = np.zeros((e, d), np.float32)
    wr[0] = 100.0
    y = moe_fwd_dispatch(*map(torch.from_numpy, (x, wr, w1, w2)), top_k=1,
                         capacity_factor=0.25)
    s = x.shape[0] * x.shape[1]
    cap = int(np.ceil(s / e * 0.25))
    yt = y.numpy().reshape(s, -1)
    assert np.all(yt[cap:] == 0.0), "overflow tokens not dropped"
    assert np.any(yt[:cap] != 0.0)


def test_moe_dispatch_buffer_and_products(monkeypatch):
    """(test_moe_pipe.py:352, which counts XLA's FLOPs) the experts' two
    products run over an [E, C, D] buffer, C = ceil(k·S/E·cf); at k = 1
    of 4, cf 1, they cost C/S = 1/4 of the dense path's expert products"""
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.parallel import moe
    seen = []
    plain = funcs.class_einsum

    def spy(spec, a, b, cls=None):
        seen.append((spec, tuple(a.shape), tuple(b.shape)))
        return plain(spec, a, b, cls)

    monkeypatch.setattr(funcs, "class_einsum", spy)
    x, wr, w1, w2 = map(torch.from_numpy, _moe_rand(3, n=8, t=32, d=32,
                                                    f=64))

    def products(spec, a, b):
        """2 x the product of every index's size: the einsum's FLOPs"""
        ia, ib = spec.split("->")[0].split(",")
        size = dict(zip(ia, a))
        size.update(zip(ib, b))
        return 2 * math.prod(size.values())

    def expert_flops(fn, **kw):
        """the shapes of each einsum, and the FLOPs of the experts' two
        (neither the router's nor the gates' combine)"""
        seen.clear()
        fn(x, wr, w1, w2, top_k=1, **kw)
        shapes = {s: (a, b) for s, a, b in seen}
        return shapes, sum(products(s, a, b) for s, a, b in seen
                           if s.split(",")[1].startswith("e")
                           and s != "sd,ed->se")

    dense, fd = expert_flops(moe.moe_fwd)
    disp, fx = expert_flops(moe.moe_fwd_dispatch, capacity_factor=1.0)
    s, e = 8 * 32, 4
    assert disp["ecd,edf->ecf"][0] == (e, math.ceil(s / e), 32)
    assert disp["ecf,efd->ecd"][0] == (e, math.ceil(s / e), 64)
    assert fx * 4 == fd and fx < 0.45 * fd, (fx, fd)


def test_moe_select_matches_jax(monkeypatch):
    """(test_moe_pipe.py:371) the static rules and the two switches, on a
    grid of token counts, expert counts and k, against the JAX package's
    moe_select"""
    from tensorforth_tpu.parallel.moe import moe_select as jselect
    from tensorforth_tpu_torch.parallel.moe import moe_select
    monkeypatch.delenv("T4_MOE_DISPATCH", raising=False)
    assert not moe_select((4, 8), 4, 2)
    assert moe_select((8, 64), 8, 2)
    assert not moe_select((8, 64), 4, 2)
    for env in ("", "1", "0"):
        monkeypatch.setenv("T4_MOE_DISPATCH", env)
        for cap in ("1.25", "0.5"):
            monkeypatch.setenv("T4_MOE_CAP", cap)
            for dims in ((1, 1), (4, 8), (8, 32), (8, 64), (16, 256)):
                for e in (2, 4, 8, 16):
                    for k in (1, 2, 3):
                        assert moe_select(dims, e, k) == jselect(dims, e,
                                                                 k)


MOE_NET = """0 trace
4 8 16 1 nn.model
2 32 4 nn.moe tanh flatten 4 linear softmax
constant mo"""


def test_moe_word_builds_and_learns(t4p):
    """(test_moe_pipe.py:43) nn.moe through the word path: 12 steps of
    forward / backprop / nn.adam cut the loss below 0.7 of its first"""
    out = t4p.forth(MOE_NET + "\nmo network")
    assert "moe" in out
    t4p.forth("512 vector randn 4 8 16 1 reshape4 constant xv")
    t4p.forth("mo xv forward")
    t4p.forth("16 vector{ 1 0 0 0  1 0 0 0  1 0 0 0  1 0 0 0 } "
              "4 1 4 1 reshape4 nn.onehot= drop")
    losses = []
    for _ in range(12):
        out = t4p.forth(
            "mo xv forward loss.ce . backprop 0.005 nn.adam drop")
        losses.append(float(out.strip().split()[0]))
    assert losses[-1] < losses[0] * 0.7, f"moe not learning: {losses}"


@pytest.mark.parametrize("line", ["nn.moe", "1 4 1 1 nn.model nn.moe",
                                  "1 4 1 1 nn.model 16 nn.moe .s",
                                  "1 4 2 1 nn.model 0 16 4 nn.moe .s",
                                  "1 4 2 1 nn.model 3 16 2 nn.moe .s"])
def test_moe_word_errors_match_jax(t4, t4p, line):
    """(test_moe_pipe.py:63) the usage error and the factory's `_err`
    (k outside 1..E, a hidden dim of 0): the same lines, the same stack"""
    line = "abort " + line
    assert t4p.forth(line) == t4.forth(line)
    assert "nn.moe" in t4p.forth("abort nn.moe")


def test_t4_52_moe_matches_jax(t4, t4p, monkeypatch):
    """examples/t4_52_moe.4th through both REPLs: its MoE parts (the
    network, the forward, a step of backprop and Adam) byte for byte;
    its nn.pipe part (two pipeline ranks of the port, cut to 3 batches
    an epoch as test_scripts.py cuts its scripts) lands on the loss of
    the same epochs through the JAX package's `nn.train` (the word path's
    step, which the pipeline takes: test_moe_pipe.py:85-95), within that
    test's rtol 1e-4 (the JAX package's own nn.pipe needs two devices)"""
    import re
    lines = script_lines("t4_52_moe.4th")
    cut = next(i for i, ln in enumerate(lines) if "pipeline-parallel" in ln)
    got = run_lines(t4p, lines[:cut])
    assert got == run_lines(t4, lines[:cut])
    assert "loss after" in got and "[  1] moe" in got
    monkeypatch.setenv("T4_MAX_BATCH", "3")
    rest = run_lines(t4p, lines[cut:cut + 6])
    want = run_lines(t4, [ln.replace("2 2 nn.pipe", "2 nn.train")
                          for ln in lines[cut:cut + 6]])
    loss = re.compile(r"final loss=(\S+)")
    assert "nn.pipe 2 epochs over pp2 done" in rest
    assert "nn.train 2 epochs done" in want and "ERROR" not in rest
    (a,), (b,) = loss.findall(rest), loss.findall(want)
    assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b)), (a, b)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_moe_model_file_across_packages(t4, t4p, tmp_path, saver):
    """a model with attention and MoE saved by one package loads into
    the other (test_moe_pipe.py:167): the layers rebuilt, the file saved
    again byte for byte, the forward within TOL_MOE"""
    src, dst = (t4, t4p) if saver == "jax" else (t4p, t4)
    a, b = tmp_path / "a.t4", tmp_path / "b.t4"
    net = ("0 trace 4 8 16 1 nn.model 4 nn.attn 2 32 4 nn.moe tanh "
           "flatten 4 linear softmax constant svm\n"
           "512 vector randn 4 8 16 1 reshape4 constant sx")
    for inst in (t4p, t4):
        inst.forth(net)
    src.forth(f'svm s" {a}" save drop')
    outs = []
    for inst in (dst, src):
        out = inst.forth(f'4 8 16 1 nn.model constant ldm ldm s" {a}" load '
                         "network")
        assert "attn" in out and "moe" in out, out
        inst.forth("ldm sx forward")
        d = inst.vm.mmu.du2obj(inst.vm.tos)[-1].ensure_data()
        outs.append(np.asarray(d.numpy() if torch.is_tensor(d) else d))
    dst.forth(f'ldm s" {b}" save drop')
    assert b.read_bytes() == a.read_bytes()
    np.testing.assert_allclose(outs[0], outs[1], rtol=0,
                               atol=TOL_MOE * np.abs(outs[1]).max())


# --- tiny_moe through three optimizer steps ---------------------------------------
OPTS = {"sgd": lambda m: m.sgd(0.05), "adam": lambda m: m.adam(1e-3),
        "adamw": lambda m: m.adamw(1e-3)}


@pytest.mark.parametrize("opt", list(OPTS))
def test_tiny_moe_three_steps_match_jax(opt):
    """the zoo's tiny_moe (batch 4): every layer tensor and the whole
    training state after each word, as test_torch_nn_models.py holds the
    other zoo nets (TOL on the first step, TOL_LATER after); before each
    forward the MoE layer's input gives its gates GATE_MARGIN"""
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.parallel import moe
    _seed(11)
    mj = _zoo("jax", "tiny_moe", batch=4)
    mt = _zoo("torch", "tiny_moe", batch=4)
    assert mt._program() == mj._program()
    weights.load_jax_params(
        mt, [tuple(np.asarray(a) for a in lp) for lp in mj._params()],
        program=mj._program())
    (ij, tj), (it, tt) = _io(mj, mt, 5)
    lr = 1e-3 if opt.startswith("adam") else None
    from tensorforth_tpu_torch.nn.ntypes import Loss
    for step in range(3):
        tol = TOL if step == 0 else TOL_LATER
        what = f"tiny_moe {opt} step {step}"
        mj.forward(ij)
        mt.forward(it)
        w1 = mt._params()[1][0]
        gates = moe._gates(mt[1].ensure_data().reshape(-1, w1.shape[1]),
                           w1[:, :, -1])
        g = torch.sort(gates, dim=-1, descending=True).values
        assert float((g[:, 1] - g[:, 2]).min()) >= GATE_MARGIN, what
        _layers_close(mj, mt, f"{what} forward", tol)
        lj, lt = mj.loss(Loss.CE, tj), mt.loss(Loss.CE, tt)
        assert abs(lt - lj) <= tol * abs(lj), (what, lt, lj)
        mj.backprop(tj)
        mt.backprop(tt)
        _layers_close(mj, mt, f"{what} backprop", tol)
        _state_close(mj, mt, f"{what} backprop", tol)
        grads = [np.asarray(t.grad[s + 2].ensure_data()).reshape(-1)
                 for t, s in mj._trainables()]
        OPTS[opt](mj)
        OPTS[opt](mt)
        _state_close(mj, mt, f"{what} {opt}", tol,
                     None if lr is None else (lr, grads))


def test_tiny_moe_training_state_crosses_the_packages():
    """weights.dump_state / load_state over tiny_moe's slots (the MoE
    layer's are [E,D,F+1,1] and [E,F,D,1]): the JAX model's Adam state
    after one step loads into the port, which dumps it back unchanged and
    takes the next step within TOL_LATER"""
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.nn.ntypes import Loss
    _seed(3)
    mj = _zoo("jax", "tiny_moe", batch=4)
    mt = _zoo("torch", "tiny_moe", batch=4)
    (ij, tj), (it, tt) = _io(mj, mt, 2)
    mj.forward(ij)
    mj.backprop(tj)
    mj.adam(1e-3)
    state = [{"w": np.asarray(t.grad[s].ensure_data()),
              "dw": np.asarray(t.grad[s + 2].ensure_data()),
              "m": np.asarray(t.mtum[s].ensure_data()),
              "v": np.asarray(t.mtum[s + 2].ensure_data())}
             for t, s in mj._trainables()]
    assert state[2]["w"].shape == (4, 16, 33, 1)
    weights.load_state(mt, state)
    for a, b in zip(state, weights.dump_state(mt)):
        for k in weights.STATE_KEYS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for m, i, t in ((mj, ij, tj), (mt, it, tt)):
        m.forward(i)
        m.loss(Loss.CE, t)
        m.backprop(t)
    _state_close(mj, mt, "tiny_moe second backprop", TOL_LATER)
    grads = [np.asarray(t.grad[s + 2].ensure_data()).reshape(-1)
             for t, s in mj._trainables()]
    mj.adam(1e-3)
    mt.adam(1e-3)
    _state_close(mj, mt, "tiny_moe second step", TOL_LATER, (1e-3, grads))


def test_tiny_moe_mm_debug_and_slots():
    """MM_DEBUG fills both slots with 0.5; the layer's four gradient
    slots and its program options are the JAX package's"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu_torch.config import Config as TConfig
    kept = JConfig.MM_DEBUG, TConfig.MM_DEBUG
    JConfig.MM_DEBUG = TConfig.MM_DEBUG = True
    try:
        mj = _zoo("jax", "tiny_moe", batch=2)
        mt = _zoo("torch", "tiny_moe", batch=2)
    finally:
        JConfig.MM_DEBUG, TConfig.MM_DEBUG = kept
    for a, b in zip(mj._params()[1], mt._params()[1]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert (b == 0.5).all()
    assert [g.shape for g in mt[1].grad[:4]] == [g.shape for g in
                                                 mj[1].grad[:4]]
    assert mt[1].stride[:2] == mj[1].stride[:2] and mt[1].iparm == 4


# --- the fused paths over the MoE net, bit for bit against the per-word path ------
FUSED_NET = """0 trace
8 28 28 1 nn.model
4 nn.attn 2 32 4 nn.moe tanh flatten 10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d
"""
FUSED_LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
              ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
              "backprop 0.001 nn.adam next ;")


@pytest.mark.parametrize("dispatch", ["0", "1"], ids=["soft", "dispatch"])
@pytest.mark.parametrize("chunk", ["0", "3"], ids=["fused", "chunks"])
def test_fused_paths_over_moe_match_per_word(t4p, monkeypatch, dispatch,
                                             chunk):
    """tiny_moe's layers at mnist_train's shape through the REPL's
    default path (fused cycles; with T4_CHUNK=3 trace chunks too) against
    T4_NO_FUSE=1 T4_NO_MACRO=1 from the same weights: the printed hit
    and loss equal, the weights bit for bit; soft and under
    T4_MOE_DISPATCH=1"""
    from tensorforth_tpu_torch.nn import cycle
    monkeypatch.setenv("T4_MAX_BATCH", "7")
    monkeypatch.setenv("T4_MOE_DISPATCH", dispatch)
    got, s = [], None
    for name, env in (("pa", PER_WORD), ("pb", DEFAULT)):
        set_env(monkeypatch, env)
        monkeypatch.setenv("T4_CHUNK", chunk)
        t4p.forth(FUSED_NET.format(name=name))
        m = models(t4p)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        t4p.forth(FUSED_LOOP.format(v=name))
        cycle.reset_counts()
        for _ in range(2):
            t4p.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        got.append((first_word(t4p.forth(f"{name}h @ . cr")),
                    first_word(t4p.forth(f"{name}l @ . cr")), weights(m)))
    assert cycle.COUNTS["fused"] + cycle.COUNTS["chunks"] >= 1
    if chunk != "0":
        assert cycle.COUNTS["chunks"] >= 1
    (ha, la, wa), (hb, lb, wb) = got
    assert ha == hb and la == lb, (ha, hb, la, lb)
    for i, (a, b) in enumerate(zip(wa, wb)):
        np.testing.assert_array_equal(b, a, err_msg=f"param {i}")


@pytest.mark.parametrize("dispatch", ["0", "1"], ids=["soft", "dispatch"])
def test_nn_train_over_tiny_moe_matches_word_path(t4p, monkeypatch,
                                                  dispatch):
    """train_epochs (the nn.train word's engine) over the zoo's tiny_moe
    lands the port's word loop's weights bit for bit, soft and under
    T4_MOE_DISPATCH=1.  (The word path's steps are held against the JAX
    package by test_tiny_moe_three_steps_match_jax; over 6 Adam steps at
    0.01 an expert weight whose gradient is near zero moves by rounding
    noise times lr, so the two packages' nn.train part by more than
    test_train_equiv's atol there.)"""
    from tests.test_torch_train_equiv import restore, snapshot, stage, word_loop
    from tensorforth_tpu import models as jmodels
    from tensorforth_tpu_torch import models
    from tensorforth_tpu_torch.nn.train import train_epochs
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    monkeypatch.setenv("T4_MOE_DISPATCH", dispatch)
    jm = jmodels.tiny_moe(batch=4)
    word, fused = (models.tiny_moe(batch=4, device="cpu") for _ in range(2))
    p0 = snapshot(jm)
    restore(word, p0)
    restore(fused, p0)
    ds, x, hot = stage(word, n_batches=3, batch=4)
    word_loop(word, x, hot, 0.01, epochs=2)
    train_epochs(fused, ds, lr=0.01, epochs=2)
    changed = False
    for j, (pw, pf) in enumerate(zip(snapshot(word), snapshot(fused))):
        for k, (a, b) in enumerate(zip(pw, pf)):
            np.testing.assert_array_equal(b, a, err_msg=f"layer {j}.{k}")
            changed |= not np.array_equal(a, p0[j][k])
    assert changed


def test_chip_smoke_moe_phase_runs_on_the_cpu(capsys, monkeypatch):
    """chip_smoke.py's `moe` phase on the CPU (its card and CPU runs both
    on the CPU, the fused window cut to 4 batches): every check holds"""
    import chip_smoke as cs
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    cs.phase_moe(0, device="cpu", fused_batches=4)
    out = capsys.readouterr().out
    line = next(json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"phase": "moe"'))
    assert line["checks"] and all(line["checks"].values()), line["checks"]
    assert '"fused_dispatch_equals_per_word": true' in out
