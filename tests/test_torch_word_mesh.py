"""The port's word path, `nn.train` and serving under T4_MESH on gloo
ranks on the CPU (funcs.word_mesh, serve.serving_mesh): test_word_mesh's
three cases, test_parallel's `nn.train` on a mesh and test_lm's two
mesh-serving pins, against the single-device outputs those JAX tests
compute, under their own bounds (equal hits, the loss within 5e-5, the
weights within 2e-4, equal greedy tokens).  Each case starts its ranks
with parallel/launch.py (4 processes at most)."""
import os

import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    fresh_jax_chunk_programs, same_data_roots)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


# --- test_word_mesh: the word loop under T4_MESH ------------------------------
# test_word_mesh's own bounds against the single-device run it computes
MESH_LOSS_TOL, MESH_W_ATOL = 5e-5, 2e-4
WORD_MODEL = """0 trace
8 28 28 1 nn.model
flatten 16 linear relu 10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d
"""
WORD_LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
             ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
             "backprop 0.001 nn.adam next ;")
PROBE_LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
              ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
              "backprop 0.001 nn.adam 0 nn.w drop next ;")


def _port_repl():
    import io
    import os
    from tensorforth_tpu_torch.cli import TensorForth
    os.environ.setdefault("T4_SEED", "42")
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device="cpu")

    def run(script):
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]
    inst.forth = run
    return inst


def _loop_run(inst, models, name, loop, epochs, snap=None, init=None):
    """the loop's hit count, last loss and weights after `epochs`, from the
    weights `snap` (the model's own when None; `init` gets them)"""
    from tests import test_torch_fusion as tf
    inst.forth(WORD_MODEL.format(name=name))
    m = models(inst)[-1]
    if snap is not None:
        tf.pin(m, snap)
    if init is not None:
        init.append(tf.snap(m))
    inst.forth(loop.format(v=name))
    for _ in range(epochs):
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
    hit = inst.forth(f"{name}h @ . cr").strip().split()[0]
    lox = inst.forth(f"{name}l @ . cr").strip().split()[0]
    return hit, lox, tf.weights(m)


def _rank_word_loop(rank, world, spec, env, loop, epochs, snap):
    import os
    from tensorforth_tpu_torch.nn import cycle, funcs
    from tests.test_torch_fusion import models
    os.environ.update(env)
    os.environ["T4_MESH"] = spec
    cycle.reset_counts()
    got = _loop_run(_port_repl(), models, "wb", loop, epochs, snap)
    mesh = funcs.word_mesh()
    return got, (mesh.dp, mesh.tp), dict(cycle.COUNTS)


def _jax_single_device(t4, monkeypatch, env, loop, epochs):
    """test_word_mesh's reference: the JAX package's word loop on one
    device at its defaults; (hit, loss, weights) and the initial weights"""
    from tests.test_torch_fusion import models
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("T4_MESH", raising=False)
    init = []
    ref = _loop_run(t4, models, "wa", loop, epochs, init=init)
    return ref, init[0]


def _compare(ref, got, what, free=()):
    """free: the parameters left out of the weights' comparison, whose
    gradients the caller showed to be rounding noise (_bias_noise)"""
    (ha, la, wa), (hb, lb, wb) = ref, got
    assert ha == hb, f"{what}: hit counts differ: {ha} vs {hb}"
    assert abs(float(la) - float(lb)) < MESH_LOSS_TOL, (what, la, lb)
    for i, (a, b) in enumerate(zip(wa, wb)):
        if i not in free:
            np.testing.assert_allclose(b, a, rtol=0, atol=MESH_W_ATOL,
                                       err_msg=f"{what}: param {i}")


@pytest.mark.parametrize("mesh_spec", ["dp4", "dp2,tp2"])
def test_word_loop_mesh_matches_single_device(t4, monkeypatch, mesh_spec,
                                              fresh_jax_chunk_programs):
    """test_word_mesh's pin: 7 batches an epoch in chunks of 3 (3 + 3 and
    a one-batch tail), 2 epochs at the defaults; the port's loop over 4
    gloo ranks against the single-device run the JAX test computes"""
    from tensorforth_tpu_torch.parallel import launch
    env = {"T4_MAX_BATCH": "7", "T4_CHUNK": "3"}
    ref, s = _jax_single_device(t4, monkeypatch, env, WORD_LOOP, 2)
    got, shape, counts = launch.run(_rank_word_loop, 4, mesh_spec, env,
                                    WORD_LOOP, 2, s)
    assert shape == ((4, 1) if mesh_spec == "dp4" else (2, 2))
    assert counts["chunks"] >= 1 and counts["captures"] == 0
    _compare(ref, got, mesh_spec)


def test_word_loop_mesh_chunk_rollback(t4, monkeypatch,
                                       fresh_jax_chunk_programs):
    """a weight read in the loop (`0 nn.w`) rolls each chunk back and
    replays it; the dp4 run still lands on the single-device numbers"""
    from tensorforth_tpu_torch.parallel import launch
    env = {"T4_MAX_BATCH": "5", "T4_CHUNK": "4"}
    ref, s = _jax_single_device(t4, monkeypatch, env, PROBE_LOOP, 2)
    got, _shape, _c = launch.run(_rank_word_loop, 4, "dp4", env,
                                 PROBE_LOOP, 2, s)
    _compare(ref, got, "dp4+rollback")


def _rank_unset(rank, world):
    import os
    from tensorforth_tpu_torch.nn import funcs
    os.environ.pop("T4_MESH", None)
    none = funcs.word_mesh()
    os.environ["T4_MESH"] = "dp4096"
    over = funcs.word_mesh()
    os.environ["T4_MESH"] = "dp2"
    return none, over, funcs.word_mesh().shape


def test_word_mesh_unset_is_none(monkeypatch):
    """no T4_MESH, no mesh; a spec asking for more ranks than the group
    has (or any spec in one process) is None, as in the JAX package"""
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.parallel import launch
    monkeypatch.delenv("T4_MESH", raising=False)
    assert funcs.word_mesh() is None
    monkeypatch.setenv("T4_MESH", "dp4096")
    assert funcs.word_mesh() is None
    none, over, shape = launch.run(_rank_unset, 2)
    assert none is None and over is None and shape == (2, 1)


def _rank_nn_train(rank, world, spec):
    import os
    from tensorforth_tpu_torch.nn import cycle, funcs
    os.environ.update({"T4_MAX_BATCH": "4", "T4_MESH": spec})
    inst = _port_repl()
    out = inst.forth("""0 trace
16 28 28 1 nn.model
flatten 64 linear relu 10 linear softmax
constant mm2
mm2 batchsize dataset mnist_train constant dm2
mm2 dm2 0.001 40 nn.train""")
    out += inst.forth("dm2 rewind\nmm2 dm2 forward nn.hit .")
    return out, funcs.word_mesh().shape, dict(cycle.COUNTS)


def test_nn_train_on_mesh():
    """test_parallel's nn.train under T4_MESH, on 4 gloo ranks as dp2,tp2
    (the JAX test's dp4,tp2 needs 8 processes): 40 epochs of 4 batches,
    then a batch's hits at least 10 of 16, as the JAX test asks; the
    epochs ran uncaptured"""
    from tensorforth_tpu_torch.parallel import launch
    out, shape, counts = launch.run(_rank_nn_train, 4, "dp2,tp2")
    assert shape == (2, 2) and counts["captures"] == 0
    assert "not in the port yet" not in out and "ERROR" not in out
    last = [ln for ln in out.strip().split("\n") if ln][-1]
    assert int(float(last.split()[0])) >= 10, out[-500:]


def _rank_witness(rank, world, spec, batches):
    import os
    import chip_smoke as cs
    os.environ["T4_MESH"] = spec
    return cs._mesh_word_loop("cpu", 2, batches, EXAMPLES)


EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


@pytest.mark.parametrize("spec", ["dp2", "dp2,tp2"])
def test_word_loop_mesh_bit_equal_to_its_emulation(spec):
    """chip_smoke's witness: t4_30e's word loop (nn_c, batch 100, 2
    epochs of 3 batches) under the mesh equals, bit for bit, one process
    that runs the ranks' arithmetic in turn with no collective
    (_emulated_mesh), at the ranks' own CPU thread count (the CPU's sums
    split over threads)"""
    import torch
    import chip_smoke as cs
    from tensorforth_tpu_torch.parallel import launch
    world = 4 if "tp" in spec else 2
    got = launch.run(_rank_witness, world, spec, 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        with cs._emulated_mesh(spec):
            emu = cs._mesh_word_loop("cpu", 2, 3, EXAMPLES)
    finally:
        torch.set_num_threads(threads)
    assert got["printed"] == emu["printed"] and len(emu["printed"]) == 2
    assert not got["faults"] and not emu["faults"]
    for a, b in zip(got["weights"], emu["weights"]):
        np.testing.assert_array_equal(a, b)


BN_MODEL = """0 trace
8 28 28 1 nn.model
2 3 conv2d batchnorm relu flatten 12 linear batchnorm relu
10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d
"""


def _free_biases(m):
    """(layer, index in tf.weights' order) of each bias whose features are
    the channels of the batchnorm that takes its layer's output: the
    batchnorm subtracts each channel's batch mean, so that bias's exact
    gradient is zero (a linear layer's features lie along W, its
    batchnorm's one channel along C: its bias is not free)"""
    from tensorforth_tpu_torch.nn.funcs import Layer
    prog, out, at = m._program(), [], 0
    for j, pl in enumerate(m._params()):
        if (len(pl) == 2 and j + 1 < len(prog)
                and prog[j + 1][0] == Layer.BATCHNM
                and pl[1].numel() == m[j + 1].C()):
            out.append((j, at + 1))
        at += len(pl)
    return out


def _bias_noise(m, free, steps):
    """for each free bias (_free_biases): (index, g, bound), g the most
    any of the `steps` Adam steps' gradients can have been, per channel,
    from Adam's second moment v_T = sum_t (1 - b2) b2^(T-t) g_t^2 (so
    |g_t| <= sqrt(v_T / ((1 - b2) b2^(T-1)))), and bound = n u S, u =
    2^-24, the rounding of an f32 sum of n terms whose exact value is 0:
    n the batch's rows a channel sums over, S the sum of their magnitudes
    in the last step (backprop leaves the batchnorm's input gradient in
    its input activation)"""
    b2 = 0.999
    out = []
    for j, at in free:
        v = m[j].mtum[3].numpy().ravel().astype(np.float64)
        g = np.sqrt(v / ((1 - b2) * b2 ** (steps - 1)))
        dx = m[j + 1].numpy()
        dx = dx.reshape(-1, dx.shape[-1]).astype(np.float64)
        out.append((at, g, dx.shape[0] * 2.0 ** -24 * np.abs(dx).sum(0)))
    return out


def _rank_batchnorm(rank, world, env):
    """a batchnorm program's word loop: one process alone (no T4_MESH)
    and then, from the same weights, under dp2 on the group, each with
    the collectives it issued; then the refusals"""
    import os
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tests import test_torch_fusion as tf
    os.environ.update(env)
    inst = _port_repl()                 # one REPL: the MMU is one a process
    runs, snap = {}, None
    for spec, v in (("", "bo"), ("dp2", "bm")):
        os.environ["T4_MESH"] = spec
        before = dict(pm.COUNTS)
        inst.forth(BN_MODEL.format(name=v))
        m = tf.models(inst)[-1]
        if snap is None:
            snap = tf.snap(m)
        tf.pin(m, snap)
        inst.forth(WORD_LOOP.format(v=v))
        for _ in range(2):
            inst.forth(f"{v}d rewind drop {v} {v}d {v}ep drop")
        hit = inst.forth(f"{v}h @ . cr").strip().split()[0]
        lox = inst.forth(f"{v}l @ . cr").strip().split()[0]
        runs[spec or "one"] = ((hit, lox, tf.weights(m)),
                               {k: pm.COUNTS[k] - before[k] for k in before},
                               _bias_noise(m, _free_biases(m), 6))
    prog = ((funcs.Layer.FLATTEN, (), (7, 784)),)
    errs = []

    def moe_over_ep2():
        os.environ["T4_MESH"] = "ep2"
        return funcs._mesh_for(((funcs.Layer.MOE, (3, 8, 2),
                                 (8, 4, 1, 1)),), 8)
    for call in (lambda: funcs._mesh_for(prog, 7), moe_over_ep2,
                 lambda: funcs._check_mesh(
                     type("M", (), {"tp": 2})(),
                     ((funcs.Layer.LINEAR, (), (8, 1, 5, 1)),))):
        try:
            call()
            errs.append(None)
        except (ValueError, NotImplementedError) as e:
            errs.append(str(e))
    return runs, errs


def test_word_loop_batchnorm_on_mesh():
    """a batchnorm program under dp2: the batch's moments and channel
    means all-reduced over dp (collectives issued), landing on the run
    of one process within test_word_mesh's bounds; the conv's bias, whose
    exact gradient is zero (its channels are the batchnorm's), is left
    out of the weights' comparison, and in its place its gradients are
    shown to be rounding noise in both runs (_bias_noise; ROADMAP C12);
    an odd batch, MoE experts that do not divide ep and output features
    that do not divide tp raise"""
    from tensorforth_tpu_torch.parallel import launch
    env = {"T4_MAX_BATCH": "3", "T4_CHUNK": "2"}
    runs, errs = launch.run(_rank_batchnorm, 2, env)
    (one, c1, n1), (dp2, c2, n2) = runs["one"], runs["dp2"]
    assert not any(c1.values())          # no collective, no hop
    # forward: one moments' all-reduce a batchnorm layer; backward: one
    # means' all-reduce a batchnorm layer and one a weight or bias
    assert c2["all_reduce"] >= 6 * (2 * 2 + 6) and c2["all_gather"] > 0
    for noise in (n1, n2):
        assert [at for at, _, _ in noise] == [1]    # the conv's bias
        for at, g, bound in noise:
            assert (g <= bound).all(), (at, g, bound)
    _compare(one, dp2, "batchnorm dp2", free=(1,))
    assert "batch of 7 does not divide over dp2" in errs[0]
    assert "3 experts do not divide over ep2" in errs[1]
    assert "do not divide over tp2" in errs[2]


# --- test_lm's mesh-serving pins ------------------------------------------
def _rank_generate(rank, world, spec, params, prompt):
    import os
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn import serve
    m = zoo.tiny_lm(batch=4, seq=24, vocab=16, dim=16, heads=4, layers=2,
                    rope=True, device="cpu")
    weights.load_jax_params(m, params)
    runs = {}
    for mesh in ("", spec):
        os.environ["T4_MESH"] = mesh
        runs[mesh or "one"] = (
            serve.generate(m, prompt, n_new=16, temp=0.0),
            serve.generate(m, prompt, n_new=16, temp=0.0, kv_dtype="int8",
                           win=8),
            serve.generate(m, prompt, n_new=16, temp=0.9, seed=5, top_k=4),
            serve.generate(m, prompt, n_new=16, temp=0.0, prefill=False))
    sm = serve.serving_mesh(m._program(), prompt.shape[0])
    return runs, None if sm is None else sm.shape


@pytest.mark.parametrize("spec", ["dp2", "dp2,tp2"])
def test_generate_mesh_sharded_matches_single_device(t4, monkeypatch, spec):
    """test_lm's pin: the batch over dp, the heads over tp, the KV caches
    [N/dp, h/tp, S, dh]; greedy tokens equal to the JAX package's
    single-device ones (f32, and int8 with windows), and the port's own
    one-rank tokens equal for a sampled top-k draw and without prefill"""
    from tensorforth_tpu.models import tiny_lm
    from tensorforth_tpu.nn.serve import generate
    from tensorforth_tpu_torch.parallel import launch
    m = tiny_lm(batch=4, seq=24, vocab=16, dim=16, heads=4, layers=2,
                rope=True)
    prompt = np.random.RandomState(3).randint(0, 16, (4, 6)).astype(np.int32)
    monkeypatch.delenv("T4_MESH", raising=False)
    base = generate(m, prompt, n_new=16, temp=0.0)
    base_q8 = generate(m, prompt, n_new=16, temp=0.0, kv_dtype="int8",
                       win=8)
    params = [tuple(np.asarray(w) for w in pl) for pl in m._params()]
    runs, shape = launch.run(_rank_generate, 4 if "tp" in spec else 2,
                             spec, params, prompt)
    assert shape == ((2, 2) if "tp" in spec else (2, 1))
    got = runs[spec]
    np.testing.assert_array_equal(got[0], base, f"{spec} flipped tokens")
    np.testing.assert_array_equal(got[1], base_q8)
    for a, b in zip(got, runs["one"]):
        np.testing.assert_array_equal(a, b)


def _rank_fallback(rank, world):
    import os
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn import serve
    m = zoo.tiny_lm(batch=3, seq=8, vocab=16, dim=16, heads=4, layers=1,
                    device="cpu")
    prompt = np.random.RandomState(1).randint(0, 16, (3, 4))
    os.environ.pop("T4_MESH", None)
    one = serve.generate(m, prompt, n_new=4)
    os.environ["T4_MESH"] = "dp2"
    return (serve.serving_mesh(m._program(), 3),
            serve.serving_mesh(m._program(), 4).shape,
            serve.generate(m, prompt, n_new=4), one)


def test_generate_mesh_falls_back_when_the_batch_does_not_divide():
    """3 prompts over dp2 serve on one device, as in the JAX package"""
    from tensorforth_tpu_torch.parallel import launch
    none, shape, got, one = launch.run(_rank_fallback, 2)
    assert none is None and shape == (2, 1)
    np.testing.assert_array_equal(got, one)
