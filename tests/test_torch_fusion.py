"""The fused training cycle of the port's REPL (nn/model.py, nn/cycle.py)
against its own per-word path and against the JAX package, on the CPU:
test_fusion.py's cases.  After one canonical `forward loss.X ...
backprop nn.adam` cycle the next runs as one fused body whose slices the
words apply; what the words leave must be what the per-word path leaves.

Each case runs twice:
  per_word  the port with T4_NO_FUSE=1 T4_NO_MACRO=1, then the port at
            its defaults, from the same weights: the same printed hits
            and losses, the weights equal bit for bit (the fused body
            calls the words' own functions in their order);
  jax       the JAX package at its defaults, then the port at its
            defaults, from the same weights: test_fusion.py's contract,
            hits and losses printed alike, weights within 1e-6, or within
            JAX_ATOL after steps at a rate of 0.01 (see there).
The last test holds the fused body itself against the JAX package's
get_fused_cycle_ds on equal inputs.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_repl import t4p  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MODEL = """0 trace
8 28 28 1 nn.model
flatten 16 linear relu {drop}10 linear softmax
constant {name}
{name} batchsize dataset mnist_train constant {name}d
"""
LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
        ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
        "backprop {lr} nn.adam next ;")
MODES = ("per_word", "jax")
# the two packages' f32 GEMMs sum in another order, and Adam's m / sqrt(v)
# magnifies that last bit where a gradient is near zero: after 12 steps at
# a rate of 0.01 one weight in 160 lay 1.39e-6 from the JAX package's
# (the port's fused and per-word paths agree bit for bit there)
JAX_ATOL = 5e-6
# the fused body against the JAX package's: XLA CPU's conv and GEMM sums
# run in another order than torch's; at the test's shapes the outputs lay
# up to 1.7e-6 of their largest value apart (the gradients and moments)
TOL_BODY = 1e-5
PER_WORD = {"T4_NO_FUSE": "1", "T4_NO_MACRO": "1"}
DEFAULT = {"T4_NO_FUSE": "0", "T4_NO_MACRO": "0"}


@pytest.fixture(autouse=True)
def same_data_roots(monkeypatch):
    """both packages search the port's data roots"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu_torch.config import Config
    monkeypatch.setattr(JConfig, "DATA_ROOTS", list(Config.DATA_ROOTS))


@pytest.fixture(autouse=True)
def fresh_jax_chunk_programs():
    """after each test, the JAX package's compiled chunk programs as a
    fresh process has them: tests/test_chunk.py reads that cache's size
    to see that its dropout model's chunk was built, and the same
    program left there by a [jax] case of the port's tests (the same
    model at the same shapes) hid the build when both files ran in one
    test worker"""
    yield
    from tensorforth_tpu.nn import funcs
    funcs.get_fused_chunk_ds.cache_clear()


def models(inst):
    return [o for o in inst.vm.mmu._objs.values()
            if getattr(o, "is_model", lambda: False)()]


def host(w):
    return (w.detach().cpu().numpy() if torch.is_tensor(w)
            else np.asarray(w)).astype(np.float32)


def snap(m):
    return [tuple(host(w) for w in pl) for pl in m._params()]


def pin(m, s):
    for j in range(m.numel - 1):
        for k, w in enumerate(s[j]):
            g = m[j].grad[k]
            g.replace_data(np.asarray(w, np.float32).reshape(g.shape))


def weights(m):
    return [host(w) for pl in m._params() for w in pl]


def paired_runs(mode, t4, t4p):
    """[(instance, env)] of the reference run and the port's default run"""
    first = (t4p, PER_WORD) if mode == "per_word" else (t4, DEFAULT)
    return [first, (t4p, DEFAULT)]


def set_env(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def assert_weights(mode, wa, wb, atol):
    """per_word: equal bit for bit; jax: within the reference test's
    tolerance"""
    for i, (a, b) in enumerate(zip(wa, wb)):
        if mode == "per_word":
            np.testing.assert_array_equal(b, a, err_msg=f"param {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                       err_msg=f"param {i}")


def first_word(out):
    return out.strip().split()[0]


@pytest.mark.parametrize("mode", MODES)
def test_fused_cycle_matches_unfused_word_loop(t4, t4p, monkeypatch, mode):
    """identical hits, losses and weights, fusion on against the
    reference; the port's fused cycle must have run"""
    from tensorforth_tpu_torch.nn import cycle
    monkeypatch.setenv("T4_MAX_BATCH", "4")
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "ma" if n == 0 else "mb"
        inst.forth(MODEL.format(name=name, drop=""))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        cycle.reset_counts()
        inst.forth(LOOP.format(v=name, lr="0.001"))
        for _ in range(3):
            inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        got.append((first_word(inst.forth(f"{name}h @ . cr")),
                    first_word(inst.forth(f"{name}l @ . cr")), weights(m)))
    assert m._fuse_sig is not None and cycle.COUNTS["fused"] >= 1, \
        "the fused cycle never ran"
    (ha, la, wa), (hb, lb, wb) = got
    assert ha == hb and la == lb, (ha, hb, la, lb)
    assert_weights(mode, wa, wb, 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_fusion_lr_change_falls_back(t4, t4p, monkeypatch, mode):
    """a new rate mid-run voids the speculative step and arms again at
    the new rate: the mixed-rate run lands where the reference lands"""
    monkeypatch.setenv("T4_MAX_BATCH", "4")
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "mc" if n == 0 else "mf"
        inst.forth(MODEL.format(name=name, drop=""))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        inst.forth(LOOP.format(v=name, lr="0.001"))
        inst.forth(f": {name}ep2 for forward loss.ce {name}l ! "
                   f"nn.hit {name}h +! backprop 0.01 nn.adam next ;")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep2 drop")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep2 drop")
        got.append((first_word(inst.forth(f"{name}l @ . cr")), weights(m)))
    (la, wa), (lb, wb) = got
    assert la == lb, (la, lb)
    assert_weights(mode, wa, wb, JAX_ATOL)
    assert "3 " in t4p.forth("1 2 + . cr")


@pytest.mark.parametrize("mode", MODES)
def test_fusion_direct_weight_write_breaks_safely(t4, t4p, monkeypatch,
                                                  mode):
    """nn.w= between backprop and nn.adam voids the stash: the written
    weight survives into the step (one small Adam step from all ones),
    and the run ends where the reference's does"""
    monkeypatch.setenv("T4_MAX_BATCH", "4")
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "md" if n == 0 else "mg"
        inst.forth(MODEL.format(name=name, drop=""))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        inst.forth(LOOP.format(v=name, lr="0.001"))
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        inst.forth(f"{name}d rewind drop")
        inst.forth(f"{name} {name}d forward loss.ce {name}l ! backprop")
        inst.forth(f"{name} 160 vector ones 3 nn.w= drop")
        inst.forth(f"{name} 0.001 nn.adam drop")
        w = float(first_word(inst.forth(f"{name} 3 nn.w sum . cr drop")))
        assert abs(w - 160.0) < 2.0, f"the nn.w= write was lost: {w}"
        got.append(weights(m))
    assert_weights(mode, got[0], got[1], 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_fusion_eval_loop_after_training(t4, t4p, monkeypatch, mode):
    """an eval-only loop right after fused training counts the
    reference's hits, leaves the weights alone and disarms fusion"""
    monkeypatch.setenv("T4_MAX_BATCH", "4")
    got, s = [], None
    for n, (inst, env) in enumerate(paired_runs(mode, t4, t4p)):
        set_env(monkeypatch, env)
        name = "me" if n == 0 else "mh"
        inst.forth(MODEL.format(name=name, drop=""))
        m = models(inst)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        inst.forth(LOOP.format(v=name, lr="0.001"))
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        w_before = weights(m)
        inst.forth(f"variable {name}v 0 {name}v !")
        inst.forth(f": {name}ev for forward nn.hit {name}v +! next ;")
        inst.forth(f"{name}d rewind drop {name} {name}d {name}ev drop")
        hits = first_word(inst.forth(f"{name}v @ . cr"))
        assert 0 <= int(float(hits)) <= 32
        for a, b in zip(w_before, weights(m)):
            np.testing.assert_array_equal(a, b)
        if env is DEFAULT:            # the eval forward disarmed fusion
            assert m._fuse_sig is None and m._pending is None
        got.append((hits, w_before))
    assert got[0][0] == got[1][0]
    assert_weights(mode, got[0][1], got[1][1], 1e-6)


def test_fused_cycle_on_a_batch_already_made(t4p, monkeypatch):
    """a batch some reader made before the forward (so it is no longer a
    corpus offset) takes the fused cycle over an input copied in (the
    JAX package's get_fused_cycle): the same values as the per-word
    path, bit for bit"""
    from tensorforth_tpu_torch.mu.dataset import Dataset
    from tensorforth_tpu_torch.nn import cycle
    load = Dataset._load

    def made(self, data, label):
        load(self, data, label)
        self.ensure_data()

    monkeypatch.setattr(Dataset, "_load", made)
    monkeypatch.setenv("T4_MAX_BATCH", "4")
    got, s = [], None
    for name, env in (("mx", PER_WORD), ("my", DEFAULT)):
        set_env(monkeypatch, env)
        t4p.forth(MODEL.format(name=name, drop=""))
        m = models(t4p)[-1]
        if s is None:
            s = snap(m)
        else:
            pin(m, s)
        cycle.reset_counts()
        t4p.forth(LOOP.format(v=name, lr="0.001"))
        for _ in range(2):
            t4p.forth(f"{name}d rewind drop {name} {name}d {name}ep drop")
        got.append((first_word(t4p.forth(f"{name}h @ . cr")),
                    first_word(t4p.forth(f"{name}l @ . cr")), weights(m)))
    assert cycle.COUNTS["fused"] >= 4 and cycle.COUNTS["chunks"] == 0
    (ha, la, wa), (hb, lb, wb) = got
    assert ha == hb and la == lb
    assert_weights("per_word", wa, wb, 0)


def test_failed_cycle_raises_through_the_word(t4p, monkeypatch):
    """a fused cycle that fails (on the card: its capture or a replay)
    raises through the words, with no per-word run in its place; the REPL
    goes on.  The native inner interpreter runs the colon word and names
    the word that raised, `forward` (the JAX package's engine does the
    same); the Python loop names the word typed, `mzep`"""
    from tensorforth_tpu_torch.nn import cycle

    def fail(self, k=1):
        raise RuntimeError("the cycle failed")

    monkeypatch.setenv("T4_MAX_BATCH", "4")
    set_env(monkeypatch, DEFAULT)
    t4p.forth(MODEL.format(name="mz", drop=""))
    t4p.forth(LOOP.format(v="mz", lr="0.001"))
    monkeypatch.setattr(cycle.Cycle, "run", fail)
    out = t4p.forth("mzd rewind drop mz mzd mzep drop")
    assert t4p.vm._engine is not None
    assert "ERROR in 'forward': the cycle failed" in out
    # the arming cycle ran word by word, the failed one nothing more
    assert first_word(t4p.forth("mzh @ . cr")) != "0"
    assert models(t4p)[-1]._iter == 1
    assert "3 " in t4p.forth("1 2 + . cr")


@pytest.mark.parametrize("opt", ["adam", "sgdm"])
def test_fused_body_matches_jax_get_fused_cycle_ds(opt):
    """the port's fused body (one run of a Cycle over a corpus) against
    the JAX package's get_fused_cycle_ds on equal inputs: all 16 outputs.
    All within TOL_BODY of each output's largest value; the labels,
    the hit count and the finite status equal"""
    import jax.numpy as jnp
    from tensorforth_tpu.nn import funcs as jfuncs
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.nn import cycle
    from tensorforth_tpu_torch.nn.ntypes import Layer

    rs = np.random.RandomState(3)
    mmu = MMU.get_mmu()
    m = mmu.model(device="cpu")
    m.npush(mmu.tensor(8, 6, 6, 2, device="cpu"))
    m.add(Layer.CONV, 4, 0.5, [3, 1, 0, 1])
    m.add(Layer.MAXPOOL, 2)
    m.add(Layer.RELU)
    m.add(Layer.FLATTEN)
    m.add(Layer.LINEAR, 16, 1.0)
    m.add(Layer.TANH)
    m.add(Layer.LINEAR, 5, 1.0)
    m.add(Layer.SOFTMAX)
    m.grad_alloc({"adam": 2, "sgdm": 1}[opt])
    prog = m._program()
    hyper = (0.01, 0.9, 0.999, 0.0) if opt == "adam" else (0.05, 0.9, 0, 0)
    buf = rs.randint(0, 256, size=(40, 6, 6, 2)).astype(np.uint8)
    lab = rs.randint(0, 5, size=40).astype(np.int64)
    pos, mean, scale = 16, 12.0, 1.0 / 64.0
    tr = m._trainables()
    ws = [rs.randn(*t.grad[s].shape).astype(np.float32) * 0.3 for t, s in tr]
    ms = [rs.randn(*w.shape).astype(np.float32) * 0.01 for w in ws]
    vs = [np.abs(rs.randn(*w.shape)).astype(np.float32) * 1e-4 for w in ws]
    for (t, s), w, mm, v in zip(tr, ws, ms, vs):
        t.grad[s].set_numpy(w)
        t.mtum[s].set_numpy(mm)
        if opt == "adam":
            t.mtum[s + 2].set_numpy(v)
    cyc = cycle.get(m, prog, True, "ce", opt, m._ndivs(),
                    ("ds", torch.from_numpy(buf), torch.from_numpy(lab), 8,
                     mean, scale, tuple(m[0].shape)), 1)
    cyc.load(m._fused_state(), pos, None, hyper)
    cyc.run(1)
    got = cyc.stash

    jparams = tuple(tuple(jnp.asarray(host(w)) for w in pl)
                    for pl in m._params())
    dws, dbs = m._gather_grads()
    z1 = jnp.zeros((1,), jnp.float32)
    jd = tuple(jnp.asarray(host(d)) if d is not None else z1 for d in dws)
    jb = tuple(jnp.asarray(host(d)) if d is not None else z1 for d in dbs)
    fn = jfuncs.get_fused_cycle_ds(prog, True, "ce", opt, m._ndivs(), 8,
                                   mean, scale, tuple(m[0].shape))
    import jax
    want = fn(jnp.asarray(buf), jnp.asarray(lab, jnp.int32), jnp.int32(pos),
              jparams, jd, jb, tuple(jnp.asarray(x) for x in ms),
              tuple(jnp.asarray(x) for x in vs) if opt == "adam" else (),
              jax.random.PRNGKey(0),
              *(jnp.float32(h) for h in hyper))
    names = ("x", "labels", "outs", "masks", "hot", "hit", "lval", "dout",
             "dxs", "ndws", "ndbs", "nws", "nms", "nvs", "zdws", "fin")
    assert len(got) == len(want) == 16
    for name, g, w in zip(names, got, want):
        if opt != "adam" and name == "nvs":
            continue                      # sgdm keeps no second moment
        gl = [x for x in jax.tree_util.tree_leaves(
            g, is_leaf=lambda v: v is None or torch.is_tensor(v))
            if x is not None]
        wl = jax.tree_util.tree_leaves(w)
        if name in ("ndws", "ndbs"):      # the JAX placeholders of the
            wl = [x for x in wl if x.shape != (1,)]     # parameterless
        assert len(gl) == len(wl), name
        for a, b in zip(gl, wl):
            a, b = host(a), np.asarray(b, np.float32)
            assert a.size == b.size, name
            a, b = a.reshape(-1), b.reshape(-1)
            if name in ("labels", "fin", "hit"):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                tol = TOL_BODY * max(float(np.abs(b).max()), 1e-30)
                np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                           err_msg=name)
