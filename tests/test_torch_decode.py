"""The port's decode on its device-position body (nn/serve.py Decoder:
the step reads its position, token and key from device buffers, so that
the card can replay it as a captured CUDA graph; on the CPU the same body
runs eagerly, step by step) against the JAX package's `generate`, on the
CPU: greedy and sampled tokens, windows, the three cache types, prefill
on and off, n_new = 0 and test_lm.py's MoE LM; the window segments and
the key chain the body reads; the Decoder cache's signature; and the LM
tier's class Functions (nn/funcs.py class_einsum, class_matmul): exact
f32 on the CPU, and a named class's products, forward and backward,
against f64 of the bf16 parts.
"""
import json

import numpy as np
import pytest
import torch

from tests.test_torch_serve import _pair
from tests.test_torch_threads import one_torch_thread  # noqa: F401

# a named class's products against f64 of the class's bf16 parts: the
# parts multiply exactly in f32, so only the f32 sums round (K ≤ 64 terms
# here: 64 · 2⁻²⁴ of the largest term)
TOL_CLASS = 1e-5


def _both(mj, mt, prompt, n_new, **kw):
    from tensorforth_tpu.nn.serve import generate as jax_generate
    from tensorforth_tpu_torch.nn import serve
    serve.reset_counts()
    got = serve.generate(mt, prompt, n_new, **kw)
    return got, jax_generate(mj, prompt, n_new, **kw)


@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "steps"])
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pick", ["greedy", "top_k", "top_p"])
def test_device_position_body_matches_jax(kv, prefill, pick):
    """the JAX package's tokens from the eager device-position body, with
    windowed segments (win 4: windows 8 and 16 after a 5-token prompt,
    4, 8 and 16 without the prefill); one eager step a token after the
    prefill, none replayed"""
    from tensorforth_tpu_torch.nn import serve
    mj, mt = _pair(rope=True)
    prompt = np.random.RandomState(2).randint(0, 32, (2, 5))
    kw = {"greedy": dict(temp=0.0),
          "top_k": dict(temp=1.0, seed=3, top_k=4),
          "top_p": dict(temp=0.8, seed=5, top_p=0.9)}[pick]
    got, want = _both(mj, mt, prompt, 12, kv_dtype=kv, win=4,
                      prefill=prefill, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:, 5:])) > 3          # decode is not stuck
    assert serve.COUNTS == {"captures": 0, "replays": 0,
                            "steps": 11 if prefill else 16}


@pytest.mark.parametrize("win", [0, 8])
@pytest.mark.parametrize("prefill", [True, False], ids=["prefill", "steps"])
def test_n_new_zero_returns_the_prompt(win, prefill):
    """(test_lm.py:228) n_new = 0 returns the prompt, as the JAX package
    does"""
    mj, mt = _pair(rope=False)
    prompt = np.arange(12) % 32
    got, want = _both(mj, mt, prompt, 0, temp=0.0, win=win, prefill=prefill)
    np.testing.assert_array_equal(got, prompt)
    np.testing.assert_array_equal(got, want)


def _moe_lm(pkg):
    """test_lm.py:207-225's MoE LM"""
    if pkg == "jax":
        from tensorforth_tpu.models.zoo import _new_model
        from tensorforth_tpu.nn.ntypes import Layer
        m = _new_model(1, 24, 1, 1)
    else:
        from tensorforth_tpu_torch.models.zoo import _new_model
        from tensorforth_tpu_torch.nn.ntypes import Layer
        m = _new_model(1, 24, 1, 1, device="cpu")
    m.add(Layer.EMBED, 16, 16.0)
    m.add(Layer.LNORM)
    m.add(Layer.ATTN, 4, 1.0)               # causal
    m.add(Layer.MOE, 4, 32.0, [2])          # 4 experts, top-2
    m.add(Layer.TANH)
    m.add(Layer.PROJ, 16)
    m.add(Layer.SOFTMAX)
    return m


@pytest.mark.parametrize("dispatch", ["", "1"], ids=["auto", "dispatch"])
def test_moe_lm_matches_jax(t4, monkeypatch, dispatch):
    """(test_lm.py:207) the MoE layer in the prefill and in the step:
    the JAX package's tokens, with the weights carried over, and prefill
    and sequential tokens equal.  Under T4_MOE_DISPATCH=1 both routes
    take the dispatch path, whose capacity follows each call's token
    count (5 slots an expert for the 8-token prefill, 1 for a step), so
    the prefill drops assignments a step does not and the two sequences
    part, in both packages alike"""
    from tensorforth_tpu.nn import serve as jserve
    from tensorforth_tpu_torch import weights
    monkeypatch.setenv("T4_MOE_DISPATCH", dispatch)
    # the JAX package reads the switch when it traces; the port when it
    # runs.  A fresh trace reads this case's
    jserve._generate.clear_cache()
    from tensorforth_tpu.system import System as JSystem
    JSystem.get_sys().seed(3)
    mj, mt = _moe_lm("jax"), _moe_lm("torch")
    assert mt._program() == mj._program()
    weights.load_jax_params(
        mt, [tuple(np.asarray(a) for a in lp) for lp in mj._params()])
    prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    seq, jseq = _both(mj, mt, prompt, 16, temp=0.0, prefill=False)
    pre, jpre = _both(mj, mt, prompt, 16, temp=0.0, prefill=True)
    np.testing.assert_array_equal(seq, jseq)
    np.testing.assert_array_equal(pre, jpre)
    if not dispatch:
        np.testing.assert_array_equal(seq, pre, "MoE prefill diverged")


def test_serve_generate_is_one_segment():
    """the serve phase's shape: a 2048-token prompt, 64 new tokens and
    T4_DECODE_WIN=512 double the first window to s_max, so the decode
    is one graph of 63 replays; shorter prompts have several segments,
    each window covering its positions (the JAX package's loop,
    serve.py:370-383)"""
    from tensorforth_tpu_torch.nn.serve import _segments
    assert _segments(2048, 2112, 512) == [(2112, 63)]
    assert _segments(5, 17, 4) == [(8, 3), (16, 8)]
    assert _segments(0, 17, 4) == [(4, 4), (8, 4), (16, 8)]
    assert _segments(5, 17, 0) == [(17, 11)]
    assert _segments(12, 12, 8) == []
    for t0, s_max, win in ((5, 17, 4), (0, 40, 3), (30, 31, 8), (7, 64, 1)):
        segs, t = _segments(t0, s_max, win), t0
        for w, steps in segs:
            assert t + steps <= w or w == s_max   # reads stay in the window
            t += steps
        assert t == max(t0, s_max - 1)


def test_key_chain_is_jax_split():
    """the n pick keys the body reads are those of n successive
    `key, sub = jax.random.split(key)`"""
    import jax
    from tensorforth_tpu_torch.ops import rng
    for seed in (0, 7, 123456789):
        k, want = jax.random.PRNGKey(seed), []
        for _ in range(6):
            k, sub = jax.random.split(k)
            want.append(tuple(int(v) for v in np.asarray(sub)))
        assert rng.split_chain(rng.PRNGKey(seed), 6) == want


def test_decoder_cache_keys_on_weights_and_settings(monkeypatch):
    """a Decoder is reused for the same model, signature and weights;
    weights loaded anew, another class or another MoE routing make a new
    one (a capture would replay what it baked in)"""
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.nn import serve
    _mj, mt = _pair(rope=False)
    prog = mt._program()

    def dec():
        return serve._decoder(mt._uid, prog, mt._params(), 2, 20, "float32",
                              False, 0, 0.0, torch.device("cpu"))

    a = dec()
    assert dec() is a
    weights.load_jax_params(mt, [tuple(w.clone() for w in lp)
                                 for lp in mt._params()])
    b = dec()
    assert b is not a and dec() is b
    monkeypatch.setattr(Config, "PRECISION", "strict")
    assert dec() is not b
    monkeypatch.setattr(Config, "PRECISION", "fast")
    monkeypatch.setenv("T4_MOE_DISPATCH", "1")
    assert dec() is not b


# --- the LM tier's class Functions -------------------------------------------------
SPECS = {"qk": ("nqd,nkd->nqk", (3, 8, 16), (3, 8, 16)),
         "pv": ("nqk,nkd->nqd", (3, 8, 8), (3, 8, 16)),
         "experts": ("ntd,edf->ntef", (2, 4, 16), (4, 16, 8)),
         "combine": ("nted,nte->ntd", (2, 4, 3, 8), (2, 4, 3)),
         "decode": ("nhd,nhsd->nhs", (2, 4, 16), (2, 4, 8, 16))}


@pytest.mark.parametrize("spec", list(SPECS))
def test_class_einsum_is_plain_f32_on_the_cpu(spec):
    """with no class named, a CPU einsum is torch.einsum, forward and
    backward bit for bit (the CPU tests against the JAX package do not
    move)"""
    from tensorforth_tpu_torch.nn import funcs
    s, sa, sb = SPECS[spec]
    rs = np.random.RandomState(0)
    a0, b0 = (torch.from_numpy(rs.randn(*sh).astype(np.float32))
              for sh in (sa, sb))
    g = None
    outs = []
    for fn in (funcs.class_einsum, torch.einsum):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y = fn(s, a, b)
        g = torch.ones_like(y) if g is None else g
        outs.append((y.detach(), *torch.autograd.grad(y, (a, b), g)))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    a = torch.from_numpy(rs.randn(5, 16).astype(np.float32))
    w = torch.from_numpy(rs.randn(7, 16).astype(np.float32))
    assert torch.equal(funcs.class_matmul(a, w.T), a @ w.T)


def _parts(x, cls):
    """the class's bf16 parts of x, in f64: (hi,) or (hi, lo)"""
    hi = x.to(torch.bfloat16).double()
    if cls == "fast":
        return (hi,)
    return hi, (x - x.to(torch.bfloat16).float()).to(torch.bfloat16).double()


def _class_ref(spec, a, b, cls):
    """the class's sum of products of bf16 parts, in f64: hi·hi, and
    under strict also lo·hi + hi·lo"""
    pa, pb = _parts(a, cls), _parts(b, cls)
    y = torch.einsum(spec, pa[0], pb[0])
    if cls == "strict":
        y = y + torch.einsum(spec, pa[1], pb[0]) + torch.einsum(
            spec, pa[0], pb[1])
    return y


@pytest.mark.parametrize("cls", ["fast", "strict"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_named_class_products_against_f64_of_parts(spec, cls):
    """a named class on the CPU computes the card's arithmetic: the
    forward and both cotangents are class products of bf16 parts (of a
    and b, of g and b, of a and g), within TOL_CLASS of their largest
    value of f64 over the same parts, and away from exact f32 by about
    the class's rounding"""
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.funcs import _grad_specs
    s, sa, sb = SPECS[spec]
    rs = np.random.RandomState(1)
    a = torch.from_numpy(rs.randn(*sa).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rs.randn(*sb).astype(np.float32)).requires_grad_(True)
    y = funcs.class_einsum(s, a, b, cls)
    g = torch.from_numpy(rs.randn(*y.shape).astype(np.float32))
    da, db = torch.autograd.grad(y, (a, b), g)
    sga, sgb = _grad_specs(s)
    a_, b_ = a.detach(), b.detach()
    for got, want in ((y.detach(), _class_ref(s, a_, b_, cls)),
                      (da, _class_ref(sga, g, b_, cls)),
                      (db, _class_ref(sgb, a_, g, cls))):
        top = want.abs().max()
        assert (got.double() - want).abs().max() <= TOL_CLASS * top
    exact = torch.einsum(s, a_.double(), b_.double())
    off = float((y.detach().double() - exact).abs().max() / exact.abs().max())
    assert (1e-4 < off < 2e-2) if cls == "fast" else off < 1e-4, off


def test_chip_smoke_serve_phase_runs_tiny_on_the_cpu(capsys):
    """chip_smoke.py's `serve` phase at a tiny size on the CPU: the eager
    body steps once a token after the prefill, its tokens equal the
    uncaptured control's (the same body) and the strict replay, and the
    MoE LM's too"""
    import chip_smoke as cs
    lm = dict(batch=2, vocab=16, dim=32, heads=4, layers=2, rope=True)
    cs.phase_serve(0, device="cpu", lm=lm, n_prompt=16, n_new=6,
                   moe_lm_cfg=dict(lm, layers=1))
    out = capsys.readouterr().out
    line = next(json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"phase": "serve"'))
    assert line["checks"] and all(line["checks"].values()), line["checks"]
    assert '"decode_counts": {"captures": 0, "replays": 0, "steps": 5}' \
        in out
