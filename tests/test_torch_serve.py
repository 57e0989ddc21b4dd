"""The port's serving slice (tensorforth_tpu_torch: tiny_lm -> generate)
held against the JAX package.  CPU only: the same numpy weights are
loaded into the port model with weights.load_jax_params and handed to
the JAX serving code, and the same numpy inputs go through both
packages."""
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tensorforth_tpu.nn import serve as jserve
from tensorforth_tpu_torch.nn import serve as tserve
from tensorforth_tpu_torch.weights import load_jax_params

from tests.test_torch_threads import one_torch_thread  # noqa: F401

LM = dict(batch=2, seq=24, vocab=32, dim=32, heads=4, layers=2)


def _pair(rope, seed=0):
    """(a stand-in for the JAX model, a port tiny_lm) holding the same
    weights.  JAX's generate() reads a model through _program() and
    _params() alone; the two packages' programs are equal
    (test_tiny_lm_program_matches_jax).  The weights are drawn wider than
    the init's (matrices at 8/sqrt(fan-in), norm gains near 1) so that
    greedy decode walks through many tokens instead of settling on one."""
    from tensorforth_tpu_torch.models import tiny_lm
    mt = tiny_lm(**LM, rope=rope, device="cpu")
    rs = np.random.RandomState(seed)
    params = []
    for lp in mt._params():
        layer = []
        for i, a in enumerate(lp):
            w = rs.randn(*a.shape).astype(np.float32)
            if a.dim() == 2:
                w *= 8.0 / np.sqrt(a.shape[1])
            else:
                w = w * 0.1 + (1.0 if i == 0 and lp[0].dim() == 1 else 0.0)
            layer.append(w)
        params.append(tuple(layer))
    load_jax_params(mt, params)
    jparams = tuple(tuple(jnp.asarray(a) for a in lp) for lp in params)
    mj = SimpleNamespace(_program=mt._program, _params=lambda: jparams)
    return mj, mt


@pytest.mark.parametrize("rope", [False, True])
def test_tiny_lm_program_matches_jax(t4, rope):
    """the port's tiny_lm has the JAX package's program and parameter
    shapes"""
    from tensorforth_tpu.models import tiny_lm as jax_lm
    from tensorforth_tpu_torch.models import tiny_lm as torch_lm
    mj = jax_lm(**LM, rope=rope)
    mt = torch_lm(**LM, rope=rope, device="cpu")
    assert mt._program() == mj._program()
    assert ([[tuple(a.shape) for a in lp] for lp in mt._params()]
            == [[tuple(a.shape) for a in lp] for lp in mj._params()])


def test_quant8_matches_jax():
    """identical int8 codes (both round half to even); scales within
    1e-7 relative error"""
    rs = np.random.RandomState(1)
    v = rs.randn(3, 4, 9, 16).astype(np.float32)
    v[0, 0, 0] = 0.0                          # the 1e-8 scale floor
    v[1, 2, 3, :2] = [127.0 / 2, -127.0 / 2]  # exact .5 after scaling
    qj, sj = jserve._quant8(jnp.asarray(v))
    qt, st = tserve._quant8(torch.from_numpy(v))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_filter_top_k_matches_jax(k):
    lg = np.random.RandomState(k).randn(4, 16).astype(np.float32)
    want = np.asarray(jserve._filter_top_k(jnp.asarray(lg), k))
    got = tserve._filter_top_k(torch.from_numpy(lg), k).numpy()
    np.testing.assert_array_equal(got == -1.0e30, want == -1.0e30)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.3, 0.8, 0.95])
def test_filter_top_p_matches_jax(p):
    lg = (np.random.RandomState(int(p * 100)).randn(4, 16) * 2
          ).astype(np.float32)
    want = np.asarray(jserve._filter_top_p(jnp.asarray(lg), p))
    got = tserve._filter_top_p(torch.from_numpy(lg), p).numpy()
    np.testing.assert_array_equal(got == -1.0e30, want == -1.0e30)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rope", [False, True])
def test_generate_greedy_tokens_match_jax(rope):
    """f32 cache, greedy: identical tokens to the JAX package for the
    batched prefill and the sequential replay, with and without
    windowed decode (win=4 runs the segment loop)"""
    from tensorforth_tpu.nn.serve import generate as jax_generate
    from tensorforth_tpu_torch.nn.serve import generate as torch_generate
    mj, mt = _pair(rope)
    prompt = np.random.RandomState(2).randint(0, 32, (2, 5))
    outs = []
    for prefill in (True, False):
        for win in (0, 4):
            kw = dict(temp=0.0, kv_dtype="float32", win=win,
                      prefill=prefill)
            want = jax_generate(mj, prompt, 19, **kw)
            got = torch_generate(mt, prompt, 19, **kw)
            assert got.shape == (2, 24) and got.dtype == np.int32
            np.testing.assert_array_equal(
                got, want, f"rope={rope} prefill={prefill} win={win}")
            outs.append(got)
    assert len(np.unique(outs[0][:, 5:])) > 3      # decode is not stuck


@pytest.mark.parametrize("seed,top_k,top_p", [(7, 0, 0.0), (3, 4, 0.0),
                                                (5, 0, 0.9)],
                         ids=["plain", "top_k4", "top_p0.9"])
@pytest.mark.parametrize("prefill", [True, False])
@pytest.mark.parametrize("win", [0, 4])
def test_generate_sampled_tokens_match_jax(seed, top_k, top_p, prefill, win):
    """temp 1.0, f32 cache: the same tokens as the JAX package.  Both draw
    argmax(gumbel + logits) with one split of PRNGKey(seed) per pick, the
    gumbel noise from the same threefry bits and XLA CPU's logs; the
    logits agree to f32 rounding, so no draw flips at these seeds."""
    from tensorforth_tpu.nn.serve import generate as jax_generate
    from tensorforth_tpu_torch.nn.serve import generate as torch_generate
    mj, mt = _pair(rope=True)
    prompt = np.random.RandomState(2).randint(0, 32, (2, 5))
    kw = dict(temp=1.0, seed=seed, top_k=top_k, top_p=top_p,
              kv_dtype="float32", win=win, prefill=prefill)
    want = jax_generate(mj, prompt, 12, **kw)
    got = torch_generate(mt, prompt, 12, **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:, 5:])) > 3          # the draw is not stuck


def test_gumbel_and_keys_match_jax():
    """the draw's pieces bit for bit: split, fold_in, uniform and the
    gumbel noise of jax.random.categorical"""
    import jax
    from tensorforth_tpu_torch.ops import rng

    def pair(k):
        return tuple(int(v) for v in np.asarray(k))

    for seed in (0, 7, 2280545969, 1258627373665771185):
        k = jax.random.PRNGKey(seed)
        assert rng.PRNGKey(seed) == pair(k)
        assert rng.split(rng.PRNGKey(seed), 3) == [
            pair(x) for x in jax.random.split(k, 3)]
        for d in (0, 1, 5, 123456):
            assert rng.fold_in(rng.PRNGKey(seed), d) == pair(
                jax.random.fold_in(k, d))
        sub = jax.random.split(k)[1]
        for shape in ((2, 32), (3, 5, 7), (4097,)):
            got = rng.uniform(pair(sub), shape).numpy()
            want = np.asarray(jax.random.uniform(sub, shape))
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            got = rng.gumbel(pair(sub), shape).numpy()
            want = np.asarray(jax.jit(
                lambda k_, s=shape: jax.random.gumbel(k_, s))(sub))
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


@pytest.mark.parametrize("kv,tol", [("bfloat16", 2e-2), ("int8", 3e-2)])
def test_step_token_low_precision_cache_matches_jax(kv, tol, monkeypatch):
    """bf16 and int8 caches: _step_token logits for identical inputs
    (2e-2 bf16, 3e-2 int8 — the packages round to bf16/int8 at other
    places); the stored K/V agree too, layer by layer: layer 0's within
    the same bounds (one rounding of f32 values that may differ in their
    last bit), and layer 1's from the same layer-0 entries.  (The two
    packages' f32 GEMMs sum in another order (ROADMAP C11), so a layer-0
    value within that last bit of a bf16 rounding point may round to the
    neighbouring bf16 value in one of them; layer 1 reads it through
    attention, wo, layernorm and wqkv, which carry that one step to 0.125
    in its own entries.  Where layer 0's entries differ, layer 1 is held
    on a step whose layer-0 entries are the JAX package's.)"""
    mj, mt = _pair(rope=True, seed=3)
    program = mj._program()
    rs = np.random.RandomState(4)
    n, s_max, t = 2, 24, 9
    h, dh = 4, 8
    kv_prefix = rs.randn(2, n, h, s_max, dh).astype(np.float32)
    kv_prefix[:, :, :, t:] = 0.0
    tok = rs.randint(0, 32, (n,))

    def jax_caches():
        if kv == "int8":
            out = []
            for _ in range(2):
                qk, sk = jserve._quant8(jnp.asarray(kv_prefix[0]))
                qv, sv = jserve._quant8(jnp.asarray(kv_prefix[1]))
                out.append((qk, qv, sk, sv))
            return tuple(out)
        c = jnp.asarray(kv_prefix).astype(jnp.bfloat16)
        return tuple((c[0], c[1], None, None) for _ in range(2))

    def torch_caches():
        if kv == "int8":
            out = []
            for _ in range(2):
                qk, sk = tserve._quant8(torch.from_numpy(kv_prefix[0]))
                qv, sv = tserve._quant8(torch.from_numpy(kv_prefix[1]))
                out.append((qk, qv, sk, sv))
            return out
        c = torch.from_numpy(kv_prefix).to(torch.bfloat16)
        return [(c[0].clone(), c[1].clone(), None, None) for _ in range(2)]

    def close(ct, cj, layer):
        for a, b in zip(ct[layer], cj[layer]):
            if a is not None:
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=tol, atol=tol)

    def same(ct, cj, layer):
        return all(np.array_equal(a.float().numpy(),
                                  np.asarray(b, np.float32))
                   for a, b in zip(ct[layer], cj[layer]) if a is not None)

    def jax_layer0(cj):
        """tserve._store_at, whose first store (layer 0's) then takes the
        JAX package's entries at t"""
        real, calls = tserve._store_at, []

        def store(cache, tt, k1, v1):
            real(cache, tt, k1, v1)
            if not calls:
                for c, b in zip(cache, cj[0]):
                    if c is not None:
                        c[:, :, t] = torch.from_numpy(np.asarray(b)[
                            :, :, t].astype(np.float32)).to(c.dtype)
            calls.append(1)
        return store

    for w in (0, 16):
        lj, cj = jserve._step_token(program, mj._params(), jax_caches(),
                                    jnp.asarray(tok, jnp.int32), t, s_max,
                                    w=w)
        lt, ct = tserve._step_token(program, mt._params(), torch_caches(),
                                    torch.from_numpy(tok), t, s_max, w=w)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=tol, atol=tol)
        close(ct, cj, 0)
        if not same(ct, cj, 0):
            with monkeypatch.context() as mp:
                mp.setattr(tserve, "_store_at", jax_layer0(cj))
                lt, ct = tserve._step_token(program, mt._params(),
                                            torch_caches(),
                                            torch.from_numpy(tok), t,
                                            s_max, w=w)
            assert same(ct, cj, 0)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       rtol=tol, atol=tol)
        close(ct, cj, 1)


def test_load_jax_params_rejects_mismatch(t4):
    from tensorforth_tpu.models import tiny_lm as jax_lm
    from tensorforth_tpu_torch.models import tiny_lm as torch_lm
    mj = jax_lm(**LM)
    params = [tuple(np.asarray(a) for a in lp) for lp in mj._params()]
    wide = torch_lm(**dict(LM, dim=64), device="cpu")
    with pytest.raises(ValueError):
        load_jax_params(wide, params)
    deep = torch_lm(**dict(LM, layers=3), device="cpu")
    with pytest.raises(ValueError):
        load_jax_params(deep, params)
    roped = torch_lm(**LM, rope=True, device="cpu")
    with pytest.raises(ValueError):
        load_jax_params(roped, params, program=mj._program())


def test_entry_points_raise_without_gpu():
    """device=None means the CUDA card: with no card the entry points
    raise instead of falling back to the CPU"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.mu.mmu import MMU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_lm(**LM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MMU.get_mmu().tensor(2, 3)
