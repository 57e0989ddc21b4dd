"""K1, K2a and K2b at head dims 640, 768, 896 and 1024 (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) as far as the CPU can hold them.

On the card a cluster of dh / 128 CTAs (5 to 8) splits dh: each forms s2
(and in the backward dp) over its 128 columns, and the partials, each
rounded to f32, are added in f32 in the order of a tree of pairs (each
quad's owner adds them so in Xrs's reduce-scatter), ((x0 + x1) + (x2 + x3)) + x4 at five CTAs up to ((x0 + x1) + (x2 + x3)) +
((x4 + x5) + (x6 + x7)) at eight (ops.attn.cluster_sum).  Here that
order, in both classes, holds the class's tolerance against f64 and
against the JAX package's Pallas kernels in interpret mode at [1, 512,
dh]; every rank of a cluster forms the same bits; the plans and the
source agree; the CPU path launches nothing; a ring chunk at dh 1024
reaches the flash pair; and a tiny_lm with one head of 1024 trains a step
and decodes as the JAX package's does.  Inputs come from numpy seeds;
tolerances are stated at each test (the same as
tests/test_torch_attn_dh512.py's at dh 384 and 512).
"""
import math

import numpy as np
import pytest
import torch

from tensorforth_tpu_torch.nn import funcs
from tensorforth_tpu_torch.ops import attn, gemm
from tests.test_torch_attn_dh512 import (
    TOL_BWD, TOL_BWD_HYBRID, TOL_FWD, TOL_FWD_HYBRID, _f64, _inputs,
    _pallas, _ratio, _source, _worst)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DHS = (640, 768, 896, 1024)
MASKS = [(True, True), (False, True)]   # (causal, with an lse cotangent)


def _tree(parts):
    """the sum of a cluster's partials written out as a tree of pairs,
    rank 0's block of four first"""
    x = parts
    pair = [x[i] + x[i + 1] if i + 1 < len(x) else x[i]
            for i in range(0, len(x), 2)]
    quad = [pair[i] + pair[i + 1] if i + 1 < len(pair) else pair[i]
            for i in range(0, len(pair), 2)]
    return quad[0] + quad[1] if len(quad) > 1 else quad[0]


@pytest.mark.parametrize("cl", [5, 6, 7, 8])
def test_every_rank_forms_the_same_bits(cl):
    """the tree of pairs: each rank adds the sums of the blocks beside its
    own (1, 2, then 4 ranks) to its own, and an f32 sum of two terms
    commutes, so every rank's sum is the same bits: ((x0 + x1) + (x2 +
    x3)) + x4 at five CTAs, ... + ((x4 + x5) + x6) at seven, the order
    Xrs's owners add in (one slot and four barriers in the f32 class).
    That is not the left-to-right sum, on some of 2^16 elements: the
    order is the kernel's, not any order."""
    rs = np.random.RandomState(cl)
    parts = [torch.from_numpy(rs.randn(1 << 16).astype(np.float32))
             for _ in range(cl)]
    sums = [attn.cluster_sum(parts, r) for r in range(cl)]
    assert all(torch.equal(s, sums[0]) for s in sums)
    assert torch.equal(sums[0], _tree(parts))
    left = parts[0]
    for p in parts[1:]:
        left = left + p
    assert not torch.equal(sums[0], left)
    assert attn.exchange_barriers(cl) == attn.xrs_barriers(1) == 4


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("causal,with_dlse", MASKS, ids=str)
def test_cluster_order_holds_the_f32_class_against_f64(dh, causal,
                                                       with_dlse):
    """the six products taken exactly, the cluster's partials rounded to
    f32 and added in the tree's order: o and lse within 0.05 of the
    forward's f64 tolerance (2e-5 + 2e-5 |x|), dq, dk, dv within 0.01 of
    the backward's (2e-4 + 2e-4 |x|)"""
    q, k, v, do, dlse = _inputs(dh, 31 + causal)
    cl = dh // 128
    fwd64, grads64 = _f64(q, k, v, do, dlse, causal)
    o, lse = attn.flash_attention_split_ref(q, k, v, causal, 3, cl)
    assert _ratio((o, lse), fwd64, TOL_FWD) <= 0.05
    o32, lse32 = attn.flash_attention_ref(q, k, v, causal)
    got = attn.flash_attention_bwd_split_ref(q, k, v, o32, lse32, do, causal,
                                             3, dlse, cl)
    assert _ratio(got, grads64, TOL_BWD) <= 0.01


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
@pytest.mark.parametrize("causal", [True, False])
def test_cluster_order_matches_the_pallas_kernels(dh, hybrid, causal):
    """the plain versions in the cluster's sum order against the JAX
    package's flash_attention and flash_attention_bwd in interpret mode,
    with an lse cotangent, the backward on the Pallas forward's o and lse.
    f32: o and lse within 2e-5, dq, dk, dv within 2e-4, absolute plus
    relative.  hybrid: o and lse within 3e-2, each gradient within 5% of
    its largest value."""
    q, k, v, do, dlse = _inputs(dh, 41 + 2 * hybrid + causal)
    cl = dh // 128
    (oj, lj), want = _pallas(q, k, v, do, dlse, causal, hybrid)
    if hybrid:
        o, lse = attn.flash_attention_ref(q, k, v, causal, True, cl)
        got = attn.flash_attention_bwd_ref(q, k, v, oj, lj, do, causal, True,
                                           dlse, cl)
        np.testing.assert_allclose(o.numpy(), oj.numpy(),
                                   rtol=TOL_FWD_HYBRID, atol=TOL_FWD_HYBRID)
        np.testing.assert_allclose(lse.numpy(), lj.numpy(),
                                   rtol=TOL_FWD_HYBRID, atol=TOL_FWD_HYBRID)
        for g, w in zip(got, want):
            assert ((g - w).abs().max() <= TOL_BWD_HYBRID * w.abs().max())
    else:
        o, lse = attn.flash_attention_split_ref(q, k, v, causal, 3, cl)
        got = attn.flash_attention_bwd_split_ref(q, k, v, oj, lj, do, causal,
                                                 3, dlse, cl)
        assert _ratio((o, lse), (oj, lj), TOL_FWD) <= 1
        assert _ratio(got, want, TOL_BWD) <= 1


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_plans_take_the_cluster_route_the_source_builds(dh, hybrid):
    """both classes at dh 640 to 1024: the backward on a cluster of dh /
    128 CTAs (5 to 8, a portable cluster's most), each with the dh-128
    tiles of its class over its 128 columns and Xrs's exchange (the f32
    class one 32 KB slot and four barriers: the two rounds' receipts and
    reads; the hybrid class two slots and the two receipts); the f32
    class's forward on the same cluster (Xrs with one slot: four
    barriers); the hybrid forward on the wide route's pair
    of CTAs (four warpgroups each, tests/test_torch_fwd_wide_bf16.py);
    each route's shared memory is the source's static_assert, under 227
    KB; the grid is cluster x B*h x S / rows CTAs; the C entries take the
    route"""
    cl, parts = dh // 128, 1 if hybrid else 3
    fwd = attn.fwd_plan(16, 2048, dh, hybrid)
    bwd = attn.bwd_plan(16, 2048, dh, hybrid)
    assert bwd.dq.cluster == bwd.dkv.cluster == cl <= 8
    assert fwd.blocks == cl
    assert attn.fwd_cluster(dh) == attn.bwd_cluster(dh, hybrid) == cl
    assert bwd.dq.tile == 64 and bwd.dq.ctas == cl * 16 * 2048 // 64
    assert max(fwd.smem, bwd.dkv.smem) <= gemm.SM90_SMEM_LIMIT
    assert (bwd.dq.smem, bwd.dkv.smem) == {3: (230456, 230968),
                                           1: (164920, 165944)}[parts]
    assert (f"Bwd<{dh}, {parts}, {cl}>::SMEM_DKV == {bwd.dkv.smem}"
            in _source("flash_bwd.cu"))
    src = _source("flash_bwd.cu")
    for kernel in ("DKV", "DQ", "BWD_CL"):
        assert (f"if (dh == {dh} && parts == {parts}) return "
                f"T4_{kernel}({dh}, {parts}, {cl});") in src
    assert "CL >= 3 && CL <= 8" in _source("sm90_gemm.cuh")
    if hybrid:
        assert (fwd.cluster, fwd.warpgroups, fwd.v_stages) == (2, 4, 1)
        assert (fwd.bq, fwd.bkv) == attn.WIDE_TILES == (64, 32)
        assert fwd.ctas == 2 * 16 * 2048 // 64
        assert fwd.smem == 205872
        assert f"Wide<{dh}>::SMEM == {fwd.smem}" in _source("flash_fwd.cuh")
        for kernel in ("WIDE", "WIDE_CL"):
            assert (f"if (dh == {dh} && parts == 1) return "
                    f"T4_{kernel}({dh});") in _source("flash_fwd.cu")
        return
    assert fwd.cluster == cl
    assert (fwd.bq, fwd.bkv) == attn.FWD_TILES[128] == (128, 64)
    assert fwd.ctas == cl * 16 * 2048 // 128
    # the dh-128 tiles, the 32 KB slot and Xrs's four barriers
    assert fwd.smem == 230456
    assert (f"Fwd<{dh}, {parts}, {cl}>::SMEM == {fwd.smem}"
            in _source("flash_fwd.cuh"))
    for kernel in ("FWD", "FWD_CL"):
        assert (f"if (dh == {dh} && parts == {parts}) return "
                f"T4_{kernel}({dh}, {parts}, {cl});") in _source(
                    "flash_fwd.cu")


@pytest.mark.parametrize("dh", DHS)
def test_cpu_path_launches_nothing(dh):
    """CPU tensors at dh 640 to 1024 take the plain versions through the
    differentiable (o, lse) pair: no kernel and no split launch"""
    q, k, v, do, dlse = _inputs(dh, 61)
    counts = (attn.flash_attention.launches,
              attn.flash_attention.split_launches,
              dict(attn.flash_attention_bwd.launches),
              attn.flash_attention_bwd.split_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attn.flash_attention_lse(*leaves, True)
    torch.autograd.backward([o, lse], [do, dlse])
    o_r, lse_r = attn.flash_attention_ref(q, k, v, True)
    assert torch.equal(o.detach(), o_r) and torch.equal(lse.detach(), lse_r)
    want = attn.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, True,
                                        dlse=dlse)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    assert counts == (attn.flash_attention.launches,
                      attn.flash_attention.split_launches,
                      dict(attn.flash_attention_bwd.launches),
                      attn.flash_attention_bwd.split_launches)


def test_ring_chunk_at_dh1024_takes_the_flash_pair(monkeypatch):
    """parallel/ring.py's chunk attention follows funcs._flash_ok: with
    the gate's device half opened (a CUDA tensor on the card), a square
    [2, 512, 1024] chunk goes through flash_attention_lse (K1 forward,
    K2a/K2b backward: K4), a [2, 512, 1152] one through the einsum"""
    from tensorforth_tpu_torch.parallel import ring
    calls = []
    real = attn.flash_attention_lse

    def pair(q, k, v, causal, hybrid):
        calls.append(q.shape[-1])
        return real(q, k, v, causal, hybrid)

    monkeypatch.setattr(funcs, "_flash_ok",
                        lambda q: funcs._flash_shape_ok(q.shape[1],
                                                        q.shape[2]))
    monkeypatch.setattr(attn, "flash_attention_lse", pair)
    for dh in (1024, 1152):
        q, k, v, _, _ = _inputs(dh, 81, with_dlse=False)
        o, lse = ring._chunk_attn(q, k, v, True)
        o_r, lse_r = attn.flash_attention_ref(q, k, v, True)
        np.testing.assert_allclose(o.numpy(), o_r.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), lse_r.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert calls == [1024]


LM1024 = dict(dim=1024, heads=1, seq=512, layers=1)
LR = 0.01


def test_train_step_at_dh1024_matches_jax(t4):
    """tiny_lm(dim=1024, heads=1, seq=512, layers=1, rope=True): the head
    dim whose flash kernels run on clusters of eight CTAs on the card.
    One forward / loss(CE) / backprop / adam(0.01) step of the port
    against the JAX package's with its weights (weights.load_jax_params
    carries the one-head model).  The bounds and their reasons are
    tests/test_torch_attn_dh512.py's dh-512 step's: every layer output,
    dx, dw and db, and Adam's m and v within 1e-5 of the tensor's largest
    value, the loss within 1e-5 of itself; the weights after Adam's first
    step within 1e-5 where the gradient is at least 1e-2, elsewhere the
    update of the port's own m and v (within 1e-6) and within two steps
    of the JAX weight."""
    from tests.test_torch_train import _jax_state, _np, _pair
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.nn.ntypes import Loss
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(
        LM1024["layers"], True, dim=LM1024["dim"], heads=LM1024["heads"],
        seq=LM1024["seq"])
    # the carrier kept every weight of the one-head model
    for a, b in zip(_jax_state(mj), weights.dump_state(mt)):
        assert np.array_equal(a["w"], b["w"])
    layers = range(mj.numel)
    mj.forward(inp_j)
    mt.forward(inp_t)
    assert _worst((_np(mt[i]), _np(mj[i])) for i in layers) <= 1e-5
    lj, lt = mj.loss(Loss.CE, hot_j), mt.loss(Loss.CE, hot_t)
    assert abs(lj - lt) <= 1e-5 * abs(lj)
    mj.backprop(hot_j)
    mt.backprop(hot_t)
    assert _worst((_np(mt[i]), _np(mj[i])) for i in layers) <= 1e-5
    before = [(b["w"].reshape(-1).copy(), a["dw"].reshape(-1))
              for a, b in zip(_jax_state(mj), weights.dump_state(mt))]
    assert _worst((b["dw"], a["dw"]) for a, b in zip(
        _jax_state(mj), weights.dump_state(mt))) <= 1e-5
    mj.adam(LR)
    mt.adam(LR)
    after = list(zip(_jax_state(mj), weights.dump_state(mt)))
    for key in ("m", "v"):
        assert _worst((b[key], a[key]) for a, b in after) <= 1e-5
    two_steps = 2 * LR * 0.1 / math.sqrt(0.001)
    for (w0, g), (a, b) in zip(before, after):
        w, wj = b["w"].reshape(-1), a["w"].reshape(-1)
        big = np.abs(g) >= 1e-2
        np.testing.assert_allclose(w[big], wj[big], rtol=0, atol=1e-5)
        own = w0 - LR * b["m"].reshape(-1) / (np.sqrt(b["v"].reshape(-1))
                                              + 1e-6)
        np.testing.assert_allclose(w[~big], own[~big], rtol=0, atol=1e-6)
        assert np.abs(w - wj).max() <= two_steps


def test_greedy_tokens_at_dh1024_match_jax():
    """the same dh-1024 tiny_lm, with the JAX package's generate reading
    the port's weights: greedy tokens equal, f32 cache, batched prefill
    (the flash path on the card) and the sequential replay"""
    import jax.numpy as jnp
    from types import SimpleNamespace
    from tensorforth_tpu.nn.serve import generate as jax_generate
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.weights import load_jax_params
    mt = tiny_lm(batch=2, vocab=32, rope=True, device="cpu", **LM1024)
    rs = np.random.RandomState(73)
    params = []
    for lp in mt._params():
        layer = []
        for i, a in enumerate(lp):
            w = rs.randn(*a.shape).astype(np.float32)
            if a.dim() == 2:
                w *= 8.0 / np.sqrt(a.shape[1])   # decode walks many tokens
            else:
                w = w * 0.1 + (1.0 if i == 0 and lp[0].dim() == 1 else 0.0)
            layer.append(w)
        params.append(tuple(layer))
    load_jax_params(mt, params)
    jparams = tuple(tuple(jnp.asarray(a) for a in lp) for lp in params)
    mj = SimpleNamespace(_program=mt._program, _params=lambda: jparams)
    prompt = rs.randint(0, 32, (2, 12))
    for prefill in (True, False):
        kw = dict(temp=0.0, kv_dtype="float32", prefill=prefill)
        got = generate(mt, prompt, 8, **kw)
        np.testing.assert_array_equal(got, jax_generate(mj, prompt, 8, **kw))
    assert len(np.unique(got[:, 12:])) > 2
