"""K1, K2a and K2b at head dims 384 and 512 (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) as far as the CPU can hold them.

On the card a cluster of dh / 128 CTAs splits dh: each forms s2 (and in
the backward dp) over its 128 columns, and the partials, each rounded to
f32, are added in f32 in pairs, (x0 + x1) + x2 at three CTAs and
(x0 + x1) + (x2 + x3) at four (ops.attn.cluster_sum).  Here that order,
in both classes, holds the class's tolerance against f64 and against the
JAX package's Pallas kernels in interpret mode at [1, 512, 384] and
[1, 512, 512]; every rank of a cluster forms the same bits; the plans
and the source agree; the gate admits 128 to 1024 and refuses 1152; the
CPU path launches nothing; and a tiny_lm with one head of 512 trains a
step and decodes as the JAX package's does.  Inputs come from numpy
seeds; tolerances are stated at each test.
"""
import math
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.ops.attn_pallas import (
    flash_attention as jax_flash, flash_attention_bwd as jax_flash_bwd)
from tensorforth_tpu_torch.nn import funcs
from tensorforth_tpu_torch.ops import attn, gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(attn.__file__), "csrc")
TOL_FWD = 2e-5     # absolute plus relative: tests/test_torch_attn.py
TOL_FWD_HYBRID = 3e-2  # the hybrid forward's: tests/test_torch_attn.py
TOL_BWD = 2e-4     # absolute plus relative: tests/test_attention.py:185
TOL_BWD_HYBRID = 0.05  # of the largest value: tests/test_torch_attn_bwd.py
DHS = (384, 512)
MASKS = [(True, True), (False, True)]   # (causal, with an lse cotangent)


def _inputs(dh, seed, with_dlse=True):
    """q, k, v, do [1, 512, dh] and dlse [1, 512]: randn from a numpy seed"""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 512, dh).astype(np.float32))
                   for _ in range(4))
    dlse = (torch.from_numpy(rs.randn(1, 512).astype(np.float32))
            if with_dlse else None)
    return q, k, v, do, dlse


def _ratio(got, want, tol):
    """the largest |got - want| / (tol + tol |want|)"""
    return max(((g.double() - w.double()).abs()
                / (tol + tol * w.double().abs())).max().item()
               for g, w in zip(got, want))


def _f64(q, k, v, do, dlse, causal):
    """(o, lse) and dq, dk, dv of the exact attention by f64 autograd"""
    s, dh = q.shape[1], q.shape[2]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    sc = torch.einsum("nqd,nkd->nqk", leaves[0], leaves[1]) / math.sqrt(dh)
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            attn.NEG_INF)
    o = torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1), leaves[2])
    lse = torch.logsumexp(sc, dim=-1)
    grads = torch.autograd.grad([o, lse], leaves, [do.double(),
                                                   dlse.double()])
    return (o.detach(), lse.detach()), grads


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("causal,with_dlse", MASKS, ids=str)
def test_cluster_order_holds_the_f32_class_against_f64(dh, causal,
                                                       with_dlse):
    """the six products taken exactly, the cluster's partials rounded to
    f32 and added in pairs: o and lse within 0.05 of the forward's f64
    tolerance (2e-5 + 2e-5 |x|), dq, dk, dv within 0.01 of the
    backward's (2e-4 + 2e-4 |x|)"""
    q, k, v, do, dlse = _inputs(dh, 31 + causal)
    cl = dh // 128
    fwd64, grads64 = _f64(q, k, v, do, dlse, causal)
    o, lse = attn.flash_attention_split_ref(q, k, v, causal, 3, cl)
    assert _ratio((o, lse), fwd64, TOL_FWD) <= 0.05
    o32, lse32 = attn.flash_attention_ref(q, k, v, causal)
    got = attn.flash_attention_bwd_split_ref(q, k, v, o32, lse32, do, causal,
                                             3, dlse, cl)
    assert _ratio(got, grads64, TOL_BWD) <= 0.01


def _pallas(q, k, v, do, dlse, causal, hybrid):
    """the JAX package's forward (o, lse [B, S]) and backward (dq, dk, dv)
    in interpret mode; the f32 class at precision highest, as
    tests/test_attention.py runs it"""
    with jax.default_matmul_precision("float32" if hybrid else "highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = jax_flash(qj, kj, vj, causal=causal, return_lse=True,
                           interpret=True, hybrid=hybrid)
        grads = jax_flash_bwd(qj, kj, vj, oj, lj, doj, causal=causal,
                              interpret=True, hybrid=hybrid,
                              dlse=jnp.asarray(dlse.numpy()))
    return ((torch.tensor(np.asarray(oj)),
             torch.tensor(np.asarray(lj)[..., 0])),
            [torch.tensor(np.asarray(g)) for g in grads])


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


@pytest.mark.parametrize("cl", [2, 3, 4])
def test_every_rank_forms_the_same_bits(cl):
    """each CTA adds the partials in its own order (its pair's first, its
    own first within it), and an f32 sum of two terms commutes: every
    rank's sum is the same bits, (x0 + x1) + x2 or (x0 + x1) + (x2 + x3).
    At four CTAs that is not the left-to-right sum, on some of 2^16
    elements: the order is the kernel's, not any order."""
    rs = np.random.RandomState(cl)
    parts = [torch.from_numpy(rs.randn(1 << 16).astype(np.float32))
             for _ in range(cl)]
    sums = [attn.cluster_sum(parts, r) for r in range(cl)]
    assert all(torch.equal(s, sums[0]) for s in sums)
    want = parts[0] + parts[1]
    if cl > 2:
        want = want + (parts[2] if cl == 3 else parts[2] + parts[3])
    assert torch.equal(sums[0], want)
    if cl == 4:
        left = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        assert not torch.equal(sums[0], left)


def test_the_cluster_sums_each_ctas_columns_in_f32():
    """with cluster 4 each CTA's 128 columns form one f32 partial: with q
    zero outside the first 128 columns the scores are that partial alone,
    the one-sum order's exact scores rounded once"""
    q, k, v, do, _ = _inputs(512, 51, with_dlse=False)
    q[..., 128:] = 0
    s1 = attn._cluster_scores(attn._einsum, q.double(), k.double(), 1)
    s4 = attn._cluster_scores(attn._einsum, q.double(), k.double(), 4)
    assert torch.equal(s1, s4)
    o1, l1 = attn.flash_attention_split_ref(q, k, v, True, 3, 1)
    o4, l4 = attn.flash_attention_split_ref(q, k, v, True, 3, 4)
    assert _ratio((o4, l4), (o1, l1), TOL_FWD) <= 0.05


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_plans_take_the_cluster_route_the_source_builds(dh, hybrid):
    """both classes at dh 384 and 512: the backward on a cluster of dh /
    128 CTAs, each with the dh-128 tiles of its class over its 128
    columns and Xrs's exchange (the f32 class one 32 KB slot and four
    barriers, the hybrid class two slots and two barriers); the f32
    class's forward on the same cluster and Xrs's exchange (one slot and
    four barriers); the hybrid forward on the wide route
    (one CTA of dh / 128 warpgroups, tests/test_torch_fwd_wide_bf16.py);
    each route's shared memory is the source's static_assert, under 227
    KB; the grid is cluster x B*h x S / rows CTAs"""
    cl, parts = dh // 128, 1 if hybrid else 3
    fwd = attn.fwd_plan(16, 2048, dh, hybrid)
    bwd = attn.bwd_plan(16, 2048, dh, hybrid)
    assert bwd.dq.cluster == bwd.dkv.cluster == cl == fwd.blocks
    assert attn.fwd_cluster(dh) == attn.bwd_cluster(dh, hybrid) == cl
    assert bwd.dq.tile == 64 and bwd.dq.ctas == cl * 16 * 2048 // 64
    assert max(fwd.smem, bwd.dkv.smem) <= gemm.SM90_SMEM_LIMIT
    assert (bwd.dq.smem, bwd.dkv.smem) == {3: (230456, 230968),
                                           1: (164920, 165944)}[parts]
    src = _source("flash_bwd.cu")
    assert f"Bwd<{dh}, {parts}, {cl}>::SMEM_DKV == {bwd.dkv.smem}" in src
    for kernel in ("DKV", "DQ"):
        assert (f"if (dh == {dh} && parts == {parts}) return "
                f"T4_{kernel}({dh}, {parts}, {cl});") in src
    if hybrid:
        assert (fwd.cluster, fwd.warpgroups) == (1, cl)
        assert (fwd.bq, fwd.bkv) == attn.WIDE_TILES == (64, 32)
        assert fwd.ctas == 16 * 2048 // 64
        assert fwd.smem == {384: 173096, 512: 230440}[dh]
        assert f"Wide<{dh}>::SMEM == {fwd.smem}" in _source("flash_fwd.cuh")
        assert (f"if (dh == {dh} && parts == 1) return T4_WIDE({dh});"
                in _source("flash_fwd.cu"))
        return
    assert fwd.cluster == cl
    assert (fwd.bq, fwd.bkv) == attn.FWD_TILES[128] == (128, 64)
    assert fwd.ctas == cl * 16 * 2048 // 128
    assert fwd.smem == 230456
    assert (f"Fwd<{dh}, {parts}, {cl}>::SMEM == {fwd.smem}"
            in _source("flash_fwd.cuh"))
    assert (f"if (dh == {dh} && parts == {parts}) return "
            f"T4_FWD({dh}, {parts}, {cl});") in _source("flash_fwd.cu")


@pytest.mark.parametrize("source,fn", [
    ("flash_fwd", "t4_flash_fwd"), ("flash_fwd", "t4_flash_fwd_clusters"),
    ("flash_bwd", "t4_flash_bwd_clusters")])
def test_ctypes_tables_match_the_c_entries(source, fn):
    """K1's entry took the plan's cluster, and both sources an occupancy
    query: a pointer passed as an int would be cut to 32 bits"""
    from tests.test_torch_split6 import _c_params
    kind = {attn._P: "p", attn._I: "i", attn._F: "f"}
    assert ([kind[t] for t in attn._ARGTYPES[source][fn]]
            == _c_params(_source(source + ".cu"), fn))


def test_gate_admits_up_to_1024_and_refuses_1152():
    """sdpa's gate (and with it generate's prefill, nn.attn, nn.train's
    graphs and the ring's chunks) admits every dh % 128 == 0 from 128 to
    1024 at S >= 512, S % 256 == 0 (dh 384 to 1024 on clusters of dh /
    128 CTAs, 8 at most); dh 1152 takes the einsum path, the wrappers
    refuse it, bad_args refuses dh > 1024, and neither C entry has a
    route for it"""
    for dh in range(128, 1025, 128):
        assert funcs._flash_shape_ok(512, dh)
        assert funcs._flash_shape_ok(2048, dh)
        assert not funcs._flash_shape_ok(256, dh)
        assert not funcs._flash_shape_ok(640, dh)
    assert not funcs._flash_shape_ok(2048, 1152)
    assert attn.KERNEL_DH == tuple(range(128, 1025, 128))
    x = torch.zeros(1, 512, 1152)
    with pytest.raises(ValueError, match="dh in"):
        attn._check_shape("flash_attention", (x, x, x))
    # the wrappers on a tensor of the card (its shape and device alone:
    # the contract is checked before any data is read)
    cuda = SimpleNamespace(shape=x.shape, device=torch.device("cuda", 0),
                           is_cuda=True)
    lse = SimpleNamespace(shape=x.shape[:2], device=cuda.device,
                          is_cuda=True)
    with pytest.raises(ValueError, match="dh in"):
        attn.flash_attention(cuda, cuda, cuda, True)
    for only in (None, "dkv", "dq"):
        with pytest.raises(ValueError, match="dh in"):
            attn.flash_attention_bwd(cuda, cuda, cuda, cuda, lse, cuda,
                                     True, only=only)
    assert "dh % 128 != 0 || dh > 1024" in _source("flash_bwd.cu")
    for name in ("flash_fwd.cu", "flash_bwd.cu"):
        assert not re.search(r"dh == (11[5-9]\d|1[2-9]\d\d|[2-9]\d{3})",
                             _source(name))


@pytest.mark.parametrize("dh", DHS)
def test_cpu_path_launches_nothing(dh):
    """CPU tensors at dh 384 and 512 take the plain versions through the
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


LM512 = dict(dim=512, heads=1, seq=512, layers=2)


def _worst(pairs):
    """the largest |got - want| over each tensor's largest |want|, of
    (got, want) pairs"""
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in pairs)


LR = 0.01


def test_train_step_at_dh512_matches_jax(t4):
    """tiny_lm(dim=512, heads=1, seq=512, layers=2, rope=True): the head
    dim whose flash kernels run on clusters of four CTAs on the card.  One
    forward / loss(CE) / backprop / adam(0.01) step of the port against
    the JAX package's with its weights (weights.load_jax_params).  Every
    layer output, dx, dw and db, and Adam's m and v, within 1e-5 of the
    tensor's largest value, and the loss within 1e-5 of itself: at dim and
    S 512 the f32 sums are 32 times longer than tests/test_torch_train.py's
    (the two packages' differ by 1.6e-6 of the largest value at most).
    The weights after Adam's first step: within 1e-5 where the gradient is
    at least 1e-2; below that the update m / (sqrt(v) + 1e-6) turns the
    packages' 1e-6 gradient difference into up to twice its step, so there
    each weight is the update of the port's own m and v (within 1e-6) and
    within two steps (2 lr (1 - b1) / sqrt(1 - b2)) of the JAX weight."""
    from tests.test_torch_train import _jax_state, _np, _pair
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.nn.ntypes import Loss
    mj, mt, (inp_j, hot_j), (inp_t, hot_t) = _pair(
        LM512["layers"], True, dim=LM512["dim"], heads=LM512["heads"],
        seq=LM512["seq"])
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


def test_greedy_tokens_at_dh512_match_jax():
    """the same dh-512 tiny_lm, with the JAX package's generate reading
    the port's weights: greedy tokens equal, f32 cache, batched prefill
    (the flash path on the card) and the sequential replay"""
    from tensorforth_tpu.nn.serve import generate as jax_generate
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.weights import load_jax_params
    mt = tiny_lm(batch=2, vocab=32, rope=True, device="cpu", **LM512)
    rs = np.random.RandomState(71)
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
