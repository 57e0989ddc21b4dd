"""K3's f32 class (csrc/flash_bwd_fused.cu: fused_f32_sm90_kernel) as six
bf16 products of the three-part split on wgmma, at dh 128 on one CTA and
at dh 256 on a cluster of two CTAs that split dh, as far as the CPU can
hold it.

The kernel runs only on the card, where chip_smoke.py holds it against
its plain version, against the two-kernel split (six-product K2) and
against f64.  Here: a model of its arithmetic (attn.
flash_attention_bwd_fused_split_ref: the split's parts, the products of
each pair taken exactly and summed in f32 in the kernel's order, at dh 256
each CTA's half of s2 and dp rounded to f32 and the halves added in f32,
p and ds split in turn) against f64 autograd, against the JAX package's
fused kernel in Pallas interpret mode and against six-product K2's plain
version (at dh 256 in its cluster order); the route and the grid that
fused_plan picks from dh and the class; the shared memory of each route
against the source; the launch's refusals on meta tensors; the CPU path;
no FMA body left.  Inputs come from numpy seeds; tolerances are stated at
each test.
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import TOL_FUSED_SPLIT
from tensorforth_tpu.ops import attn_pallas
from tensorforth_tpu_torch.ops import attn, gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "tensorforth_tpu_torch", "ops", "csrc",
                   "flash_bwd_fused.cu")
TOL_BWD = 2e-4     # absolute plus relative: tests/test_attention.py:185


def _case(shape, causal, seed, with_dlse=False):
    """q, k, v, o, lse, do, dlse: randn from a numpy seed, o and lse from
    the f32 forward's plain version"""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(*shape).astype(np.float32))
                   for _ in range(4))
    dlse = (torch.from_numpy(rs.randn(*shape[:2]).astype(np.float32))
            if with_dlse else None)
    o, lse = attn.flash_attention_ref(q, k, v, causal)
    return q, k, v, o, lse, do, dlse


def _f64_grads(q, k, v, do, dlse, causal):
    """dq, dk, dv of the exact (o, lse) attention by f64 autograd"""
    s, dh = q.shape[1], q.shape[2]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    sc = torch.einsum("nqd,nkd->nqk", leaves[0], leaves[1]) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool).tril()
        sc = sc.masked_fill(~keep, attn.NEG_INF)
    outs = [torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1),
                         leaves[2])]
    cots = [do.double()]
    if dlse is not None:
        outs.append(torch.logsumexp(sc, dim=-1))
        cots.append(dlse.double())
    return torch.autograd.grad(outs, leaves, cots)


def _ratio(got, want, tol):
    """the largest |got - want| / (tol + tol |want|) over dq, dk and dv"""
    return max(((g.double() - w.double()).abs()
                / (tol + tol * w.double().abs())).max().item()
               for g, w in zip(got, want))


def _model(q, k, v, o, lse, do, causal, dlse=None, bq=None, sms=attn.N_SM):
    """(dq, dk, dv) of the model, its partials summed as the wrapper sums
    them"""
    dq, dkp, dvp = attn.flash_attention_bwd_fused_split_ref(
        q, k, v, o, lse, do, bq, causal, dlse, sms)
    return dq, dkp.sum(dim=1), dvp.sum(dim=1)


# (shape, causal, with_dlse, bq)
CASES = [((1, 1024, 128), True, False, None), ((1, 512, 128), False, False,
                                                 128),
         ((2, 512, 128), True, True, 256)]
# dh 256: the cluster route
CASES_256 = [((1, 512, 256), True, False, 256),
             ((1, 512, 256), True, True, 128),
             ((1, 256, 256), False, True, None)]


# ---------------------------------------------------------------------------
# (a) the six-product arithmetic of the fused kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,causal,with_dlse,bq", CASES + CASES_256,
                         ids=str)
def test_model_holds_the_class_against_f64(shape, causal, with_dlse, bq):
    """within 0.01 of the class's f64 tolerance, 2e-4 + 2e-4 |x|: what is
    left is the f32 roundings of s2, p, dp, ds (at dh 256 of each half of
    s2 and dp, and of their sum), of each pair's products and of the
    forward's o and lse"""
    q, k, v, o, lse, do, dlse = _case(shape, causal, 31, with_dlse)
    got = _model(q, k, v, o, lse, do, causal, dlse, bq)
    assert _ratio(got, _f64_grads(q, k, v, do, dlse, causal), TOL_BWD) <= 0.01


@pytest.mark.parametrize("causal", [False, True])
def test_model_matches_the_pallas_fused_backward(causal):
    """against the JAX package's fused kernel in interpret mode at
    precision highest, on the Pallas forward's o and lse, bq 256 (two Q
    blocks): within 1e-5 + 1e-5 |x|, the tolerance of the JAX package's
    own fused test (tests/test_attention.py:364-368)"""
    b, s, dh, bq = 1, 512, 128, 256
    q, k, v, _, _, do, _ = _case((b, s, dh), causal, 32)
    with jax.default_matmul_precision("highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = attn_pallas.flash_attention(qj, kj, vj, causal=causal,
                                             return_lse=True, interpret=True)
        want = attn_pallas.flash_attention_bwd_fused(
            qj, kj, vj, oj, lj, doj, bq=bq, bkv=256, causal=causal,
            interpret=True)
    o = torch.tensor(np.asarray(oj))
    lse = torch.tensor(np.asarray(lj)[..., 0])
    got = _model(q, k, v, o, lse, do, causal, None, bq)
    assert _ratio(got, [torch.tensor(np.asarray(w)) for w in want],
                  TOL_FUSED_SPLIT) <= 1


@pytest.mark.parametrize("shape,causal,with_dlse,bq", CASES + CASES_256,
                         ids=str)
def test_model_keeps_the_fused_equals_split_margin(shape, causal, with_dlse,
                                                   bq):
    """against six-product K2's plain version (the products of the same
    parts taken exactly over the whole reduction; at dh 256 in its
    cluster's order, cluster 2, as K2's cluster kernels sum s2 and dp):
    within 0.3 of chip_smoke.py's fused-equals-split bound, 1e-5 + 1e-5
    |x|, so the check keeps most of its margin for the tensor cores'
    sums"""
    q, k, v, o, lse, do, dlse = _case(shape, causal, 33, with_dlse)
    got = _model(q, k, v, o, lse, do, causal, dlse, bq)
    six = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal,
                                             3, dlse, shape[2] // 128)
    assert _ratio(got, six, TOL_FUSED_SPLIT) <= 0.3


@pytest.mark.parametrize("causal,with_dlse", [(True, True), (False, False)],
                         ids=str)
def test_cluster_model_matches_the_pallas_fused_backward(causal, with_dlse):
    """dh 256: against the JAX package's fused kernel in interpret mode at
    precision highest, on the Pallas forward's o and lse, bq 256 (two Q
    blocks): within 1e-5 + 1e-5 |x|, the tolerance of the JAX package's
    own fused test (tests/test_attention.py:364-368)"""
    b, s, dh, bq = 1, 512, 256, 256
    q, k, v, _, _, do, dlse = _case((b, s, dh), causal, 37, with_dlse)
    with jax.default_matmul_precision("highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = attn_pallas.flash_attention(qj, kj, vj, causal=causal,
                                             return_lse=True, interpret=True)
        want = attn_pallas.flash_attention_bwd_fused(
            qj, kj, vj, oj, lj, doj, bq=bq, bkv=256, causal=causal,
            interpret=True,
            dlse=None if dlse is None else jnp.asarray(dlse.numpy()))
    o = torch.tensor(np.asarray(oj))
    lse = torch.tensor(np.asarray(lj)[..., 0])
    got = _model(q, k, v, o, lse, do, causal, dlse, bq)
    assert _ratio(got, [torch.tensor(np.asarray(w)) for w in want],
                  TOL_FUSED_SPLIT) <= 1


def test_cluster_model_adds_the_halves_in_f32():
    """dh 256 sums each CTA's half of s2 and dp on its own: with the second
    half of q and do zeroed the model equals its one-CTA order exactly
    (the dh-256 model's first half alone), where with both halves it
    differs from six-product K2 in one sum but keeps its margin"""
    q, k, v, o, lse, do, _ = _case((1, 256, 256), True, 38)
    q[..., 128:] = 0
    do[..., 128:] = 0
    got = _model(q, k, v, o, lse, do, True, bq=128)
    one = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, True, 3,
                                             None, 1)
    two = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, True, 3,
                                             None, 2)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert _ratio(got, two, TOL_FUSED_SPLIT) <= 0.3


def test_model_sums_per_chunk_and_zeroes_unseen_blocks():
    """the model's dq follows the plan's chunks (many heads: chunks of
    several KV tiles) and equals itself on one chunk per tile within f32
    roundings; the causal partials are zero past each Q block"""
    q, k, v, o, lse, do, _ = _case((8, 512, 128), True, 34)
    assert attn.fused_plan(8, 512, 256, True, False, 128, 16).chunk > 1
    many = attn.flash_attention_bwd_fused_split_ref(q, k, v, o, lse, do, 256,
                                                    True, sms=16)
    one = attn.flash_attention_bwd_fused_split_ref(q, k, v, o, lse, do, 256,
                                                   True, sms=10 ** 6)
    assert attn.fused_plan(8, 512, 256, True, False, 128, 10 ** 6).chunk == 1
    assert _ratio(many, one, 1e-6) <= 1
    assert torch.equal(many[1], one[1]) and torch.equal(many[2], one[2])
    assert many[1].shape == (8, 2, 512, 128)
    assert not many[1][:, 0, 256:].any() and not many[2][:, 0, 256:].any()


def test_model_takes_only_the_six_product_route():
    """both head dims of the kernel take the six-product route (dh 256 on
    the cluster's plan); a head dim that no kernel takes is refused"""
    q, k, v, o, lse, do, _ = _case((1, 128, 256), True, 35)
    got = attn.flash_attention_bwd_fused_split_ref(q, k, v, o, lse, do)
    assert [tuple(g.shape) for g in got] == [(1, 128, 256),
                                             (1, 1, 128, 256),
                                             (1, 1, 128, 256)]
    q, k, v, o, lse, do, _ = _case((1, 128, 64), True, 35)
    with pytest.raises(ValueError):
        attn.flash_attention_bwd_fused_split_ref(q, k, v, o, lse, do)


# ---------------------------------------------------------------------------
# (b) the route, the plan and the source
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,bq,causal", [(2048, 1024, True),
                                         (1024, 256, False),
                                         (576, 192, True)])
def test_plan_picks_the_route_from_dh_and_the_class(s, bq, causal):
    """f32: three bf16 parts on the six-product kernel, 64-row KV tiles, at
    dh 256 on clusters of two CTAs (the grid counts both); hybrid: one
    part, one CTA an item; whatever the shape, bq or mask"""
    for dh, hybrid, parts, tile, cluster in (
            (128, False, 3, 64, 1), (256, False, 3, 64, 2),
            (128, True, 1, 128, 1), (256, True, 1, 64, 1)):
        plan = attn.fused_plan(4, s, bq, causal, hybrid, dh)
        assert (plan.parts, plan.kv_tile, plan.cluster) == (parts, tile,
                                                            cluster)
        assert attn.fused_parts(dh, hybrid) == parts
        assert attn.fused_cluster(dh, hybrid) == cluster
        assert plan.smem == attn.fused_smem(dh, parts)
        assert plan.ctas == 4 * len(plan.items) * cluster


@pytest.mark.parametrize("bh,s,bq", [(32, 2048, 1024), (8, 1024, 512),
                                     (64, 2048, 128)])
def test_cluster_plan_gives_every_pair_of_sms_an_item(bh, s, bq):
    """the cluster route's chunk is the longest that still gives every
    cluster slot (a pair of SMs: 66 on 132 SMs, or fewer where the card
    runs fewer clusters at once) an item with work, and no longer chunk
    would; the dh-128 route at the same work counts SMs"""
    for clusters in (None, 60):
        slots = 66 if clusters is None else 60
        plan = attn.fused_plan(bh, s, bq, True, False, 256, 132, clusters)
        with_work = bh * sum(1 for w in plan.work if w)
        assert plan.chunk == 1 or with_work >= slots
        if plan.chunk * 2 <= s // 64:
            longer = attn._chunk_works(s, bq, True, 64, 2 * plan.chunk)
            assert bh * sum(1 for w in longer.values() if w) < slots
    # [32, 2048, 256] at bq 1024: chunks of 16 tiles, 96 items with work
    # for 66 pairs, 256 CTAs in all: the grid of the dh-128 route at
    # [64, 2048, 128], 192 items for 132 SMs
    plan = attn.fused_plan(32, 2048, 1024, True, False, 256)
    assert (plan.chunk, plan.ctas, plan.n_slots) == (16, 256, 2)
    one = attn.fused_plan(64, 2048, 1024, True, False, 128)
    assert (one.chunk, one.ctas, one.work) == (16, 256, plan.work)


def test_each_routes_shared_memory_fits_and_matches_the_source():
    """every route stays under a block's 227 KB, and the bytes the plan
    passes are the source's: F6 (K, V, Q, dO in three parts of 64 rows of
    the CTA's 128 columns, ds^T's three parts, lse, delta, three
    barriers), on a pair with ds^T's parts inside the 32 KB exchange
    slot and Xch's two barriers (`full` and `empty`: the cluster's budget,
    which the source states), and Hy"""
    with open(SRC) as f:
        src = f.read()
    sizes = {(dh, parts): attn.fused_smem(dh, parts)
             for dh, parts in ((128, 3), (256, 3), (128, 1), (256, 1))}
    assert all(n <= gemm.SM90_SMEM_LIMIT == 232448 for n in sizes.values())
    assert sizes[(128, 3)] == 1024 + 4 * 3 * 64 * 128 * 2 + 3 * 64 * 64 * 2 \
        + 2 * 64 * 4 + 3 * 8 == 222744
    assert sizes[(256, 3)] == 1024 + 4 * 3 * 64 * 128 * 2 + 256 * 32 * 4 \
        + 2 * 64 * 4 + 5 * 8 == 230952
    assert attn.FUSED_EXCHANGE == 256 * 32 * 4 >= 3 * 64 * 64 * 2
    assert "SMEM = ALIGN + KV + 2 * TILE + DS + 2 * ROWS +" in src
    assert "(3 + XBAR) * 8" in src
    assert "DS = CL > 1 && SLOTS == 1 ? XCH : XCH + NP * DS_PART" in src
    assert "XCH = CL > 1 ? SLOTS * HT * 32 * 4 : 0" in src
    assert "CL == 2 ? Xch<HT>::NBAR" in src
    assert 'static_assert(F6<2>::SMEM == 230952, "the cluster\'s budget")' \
        in src
    assert "PART = 2 * BOX" in src and "TILE = NP * PART" in src
    # Hy<D>::SMEM at both head dims
    assert sizes[(128, 1)] == 1024 + 2 * 32768 + 2 * 16384 + 3 * 33792 + 32
    assert sizes[(256, 1)] == 1024 + 2 * 32768 + 2 * 8192 + 2 * 66560 + 24
    assert "ALIGN + 2 * KV_BYTES + 2 * DS_BYTES + NS * STAGE + (NS + 1) * 8" \
        in src


def test_no_fma_body_is_left_at_dh128():
    """no FMA body is left at any dh: the f32 class routes to the wgmma
    kernel at dh 128 (one CTA) and at dh 256 to 1024 (clusters of dh /
    128, the partial scores summed through distributed shared memory), and
    the FMA tile header and helpers are gone"""
    with open(SRC) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    csrc = os.path.dirname(SRC)
    assert not os.path.exists(os.path.join(csrc, "flash_bwd_tile.cuh"))
    with open(os.path.join(csrc, "flash_tile.cuh")) as f:
        tile = f.read()
    for fma in ("fused_f32_kernel", "launch_fma", "FMA_D", "FMA_BK",
                "FMA_SMEM", "flash_bwd_tile.cuh", "fmaf", "pds_tiles",
                "accum_dkv", "accum_rows", "load_tile", "dot_rows",
                "atomic", "parts == 0"):
        assert fma not in code and fma not in tile
    for dh in range(128, 1025, 128):
        assert f"case {dh}: return F::template run<{dh // 128}, 3>" in code
    assert "launch_cluster(fused6_kernel<CL, NP>()" in code
    assert "fused6_body<CL, 3>" in code
    start = code.index("void fused6_body(")
    body = code[start:code.index("struct Fused", start)]
    assert "score6<NP>" in body and "grad6<NP>" in body
    assert "wgmma_64<1, 1>" in body
    for step in ("cluster_sync()", "xch_send_dp(Xch<HT>{xslot, xfull}",
                 "xch_sum_scores<false>(Xch<HT>{xslot, xfull}",
                 "Xch<HT>{xslot, xfull}.read()",
                 "Xch<HT>{xslot, xfull}.drain(it)", "xr.send_dp(dp, it)",
                 "xr.sum(s, dp, it)", "xr.read(it, n_pairs)"):
        assert step in body
    # the last round's read follows the dq products, the last readers of
    # ds^T in the slot (Xch's pair, and Xrs's one slot)
    for read in ("Xch<HT>{xslot, xfull}.read()", "xr.read(it, n_pairs)"):
        assert body.index("wgmma_64<1, 1>") < body.index(read)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f32_at_128", "no_parts_at_128",
                                 "two_parts", "parts_in_hybrid",
                                 "bf16_at_256", "strided", "shapes",
                                 "f32_at_256", "f32_parts_at_256"])
def test_launch_refuses_what_the_kernels_do_not_take(bad):
    """the fused kernel takes contiguous operands of one shape: bf16 [3,
    B*h, S, dh] parts in the f32 class at either dh (f32 operands at dh
    256, which the FMA route took, are refused), bf16 [B*h, S, dh] in the
    hybrid class; anything else raises before a library is built"""
    hybrid = bad in ("parts_in_hybrid", "strided", "shapes")
    dh = 256 if bad.endswith("_256") else 128
    ops = [_meta(3, 2, 128, 128) for _ in range(4)]
    if hybrid:
        ops = [_meta(2, 128, 128) for _ in range(4)]
    if bad == "f32_at_128":
        ops = [_meta(2, 128, 128, dtype=torch.float32) for _ in range(4)]
    elif bad == "no_parts_at_128":
        ops[1] = _meta(2, 128, 128)
    elif bad == "two_parts":
        ops[2] = _meta(2, 2, 128, 128)
    elif bad == "parts_in_hybrid":
        ops[0] = _meta(3, 2, 128, 128)
    elif bad == "bf16_at_256":
        ops = [_meta(2, 128, 256) for _ in range(4)]
    elif bad == "f32_at_256":
        ops = [_meta(2, 128, 256, dtype=torch.float32) for _ in range(4)]
    elif bad == "f32_parts_at_256":
        ops = [_meta(3, 2, 128, 256, dtype=torch.float32) for _ in range(4)]
    elif bad == "strided":
        ops[1] = _meta(2, 128, 256)[:, :, :128]
    elif bad == "shapes":
        ops[3] = _meta(2, 192, 128)
    rows = _meta(2, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        attn._launch_fused(ops, rows, rows, 128, True, hybrid)


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version: neither the kernel nor the
    split is launched, and chip_smoke's fused case counts no launch"""
    q, k, v, o, lse, do, dlse = _case((1, 256, 128), True, 36, True)
    attn.flash_attention_bwd_fused.launches = 0
    attn.flash_attention_bwd_fused.split_launches = 0
    got = attn.flash_attention_bwd_fused(q, k, v, o, lse, do, 128, True,
                                         dlse=dlse)
    want = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, 128,
                                              True, dlse=dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    split = attn.flash_attention_bwd(q, k, v, o, lse, do, True, dlse=dlse)
    row = chip_smoke.fused_case((q, k, v, o, lse, do, True, False, dlse),
                                split, 128, None, None, timed=False)
    assert row["ok"] and row["launches_of_one_call"] == {"kernel": 0,
                                                         "split": 0}
    assert row["grid"]["route"].startswith("bf16 wgmma, six products")
    assert attn.flash_attention_bwd_fused.launches == 0
    assert attn.flash_attention_bwd_fused.split_launches == 0


def test_cpu_path_at_dh256_launches_nothing():
    """CPU tensors at dh 256 take the plain version too: no kernel, no
    split and no occupancy query; chip_smoke's fused case counts no launch,
    holds the plain version against f64 and names the cluster route, its
    CTAs counted in pairs"""
    q, k, v, o, lse, do, dlse = _case((1, 256, 256), True, 39, True)
    attn.flash_attention_bwd_fused.launches = 0
    attn.flash_attention_bwd_fused.split_launches = 0
    got = attn.flash_attention_bwd_fused(q, k, v, o, lse, do, 128, True,
                                         dlse=dlse)
    want = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, 128,
                                              True, dlse=dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    split = attn.flash_attention_bwd(q, k, v, o, lse, do, True, dlse=dlse)
    f64 = _f64_grads(q, k, v, do, dlse, True)
    row = chip_smoke.fused_case((q, k, v, o, lse, do, True, False, dlse),
                                split, 128, f64, None, timed=False)
    assert row["ok"] and row["launches_of_one_call"] == {"kernel": 0,
                                                         "split": 0}
    assert row["f64_ratio"] <= 0.01
    assert row["grid"]["route"] == ("bf16 wgmma, six products of a "
                                    "three-part split, dh split over a "
                                    "cluster of two CTAs")
    assert row["grid"]["cluster"] == 2
    assert row["grid"]["ctas"] == 2 * len(attn.fused_plan(
        1, 256, 128, True, False, 256).items)
    assert attn.flash_attention_bwd_fused.launches == 0
    assert attn.flash_attention_bwd_fused.split_launches == 0
    assert attn._active_clusters.cache_info().currsize == 0


def test_cluster_query_entry_matches_its_ctypes_row():
    """t4_flash_bwd_fused_clusters takes the route's (dh, parts) and one
    pointer (an int it fills), as its ctypes row says, and
    t4_flash_bwd_fused's row ends with the cluster before oscale and the
    stream"""
    with open(SRC) as f:
        src = f.read()
    head = re.search(r'extern "C" int t4_flash_bwd_fused_clusters\((.*?)\)',
                     src, re.S).group(1)
    assert head.strip() == "int dh, int parts, void* n"
    table = attn._ARGTYPES["flash_bwd_fused"]
    assert table["t4_flash_bwd_fused_clusters"] == [attn._I, attn._I,
                                                     attn._P]
    assert table["t4_flash_bwd_fused"][-3:] == [attn._I, attn._F, attn._P]
    assert re.search(r"int smem,\s+int cluster, float oscale, void\* stream",
                     src)
