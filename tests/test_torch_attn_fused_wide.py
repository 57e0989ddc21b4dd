"""K3, the fused single-kernel flash backward (csrc/flash_bwd_fused.cu), at
head dims 384 to 1024, as far as the CPU can hold it.

On the card both classes run there on clusters of dh / 128 CTAs (3 to
8): each CTA takes the split body over its 128 columns of dh (the f32
class's six products of the three-part split, or the hybrid class's one
product), and the partial s2 and dp are added through distributed shared
memory in cluster_sum's tree of pairs, as K2a and K2b add theirs.  Here
the plain versions in that order, both classes, causal and not (with an
lse cotangent), hold the tolerances of tests/test_torch_attn_fused.py and
tests/test_torch_attn_dh1024.py against the JAX package's fused Pallas
kernel in interpret mode at [1, 512, dh]; the f32 class's six-product
model holds f64; the plan counts a cluster of SMs a slot and its shared
memory is the source's static_assert; the CPU path launches nothing; and
dh 1152 is refused, the deviation named.  Inputs come from numpy seeds.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.ops.attn_pallas import (
    flash_attention as jax_flash,
    flash_attention_bwd_fused as jax_flash_bwd_fused)
from tensorforth_tpu_torch.ops import attn, gemm
from tests.test_torch_attn_dh512 import (
    TOL_BWD, TOL_BWD_HYBRID, _f64, _inputs, _ratio)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(attn.__file__), "csrc",
                   "flash_bwd_fused.cu")
DHS = (384, 512, 640, 768, 896, 1024)
BQ = 256           # two Q blocks at S 512: the partials' sum is exercised
TOL_F32 = 1e-5     # absolute plus relative: tests/test_torch_attn_fused.py
#                    (f32 sums in another order; the interpreter's dots
#                    pinned to full f32)


def _source():
    with open(SRC) as f:
        return f.read()


def _pallas_fused(q, k, v, do, dlse, causal, hybrid):
    """the JAX package's forward residuals (o, lse [B, S]) and its fused
    backward (dq, dk, dv) in interpret mode, bq = BQ; the f32 class at
    precision highest, as tests/test_attention.py runs it"""
    with jax.default_matmul_precision("float32" if hybrid else "highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = jax_flash(qj, kj, vj, causal=causal, return_lse=True,
                           interpret=True, hybrid=hybrid)
        grads = jax_flash_bwd_fused(
            qj, kj, vj, oj, lj, doj, bq=BQ, causal=causal, interpret=True,
            hybrid=hybrid,
            dlse=None if dlse is None else jnp.asarray(dlse.numpy()))
    return ((torch.tensor(np.asarray(oj)),
             torch.tensor(np.asarray(lj)[..., 0])),
            [torch.tensor(np.asarray(g)) for g in grads])


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
@pytest.mark.parametrize("causal", [True, False])
def test_cluster_order_matches_the_pallas_fused_kernel(dh, hybrid, causal):
    """the plain version with the scores in the cluster's order (an f32
    sum per CTA's 128 columns, added in cluster_sum's order), on the
    Pallas forward's o and lse, against the JAX package's
    flash_attention_bwd_fused in interpret mode (with an lse cotangent in
    the non-causal cases).  f32: within 1e-5 absolute plus relative, the
    tolerance of tests/test_torch_attn_fused.py at dh 128 (the cluster's
    order moves the scores by a few f32 roundings); hybrid (bf16
    multiplicands): each gradient within 5% of its largest value, the
    bound of tests/test_attention.py:221-225"""
    q, k, v, do, dlse = _inputs(dh, 141 + 2 * hybrid + causal,
                                with_dlse=not causal)
    cl = dh // 128
    (oj, lj), want = _pallas_fused(q, k, v, do, dlse, causal, hybrid)
    got = attn.flash_attention_bwd_fused_ref(q, k, v, oj, lj, do, BQ, causal,
                                             hybrid, dlse, cl)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 512, dh)
        if hybrid:
            assert (g - w).abs().max() <= TOL_BWD_HYBRID * w.abs().max()
    if not hybrid:
        assert _ratio(got, want, TOL_F32) <= 1


@pytest.mark.parametrize("dh", DHS)
def test_six_product_model_in_cluster_order_holds_f64(dh):
    """the f32 class's model (the six products of parts exact, each CTA's
    128 columns of s2 and dp rounded to f32 and added in cluster_sum's
    order, the gradients summed as the kernel sums them) against f64
    autograd, causal with an lse cotangent: within 0.01 of the backward's
    tolerance, 2e-4 + 2e-4 |x| (tests/test_attention.py:185), as
    tests/test_torch_attn_dh1024.py holds K2's model"""
    q, k, v, do, dlse = _inputs(dh, 161)
    _, grads64 = _f64(q, k, v, do, dlse, True)
    o, lse = attn.flash_attention_ref(q, k, v, True)
    dq, dkp, dvp = attn.flash_attention_bwd_fused_split_ref(
        q, k, v, o, lse, do, BQ, True, dlse)
    assert _ratio((dq, dkp.sum(dim=1), dvp.sum(dim=1)), grads64,
                  TOL_BWD) <= 0.01


@pytest.mark.parametrize("dh", (512, 1024))
def test_slots_model_sums_to_the_plain_version(dh):
    """the item-by-item model of the kernel's grid, in the cluster's
    order: its dq slots summed, and its partials, within 1e-5 (absolute
    plus relative) of the plain version's, the partials' never-visited
    blocks zero"""
    q, k, v, do, _ = _inputs(dh, 171, with_dlse=False)
    o, lse = attn.flash_attention_ref(q, k, v, True)
    cl = dh // 128
    slots, dkp, dvp = attn.flash_attention_bwd_fused_slots_ref(
        q, k, v, o, lse, do, BQ, True, cluster=cl)
    dq, dkp_r, dvp_r = attn.flash_attention_bwd_fused_parts_ref(
        q, k, v, o, lse, do, BQ, True, cluster=cl)
    assert _ratio((slots.sum(dim=0), dkp, dvp), (dq, dkp_r, dvp_r),
                  TOL_F32) <= 1
    assert not dkp[:, 0, BQ:].any() and not dvp[:, 0, BQ:].any()


@pytest.mark.parametrize("dh", DHS)
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_plan_takes_the_cluster_route_the_source_builds(dh, hybrid):
    """both classes at dh 384 to 1024: a cluster of dh / 128 CTAs, 64-row
    KV tiles, the parts of the class; the shared memory the plan passes is
    the source's static_assert (the f32 class: the dh-256 route's 230,952
    bytes and Xrs's two barriers more, its one slot holding ds^T once
    read; the hybrid class: one part of each tile, K's and V's space at
    the 64 KB that warpgroup 1's sums pass through, Xrs's two slots and
    two barriers, ds^T's part beside them), under 227 KB; the grid counts
    every CTA; the C entry routes the dh to that instance"""
    cl, parts = dh // 128, 1 if hybrid else 3
    plan = attn.fused_plan(4, 2048, 1024, True, hybrid, dh)
    assert (plan.cluster, plan.kv_tile, plan.parts) == (cl, 64, parts)
    assert attn.fused_cluster(dh, hybrid) == attn.bwd_cluster(dh, hybrid)
    assert plan.ctas == cl * 4 * len(plan.items)
    assert plan.smem == attn.fused_smem(dh, parts) <= gemm.SM90_SMEM_LIMIT
    want = {3: 230952 + 8 * 2,
            1: 1024 + 65536 + 2 * 16384 + 2 * 32768 + 8192 + 512
            + 8 * (3 + attn.xrs_barriers(2))}[parts]
    assert plan.smem == want
    src = _source()
    suffix = "" if parts == 3 else ", 1"
    assert f"F6<{cl}{suffix}>::SMEM == {want}" in src
    assert f"case {dh}: return F::template run<{cl}, {parts}>" in src


@pytest.mark.parametrize("dh", (384, 640, 1024))
def test_plan_counts_a_cluster_of_sms_a_slot(dh):
    """a slot is a cluster of dh / 128 SMs, at most the clusters the card
    runs at once: the chunk is the longest that still gives every slot an
    item with work, and a chunk twice as long would not"""
    cl = dh // 128
    for clusters in (None, 15):
        slots = 132 // cl if clusters is None else min(132 // cl, clusters)
        plan = attn.fused_plan(16, 2048, 1024, True, False, dh, 132,
                               clusters)
        with_work = 16 * sum(1 for w in plan.work if w)
        assert plan.chunk == 1 or with_work >= slots
        if plan.chunk * 2 <= 2048 // 64:
            longer = attn._chunk_works(2048, 1024, True, 64, 2 * plan.chunk)
            assert 16 * sum(1 for w in longer.values() if w) < slots


@pytest.mark.parametrize("dh", (384, 1024))
@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_cpu_path_is_the_plain_version_and_launches_nothing(dh, hybrid):
    """CPU tensors take the plain version (bit for bit): no kernel, no
    split, no question to a card"""
    q, k, v, do, dlse = _inputs(dh, 181)
    o, lse = attn.flash_attention_ref(q, k, v, False, hybrid)
    attn.flash_attention_bwd_fused.launches = 0
    attn.flash_attention_bwd_fused.split_launches = 0
    got = attn.flash_attention_bwd_fused(q, k, v, o, lse, do, BQ, False,
                                         hybrid, dlse)
    want = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, BQ, False,
                                              hybrid, dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert attn.flash_attention_bwd_fused.launches == 0
    assert attn.flash_attention_bwd_fused.split_launches == 0
    assert attn._active_clusters.cache_info().currsize == 0


@pytest.mark.parametrize("hybrid", [False, True], ids=["f32", "hybrid"])
def test_dh1152_is_refused_with_the_deviation_named(hybrid):
    """a cluster of nine CTAs is past the eight of a portable cluster: the
    wrapper and its plain version refuse dh 1152 and say why, and the C
    entry has no route there"""
    x = torch.zeros(1, 128, 1152)
    lse = torch.zeros(1, 128)
    for fn in (attn.flash_attention_bwd_fused,
               attn.flash_attention_bwd_fused_parts_ref):
        with pytest.raises(ValueError, match="portable cluster"):
            fn(x, x, x, x, lse, x, None, False, hybrid)
    assert "case 1152" not in _source()
