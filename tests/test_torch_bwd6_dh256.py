"""The flash backward's f32 class at dh 256 (K2a and K2b, csrc/flash_bwd.cu)
as far as the CPU can hold it.

On the card a cluster of two CTAs splits dh: each forms s2 and dp over its
128 columns in six bf16 products, and the two partials, each rounded to
f32, are added in f32 (ops.attn.flash_attention_bwd_split_ref with
cluster 2 takes its products exactly and its sums in that order).  Here
that arithmetic, and the one-sum order of cluster 1, holds the class's
tolerance against f64, against the JAX package's Pallas backward in
interpret mode and against K3-f32's plain version, causal and with an lse
cotangent; the CPU path launches nothing.  Inputs come from numpy seeds;
tolerances are stated at each test.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_FUSED_SPLIT
from tensorforth_tpu.ops.attn_pallas import (
    flash_attention as jax_flash, flash_attention_bwd as jax_flash_bwd)
from tensorforth_tpu_torch.ops import attn

from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL_BWD = 2e-4     # absolute plus relative: tests/test_attention.py:185
SHAPE = (1, 512, 256)
# (causal, with an lse cotangent)
MASKS = [(True, False), (True, True), (False, True)]


def _inputs(causal, with_dlse, seed):
    """q, k, v, do, dlse: randn from a numpy seed"""
    rs = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rs.randn(*SHAPE).astype(np.float32))
                   for _ in range(4))
    dlse = (torch.from_numpy(rs.randn(*SHAPE[:2]).astype(np.float32))
            if with_dlse else None)
    return q, k, v, do, dlse


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


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("causal,with_dlse", MASKS, ids=str)
def test_cluster_order_holds_the_backward_against_f64(cluster, causal,
                                                      with_dlse):
    """the six products taken exactly, s2 and dp summed in one f32 sum
    (cluster 1) or as the cluster's two halves (cluster 2): dq, dk, dv lie
    within 0.01 of the class's f64 tolerance, 2e-4 + 2e-4 |x|"""
    q, k, v, do, dlse = _inputs(causal, with_dlse, 21)
    o, lse = attn.flash_attention_ref(q, k, v, causal)
    got = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal, 3,
                                             dlse, cluster)
    assert _ratio(got, _f64_grads(q, k, v, do, dlse, causal),
                  TOL_BWD) <= 0.01


@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("causal,with_dlse", [(True, True), (False, False)],
                         ids=str)
def test_cluster_order_matches_the_pallas_backward(cluster, causal,
                                                   with_dlse):
    """against the JAX package's two backward kernels in interpret mode at
    precision highest, on the Pallas forward's o and lse: within 2e-4
    absolute plus relative, tests/test_attention.py's tolerance"""
    q, k, v, do, dlse = _inputs(causal, with_dlse, 22)
    with jax.default_matmul_precision("highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = jax_flash(qj, kj, vj, causal=causal, return_lse=True,
                           interpret=True)
        want = jax_flash_bwd(
            qj, kj, vj, oj, lj, doj, causal=causal, interpret=True,
            dlse=None if dlse is None else jnp.asarray(dlse.numpy()))
    o = torch.tensor(np.asarray(oj))
    lse = torch.tensor(np.asarray(lj)[..., 0])
    got = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal, 3,
                                             dlse, cluster)
    assert _ratio(got, [torch.tensor(np.asarray(w)) for w in want],
                  TOL_BWD) <= 1


@pytest.mark.parametrize("causal,with_dlse", MASKS, ids=str)
def test_cluster_order_keeps_the_fused_equals_split_margin(causal,
                                                           with_dlse):
    """K3's f32 class at dh 256 (its plain version: exact f32 products)
    against the cluster's order: within 0.3 of chip_smoke.py's
    fused-equals-split bound, 1e-5 + 1e-5 |x|, so the check on the card
    keeps most of its margin for the tensor cores' sums"""
    q, k, v, do, dlse = _inputs(causal, with_dlse, 23)
    o, lse = attn.flash_attention_ref(q, k, v, causal)
    got = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal, 3,
                                             dlse, 2)
    fused = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, None,
                                               causal, dlse=dlse)
    assert _ratio(fused, got, TOL_FUSED_SPLIT) <= 0.3


def test_the_halves_are_added_in_f32():
    """cluster 2 sums each half of dh on its own: with the second half of
    q zeroed it gives the first half's sum exactly, where cluster 1 and 2
    differ once both halves count"""
    q, k, v, do, _ = _inputs(True, False, 24)
    o, lse = attn.flash_attention_ref(q, k, v, True)
    one, two = (attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, True,
                                                   3, None, c)
                for c in (1, 2))
    assert not all(torch.equal(a, b) for a, b in zip(one, two))
    q0, do0 = q.clone(), do.clone()
    q0[..., 128:] = 0
    do0[..., 128:] = 0
    one, two = (attn.flash_attention_bwd_split_ref(q0, k, v, o, lse, do0,
                                                   True, 3, None, c)
                for c in (1, 2))
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_cpu_path_at_dh256_launches_nothing():
    """CPU tensors at dh 256 take the plain version: no kernel and no
    split"""
    q, k, v, do, dlse = _inputs(True, True, 25)
    o, lse = attn.flash_attention_ref(q, k, v, True)
    attn.flash_attention_bwd.launches = {"dkv": 0, "dq": 0}
    attn.flash_attention_bwd.split_launches = 0
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, True, dlse=dlse)
    want = attn.flash_attention_bwd_ref(q, k, v, o, lse, do, True,
                                        dlse=dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert attn.flash_attention_bwd.launches == {"dkv": 0, "dq": 0}
    assert attn.flash_attention_bwd.split_launches == 0
