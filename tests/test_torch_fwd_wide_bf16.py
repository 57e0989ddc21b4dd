"""The bf16 forward at head dims 384 to 1024 on its wide route (K1 hybrid
in csrc/flash_fwd.cu, K8 in csrc/attn_dots.cu; the body fwd_wide_body of
csrc/flash_fwd.cuh), as far as the CPU can hold it.

On the card warpgroup w of a CTA owns the w-th 128 columns of dh: it forms
its partial scores over them into a slot of the CTA's shared memory, and
every warpgroup adds the slots in ops.attn.cluster_sum's order, (x0 + x1)
+ x2 or (x0 + x1) + (x2 + x3); past dh 512 a pair of CTAs holds the
columns (rank 0 the first four blocks, rank 1 the rest) and adds its two
CTA sums once a tile.  Here: the plan at every dh against the source's
static_asserts (cluster 1 to dh 512, 2 past it; the column layout); a
model of that sum bit for bit against `_cluster_scores`, which the f32
class's cluster route and the backward kernels re-form; the plain
versions at [1, 512, dh] against the JAX package's kernels in interpret
mode (K8 against a copy of bench.py's probe body, K1 hybrid against
`flash_attention(..., hybrid=True, interpret=True)`) with their stated
tolerances; the C entries' dispatch.  Inputs come from numpy seeds.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu.ops.attn_pallas import flash_attention as jax_flash
from tensorforth_tpu_torch.ops import attn, gemm
from tests.test_torch_dots_sm90 import _bf16_case, _pallas_probe
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(attn.__file__), "csrc")
DHS = (384, 512, 640, 768, 896, 1024)
TOL_FWD_HYBRID = 3e-2   # the hybrid forward's: tests/test_torch_attn.py
TOL_DOTS_PROBE = 1e-3   # of the largest value: tests/test_torch_dots_sm90.py


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("dh", DHS)
def test_plan_fits_an_sm_and_is_the_sources(dh):
    """one CTA of dh / 128 warpgroups to dh 512, a pair of CTAs of four
    warpgroups past it (no cluster above 2 CTAs); 64 query rows, 32-key
    tiles; Q [64, 128 w], two stages of K and two of V (one in a pair),
    an 8 KB slot of partial scores a warpgroup, the pair's 8 KB message
    and its two barriers: under 232,448 bytes and equal to the source's
    static_assert"""
    plan = attn.fwd_plan(16, 2048, dh, True)
    n = dh // 128
    wgs, cl = min(n, 4), 1 if n <= 4 else 2
    assert (plan.parts, plan.blocks, plan.cluster, plan.warpgroups) == (
        1, n, cl, wgs)
    assert (plan.bq, plan.bkv, plan.stages, plan.v_stages) == (
        64, 32, 2, 2 if cl == 1 else 1)
    assert plan.ctas == cl * 16 * 2048 // 64
    cols = 128 * wgs
    want = (1024 + 64 * cols * 2 + (2 + plan.v_stages) * 32 * cols * 2
            + wgs * 128 * 16 * 4 + (8192 if cl == 2 else 0)
            + (1 + 2 + plan.v_stages + (2 if cl == 2 else 0)) * 8)
    assert plan.smem == want <= gemm.SM90_SMEM_LIMIT == 232448
    assert f"Wide<{dh}>::SMEM == {plan.smem}" in _source("flash_fwd.cuh")
    assert "CL = NBLK > 4 ? 2 : 1" in _source("flash_fwd.cuh")
    # the f32 class keeps its cluster of dh / 128 CTAs
    assert attn.fwd_plan(16, 2048, dh, False).cluster == n


@pytest.mark.parametrize("dh", DHS)
def test_column_layout_of_the_warpgroups(dh):
    """warpgroup w of rank r holds the 128 columns of block 4 r + w: rank 0
    the first four blocks, rank 1 the rest, every block once"""
    blocks = attn.wide_blocks(dh)
    n = dh // 128
    assert len(blocks) == attn.fwd_plan(1, 64, dh, True).cluster
    assert blocks[0] == tuple(range(min(n, 4)))
    assert sum(blocks, ()) == tuple(range(n))
    assert all(len(b) <= 4 for b in blocks)


def _wide_sum(parts, dh):
    """the kernel's sum of the warpgroups' partials: in each CTA the slots
    in order, (x0 + x1) + x2 or (x0 + x1) + (x2 + x3) (one block alone);
    in a pair the two CTA sums added once (rank 0's first; the sum of two
    commutes)"""
    sums = []
    for blocks in attn.wide_blocks(dh):
        xs = [parts[b] for b in blocks]
        if len(xs) == 4:
            sums.append((xs[0] + xs[1]) + (xs[2] + xs[3]))
        else:
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x
            sums.append(acc)
    return sums[0] if len(sums) == 1 else sums[0] + sums[1]


@pytest.mark.parametrize("dh", DHS)
def test_wide_sum_is_the_cluster_scores_bit_for_bit(dh):
    """each warpgroup's f32 partial over its 128 columns, added as the
    kernel adds them, gives `_cluster_scores` at dh / 128 bit for bit:
    the forward's s2 is the f32 class's cluster route's and what K2a, K2b
    and K3 re-form.  One f32 sum over all of dh is not the same bits."""
    q, k, _ = _bf16_case(60 + dh // 128, (1, 256, dh))
    qf, kf = q.float(), k.float()
    n = dh // 128
    parts = [torch.einsum("nqd,nkd->nqk", qf[..., c * 128:(c + 1) * 128],
                          kf[..., c * 128:(c + 1) * 128]) for c in range(n)]
    got = _wide_sum(parts, dh)
    assert torch.equal(got, attn._cluster_scores(attn._einsum, qf, kf, n))
    assert torch.equal(got, attn.cluster_sum(parts))
    assert not torch.equal(got, torch.einsum("nqd,nkd->nqk", qf, kf))


@pytest.mark.parametrize("dh", (384, 640, 1024))
def test_probe_plain_version_matches_the_pallas_probe(dh):
    """K8's plain version at [1, 512, dh] against bench.py's probe body in
    interpret mode: within 1e-3 of the largest value (both round the
    scores to bf16 from f32 sums in other orders; a score that rounds to
    the neighbouring bf16 value moves by a relative 2^-8)"""
    q, k, v = _bf16_case(70 + dh // 128, (1, 512, dh))
    want = np.asarray(_pallas_probe(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))))
    got = attn.attn_dots_ref(q, k, v)
    assert got.shape == (1, 512, dh) and got.dtype == torch.float32
    assert (np.max(np.abs(got.numpy() - want))
            <= TOL_DOTS_PROBE * np.max(np.abs(want)))


@pytest.mark.parametrize("dh", (384, 640, 1024))
@pytest.mark.parametrize("causal", [True, False])
def test_hybrid_plain_version_matches_the_pallas_kernel(dh, causal):
    """K1 hybrid's plain version (scores in the wide route's order) at [1,
    512, dh] against the JAX package's hybrid flash_attention in interpret
    mode: o and lse within 3e-2, absolute plus relative (the hybrid
    tolerance of tests/test_torch_attn.py)"""
    rs = np.random.RandomState(80 + dh // 128 + causal)
    q, k, v = (torch.from_numpy(rs.randn(1, 512, dh).astype(np.float32))
               for _ in range(3))
    with jax.default_matmul_precision("float32"):
        oj, lj = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           causal=causal, return_lse=True, interpret=True,
                           hybrid=True)
    o, lse = attn.flash_attention_ref(q, k, v, causal, True, dh // 128)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj),
                               rtol=TOL_FWD_HYBRID, atol=TOL_FWD_HYBRID)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lj)[..., 0],
                               rtol=TOL_FWD_HYBRID, atol=TOL_FWD_HYBRID)


def test_c_entries_take_the_wide_route_in_the_bf16_class_only():
    """t4_flash_fwd sends the hybrid class at dh 384 to 1024 to the wide
    kernel and the f32 class to its clusters; t4_attn_dots takes the wide
    kernel there; the wide body keeps no cluster barrier in its loop and
    stores to the pair's CTA only past dh 512"""
    fwd, dots = _source("flash_fwd.cu"), _source("attn_dots.cu")
    for dh in DHS:
        assert f"if (dh == {dh} && parts == 1) return T4_WIDE({dh});" in fwd
        assert (f"if (dh == {dh} && parts == 3) return "
                f"T4_FWD({dh}, 3, {dh // 128});") in fwd
        assert f"case {dh}: return launch_dots<{dh}>" in dots
    head = _source("flash_fwd.cuh")
    body = head[head.index("void fwd_wide_body"):head.index("int wide_maps")]
    code = re.sub(r"//[^\n]*", "", body)
    assert "cluster_sync();" in code and code.count("cluster_sync") == 1
    assert "if constexpr (W::CL == 2) cluster_sync();" in code
    assert "Xch" not in code and "T4_XCH" not in code
    assert code.count("push<128>") == 1
