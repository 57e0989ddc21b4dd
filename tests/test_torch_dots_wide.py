"""K8, the dots-only probe (csrc/attn_dots.cu), at head dims 384 to 1024,
as far as the CPU can hold it.

On the card the probe takes the hybrid forward's wide route there: a
warpgroup per 128 columns of dh forms the scores over its columns, the
partials added in the CTA's shared memory (and by a pair of CTAs past dh
512) in cluster_sum's order before their rounding to bf16, then P V over
its own columns, accumulated over every key by the tensor cores.  Here
the plain version in that order against a copy of bench.py's probe body
in interpret mode (tests/test_torch_dots_sm90.py's, at dh 128 and 256);
the plain version's scores in the cluster's order, bit for bit; the plan
is the hybrid forward's wide plan and the source launches it; the ctypes
table follows the C entry; the CPU path launches nothing; dh 1152 is
refused.  Inputs come from numpy seeds; tolerances are stated at each
test.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorforth_tpu_torch.ops import attn, gemm
from tests.test_torch_dots_sm90 import (
    _bf16_case, _c_params, _pallas_probe, _source)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DHS = (384, 512, 640, 768, 896, 1024)


@pytest.mark.parametrize("dh", DHS)
def test_plain_version_matches_the_pallas_probe(dh):
    """[1, 512, dh]: within 1e-3 of the largest value, the bound of
    tests/test_torch_dots_sm90.py at dh 128 and 256.  Both round the
    scores to bf16 from f32 sums taken in another order (here an f32 sum
    per 128 columns, added in the cluster's order), and a score that
    rounds to the neighbouring bf16 value moves by a relative 2^-8; the
    sums over the keys (one f32 sum against the probe's) add f32
    roundings far below that"""
    q, k, v = _bf16_case(30 + dh // 128, (1, 512, dh))
    want = np.asarray(_pallas_probe(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))))
    got = attn.attn_dots_ref(q, k, v)
    assert got.shape == (1, 512, dh) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * np.max(np.abs(want))


@pytest.mark.parametrize("dh", (384, 1024))
def test_plain_version_sums_in_the_cluster_order_per_key_tile(dh):
    """the scores as the wide route forms them (each warpgroup's f32 sum
    over its 128 columns, added in cluster_sum's order, the same bits in
    any key tile), rounded to bf16, times v, one f32 sum over all the
    keys (the tensor cores accumulate o over every tile): bit for bit;
    one f32 sum over all of dh is not the same bits, nor are the 64-key
    tiles added one after another that the cluster route took"""
    q, k, v = _bf16_case(41, (1, 256, dh))
    qf, kf, vf = q.float(), k.float(), v.float()
    cl = dh // 128
    parts = [torch.einsum("nqd,nkd->nqk", qf[..., c * 128:(c + 1) * 128],
                          kf[..., c * 128:(c + 1) * 128]) for c in range(cl)]
    s2 = attn.cluster_sum(parts)
    want = torch.einsum("nqk,nkd->nqd", s2.to(torch.bfloat16).float(), vf)
    s1 = torch.einsum("nqd,nkd->nqk", qf, kf)
    whole = torch.einsum("nqk,nkd->nqd", s1.to(torch.bfloat16).float(), vf)
    tiles = torch.zeros_like(qf)
    for k0 in range(0, 256, 64):
        tiles += torch.einsum("nqk,nkd->nqd",
                              s2[..., k0:k0 + 64].to(torch.bfloat16).float(),
                              vf[:, k0:k0 + 64])
    got = attn.attn_dots_ref(q, k, v)
    assert torch.equal(got, want)
    assert not torch.equal(got, whole) and not torch.equal(got, tiles)


@pytest.mark.parametrize("dh", DHS)
def test_probe_plan_is_the_hybrid_cluster_plan_the_source_builds(dh):
    """the probe takes the hybrid forward's wide plan: one CTA of dh / 128
    warpgroups to dh 512, a pair of CTAs of four past it, 64 query rows
    and 32-key tiles, the warpgroups' slots (and the pair's message),
    under 227 KB (the source's static_assert); the C entry launches that
    instance"""
    cl = dh // 128
    plan = attn.fwd_plan(16, 2048, dh, True)
    assert (plan.parts, plan.stages, plan.blocks) == (1, 2, cl)
    assert (plan.cluster, plan.warpgroups) == ((1, cl) if cl <= 4
                                               else (2, 4))
    assert (plan.bq, plan.bkv) == (64, 32)
    assert plan.smem <= gemm.SM90_SMEM_LIMIT
    assert f"Wide<{dh}>::SMEM == {plan.smem}" in _source("flash_fwd.cuh")
    src = _source("attn_dots.cu")
    assert f"case {dh}: return launch_dots<{dh}>" in src
    assert "fwd_wide_body<D, true>" in src
    assert "Wide<D>::SMEM" in src and "wide_grid<D>" in src
    code = re.sub(r"//[^\n]*", "", _source("flash_fwd.cuh"))
    assert "!DOTS" in code and "probe has no cluster route" not in code


def test_ctypes_table_matches_the_c_entry():
    """t4_attn_dots takes (q, k, v, o, bh, s, dh, stream) and
    t4_attn_dots_clusters (dh, n): a pointer passed as an int would be
    cut to 32 bits"""
    kind = {attn._P: "p", attn._I: "i", attn._F: "f"}
    table = attn._ARGTYPES["attn_dots"]
    for fn, want in (("t4_attn_dots", ["p"] * 4 + ["i"] * 3 + ["p"]),
                     ("t4_attn_dots_clusters", ["i", "p"])):
        kinds = _c_params(_source("attn_dots.cu"), fn)
        assert [kind[t] for t in table[fn]] == kinds == want
    for dh in DHS:
        assert (f"case {dh}: return dots_clusters<{dh}>(out)"
                in _source("attn_dots.cu"))


@pytest.mark.parametrize("dh", (384, 1024))
def test_cpu_path_is_the_plain_version_and_launches_nothing(dh):
    """CPU tensors take the plain version: bit for bit, no launch"""
    q, k, v = _bf16_case(43, (2, 128, dh))
    attn.attn_dots.launches = 0
    assert torch.equal(attn.attn_dots(q, k, v), attn.attn_dots_ref(q, k, v))
    assert attn.attn_dots.launches == 0


def test_dh1152_is_refused_with_the_deviation_named():
    """a cluster of nine CTAs is past the eight of a portable cluster"""
    x = torch.zeros(1, 128, 1152, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="portable cluster"):
        attn.attn_dots(x, x, x)
    assert "case 1152" not in _source("attn_dots.cu")
