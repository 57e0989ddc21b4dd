"""The six-product bf16 arithmetic of the flash backward's f32 class (K2a
and K2b, csrc/flash_bwd.cu), as far as the CPU can hold it.

The kernels run only on the card, where chip_smoke.py holds them against
their plain version, against f64 and K3's f32 class against them.  Here:
the backward's products taken exactly over six products of the
three-part split hold the class's tolerance against f64, against the JAX
package's Pallas kernels and against K3-f32's plain version, where three
products of two parts do not; the kernels' plan fits an SM and follows
the source; the ctypes tables follow the C entries; the launch wrappers
refuse what the kernels do not take; the CPU path launches nothing.
Inputs come from numpy seeds; tolerances are stated at each test.
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL_FUSED_SPLIT
from tensorforth_tpu.ops.attn_pallas import (
    flash_attention as jax_flash, flash_attention_bwd as jax_flash_bwd)
from tensorforth_tpu_torch.ops import attn, gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tensorforth_tpu_torch", "ops", "csrc")
TOL_BWD = 2e-4     # absolute plus relative: tests/test_attention.py:185


def _case(shape, causal, seed, with_dlse=False):
    """q, k, v, o, lse, do, dlse: randn from a numpy seed, o and lse from
    the f32 forward's plain version (what the kernels take on the card
    comes from the forward kernel)"""
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


CASES = [((1, 1024, 128), True, False), ((1, 1024, 128), False, False),
         ((1, 512, 256), True, False), ((1, 512, 128), True, True)]


# ---------------------------------------------------------------------------
# (a) the six-product arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,causal,with_dlse", CASES, ids=str)
def test_six_products_hold_the_backward_against_f64(shape, causal,
                                                    with_dlse):
    """dq, dk, dv with the six products taken exactly lie within 0.01 of
    the class's f64 tolerance, 2e-4 + 2e-4 |x|: what is left is the f32
    roundings of s2, p, dp, ds and of the forward's o and lse"""
    q, k, v, o, lse, do, dlse = _case(shape, causal, 11, with_dlse)
    six = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal,
                                             3, dlse)
    want = _f64_grads(q, k, v, do, dlse, causal)
    assert _ratio(six, want, TOL_BWD) <= 0.01


@pytest.mark.parametrize("shape,causal", [((1, 512, 128), True),
                                          ((1, 256, 256), False)], ids=str)
def test_six_products_match_the_pallas_backward(shape, causal):
    """against the JAX package's two backward kernels in interpret mode at
    precision highest, on the Pallas forward's o and lse: within 2e-4
    absolute plus relative, tests/test_attention.py's tolerance"""
    q, k, v, _, _, do, _ = _case(shape, causal, 12)
    with jax.default_matmul_precision("highest"):
        qj, kj, vj, doj = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
        oj, lj = jax_flash(qj, kj, vj, causal=causal, return_lse=True,
                           interpret=True)
        want = jax_flash_bwd(qj, kj, vj, oj, lj, doj, causal=causal,
                             interpret=True)
    o = torch.tensor(np.asarray(oj))
    lse = torch.tensor(np.asarray(lj)[..., 0])
    six = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal, 3)
    assert _ratio(six, [torch.tensor(np.asarray(w)) for w in want],
                  TOL_BWD) <= 1


@pytest.mark.parametrize("shape,causal,with_dlse", CASES, ids=str)
def test_six_products_keep_the_fused_equals_split_margin(shape, causal,
                                                         with_dlse):
    """K3's f32 class (its plain version: exact f32 products) against the
    six products: within 0.3 of chip_smoke.py's fused-equals-split
    bound, 1e-5 + 1e-5 |x|, so the check keeps most of its margin for the
    tensor cores' sums"""
    q, k, v, o, lse, do, dlse = _case(shape, causal, 11, with_dlse)
    six = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal,
                                             3, dlse)
    fused = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, None,
                                               causal, dlse=dlse)
    assert _ratio(fused, six, TOL_FUSED_SPLIT) <= 0.3


@pytest.mark.parametrize("shape", [(1, 1024, 128), (1, 512, 256)], ids=str)
def test_three_products_miss_the_fused_equals_split_bound(shape):
    """why six: three products of two parts (K5a 3pass's count), taken
    exactly, already miss the fused-equals-split bound under the causal
    mask, before the tensor cores' sums add their own error"""
    q, k, v, o, lse, do, _ = _case(shape, True, 11)
    two = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do, True, 2)
    fused = attn.flash_attention_bwd_fused_ref(q, k, v, o, lse, do, None,
                                               True)
    assert _ratio(fused, two, TOL_FUSED_SPLIT) > 1


def test_split_ref_takes_the_products_of_the_parts():
    """with one part (hi only) the emulation is the product of the bf16
    roundings: s2 of q*scale*log2e against k equals the plain einsum of
    the rounded operands, so the parts enter where the kernels take them"""
    q, k, v, o, lse, do, _ = _case((1, 64, 128), False, 13)
    q2 = q * (attn.LOG2E / math.sqrt(128))
    parts = gemm._split3_ref(q2)
    assert torch.equal(sum(p.double() for p in parts), q2.double())
    dq, dk, dv = attn.flash_attention_bwd_split_ref(q, k, v, o, lse, do,
                                                    False, 1)
    bf = torch.bfloat16
    s2 = torch.einsum("nqd,nkd->nqk", q2.to(bf).double(),
                      k.to(bf).double()).float()
    p = torch.exp2(s2 - (lse * attn.LOG2E)[..., None])
    want = torch.einsum("nqk,nqd->nkd", p.to(bf).double(), do.to(bf).double())
    assert torch.equal(dv, want)


# ---------------------------------------------------------------------------
# (b) the plan and the C entries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", attn.KERNEL_DH)
@pytest.mark.parametrize("hybrid", [False, True])
def test_bwd_plan_fits_an_sm_and_matches_the_source(dh, hybrid):
    """both kernels' plans stay under 227 KB a CTA and follow flash_bwd.cu's
    Bwd; dh 256 in the f32 class takes a cluster of two CTAs that split
    dh, each with the dh-128 f32 tiles, the exchange slot and Xch's two
    barriers, full and empty (1,024 + 196,608 + 32,768 + 512 + 40 = 230,952 bytes for
    dK/dV); dh 384 to 1024, both classes, clusters of dh / 128 CTAs with
    the dh-128 tiles of the class and Xrs's exchange: the f32 class one
    slot and four barriers (two rounds' receipts and reads), the hybrid
    class two slots and the two receipts"""
    plan = attn.bwd_plan(64, 2048, dh, hybrid)
    with open(os.path.join(CSRC, "flash_bwd.cu")) as f:
        src = f.read()
    for tiles in (plan.dkv, plan.dq):
        assert tiles.smem <= gemm.SM90_SMEM_LIMIT == 232448
    assert plan.parts == (1 if hybrid else 3)
    cluster = (2 if dh == 256 and not hybrid else dh // 128 if dh > 256
               else 1)
    assert plan.dq.cluster == plan.dkv.cluster == cluster
    assert "ROWS = 64" in src and "TILE = DC == 128 ? 64 : 32" in src
    assert "DC = D / CL" in src and "ST = NP == 1 ? 2 : 1" in src
    assert "XCH = CL > 1 ? SLOTS * NT * 32 * 4 : 0" in src
    assert "SLOTS = CL <= 2 ? 1 : NP == 1 ? 2 : 1" in src
    assert attn.BWD_EXCHANGE == 256 * 32 * 4 == 32768
    assert attn.BWD_TILES == {128: 64, 256: 32}
    assert attn.BWD_STAGES == {3: 1, 1: 2}
    cols = dh // cluster
    p, st, tile = plan.parts, plan.dq.stages, plan.dq.tile
    assert tile == (64 if cols == 128 else 32)
    tiles = 2 * p * 64 * cols * 2 + 2 * st * p * tile * cols * 2
    slots = 2 if hybrid and cluster > 2 else 1
    xch = slots * 32768 if cluster > 1 else 0
    bars = 1 + 2 * st + {1: 0, 2: 2}.get(cluster, 4 if slots == 1 else 2)
    assert plan.dq.smem == 1024 + tiles + xch + bars * 8
    assert plan.dkv.smem == plan.dq.smem + 2 * st * tile * 4
    assert plan.dkv._replace(smem=0) == plan.dq._replace(smem=0)
    assert plan.dq.ctas == cluster * 64 * 2048 // 64
    assert ("(CL == 1   ? 0\n       : CL == 2 ? Xch<NT>::NBAR\n"
            "                 : Xrs<CL < 3 ? 3 : CL, NT, 0, SLOTS>::NBAR)"
            ) in src
    if cluster == 2:
        assert plan.dkv.smem == 230952
        assert "Bwd<256, 3, 2>::SMEM_DKV == 230952" in src
    if cluster > 2:
        assert (f"Bwd<{dh}, {p}, {cluster}>::SMEM_DKV == {plan.dkv.smem}"
                in src)


def _c_params(src: str, fn: str):
    """the parameter kinds of the C function `fn`: 'p' pointer, 'i' int,
    'f' float"""
    head = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in head.group(1).split(",")]


@pytest.mark.parametrize("fn", ["t4_flash_bwd_dkv", "t4_flash_bwd_dq",
                                "t4_split_bwd"])
def test_ctypes_tables_match_the_c_entries(fn):
    """a pointer passed as an int would be cut to 32 bits"""
    with open(os.path.join(CSRC, "flash_bwd.cu")) as f:
        kinds = _c_params(f.read(), fn)
    kind = {attn._P: "p", attn._I: "i", attn._F: "f"}
    assert [kind[t] for t in attn._ARGTYPES["flash_bwd"][fn]] == kinds


def test_no_fma_body_is_left_at_dh128():
    """no FMA body is left in flash_bwd.cu: every route of both kernels
    (dh 128 to 1024, both classes) is a wgmma instance, dh 256 in the f32
    class on a cluster of two CTAs, dh 384 to 1024 in both classes on
    clusters of three to eight"""
    with open(os.path.join(CSRC, "flash_bwd.cu")) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    assert re.search(r"flash_bwd_(?:dkv|dq)_kernel\b", code) is None
    for fma in ("fmaf", "FMA_D", "FMA_BK", "pds_tiles", "accum_dkv",
                "accum_rows", "load_tile", "flash_bwd_tile.cuh"):
        assert fma not in code
    # the FMA tiles' header is gone, and flash_tile.cuh keeps only the
    # constants
    assert not os.path.exists(os.path.join(CSRC, "flash_bwd_tile.cuh"))
    with open(os.path.join(CSRC, "flash_tile.cuh")) as f:
        tile = re.sub(r"//[^\n]*", "", f.read())
    assert "__device__" not in tile and "fmaf" not in tile
    assert "wgmma_128_rs" in code and "wgmma_64_rs" in code
    routes = set(re.findall(r"if \(dh == (\d+) && parts == (\d)\) "
                            r"return T4_(DKV|DQ)\((\d+), (\d), (\d)\)",
                            code))
    assert routes == {(dh, p, k, dh, p, cl) for k in ("DKV", "DQ")
                      for dh, p, cl in (("128", "3", "1"), ("128", "1", "1"),
                                        ("256", "3", "2"), ("256", "1", "1"),
                                        *((str(dh), p, str(dh // 128))
                                          for dh in range(384, 1025, 128)
                                          for p in ("3", "1")))}
    assert "launch_cluster(flash_bwd_dkv_sm90_kernel<D, NP, CL>" in code
    assert "launch_cluster(flash_bwd_dq_sm90_kernel<D, NP, CL>" in code


@pytest.mark.parametrize("hash_tail", ["9e5ef83d", "6f0a9c52d"])
def test_ptxas_records_name_the_new_instances(hash_tail):
    """chip_smoke.py's ptxas parser names each instance by its own
    identifier, also when digits inside the namespace's hash happen to
    give the length of a longer identifier (52 here: the build directory
    sets the hash)"""
    from chip_smoke import ptxas_by_kernel
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__"
        f"{hash_tail}_12_flash_bwd_cu_311c35f824flash_bwd_dq_sm90_kernel"
        "ILi256ELi3ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_Pfiiif' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 2 barriers"])
    rec, = ptxas_by_kernel(log)
    assert rec == {"kernel": "flash_bwd_dq_sm90_kernel<256,3,2>",
                   "stack_frame": 0, "spill_stores": 0, "spill_loads": 0,
                   "registers": 122, "static_smem": 0}


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("which", ["dkv", "dq"])
@pytest.mark.parametrize("bad", ["f32", "strided", "no_parts_in_f32",
                                 "parts_in_hybrid", "shapes", "two_parts",
                                 "f32_at_dh256"])
def test_launch_refuses_what_the_kernels_do_not_take(which, bad):
    """the kernels take contiguous operands of one shape: bf16 [3, B*h, S,
    dh] parts in the f32 class (at dh 256 too: f32 operands, which the
    FMA route took, are refused), bf16 [B*h, S, dh] in the hybrid class;
    anything else raises before a library is built"""
    hybrid = bad in ("f32", "strided", "parts_in_hybrid", "shapes")
    dh = 256 if bad == "f32_at_dh256" else 128
    plan = attn.bwd_plan(2, 128, dh, hybrid)
    ops = [_meta(2, 128, dh, dtype=torch.float32) if bad == "f32_at_dh256"
           else _meta(2, 128, dh) if hybrid else _meta(3, 2, 128, dh)
           for _ in range(4)]
    if bad == "f32":
        ops[0] = _meta(2, 128, 128, dtype=torch.float32)
    elif bad == "strided":
        ops[1] = _meta(2, 128, 256)[:, :, :128]
    elif bad == "no_parts_in_f32":
        ops[2] = _meta(2, 128, 128)
    elif bad == "parts_in_hybrid":
        ops = [_meta(3, 2, 128, 128) for _ in range(4)]
    elif bad == "shapes":
        ops[3] = _meta(2, 192, 128)
    elif bad == "two_parts":
        ops[0] = _meta(2, 2, 128, 128)
    rows = _meta(2, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        attn._launch_bwd(which, ops, rows, rows, True, plan)


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version: no kernel and no split"""
    q, k, v, o, lse, do, dlse = _case((1, 128, 128), True, 14, True)
    attn.flash_attention_bwd.launches = {"dkv": 0, "dq": 0}
    attn.flash_attention_bwd.split_launches = 0
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, True, dlse=dlse)
    want = attn.flash_attention_bwd_ref(q, k, v, o, lse, do, True,
                                        dlse=dlse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert attn.flash_attention_bwd.launches == {"dkv": 0, "dq": 0}
    assert attn.flash_attention_bwd.split_launches == 0
