"""The six-product bf16 arithmetic of K5a's class highest (csrc/gemm_sm90.cu)
and K1's f32 class (csrc/flash_fwd.cu), as far as the CPU can hold it.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions, against f64 and the split passes bit for bit.  Here:
the three-part split is exact down to its stated threshold and leaves the
two-part split of class 3pass as it was; six products of its parts, taken
exactly, hold the classes' tolerances against f64 and against the JAX
package, where three products of two parts do not by a margin worth
keeping; the kernels' tile plans fit an SM; the ctypes tables follow the C
entries; the wrappers refuse what the kernels do not take.  Inputs come
from numpy seeds; tolerances are stated at each test.
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ROUNDING_CORNERS, rounding_corners
from tensorforth_tpu.ops.attn_pallas import flash_attention as jax_flash
from tensorforth_tpu_torch.ops import attn, gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tensorforth_tpu_torch", "ops", "csrc")
KINDS = ROUNDING_CORNERS + ("mixed",)
TOL_GEMM_HIGHEST = 5e-6    # of the largest f64 value: tests/test_gemm_prec.py
TOL_ATTN = 2e-5            # absolute plus relative: tests/test_attention.py
# the three-part split gives x back for 2^-110 <= |x| < 0x1.FEp127 (the
# bottom: x's lowest bit no finer than bf16's smallest subnormal, 2^-133;
# the top: where bf16(x) rounds to inf)
SPLIT3_LOW = 2.0 ** -110
SPLIT3_HIGH = float.fromhex("0x1.FEp127")


def _parts_sum(x: np.ndarray) -> np.ndarray:
    """hi + mid + lo of the three-part split, in f64"""
    return sum(p.double() for p in gemm._split3_ref(torch.from_numpy(x))
               ).numpy()


def _in_range(x: np.ndarray) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    return (a == 0) | ((a >= SPLIT3_LOW) & (a < SPLIT3_HIGH))


# ---------------------------------------------------------------------------
# (a) the split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS + ("randn", "rand"))
def test_three_part_split_is_exact_down_to_the_threshold(kind):
    """hi + mid + lo == x for every value in the stated range, on randn,
    on all-positive rand and on every family of rounding corners; below
    it (the subnormals family lies there whole) the parts miss x by at
    most half of bf16's smallest subnormal, 2^-134"""
    rs = np.random.RandomState(5)
    if kind == "randn":
        x = rs.standard_normal((64, 48)).astype(np.float32)
    elif kind == "rand":
        x = rs.rand(64, 48).astype(np.float32)
    else:
        x = rounding_corners(kind, (64, 48), seed=3)
    keep, got = _in_range(x), _parts_sum(x)
    np.testing.assert_array_equal(got[keep], x.astype(np.float64)[keep])
    low = np.abs(x) < SPLIT3_LOW
    assert low.all() if kind == "subnormals" else keep.sum() > x.size / 2
    assert (np.abs(got[low] - x[low].astype(np.float64))
            <= 2.0 ** -134).all()


def test_the_threshold_is_where_exactness_ends():
    """every f32 exponent from 2^-110 to 2^127 splits exactly, with x's
    lowest significand bit set; at 2^-111 that bit is finer than bf16's
    smallest subnormal and the split loses it"""
    sig = np.float32(1 + 2.0 ** -23)
    exact = np.array([sig * np.float32(2.0 ** e) for e in range(-110, 127)],
                     dtype=np.float32)
    np.testing.assert_array_equal(_parts_sum(exact), exact.astype(np.float64))
    below = np.array([sig * np.float32(2.0 ** -111)], dtype=np.float32)
    assert _parts_sum(below)[0] != float(below[0])


@pytest.mark.parametrize("kind", KINDS)
def test_hi_part_and_two_part_split_unchanged(kind):
    """the split passes' hi part is bf16(x) in every class, and the
    two-part split of class 3pass (flushing, the reference's) is the one
    the layout helpers gave before the third part existed"""
    x = torch.from_numpy(rounding_corners(kind, (24, 40)))
    three = gemm._parts_ref(x, 3)
    assert three.shape == (3, 24, 40) and three.dtype == torch.bfloat16
    assert torch.equal(three[0].view(torch.int16),
                       gemm._split_ref(x, False)[0].view(torch.int16))
    hi, lo = gemm._split(x)
    two = gemm._split_ref(x, True)
    assert torch.equal(two.view(torch.int16),
                       torch.stack((hi, lo)).view(torch.int16))
    assert torch.equal(gemm._round_ref(x, x.T.contiguous(), parts=2)[0]
                       .view(torch.int16), two.view(torch.int16))


def test_round_ref_three_parts_layout():
    """[3, rows, cols padded to 8] bf16, zeros in the padding, parts in the
    order hi, mid, lo"""
    rs = np.random.RandomState(4)
    a = torch.from_numpy(rs.standard_normal((37, 53)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((53, 29)).astype(np.float32))
    ap, bp = gemm._round_ref(a, b, parts=3)
    assert ap.shape == (3, 37, 56) and bp.shape == (3, 53, 32)
    assert not ap[:, :, 53:].any() and not bp[:, :, 29:].any()
    for x, p in ((a, ap), (b, bp)):
        got = sum(q.double() for q in p[:, :, :x.shape[1]])
        assert torch.equal(got, x.double())
        assert torch.equal(p[0, :, :x.shape[1]], x.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# (b) the six-product arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("operands", ["randn", "rand"])
def test_six_products_hold_highest_against_f64(operands):
    """K5a highest's products taken exactly, at K 4096 on narrow m and n:
    within TOL_GEMM_HIGHEST of the largest f64 value on randn and on the
    words' all-positive rand, with room to spare for the tensor cores'
    sums (chip_smoke.py measures those)"""
    rs = np.random.RandomState(6)
    draw = rs.standard_normal if operands == "randn" else rs.random_sample
    a = torch.from_numpy(draw((8, 4096)).astype(np.float32))
    b = torch.from_numpy(draw((4096, 16)).astype(np.float32))
    want = a.double() @ b.double()
    err = (gemm._split_products_f64(a, b) - want).abs().max().item()
    assert err <= 0.01 * TOL_GEMM_HIGHEST * want.abs().max().item()


def _attn_case(shape, causal, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32))
            for _ in range(3)]


def _ratio(got, want):
    """the largest |got - want| over TOL_ATTN + TOL_ATTN |want|"""
    return ((got.double() - want.double()).abs()
            / (TOL_ATTN + TOL_ATTN * want.double().abs())).max().item()


ATTN_CASES = [((1, 1536, 128), True), ((1, 1536, 128), False),
              ((1, 1024, 256), True)]


@pytest.mark.parametrize("shape,causal", ATTN_CASES, ids=str)
def test_six_products_hold_the_flash_forward_against_f64_and_jax(shape,
                                                                 causal):
    """K1's f32 class with its products taken exactly: o and lse within
    2e-5 + 2e-5 |x| of the f64 attention and of the JAX package's flash
    kernel in interpret mode at precision highest (test_attention.py
    holds that kernel to the same), at under a tenth of the tolerance
    against f64"""
    q, k, v = _attn_case(shape, causal, 11)
    o6, lse6 = attn.flash_attention_split_ref(q, k, v, causal, parts=3)
    o64, lse64 = attn.flash_attention_ref(q.double(), k.double(), v.double(),
                                          causal)
    assert _ratio(o6, o64) <= 0.1 and _ratio(lse6, lse64) <= 0.1
    with jax.default_matmul_precision("highest"):
        oj, lj = jax_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           causal=causal, return_lse=True, interpret=True)
    assert _ratio(o6, torch.tensor(np.asarray(oj))) <= 1
    assert _ratio(lse6, torch.tensor(np.asarray(lj)[..., 0])) <= 1


def test_three_products_come_too_close_at_dh256():
    """why six: three products of two parts (K5a 3pass's count), taken
    exactly, already use 0.4 or more of the f32 tolerance at [1, 1024,
    256] causal, before the tensor cores' sums add their own error"""
    q, k, v = _attn_case((1, 1024, 256), True, 11)
    o64, _ = attn.flash_attention_ref(q.double(), k.double(), v.double(),
                                      True)
    o3, _ = attn.flash_attention_split_ref(q, k, v, True, parts=2)
    o6, _ = attn.flash_attention_split_ref(q, k, v, True, parts=3)
    r3, r6 = _ratio(o3, o64), _ratio(o6, o64)
    assert r3 >= 0.4 and r6 <= 0.02 * r3


def test_split_ref_of_the_f32_class_scales_q_first():
    """the emulation splits q*scale*log2e (an f32 product, as the split
    pass forms it), so the products of the parts give back the scaled
    scores exactly in f64"""
    q, k, _ = _attn_case((1, 64, 128), False, 12)
    q2 = q * (attn.LOG2E / math.sqrt(128))
    parts = gemm._split3_ref(q2)
    assert torch.equal(sum(p.double() for p in parts), q2.double())


# ---------------------------------------------------------------------------
# (c) the wrappers
# ---------------------------------------------------------------------------
def _forward_source() -> str:
    """K1's source and the body it shares with K8 (flash_fwd.cuh)"""
    out = ""
    for name in ("flash_fwd.cu", "flash_fwd.cuh"):
        with open(os.path.join(CSRC, name)) as f:
            out += f.read()
    return out


@pytest.mark.parametrize("dh", attn.KERNEL_DH)
@pytest.mark.parametrize("hybrid", [False, True])
def test_fwd_plan_fits_an_sm_and_matches_the_source(dh, hybrid):
    """the forward's plan stays under 227 KB in both classes, and its tiles
    are the ones flash_fwd.cu's Fwd is built with; the f32 class at dh
    384 to 1024 takes a cluster of dh / 128 CTAs, each with the dh-128
    tiles over its columns, the exchange slot and Xrs's four barriers
    (with one slot: the two rounds' receipts and reads); the hybrid class
    there the wide route (Wide: a
    warpgroup per 128 columns, four a CTA, a pair of CTAs past dh 512)"""
    plan = attn.fwd_plan(64, 2048, dh, hybrid)
    assert plan.smem <= gemm.SM90_SMEM_LIMIT == 232448
    assert plan.parts == (1 if hybrid else 3)
    assert plan.bq % 64 == 0 and plan.bq % plan.bkv == 0
    blocks = dh // 128 if dh > 256 else 1
    assert plan.blocks == blocks
    src = _forward_source()
    if hybrid and dh > 256:
        wgs = min(blocks, 4)
        cluster = 2 if blocks > 4 else 1
        assert (plan.cluster, plan.warpgroups) == (cluster, wgs)
        assert plan.ctas == cluster * 64 * 2048 // plan.bq
        cols = 128 * wgs
        tiles = (plan.bq + (plan.stages + plan.v_stages) * plan.bkv) * cols * 2
        xch, bars = (8192, 2) if cluster == 2 else (0, 0)
        assert plan.smem == (1024 + tiles + wgs * 8192 + xch
                             + (1 + plan.stages + plan.v_stages + bars) * 8)
        assert "NW = NBLK > 4 ? 4 : NBLK" in src
        assert "BQ = 64, BKV = 32" in src
        assert "VST = CL == 2 ? 1 : 2" in src
        assert attn.WIDE_TILES == (64, 32) and attn.WIDE_SLOT == 8192
        return
    cluster = blocks
    assert plan.cluster == cluster and plan.warpgroups == 2
    assert plan.ctas == cluster * 64 * 2048 // plan.bq
    cols = dh // cluster
    tiles = plan.parts * (plan.bq + 2 * plan.stages * plan.bkv) * cols * 2
    xch, bars = (32768, 4) if cluster > 1 else (0, 0)
    assert plan.smem == 1024 + tiles + xch + (1 + 2 * plan.stages + bars) * 8
    assert "DC = D / CL" in src
    assert "BQ = DC == 128 ? 128 : 64" in src
    assert "BKV = DC == 128 ? 64 : 32" in src
    assert "ST = NP == 1 ? 2 : 1" in src
    assert "XCH = CL > 1 ? NT * (BKV / 2) * 4 : 0" in src
    assert attn.FWD_TILES == {128: (128, 64), 256: (64, 32)}
    assert attn.FWD_STAGES == {3: 1, 1: 2}


def test_highest_plan_fits_an_sm():
    """class highest: 128 x 128 tiles, three parts of each operand in a
    stage of 96 KB, two stages"""
    plan = gemm.sm90_plan(4096, 4096, 6)
    assert plan.smem <= gemm.SM90_SMEM_LIMIT
    assert (plan.bn, plan.stages) == (128, 2)
    stage = 3 * (plan.bm * plan.bk + plan.bk * plan.bn) * 2
    assert plan.smem == 1024 + 2 * stage + 2 * 2 * 8
    assert gemm.SM90_PARTS == {1: 1, 3: 2, 6: 3}
    assert gemm.PREC_NPROD == {"default": 1, "3pass": 3, "highest": 6}


def _c_params(src: str, fn: str):
    """the parameter kinds of the C function `fn`: 'p' pointer, 'i' int,
    'f' float"""
    head = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in head.group(1).split(",")]


@pytest.mark.parametrize("source,fn", [
    ("flash_fwd", "t4_flash_fwd"), ("flash_fwd", "t4_split_qkv"),
    ("gemm_sm90", "t4_gemm_sm90"), ("gemm_sm90", "t4_round_bf16")])
def test_ctypes_tables_match_the_c_entries(source, fn):
    """a pointer passed as an int would be cut to 32 bits"""
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        kinds = _c_params(f.read(), fn)
    module = attn if source == "flash_fwd" else gemm
    kind = {module._P: "p", module._I: "i", module._F: "f"}
    assert [kind[t] for t in module._ARGTYPES[source][fn]] == kinds


def test_no_fma_body_is_left():
    """K5a highest runs on gemm_sm90.cu (gemm.cu is gone) and K1 keeps no
    FMA body: it includes neither flash_tile.cuh nor an fmaf"""
    assert not os.path.exists(os.path.join(CSRC, "gemm.cu"))
    assert "gemm" not in gemm._ARGTYPES
    code = re.sub(r"//[^\n]*", "", _forward_source())
    assert "flash_tile.cuh" not in code and "fmaf" not in code
    assert "wgmma_128_rs" in code and "score_mma" in code


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f32", "strided", "parts_in_hybrid",
                                 "no_parts_in_f32", "shapes"])
def test_forward_launch_refuses_what_the_kernel_does_not_take(bad):
    """the forward kernel takes contiguous bf16 of one shape: [B*h, S, dh]
    in the hybrid class, [3, B*h, S, dh] parts in the f32 class; anything
    else raises before a library is built"""
    bf = torch.bfloat16
    hybrid = bad in ("f32", "strided", "parts_in_hybrid", "shapes")
    ops = [_meta(2, 128, 128, dtype=bf) for _ in range(3)]
    if bad == "f32":
        ops[0] = _meta(2, 128, 128)
    elif bad == "strided":
        ops[1] = _meta(2, 128, 256, dtype=bf)[:, :, :128]
    elif bad == "parts_in_hybrid":
        ops = [_meta(3, 2, 128, 128, dtype=bf) for _ in range(3)]
    elif bad == "shapes":
        ops[2] = _meta(2, 192, 128, dtype=bf)
    with pytest.raises(ValueError):
        attn._launch_fwd(*ops, True, hybrid)


def test_wrappers_refuse_wrong_devices_and_parts():
    """a CPU tensor beside one elsewhere is neither plain nor kernel work;
    the split pass takes 1 to 3 parts"""
    q = torch.zeros(1, 128, 128)
    with pytest.raises(ValueError):
        attn.flash_attention(q, q, _meta(1, 128, 128))
    with pytest.raises(ValueError):
        gemm._mm(torch.ones(4, 4), _meta(4, 4), prec="highest")
    with pytest.raises(ValueError):
        gemm._round_launch(_meta(4, 4), _meta(4, 4), 4)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    """on CPU tensors the f32 forward and class highest are their plain
    versions (true f32), and neither the split nor a kernel is counted"""
    attn.flash_attention.launches = attn.flash_attention.split_launches = 0
    gemm.reset_launches()
    q, k, v = _attn_case((2, 128, 128), True, 13)
    o, lse = attn.flash_attention(q, k, v, causal=True)
    o_r, lse_r = attn.flash_attention_ref(q, k, v, True)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    a, b = torch.ones(5, 7), torch.ones(7, 3)
    assert torch.equal(gemm._mm(a, b, prec="highest"), a @ b)
    assert gemm._round(a, b, parts=3)[0].shape == (3, 5, 8)
    assert attn.flash_attention.launches == 0
    assert attn.flash_attention.split_launches == 0
    assert gemm.launches == dict.fromkeys(gemm.launches, 0)
