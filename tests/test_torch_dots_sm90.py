"""K8, the dots-only probe (csrc/attn_dots.cu), as the forward's bf16 wgmma
body with the softmax compiled out (csrc/flash_fwd.cuh), as far as the CPU
can hold it.

The kernel runs only on the card, where chip_smoke.py holds it against
its plain version.  Here: the plain version, summed per key tile of the
hybrid forward's plan, against the JAX package's probe body in Pallas
interpret mode at dh 128 and 256; an emulation of the tensor cores'
truncating score sums, which shows why chip_smoke.py's TOL_DOTS is of the
largest term; the plan fits an SM and is the one the source instantiates; the ctypes table follows the C entry; the launch
refuses what the kernel does not take; the CPU path launches nothing; no
FMA body is left.  Inputs come from numpy seeds; tolerances are stated at
each test.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tensorforth_tpu_torch.ops import attn, gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "tensorforth_tpu_torch", "ops", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _pallas_probe(q, k, v):
    """the kernel body of bench.py:_attn_dots_probe (bench.py:692-704) in
    a pallas_call of its own block structure, in interpret mode (the probe
    builds its call with no interpret flag): per (head, bq query rows) the
    f32 scores against every key, then their bf16 rounding times v in
    chunks of ckv keys, summed in f32"""
    nh, s, dh = q.shape
    bq, ckv = min(1024, s), min(512, s)

    def kernel(q_ref, k_ref, v_ref, o_ref):
        qb = q_ref[0]
        s2 = jnp.dot(qb, k_ref[0].T, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.DEFAULT)
        acc = jnp.zeros_like(o_ref[0])
        for i in range(s // ckv):
            acc = acc + jnp.dot(
                s2[:, i * ckv:(i + 1) * ckv].astype(jnp.bfloat16),
                v_ref[0][i * ckv:(i + 1) * ckv],
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT)
        o_ref[0] = acc

    return pl.pallas_call(
        kernel, grid=(nh, s // bq),
        in_specs=[pl.BlockSpec((1, bq, dh), lambda bi, qi: (bi, qi, 0)),
                  pl.BlockSpec((1, s, dh), lambda bi, qi: (bi, 0, 0)),
                  pl.BlockSpec((1, s, dh), lambda bi, qi: (bi, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, dh), lambda bi, qi: (bi, qi, 0)),
        out_shape=jax.ShapeDtypeStruct((nh, s, dh), jnp.float32),
        interpret=True)(q, k, v)


def _bf16_case(seed, shape):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        torch.bfloat16) for _ in range(3)]


# ---------------------------------------------------------------------------
# (a) the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 512, 128), (1, 512, 256)], ids=str)
def test_plain_version_matches_the_pallas_probe(shape):
    """within 1e-3 of the largest value: both round the scores to bf16
    from f32 sums taken in another order, and a score that rounds to the
    neighbouring bf16 value moves by a relative 2^-8 (2.3e-4 of the
    largest value at these shapes); the key-tile sums (64 or 32 keys
    against the probe's 512) add f32 roundings far below that"""
    q, k, v = _bf16_case(21, shape)
    want = np.asarray(_pallas_probe(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))))
    got = attn.attn_dots_ref(q, k, v)
    assert got.shape == shape and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * np.max(np.abs(want))


@pytest.mark.parametrize("dh,tile", [(128, 64), (256, 32)])
def test_plain_version_sums_per_key_tile_of_the_plan(dh, tile):
    """the plain version's key tile is the hybrid forward plan's (64 keys
    at dh 128, 32 at dh 256): each tile's product rounded to f32 apart and
    added to o in order, bit for bit"""
    assert attn.fwd_plan(1, 256, dh, True).bkv == tile
    q, k, v = _bf16_case(22, (1, 256, dh))
    qf, kf, vf = q.float(), k.float(), v.float()
    want = torch.zeros_like(qf)
    for k0 in range(0, 256, tile):
        s2 = torch.einsum("nqd,nkd->nqk", qf, kf[:, k0:k0 + tile])
        want += torch.einsum("nqk,nkd->nqd", s2.to(torch.bfloat16).float(),
                             vf[:, k0:k0 + tile])
    assert torch.equal(attn.attn_dots_ref(q, k, v), want)


@pytest.mark.parametrize("shape", [(4, 1024, 128), (2, 1024, 256)],
                         ids=str)
def test_truncating_score_sums_need_the_derived_tolerance(shape):
    """why chip_smoke.py's TOL_DOTS is of the largest term: the tensor
    cores' score sums truncate where the plain version's round to nearest.
    Emulated here by cutting the exact score toward zero to f32, some
    scores round to the neighbouring bf16 value, and the output moves by
    more than 1e-4 of its largest value (the probe's bound while its sums
    rounded to nearest on the CUDA cores) but within 2^-6 of the largest
    term; one bf16 step of the largest term alone is above that 1e-4"""
    from chip_smoke import TOL_DOTS
    q, k, v = _bf16_case(5, shape)
    want = attn.attn_dots_ref(q, k, v)
    exact = torch.einsum("nqd,nkd->nqk", q.double(), k.double())
    s2 = exact.float()
    s2 = torch.where(s2.double().abs() > exact.abs(),
                     torch.nextafter(s2, torch.zeros_like(s2)), s2)
    b, s, dh = shape
    bkv = attn.fwd_plan(b, s, dh, True).bkv
    got = torch.zeros(shape)
    for k0 in range(0, s, bkv):
        got += torch.einsum("nqk,nkd->nqd",
                            s2[:, :, k0:k0 + bkv].to(torch.bfloat16).float(),
                            v[:, k0:k0 + bkv].float())
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    term = exact.abs().max().item() * v.float().abs().max().item()
    assert 2.0 ** -8 * term > 1e-4 * top
    assert 1e-4 * top < err <= TOL_DOTS * term


# ---------------------------------------------------------------------------
# (b) the plan, the source and the C entry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dh", (128, 256))
def test_probe_plan_is_the_hybrid_forwards_and_fits_an_sm(dh):
    """the probe takes the forward's hybrid plan (one part, two stages of
    K and V): under 227 KB, and the source launches the body with one part
    and the softmax compiled out at that plan's shared memory (dh 384 to
    1024, on the forward's clusters: tests/test_torch_dots_wide.py)"""
    plan = attn.fwd_plan(16, 2048, dh, True)
    assert plan.smem <= gemm.SM90_SMEM_LIMIT
    assert (plan.parts, plan.stages, plan.cluster) == (1, 2, 1)
    assert (plan.bq, plan.bkv) == attn.FWD_TILES[dh]
    src = _source("attn_dots.cu")
    assert "fwd_body<D, 1, true>" in src
    assert "Fwd<D, 1>::SMEM" in src and "fwd_grid<D, 1>" in src
    assert f"launch_dots<{dh}>" in src


def _c_params(src: str, fn: str):
    """the parameter kinds of the C function `fn`: 'p' pointer, 'i' int,
    'f' float"""
    head = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
    return ["p" if "*" in p else "f" if p.strip().startswith("float")
            else "i" for p in head.group(1).split(",")]


def test_ctypes_table_matches_the_c_entry():
    """a pointer passed as an int would be cut to 32 bits"""
    kinds = _c_params(_source("attn_dots.cu"), "t4_attn_dots")
    kind = {attn._P: "p", attn._I: "i", attn._F: "f"}
    assert [kind[t] for t in attn._ARGTYPES["attn_dots"]["t4_attn_dots"]] \
        == kinds


def test_no_fma_body_is_left():
    """the probe is the forward's wgmma body: no FMA tile loops, no
    flash_tile.cuh, and the body's products are wgmma's; the DOTS switch
    compiles the softmax out"""
    code = re.sub(r"//[^\n]*", "", _source("attn_dots.cu"))
    assert '#include "flash_fwd.cuh"' in code
    for fma in ("flash_tile.cuh", "fmaf", "dot_rows", "accum_rows",
                "load_tile"):
        assert fma not in code
    body = re.sub(r"//[^\n]*", "", _source("flash_fwd.cuh"))
    assert "wgmma_128_rs" in body and "score_mma" in body
    assert body.count("if constexpr (!DOTS)") >= 1
    assert "fmaf" not in body and "flash_tile.cuh" not in body


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["f32", "strided", "shapes", "dh64",
                                 "s_not_tiles"])
def test_launch_refuses_what_the_kernel_does_not_take(bad):
    """the kernel takes contiguous bf16 [B*h, S, dh] of one shape, S % 64
    == 0, dh 128 to 1024; anything else raises before a library is built"""
    ops = [_meta(2, 128, 128) for _ in range(3)]
    if bad == "f32":
        ops[0] = _meta(2, 128, 128, dtype=torch.float32)
    elif bad == "strided":
        ops[1] = _meta(2, 128, 256)[:, :, :128]
    elif bad == "shapes":
        ops[2] = _meta(2, 192, 128)
    elif bad == "dh64":
        ops = [_meta(2, 128, 64) for _ in range(3)]
    elif bad == "s_not_tiles":
        ops = [_meta(2, 96, 128) for _ in range(3)]
    with pytest.raises(ValueError):
        attn._launch_dots(*ops)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    """CPU tensors take the plain version: bit for bit, no launch"""
    q, k, v = _bf16_case(23, (2, 256, 128))
    attn.attn_dots.launches = 0
    assert torch.equal(attn.attn_dots(q, k, v), attn.attn_dots_ref(q, k, v))
    assert attn.attn_dots.launches == 0
