"""What surrounds the port's wgmma GEMM kernel (csrc/gemm_sm90.cu, through
tensorforth_tpu_torch/ops/gemm.py), on the CPU.

The kernel itself runs only on the card, where chip_smoke.py holds it and
its rounding pass against their plain versions.  Here: the rounding pass's
plain version against the JAX package's own split (gemm_pallas.py:_kdot,
lines 80-83), bit for bit, on inputs that reach the corners of rounding to
bf16; the zero padding that TMA's 16-byte row pitch asks for changes no
product; the tile plan fits an SM; the new counter stays at zero on the
CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GEMM_SHAPES, ROUNDING_CORNERS, rounding_corners
from tensorforth_tpu.ops.gemm_pallas import _kdot
from tensorforth_tpu_torch.ops import gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = list(GEMM_SHAPES) + [(1, 1, 1)]            # m, k, n
KINDS = ROUNDING_CORNERS + ("mixed",)


def jax_split(x: np.ndarray):
    """gemm_pallas.py:80-83: ah = bf16(a), al = bf16(a - f32(ah)), as bits"""
    a = jnp.asarray(x)
    ah = a.astype(jnp.bfloat16)
    al = (a - ah.astype(jnp.float32)).astype(jnp.bfloat16)
    return (np.asarray(ah).view(np.uint16), np.asarray(al).view(np.uint16))


def bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("split", [False, True], ids=["round", "split"])
@pytest.mark.parametrize("kind", KINDS)
def test_split_ref_is_the_reference_split_bit_for_bit(kind, split):
    x = rounding_corners(kind, (24, 40))
    got = gemm._split_ref(torch.from_numpy(x), split)
    hi, lo = jax_split(x)
    assert got.shape == (2 if split else 1, 24, 40)
    np.testing.assert_array_equal(bits(got[0]), hi)
    if split:
        np.testing.assert_array_equal(bits(got[1]), lo)


# not "large": where ah is inf, the reference's dot meets the zeros of I,
# and inf * 0 is NaN
@pytest.mark.parametrize("kind", ["ties", "signed_zeros", "subnormals",
                                  "random"])
def test_split_ref_through_the_reference_kdot(kind):
    """_kdot itself on (a, I): its 3pass sum is ah + 0 + al, exact in each
    product and in all but one add, so it equals f32(hi) + f32(lo) of the
    port's split, in the reference's arithmetic (subnormal inputs and
    results of f32 operations flushed; values compared, since the sign of
    a zero sum depends on the order)"""
    x = rounding_corners(kind, (16, 16), seed=1)
    eye = np.eye(16, dtype=np.float32)
    want = np.asarray(_kdot(jnp.asarray(x), jnp.asarray(eye), "3pass"))
    hi, lo = gemm._split_ref(torch.from_numpy(x), True).float()
    got = gemm._flush(gemm._flush(hi) + gemm._flush(lo))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 3, 2), (1, 1, 1), (37, 53, 29),
                                   (64, 16, 8)], ids=str)
@pytest.mark.parametrize("split", [False, True], ids=["round", "split"])
def test_round_ref_layout_and_k5a_plain_product(shape, split):
    """the pass lays each operand out as [parts, rows, cols padded to 8]
    with zeros in the padding, and K5a's plain version is the product of
    those parts, bit for bit"""
    m, k, n = shape
    rs = np.random.RandomState(2)
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    ap, bp = gemm._round_ref(a, b, split)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    parts = 2 if split else 1
    assert ap.shape == (parts, m, kp) and bp.shape == (parts, k, np_)
    assert ap.dtype == bp.dtype == torch.bfloat16
    assert not ap[:, :, k:].any() and not bp[:, :, n:].any()
    h = [p.float() for p in (ap[0, :, :k], bp[0, :, :n])]
    if split:
        lo = [p.float() for p in (ap[1, :, :k], bp[1, :, :n])]
        want = h[0] @ h[1] + h[0] @ lo[1] + lo[0] @ h[1]
    else:
        want = h[0] @ h[1]
    got = gemm._mm_ref(a, b, prec="3pass" if split else "default")
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_padding_keeps_the_plain_product_bit_for_bit(shape):
    """K6's wrapper pads each cast's rows to a multiple of 8 where they are
    not: the plain product of the padded operands, sliced back, is the
    plain product of the originals"""
    m, k, n = shape
    if k % 8 == 0 and n % 8 == 0:   # nothing to pad: the operands are used
        a = torch.empty((m, k), device="meta")                # as they are
        b = torch.empty((k, n), device="meta")
        assert gemm._pad_inner(a) is a and gemm._pad_inner(b) is b
        return
    rs = np.random.RandomState(3)
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    ap, bp = gemm._pad_inner(a), gemm._pad_inner(b)
    kp = ap.shape[1]
    assert kp % 8 == 0 and bp.shape[1] % 8 == 0 and kp - k < 8
    bp = gemm._pad_to(bp, kp, 1)                  # zero rows to meet A's
    scale = 1.0 / max(shape)
    got = gemm._mm_v8_ref(ap, bp, scale)[:m, :n]
    assert torch.equal(got, gemm._mm_v8_ref(a, b, scale))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("nprod", [1, 3], ids=["one_product", "3pass"])
def test_tile_plan_fits_an_sm(shape, nprod):
    m, k, n = shape
    plan = gemm.sm90_plan(m, n, nprod)
    assert plan.smem <= gemm.SM90_SMEM_LIMIT == 232448
    assert plan.stages >= 3
    assert plan.a_box[0] * 2 == plan.b_box[0] * 2 == 128   # bytes, inner
    assert plan.a_box[1] == plan.bm and plan.b_box[1] == plan.bk
    assert plan.bn % plan.b_box[0] == 0 and plan.bk == plan.a_box[0]
    gx, gy = plan.grid
    assert gx * plan.bn >= n > (gx - 1) * plan.bn
    assert gy * plan.bm >= m > (gy - 1) * plan.bm
    parts = 2 if nprod == 3 else 1
    ring = plan.stages * parts * (plan.bm * plan.bk
                                  + plan.bk * plan.bn) * 2
    assert plan.smem >= ring + 2 * plan.stages * 8


def test_new_counter_stays_zero_on_the_cpu():
    gemm.reset_launches()
    a = torch.ones(5, 7)
    b = torch.ones(7, 3)
    gemm._round(a, b), gemm._round(a, b, split=True)
    gemm._mm(a, b, prec="default"), gemm._mm(a, b, prec="3pass")
    gemm._mm_v8(a, b, 0.5)
    assert gemm.launches == dict.fromkeys(gemm.launches, 0)
    assert "mm_round" in gemm.launches


def test_the_wrappers_refuse_a_mixed_device_pair():
    """a CPU tensor with a tensor elsewhere is neither plain nor kernel
    work: the wrappers raise before launching anything"""
    a = torch.ones(4, 4)
    b = torch.ones(4, 4, device="meta")
    for call in (lambda: gemm._round(a, b), lambda: gemm._mm(a, b),
                 lambda: gemm._mm_v8(a, b)):
        with pytest.raises(ValueError):
            call()
