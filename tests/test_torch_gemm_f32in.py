"""What surrounds the port's f32-operand GEMM kernels K5b and K7
(csrc/gemm_sm90_f32.cu, through tensorforth_tpu_torch/ops/gemm.py), on the
CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and against K5a class default.  Here: their tile
plans fit an SM; the wrappers pad only the rows that TMA's 16-byte pitch
needs, and that padding changes no product; K5b's plain version is the
JAX package's bf16 kernel (gemm_pallas.py:_mm_kernel_bf16, interpreted) on
operands that bf16 holds exactly; and the rounding both plain versions
share, ``_bf``, rounds the corners of f32 -> bf16 as JAX does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GEMM_SHAPES, ROUNDING_CORNERS, rounding_corners
from tensorforth_tpu.ops.gemm_pallas import _mm_pallas
from tensorforth_tpu_torch.ops import gemm

from tests.test_torch_threads import one_torch_thread  # noqa: F401

PLAN_SHAPES = [(4096, 4096, 4096), (2048, 2048, 2048), (1030, 1000, 1290),
               (1, 7, 3)]                                     # m, k, n
KERNELS = ["mm_bf16", "mm_db"]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("kernel", KERNELS)
def test_tile_plan_fits_an_sm(shape, kernel):
    m, k, n = shape
    plan = gemm.f32in_plan(kernel, m, k, n)
    assert plan.kernel == kernel
    assert plan.smem <= gemm.SM90_SMEM_LIMIT == 232448
    assert (plan.bm, plan.bn) == (128, 256)
    gx, gy = plan.grid
    assert gx * plan.bn >= n > (gx - 1) * plan.bn
    assert gy * plan.bm >= m > (gy - 1) * plan.bm
    # f32 slabs of 32 k by TMA: boxes 128 bytes wide (the swizzle's width)
    assert plan.bk * 4 == plan.a_box[0] * 4 == plan.b_box[0] * 4 == 128
    assert plan.a_box[1] == plan.bm and plan.b_box[1] == plan.bk
    assert plan.bn % plan.b_box[0] == 0
    kp, np_ = k + plan.pad[0], n + plan.pad[1]
    assert kp % 4 == np_ % 4 == 0 and max(plan.pad) < 4
    # 3 stages, and 3 tiles (a tile is rewritten only once the products
    # of the slab 3 back, which read it, are done)
    assert plan.stages >= 3 and plan.b_tiles >= 3
    assert plan.barriers == (plan.stages if kernel == "mm_db"
                             else 2 * (plan.stages + plan.b_tiles))
    f32 = plan.stages * (plan.bm + plan.bn) * plan.bk * 4
    bf16 = plan.b_tiles * plan.bk * plan.bn * 2
    assert plan.smem >= f32 + bf16 + plan.barriers * 8


@pytest.mark.parametrize("kernel", KERNELS)
def test_pads_only_the_ragged_rows(kernel):
    """(1030, 1000, 1290): B's rows 1290 -> 1292, nothing else; K7's old
    padding to 128 / 128 / 32 (DB_TILE) is gone"""
    assert gemm.f32in_plan(kernel, 1030, 1000, 1290).pad == (0, 2)
    assert gemm.f32in_plan(kernel, 4096, 4096, 4096).pad == (0, 0)
    assert gemm.f32in_plan(kernel, 1, 7, 3).pad == (1, 1)
    assert not hasattr(gemm, "DB_TILE")


@pytest.mark.parametrize("shape", list(GEMM_SHAPES) + [(1, 7, 3)], ids=str)
def test_padding_keeps_the_plain_product_bit_for_bit(shape):
    """the wrappers' zero padding of the rows, sliced back, leaves the
    plain product (K5b's and K7's are the same) as it was; an operand that
    needs none is used as it is"""
    m, k, n = shape
    plan = gemm.f32in_plan("mm_db", m, k, n)
    assert plan.pad == gemm.f32in_plan("mm_bf16", m, k, n).pad
    rs = np.random.RandomState(5)
    a = torch.from_numpy(rs.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal((k, n)).astype(np.float32))
    ap, bp = gemm._tma_ready(a, plan.pad[0]), gemm._tma_ready(b, plan.pad[1])
    assert ap.shape == (m, k + plan.pad[0]) and bp.shape == (k, n + plan.pad[1])
    for x, xp in ((a, ap), (b, bp)):
        if xp.shape == x.shape:
            assert xp is x
        else:
            assert torch.equal(xp[:, :x.shape[1]], x)
            assert not xp[:, x.shape[1]:].any()
    bz = gemm._pad_to(bp, ap.shape[1], 1)          # zero rows to meet A's
    got = gemm._mm_db_ref(ap, bz)[:, :n]
    assert torch.equal(got, gemm._mm_db_ref(a, b))


@pytest.mark.parametrize("shape", [(37, 53, 29), (130, 67, 259), (1, 7, 3),
                                   (2, 3, 2)], ids=str)
def test_k5b_plain_version_is_the_reference_kernel_on_exact_inputs(shape):
    """operands that bf16 holds exactly, at ragged shapes: the
    interpreted reference kernel (f32 in, cast to bf16 in its body)
    rounds nothing away, so both sides are the same sums"""
    m, k, n = shape
    rs = np.random.RandomState(6)
    a = rs.randint(-8, 9, (m, k)).astype(np.float32) / 4
    b = rs.randint(-8, 9, (k, n)).astype(np.float32) / 4
    got = gemm._mm_ref(torch.from_numpy(a), torch.from_numpy(b),
                       bf16=True).numpy()
    want = np.asarray(_mm_pallas(jnp.asarray(a), jnp.asarray(b), 128, 128,
                                 128, bf16=True, interpret=True))
    np.testing.assert_array_equal(got, want)


def _jax_bf(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("kind", ROUNDING_CORNERS + ("mixed",))
def test_bf_rounds_the_corners_as_jax_does(kind):
    """ties to even, signed zeros, subnormals (kept, not flushed), values
    that round to inf, every exponent: the bits of _bf equal JAX's"""
    x = rounding_corners(kind, (32, 48), seed=7)
    got = gemm._bf(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _jax_bf(x).view(np.uint32))


def test_bf_keeps_infinities_and_nan():
    """+-inf bit for bit.  A NaN stays a NaN; its payload is the
    framework's own (JAX keeps the sign and gives 0x7FC0, PyTorch's CPU
    conversion here 0xFFFF), and a NaN operand gives a NaN product
    whichever it is"""
    x = np.array([np.inf, -np.inf, np.nan, -np.nan, 1.0], np.float32)
    got = gemm._bf(torch.from_numpy(x)).numpy()
    want = _jax_bf(x)
    np.testing.assert_array_equal(got[[0, 1, 4]].view(np.uint32),
                                  want[[0, 1, 4]].view(np.uint32))
    assert np.isnan(got[2:4]).all() and np.isnan(want[2:4]).all()


def test_counters_stay_zero_on_the_cpu():
    gemm.reset_launches()
    a, b = torch.ones(5, 7), torch.ones(7, 3)
    gemm._mm(a, b, bf16=True), gemm._mm_db(a, b)
    assert gemm.launches["mm_bf16"] == gemm.launches["mm_db"] == 0
