"""GEMM kernels of the tensor tier: the CUDA kernels' wrappers and their
plain PyTorch versions (the port of tensorforth_tpu/ops/gemm_pallas.py).

Two sources replace the four Pallas TPU kernels.  ``csrc/gemm_sm90.cu``
carries the words' paths on Hopper's own machinery (bf16 wgmma reading
swizzled shared memory, fed by a ring of TMA loads):

  ``_mm``           K5a  gemm_pallas.py:_mm_kernel (via _mm_pallas): f32 in,
                         f32 out, class ``default`` (multiplicands rounded
                         to bf16), ``3pass`` (ah bh + ah bl + al bh) or
                         ``highest`` (six products of a three-part split,
                         x = hi + mid + lo exactly: the TPU's
                         BF16_BF16_F32_X6).  A rounding pass of the same
                         source (``_round``) first rounds or splits both
                         operands to bf16 parts.
  ``_mm_v8``        K6   gemm_pallas.py:_v8_kernel (via _mm_pallas_v8): bf16
                         operands (cast out here), the scale fused at the
                         flush

``csrc/gemm_sm90_f32.cu`` takes f32 operands and rounds them inside its
one launch, on the same wgmma products, as the two TPU kernels that round
in their bodies do.  Both stream f32 K-slabs through a ring of TMA stages
and round them in shared memory; no word reaches either:

  ``_mm(bf16=True)``  K5b  gemm_pallas.py:_mm_kernel_bf16: the same product
                         as class ``default``; a converter warpgroup
                         rounds B while the consumers round A
  ``_mm_db``        K7   gemm_pallas.py:_mm_kernel_db (via _mm_pallas_db):
                         the consumers round both operands

``mm`` maps the ``gemm2..4`` words' variants onto them and ``gemm`` adds
the alpha/beta/transpose epilogue, as gemm_pallas.py:312-401 does.  The
TPU tile tables of ``mm_pallas`` are VMEM tuning and do not come across;
``sm90_plan`` and ``f32in_plan`` are this card's tile plans.  Variants 2
and 3 both resolve to K5a: on the TPU variant 2 is K5a with a whole-K panel
resident, and a 256 x 2048 f32 panel does not fit an SM's shared memory.

All of them are bound by operations on this card (each source's header
says what its design does about it).  Every wrapper launches its kernel
for CUDA tensors and takes the plain version only for CPU tensors;
anything else raises.  There is no fallback on the card.  ``launches``
counts the launches of each kernel since ``reset_launches()``: K5a in any
class counts as ``mm_f32io``, its rounding pass as ``mm_round``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import Config

PREC_CLASSES = ("default", "3pass", "highest")
TMA_ROW = 8                     # bf16 per 16 bytes: TMA's row-pitch unit
TMA_ROW_F32 = 4                 # f32 per 16 bytes

launches = {"mm_f32io": 0, "mm_bf16": 0, "mm_v8": 0, "mm_db": 0,
            "mm_round": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


def prec_class() -> str:
    """the f32-I/O kernels' precision class from Config.PRECISION:
    'fast' keeps bf16 multiplicands, 'strict' asks for f32-class accuracy
    (tensorforth_tpu/__init__.py:28-43 sets 'high', which
    gemm_pallas.py:63-73 resolves to the 3-pass split)"""
    return "3pass" if Config.PRECISION == "strict" else "default"


# ===========================================================================
# the wgmma kernel's tile plan (csrc/gemm_sm90.cu)
# ===========================================================================
SM90_BM, SM90_BK, SM90_ALIGN = 128, 64, 1024
SM90_SMEM_LIMIT = 232448        # a block's dynamic shared memory on sm_90
# products per K slab -> (tile columns, ring stages): the instances
# t4_gemm_sm90 is built with (nprod 3 holds hi and lo tiles of both
# operands, so its stages are twice the size; nprod 6 holds hi, mid and
# lo: three times, and two stages of 96 KB)
SM90_TILES = {1: (256, 4), 3: (128, 3), 6: (128, 2)}
SM90_PARTS = {1: 1, 3: 2, 6: 3}     # products per slab -> parts an operand
PREC_NPROD = {"default": 1, "3pass": 3, "highest": 6}


class Sm90Plan(NamedTuple):
    nprod: int          # 1: one product; 3: the 3pass split; 6: highest
    bm: int             # block tile rows
    bn: int             # block tile columns
    bk: int             # K slab
    stages: int         # ring depth
    smem: int           # dynamic shared memory, bytes
    a_box: tuple        # TMA box of A: (inner k elements, rows)
    b_box: tuple        # TMA box of B: (inner n elements, rows of k)
    grid: tuple         # (tiles over n, tiles over m)


def sm90_plan(m: int, n: int, nprod: int) -> Sm90Plan:
    """the tile plan t4_gemm_sm90 launches for C [m, n] (the kernel refuses
    any other): a ring of `stages` stages of bf16 tiles, each A box
    [64 k x 128 rows] and each B box [64 n x 64 k] 128 bytes wide on its
    inner dimension (the 128-byte swizzle), 1024 bytes of alignment slack
    and two 8-byte barriers a stage"""
    bn, stages = SM90_TILES[nprod]
    parts = SM90_PARTS[nprod]
    stage = parts * (SM90_BM * SM90_BK + (bn // 64) * 64 * SM90_BK) * 2
    return Sm90Plan(nprod, SM90_BM, bn, SM90_BK, stages,
                    SM90_ALIGN + stages * stage + 2 * stages * 8,
                    (SM90_BK, SM90_BM), (64, SM90_BK),
                    (math.ceil(n / bn), math.ceil(m / SM90_BM)))


def _pad_inner(x):
    """x with its rows zero-padded to a multiple of TMA_ROW elements (TMA
    wants 16-byte row pitches of bf16); x itself when they are"""
    p = (-x.shape[-1]) % TMA_ROW
    return F.pad(x, (0, p)) if p else x


# ===========================================================================
# the f32-operand kernels' tile plans (csrc/gemm_sm90_f32.cu)
# ===========================================================================
class F32InPlan(NamedTuple):
    kernel: str         # "mm_bf16" (K5b) or "mm_db" (K7)
    bm: int             # block tile rows
    bn: int             # block tile columns
    bk: int             # K slab: 32 f32, one 128-byte row
    stages: int         # ring of f32 stages, filled by TMA
    b_tiles: int        # bf16 B tiles the slabs are rounded into
    barriers: int       # 8-byte mbarriers
    smem: int           # dynamic shared memory, bytes
    a_box: tuple        # TMA box of A: (inner k elements, rows)
    b_box: tuple        # TMA box of B: (inner n elements, rows of k)
    grid: tuple         # (tiles over n, tiles over m)
    pad: tuple          # zeros the wrapper adds to A's rows, to B's rows


def f32in_plan(kernel: str, m: int, k: int, n: int) -> F32InPlan:
    """the tile plan of K5b or K7 for A [m, k] @ B [k, n] (the kernels
    refuse another): 128 x 256 tiles of C; f32 slabs of 32 k by TMA into 3
    stages (A one [32 k x 128] box, B 8 boxes [32 n x 32 k], each row 128
    bytes: the swizzle's width), rounded into 3 bf16 B tiles of 16 KB; rows
    padded to 16-byte pitches.  K7: a `full` barrier a stage; K5b: `full`
    and `empty` barriers a stage and a tile.  1024 bytes of alignment
    slack."""
    bm, bn, bk, stages, tiles = 128, 256, 32, 3, 3
    barriers = stages if kernel == "mm_db" else 2 * (stages + tiles)
    if kernel not in ("mm_bf16", "mm_db"):
        raise ValueError(f"f32-operand kernel {kernel}?")
    smem = (SM90_ALIGN + stages * (bm + bn) * bk * 4 + tiles * bk * bn * 2
            + barriers * 8)
    return F32InPlan(kernel, bm, bn, bk, stages, tiles, barriers, smem,
                     (bk, bm), (32, bk),
                     (math.ceil(n / bn), math.ceil(m / bm)),
                     ((-k) % TMA_ROW_F32, (-n) % TMA_ROW_F32))


# ===========================================================================
# plain versions (CPU tensors, and what the kernels are held against)
# ===========================================================================
def _bf(x):
    """x rounded to bf16 (nearest even), as f32"""
    return x.to(torch.bfloat16).float()


def _flush(x):
    """x with its f32 subnormals replaced by zeros of the same sign"""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)


def _split(x):
    """the 3pass split of gemm_pallas.py:80-83 as the reference computes
    it: hi = bf16(x), lo = bf16(x - f32(hi)), bf16 tensors.  The TPU, and
    XLA on the CPU, take subnormal inputs of an f32 subtraction as zero and
    flush a subnormal result to zero; the rounding to bf16 keeps
    subnormals.  So does the rounding pass's kernel (sub.rn.ftz.f32)."""
    hi = x.to(torch.bfloat16)
    return hi, _flush(_flush(x) - _flush(hi.float())).to(torch.bfloat16)


def _split3_ref(x):
    """the three-part split of the class highest (csrc/split_bf16.cuh):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), bf16
    tensors; the f32 subtractions are exact and keep subnormals, so
    hi + mid + lo == x for every f32 with 2^-110 <= |x| < 0x1.FEp127"""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _mm_ref(a, b, bf16: bool = False, prec: str = "default"):
    """plain version of K5a / K5b.  Products of bf16 values are exact in
    f32, so an f32 product of the rounded operands is the kernel's
    arithmetic up to the order of its f32 sums."""
    if bf16 or prec == "default":
        return _bf(a) @ _bf(b)
    if prec == "3pass":
        (ah, al), (bh, bl) = ([p.float() for p in _split(x)] for x in (a, b))
        return ah @ bh + ah @ bl + al @ bh
    if prec == "highest":
        return a @ b
    raise ValueError(f"precision class {prec}?")


def _parts_ref(x, parts: int):
    """[parts, rows, cols padded to TMA_ROW] bf16: hi = bf16(x); with 2
    parts also lo (`_split`); with 3 mid and lo (`_split3_ref`); zeros in
    the padding"""
    x = _pad_inner(x)
    if parts == 1:
        return x.to(torch.bfloat16)[None]
    return torch.stack(_split(x) if parts == 2 else _split3_ref(x))


def _split_ref(x, split: bool):
    """[parts, rows, cols padded to TMA_ROW] bf16: hi = bf16(x) and, when
    split, lo (`_split`); zeros in the padding"""
    return _parts_ref(x, 2 if split else 1)


def _round_ref(a, b, split: bool = False, parts: int | None = None):
    """plain version of K5a's rounding pass: both operands' parts (1, or
    2 when split, or `parts`), laid out as the kernel writes them"""
    parts = parts or (2 if split else 1)
    return _parts_ref(a, parts), _parts_ref(b, parts)


def _split_products_f64(a, b, parts: int = 3):
    """a @ b from the three-part split's first `parts` parts, each product
    of parts exact in f64 and the pairs (i, j) with i + j < parts summed in
    f64: six products for 3 parts (the class highest's arithmetic), three
    for 2 (hi hi, hi mid, mid hi), without the tensor cores' truncating
    sums.  f64 result."""
    pa = [p.double() for p in _split3_ref(a)[:parts]]
    pb = [p.double() for p in _split3_ref(b)[:parts]]
    return sum(pa[i] @ pb[j] for i in range(parts) for j in range(parts)
               if i + j < parts)


def _mm_v8_ref(a, b, scale: float = 1.0):
    """plain version of K6"""
    return (_bf(a) @ _bf(b)) * scale


def _mm_db_ref(a, b):
    """plain version of K7 (class default)"""
    return _bf(a) @ _bf(b)


# ===========================================================================
# kernel wrappers
# ===========================================================================
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {   # source -> exported function -> argtypes
    "gemm_sm90": {"t4_gemm_sm90": [_P] * 3 + [_I] * 6 + [_F] + [_I] * 4
                  + [_P],
                  "t4_round_bf16": [_P] * 4 + [_I] * 6 + [_P]},
    "gemm_sm90_f32": {"t4_mm_bf16": [_P] * 3 + [_I] * 7 + [_P],
                      "t4_mm_db": [_P] * 3 + [_I] * 7 + [_P]},
}
_SOURCE = {fname: src for src, fns in _ARGTYPES.items() for fname in fns}


_FUNCS = {}    # exported function name -> its ctypes function


def _fn(fname: str):
    """the exported function of a built library csrc/<source>.cu, its
    argtypes set (the library is built on first use)"""
    fn = _FUNCS.get(fname)
    if fn is None:
        from . import _build
        fn = getattr(_build.load(_SOURCE[fname]), fname)
        fn.argtypes = _ARGTYPES[_SOURCE[fname]][fname]
        fn.restype = ctypes.c_int
        _FUNCS[fname] = fn
    return fn


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(what: str, a, b, dtype=torch.float32):
    """the kernels' contract: 2-D [m,k] @ [k,n], m, n, k >= 1, one CUDA
    device, f32.  Returns contiguous operands (a transposed view is
    copied: the kernels read row-major storage)."""
    if a.device != b.device or not a.is_cuda:
        raise ValueError(f"{what}: tensors on {a.device} and {b.device}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or 0 in a.shape or 0 in b.shape):
        raise ValueError(f"{what}: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"{what}: dtypes {a.dtype}, {b.dtype}, want "
                         f"{dtype}")
    return a.contiguous(), b.contiguous()


def _launch(name: str, fname: str, a, *args):
    """call one exported function on a's device and current stream, raise
    on a refused launch, count the launch"""
    fn = _fn(fname)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _round(a, b, split: bool = False, parts: int | None = None):
    """K5a's rounding pass: (a parts [P, m, kp], b parts [P, k, np]) bf16,
    P = 2 (hi, lo) when split, or `parts` (3: hi, mid, lo), rows
    zero-padded to TMA_ROW; one launch for both operands"""
    parts = parts or (2 if split else 1)
    if _on_cpu(a, b):
        return _round_ref(a, b, parts=parts)
    return _round_launch(*_check("_round", a, b), parts)


def _round_launch(a, b, parts: int):
    """the rounding pass on operands that passed _check"""
    if parts not in (1, 2, 3):
        raise ValueError(f"_round: {parts} parts?")
    (m, k), n = a.shape, b.shape[1]
    kp, np_ = k + (-k) % TMA_ROW, n + (-n) % TMA_ROW
    ap = torch.empty((parts, m, kp), dtype=torch.bfloat16, device=a.device)
    bp = torch.empty((parts, k, np_), dtype=torch.bfloat16, device=a.device)
    _launch("mm_round", "t4_round_bf16", a, a.data_ptr(), b.data_ptr(),
            ap.data_ptr(), bp.data_ptr(), m, n, k, kp, np_, parts)
    return ap, bp


def _gemm_sm90(name: str, ap, bp, n: int, k: int, scale: float):
    """scale * (A @ B) [m, n] by the wgmma kernel, from bf16 parts
    [P, m, lda] and [P, k, ldb] (P = 2: the 3pass split; 3: highest's)
    whose row pitches are multiples of TMA_ROW; counted as `name`"""
    parts, m, lda = ap.shape
    nprod = {p: n for n, p in SM90_PARTS.items()}[parts]
    plan = sm90_plan(m, n, nprod)
    c = torch.empty((m, n), dtype=torch.float32, device=ap.device)
    _launch(name, "t4_gemm_sm90", ap, ap.data_ptr(), bp.data_ptr(),
            c.data_ptr(), m, n, k, lda, bp.shape[2], n, float(scale), nprod,
            plan.bn, plan.stages, plan.smem)
    return c


def _mm(a, b, bf16: bool = False, prec: str | None = None):
    """A[m,k] @ B[k,n], f32 in and out: K5a in class `prec` (None: from
    Config.PRECISION), or K5b with bf16=True"""
    prec = prec_class() if prec is None else prec
    if prec not in PREC_CLASSES:
        raise ValueError(f"precision class {prec}?")
    if _on_cpu(a, b):
        return _mm_ref(a, b, bf16, prec)
    a, b = _check("_mm", a, b)
    if bf16:
        return _mm_f32in("mm_bf16", a, b)
    ap, bp = _round_launch(a, b, SM90_PARTS[PREC_NPROD[prec]])
    return _gemm_sm90("mm_f32io", ap, bp, b.shape[1], a.shape[1], 1.0)


def _mm_v8(a, b, scale: float = 1.0):
    """scale * (bf16(A) @ bf16(B)), f32 sums and output: K6.  The bf16
    cast is out here, as gemm_pallas.py:277-278 casts outside its kernel,
    and pads the rows to TMA_ROW where they are not."""
    if _on_cpu(a, b):
        return _mm_v8_ref(a, b, scale)
    a, b = _check("_mm_v8", a.to(torch.bfloat16), b.to(torch.bfloat16),
                  torch.bfloat16)
    return _gemm_sm90("mm_v8", _pad_inner(a)[None], _pad_inner(b)[None],
                      b.shape[1], a.shape[1], scale)


def _pad_to(x, m0: int, m1: int):
    """zero-pad a matrix to multiples of (m0, m1)"""
    p0, p1 = (-x.shape[0]) % m0, (-x.shape[1]) % m1
    return F.pad(x, (0, p1, 0, p0)) if p0 or p1 else x


def _tma_ready(x, pad: int):
    """x with `pad` zeros added to its rows, in storage TMA can read (a
    16-byte aligned base)"""
    if pad:
        return F.pad(x, (0, pad))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _mm_f32in(name: str, a, b):
    """K5b or K7 on operands that passed _check.  TMA reads the f32
    operands with 16-byte row pitches: rows whose length is not a multiple
    of 4 are zero-padded (the kernels never read the padding: their tensor
    maps have the true m, n, k, and TMA fills what lies beyond with
    zeros).  No other padding, and the result needs no slicing."""
    (m, k), n = a.shape, b.shape[1]
    plan = f32in_plan(name, m, k, n)
    a, b = _tma_ready(a, plan.pad[0]), _tma_ready(b, plan.pad[1])
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch(name, "t4_" + name, a, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            m, n, k, a.shape[1], b.shape[1], n, plan.smem)
    return c


def _mm_db(a, b):
    """A @ B, f32 in and out, class default: K7"""
    if _on_cpu(a, b):
        return _mm_db_ref(a, b)
    return _mm_f32in("mm_db", *_check("_mm_db", a, b))


def mm(a, b, variant: int = 3, scale: float = 1.0):
    """variants 2 and 3: the f32-I/O kernel in the active class; 4: the
    bf16-operand kernel with `scale` fused at its flush (the others
    multiply outside)"""
    if variant == 4:
        return _mm_v8(a, b, scale)
    if variant not in (2, 3):
        raise ValueError(f"gemm variant {variant}?")
    r = _mm(a, b)
    return r * scale if scale != 1.0 else r


def gemm(a, b, c, alpha=1.0, beta=0.0, ta: bool = False, tb: bool = False,
         variant: int = 3):
    """alpha * op(A) @ op(B) + beta * C through kernel variant 2, 3 or 4"""
    aa = a.T if ta else a
    bb = b.T if tb else b
    if variant == 4:
        return mm(aa, bb, 4, scale=alpha) + beta * c   # alpha in the kernel
    return alpha * mm(aa, bb, variant) + beta * c
