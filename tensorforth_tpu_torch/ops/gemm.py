"""GEMM kernels of the tensor tier: the CUDA kernels' wrappers and their
plain PyTorch versions (the port of tensorforth_tpu/ops/gemm_pallas.py).

Four kernels in ``csrc/gemm.cu`` replace the four Pallas TPU kernels:

  ``_mm``           K5a  gemm_pallas.py:_mm_kernel (via _mm_pallas): f32 in,
                         f32 out, class ``default`` (multiplicands rounded
                         to bf16), ``3pass`` (ah bh + ah bl + al bh) or
                         ``highest`` (true f32)
  ``_mm(bf16=True)``  K5b  gemm_pallas.py:_mm_kernel_bf16: the same product
                         with the bf16 rounding explicit in the body
  ``_mm_v8``        K6   gemm_pallas.py:_v8_kernel (via _mm_pallas_v8): bf16
                         operands (cast out here), the scale fused at the
                         flush
  ``_mm_db``        K7   gemm_pallas.py:_mm_kernel_db (via _mm_pallas_db):
                         K-slabs streamed through two buffers, the copy of
                         slab i+1 overlapped with the product of slab i

``mm`` maps the ``gemm2..4`` words' variants onto them and ``gemm`` adds
the alpha/beta/transpose epilogue, as gemm_pallas.py:312-401 does.  The
TPU tile tables of ``mm_pallas`` are VMEM tuning and do not come across.
Variants 2 and 3 both resolve to K5a: on the TPU variant 2 is K5a with a
whole-K panel resident, and a 256 x 2048 f32 panel does not fit an SM's
shared memory, so the port keeps the one K-blocked kernel.

All four are bound by operations on this card (the source's header says
what the design does about it).  Every wrapper launches its kernel for
CUDA tensors and takes the plain version only for CPU tensors; anything
else raises.  There is no fallback on the card.  ``launches`` counts the
launches of each kernel since ``reset_launches()``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..config import Config

PREC_CLASSES = ("default", "3pass", "highest")
DB_TILE = (128, 128, 32)        # K7 pads m, n, k to these (csrc/gemm.cu)

launches = {"mm_f32io": 0, "mm_bf16": 0, "mm_v8": 0, "mm_db": 0}


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
# plain versions (CPU tensors, and what the kernels are held against)
# ===========================================================================
def _bf(x):
    """x rounded to bf16 (nearest even), as f32"""
    return x.to(torch.bfloat16).float()


def _mm_ref(a, b, bf16: bool = False, prec: str = "default"):
    """plain version of K5a / K5b.  Products of bf16 values are exact in
    f32, so an f32 product of the rounded operands is the kernel's
    arithmetic up to the order of its f32 sums."""
    if bf16 or prec == "default":
        return _bf(a) @ _bf(b)
    if prec == "3pass":
        ah, bh = _bf(a), _bf(b)
        al, bl = _bf(a - ah), _bf(b - bh)
        return ah @ bh + ah @ bl + al @ bh
    if prec == "highest":
        return a @ b
    raise ValueError(f"precision class {prec}?")


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
_ARGTYPES = {
    "t4_mm_f32io": [_P] * 3 + [_I] * 7 + [_P],
    "t4_mm_bf16": [_P] * 3 + [_I] * 6 + [_P],
    "t4_mm_v8": [_P] * 3 + [_I] * 6 + [_F, _P],
    "t4_mm_db": [_P] * 3 + [_I] * 3 + [_P],
}


def _lib():
    """the built library csrc/gemm.cu, its functions' argtypes set"""
    from . import _build
    lib = _build.load("gemm")
    for fname, argtypes in _ARGTYPES.items():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


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
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fname)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _mm(a, b, bf16: bool = False, prec: str | None = None):
    """A[m,k] @ B[k,n], f32 in and out: K5a in class `prec` (None: from
    Config.PRECISION), or K5b with bf16=True"""
    prec = prec_class() if prec is None else prec
    if prec not in PREC_CLASSES:
        raise ValueError(f"precision class {prec}?")
    if _on_cpu(a, b):
        return _mm_ref(a, b, bf16, prec)
    a, b = _check("_mm", a, b)
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    dims = (m, n, k, k, n, n)        # sizes and the leading dimensions
    if bf16:
        _launch("mm_bf16", "t4_mm_bf16", a, a.data_ptr(), b.data_ptr(),
                c.data_ptr(), *dims)
    else:
        _launch("mm_f32io", "t4_mm_f32io", a, a.data_ptr(), b.data_ptr(),
                c.data_ptr(), *dims, PREC_CLASSES.index(prec))
    return c


def _mm_v8(a, b, scale: float = 1.0):
    """scale * (bf16(A) @ bf16(B)), f32 sums and output: K6.  The bf16
    cast is out here, as gemm_pallas.py:277-278 casts outside its
    kernel."""
    if _on_cpu(a, b):
        return _mm_v8_ref(a, b, scale)
    a, b = _check("_mm_v8", a.to(torch.bfloat16), b.to(torch.bfloat16),
                  torch.bfloat16)
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("mm_v8", "t4_mm_v8", a, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            m, n, k, k, n, n, float(scale))
    return c


def _pad_to(x, m0: int, m1: int):
    """zero-pad a matrix to multiples of (m0, m1)"""
    p0, p1 = (-x.shape[0]) % m0, (-x.shape[1]) % m1
    return F.pad(x, (0, p1, 0, p0)) if p0 or p1 else x


def _mm_db(a, b):
    """A @ B, f32 in and out, class default: K7.  cp.async needs aligned,
    in-bounds 16-byte sources, so the operands are zero-padded to tile
    multiples and the result is sliced back, as gemm_pallas.py:212-234
    does."""
    if _on_cpu(a, b):
        return _mm_db_ref(a, b)
    a, b = _check("_mm_db", a, b)
    m, n = a.shape[0], b.shape[1]
    bm, bn, bk = DB_TILE
    a, b = _pad_to(a, bm, bk), _pad_to(b, bk, bn)
    (mp, kp), np_ = a.shape, b.shape[1]
    c = torch.empty((mp, np_), dtype=torch.float32, device=a.device)
    _launch("mm_db", "t4_mm_db", a, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            mp, np_, kp)
    return c[:m, :n]


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
