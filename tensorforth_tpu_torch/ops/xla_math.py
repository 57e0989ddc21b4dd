"""exp, log, log10, tanh, the logistic, sqrt, sin, cos and pow as XLA's
CPU backend computes them in f32, bit for bit (the JAX package's jnp.exp,
jnp.log, jnp.log10, jnp.tanh, jax.nn.sigmoid, jnp.sqrt, jnp.sin, jnp.cos
and jnp.power on the CPU).

On a CPU f32 tensor each function replays XLA's own expansion: the same
range reduction, the same polynomial constants, its multiply-adds fused
where the LLVM backend fuses them, and the flush of subnormals that XLA's
CPU runtime sets (inputs of arithmetic read as zero, results written as
zero; a select passes its operand through untouched).  Any other tensor,
a CUDA one in particular, takes the torch op: on the card the port is
held to the reference tests' tolerances, not to XLA CPU's last bit.

The constants are the f32 values of XLA's emitted IR (hex doubles there).
sqrt is `vsqrtps` there, the correctly rounded root of the flushed input.
sin, cos and pow are calls of the C library's sinf, cosf and powf, which
XLA's JIT binds to the process's libm: they are replayed by calling the
same functions (through ctypes, one element at a time).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import struct

import numpy as np
import torch

_TINY = 1.1754943508222875e-38           # FLT_MIN, the smallest normal


def _c(bits: int) -> float:
    """the double an LLVM IR hex constant spells"""
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


# exp: clamp, 2^n by the exponent bits, Cody-Waite ln2 = C1 + C2
_EXP_LO, _EXP_HI = _c(0xC055F33340000000), _c(0x4056333340000000)
_LOG2E = _c(0x3FF7154760000000)
_LN2_HI, _LN2_LO = _c(0x3FE6300000000000), _c(0xBF2BD01060000000)
_EXP_P = (_c(0x3F2A0D2CE0000000), _c(0x3F56E879C0000000),
          _c(0x3F81112100000000), _c(0x3FA5553820000000),
          _c(0x3FC5555540000000), 0.5)
# log (Cephes logf): mantissa in [sqrt(1/2), sqrt(2)), three interleaved
# Horner chains of the degree-8 polynomial
_SQRTHF = _c(0x3FE6A09E60000000)
_LOG_P = ((_c(0x3FB2043760000000), _c(0xBFBD7A3700000000),
           _c(0x3FBDE4A340000000)),
          (_c(0xBFBFCBA9E0000000), _c(0x3FC23D37E0000000),
           _c(0xBFC555CA00000000)),
          (_c(0x3FC999D580000000), _c(0xBFCFFFFF80000000),
           _c(0x3FD5555540000000)))
_INV_LN10 = _c(0x3FDBCB7B20000000)
# tanh: rational form on x clamped to the f32 saturation point
_TANH_SMALL = _c(0x3F3A36E2E0000000)
_TANH_CLAMP = _c(0x401FFEC880000000)
_TANH_NUM = (_c(0xBCB3E4B800000000), _c(0x3D4C266FC0000000),
             _c(0xBDD7A6FFE0000000), _c(0x3E6B800820000000),
             _c(0x3EEF286940000000), _c(0x3F44E1BDA0000000),
             _c(0x3F740B3B80000000))
_TANH_DEN = (_c(0x3EB41A7B00000000), _c(0x3F1F12BAC0000000),
             _c(0x3F629540A0000000), _c(0x3F740B3BA0000000))


def _emulate(x) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.float32


def _f(v: float, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _ftz(x):
    """subnormals to a zero of the same sign"""
    return torch.where(x.abs() < _TINY, torch.copysign(
        torch.zeros_like(x), x), x)


def fma(a, b, c):
    """a * b + c rounded once to f32.  The f64 product of two f32 values
    is exact; the f64 sum is corrected where its rounding would land on
    an f32 halfway point (the one case of double rounding)."""
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)                # s + err == p + c exactly
    low = s.view(torch.int64) & ((1 << 29) - 1)  # the bits f32 drops
    half = (low == (1 << 28)) & (err != 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return _ftz(torch.where(half, torch.nextafter(s, toward), s).float())


def _exp(x):
    x = torch.where(x < _EXP_LO, _f(_EXP_LO, x), x)  # NaN passes through
    x = torch.where(x > _EXP_HI, _f(_EXP_HI, x), x)
    n = torch.floor(fma(x, _f(_LOG2E, x), _f(0.5, x)))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma(-n, _f(_LN2_HI, x), x)
    r = fma(-n, _f(_LN2_LO, x), r)
    p = _f(_EXP_P[0], x)
    for k in _EXP_P[1:]:
        p = fma(p, r, _f(k, x))
    y = fma(p, _ftz(r * r), r) + 1.0
    scale = ((torch.nan_to_num(n).to(torch.int32) + 127) << 23).view(
        torch.float32)                     # 2^n; n = -127 gives 0
    return _ftz(y * scale)


def exp(x):
    if not _emulate(x):
        return torch.exp(x)
    return _exp(_ftz(x))


def _log(x):
    invalid = ~(x > 0.0)                   # x <= 0 or NaN
    zero = x == 0.0
    inf = x == float("inf")
    b = torch.clamp_min(torch.nan_to_num(x, nan=0.0), _TINY).view(
        torch.int32)
    m = ((b & -2139095041) | 0x3F000000).view(torch.float32)   # [0.5, 1)
    lt = m < _SQRTHF
    e = ((b >> 23) - 127).float() + 1.0 - lt.float()
    v = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    z = _ftz(v * v)
    v3 = _ftz(z * v)
    ys = []
    for c0, c1, c2 in _LOG_P:
        ys.append(fma(fma(v, _f(c0, x), _f(c1, x)), v, _f(c2, x)))
    y = fma(fma(ys[0], v3, ys[1]), v3, ys[2])
    y = fma(y, v3, _ftz(_f(_LN2_LO, x) * e))
    v = _ftz(_ftz(v - 0.5 * z) + y)
    r = fma(_f(_LN2_HI, x), e, v).view(torch.int32)
    r = torch.where(invalid, torch.full_like(r, -1), r)   # all bits: NaN
    r = torch.where(zero, torch.full_like(r, -8388608), r)     # -inf
    r = torch.where(inf, torch.full_like(r, 0x7F800000), r)    # +inf
    return r.view(torch.float32)


def log(x):
    if not _emulate(x):
        return torch.log(x)
    return _log(_ftz(x))


def log10(x):
    if not _emulate(x):
        return torch.log10(x)
    return _ftz(_log(_ftz(x)) * _f(_INV_LN10, x))


def tanh(x):
    if not _emulate(x):
        return torch.tanh(x)
    xd = _ftz(x)
    c = _f(_TANH_CLAMP, x)
    xc = torch.where(xd < -c, -c, xd)
    xc = torch.where(xc > c, c, xc)
    x2 = _ftz(xc * xc)
    p = fma(x2, _f(_TANH_NUM[0], x), _f(_TANH_NUM[1], x))
    for k in _TANH_NUM[2:]:
        p = fma(x2, p, _f(k, x))
    q = fma(x2, _f(_TANH_DEN[0], x), _f(_TANH_DEN[1], x))
    for k in _TANH_DEN[2:]:
        q = fma(x2, q, _f(k, x))
    r = _ftz(_ftz(xc * p) / q)
    r = torch.where(xd.abs() < _TANH_SMALL, x, r)
    return torch.where(xd.abs() >= 20.0, torch.copysign(
        torch.ones_like(x), x), r)


def logistic(x):
    """1 / (1 + exp(-x)), as jax.nn.sigmoid"""
    if not _emulate(x):
        return torch.sigmoid(x)
    return _ftz(1.0 / _ftz(_exp(_ftz(-x)) + 1.0))


# --- sqrt, sin, cos, pow ----------------------------------------------------
_NAN_BITS = -4194304                     # 0xFFC00000, x86's default NaN
_QUIET = 0x00400000                      # the quiet bit of an f32 NaN
_LIBM = None


def _libm():
    """the C library's sinf, cosf and powf, typed for f32"""
    global _LIBM
    if _LIBM is None:
        try:
            lib = ctypes.CDLL("libm.so.6")
        except OSError:
            lib = ctypes.CDLL(ctypes.util.find_library("m"))
        for name, n in (("sinf", 1), ("cosf", 1), ("powf", 2)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.c_float] * n
        _LIBM = lib
    return _LIBM


def _per_element(fn, *xs):
    """fn over the elements of CPU f32 tensors of one shape, as f32"""
    cols = [x.contiguous().reshape(-1).numpy().tolist() for x in xs]
    out = np.fromiter((fn(*v) for v in zip(*cols)), np.float32,
                      count=xs[0].numel())
    return torch.from_numpy(out).reshape(xs[0].shape)


def sqrt(x):
    if not _emulate(x):
        return torch.sqrt(x)
    xd = _ftz(x)
    # the f64 root rounds once more to f32 without a double-rounding
    # error (53 >= 2 * 24 + 2); torch's own f32 root is off by an ulp
    # for some inputs
    r = torch.sqrt(xd.double()).float().view(torch.int32)
    r = torch.where(xd < 0.0, torch.full_like(r, _NAN_BITS), r)
    return torch.where(torch.isnan(x), x.view(torch.int32) | _QUIET,
                       r).view(torch.float32)


def sin(x):
    if not _emulate(x):
        return torch.sin(x)
    return _per_element(_libm().sinf, x)


def cos(x):
    if not _emulate(x):
        return torch.cos(x)
    return _per_element(_libm().cosf, x)


def _signaling(x):
    b = x.view(torch.int32)
    return torch.isnan(x) & ((b & _QUIET) == 0)


def pow(x, y):
    """x ** y for f32 tensors (or a tensor and a number) as jnp.power"""
    if not isinstance(y, torch.Tensor):
        y = torch.full_like(x, float(y))
    elif not isinstance(x, torch.Tensor):
        x = torch.full_like(y, float(x))
    x, y = torch.broadcast_tensors(x, y)
    if not (_emulate(x) and _emulate(y)):
        return torch.pow(x, y)
    # powf scales a subnormal base by 2^23 to normalize it, and under the
    # runtime's flush that product reads as zero: its log2 becomes -150
    # whatever the mantissa.  powf(2^-75, 2y) takes the same log2(x) * y
    # (both products exact in f64); the sign of a negative base is
    # applied after, as powf would have (NaN unless y is an integer,
    # negative for an odd one)
    sub = (x != 0.0) & (x.abs() < _TINY)
    xc = torch.where(sub, torch.full_like(x, 2.0 ** -75), x)
    yc = torch.where(sub, y * 2.0, y)
    r = _ftz(_per_element(_libm().powf, xc, yc))
    special = (y == 0.0) | torch.isinf(y) | torch.isnan(y)
    neg = sub & (x < 0.0) & ~special
    yi = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
    integer = yi == torch.trunc(yi)
    odd = integer & (yi.abs() < 2.0 ** 24) & (torch.fmod(yi, 2.0) != 0.0)
    r = torch.where(neg & odd, -r, r).view(torch.int32)
    r = torch.where(neg & ~integer, torch.full_like(r, _NAN_BITS), r)
    # a signaling NaN reaches powf unquieted there, where powf returns
    # x + y instead of 1: x ** 0 with x signaling, 1 ** y with y
    # signaling (a Python float carries no signaling NaN to powf here)
    r = torch.where(_signaling(x) & (y == 0.0),
                    x.view(torch.int32) | _QUIET, r)
    r = torch.where(_signaling(y) & (x == 1.0),
                    y.view(torch.int32) | _QUIET, r)
    return r.view(torch.float32)
