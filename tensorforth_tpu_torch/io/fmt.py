"""Scalar/number formatting — behavior-parity with reference io/aio.cpp to_s
and C++ ostream defaults used by sys.h dot()/dotr().
"""
from __future__ import annotations

import math

from ..config import Config

_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def gfmt(v) -> str:
    """C++ `ostream << float` default formatting (6 significant digits)"""
    f = float(v)
    if f != f:
        return "-nan" if math.copysign(1.0, f) < 0 else "nan"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    s = f"{f:g}"
    return s


def to_base(n: int, base: int) -> str:
    """digit-by-digit conversion of a non-negative int (Forth <# #S #>)"""
    if not 2 <= base <= 36:     # a trashed BASE user var must not kill
        base = 10               # the prompt's stack dump (fuzz finding)
    if n == 0:
        return "0"
    out = []
    n &= 0xFFFFFFFF
    while n:
        out.append(_DIGITS[n % base])
        n //= base
    return "".join(reversed(out))


def to_s_scalar(v, base: int = 10) -> str:
    """reference aio.cpp:38-57 — decimal w/ fraction -> %0.6g, else by-digit"""
    f = float(v)
    if not math.isfinite(f):        # %g semantics: inf/-inf/nan print,
        return f"{f:g}"             # never overflow the stack dump
    frac = abs(f - math.trunc(f))
    if base == 10 and frac > Config.DU_EPS:
        return f"{f:0.6g}"
    n = int(abs(f)) if base == 10 else (int(f) & 0xFFFFFFFF)
    s = to_base(n, base)
    if base == 10 and f < 0.0:
        s = "-" + s
    return s
