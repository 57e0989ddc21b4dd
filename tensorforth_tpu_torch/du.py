"""Tagged F32 data units (DU) — the universal stack cell.

Mirrors reference src/t4base.h:16-35: a DU is an IEEE-754 float32 whose
two low mantissa bits carry an object tag:

    bit0 = 1  -> the bit pattern (with tags cleared) is an object handle
    bit1 = 1  -> (together with bit0) the handle is a *view* (soft copy)

Scalars keep bit0 == 0; every ALU result is masked with SCALAR() so a
computed value can never collide with a handle.  Object handles encode a
small integer id:  bits = (id << 2) | view<<1 | 1.

This exact encoding is kept (instead of boxing Python objects on the
stack) so the data/return stacks remain flat float32 arrays that a native
inner interpreter can share zero-copy.
"""
from __future__ import annotations

import math
import struct
import numpy as np

from .config import Config

DU0 = np.float32(0.0)
DU1 = np.float32(1.0)
DU_EPS = np.float32(Config.DU_EPS)

_f32 = np.float32
_u32 = np.uint32
_PACK_F = struct.Struct("<f").pack
_UNPACK_I = struct.Struct("<I").unpack


def f2u(v) -> int:
    """bit pattern of a float32 value — struct round-trip (~10x faster
    than a numpy scalar .view; this runs ~15x per interpreted word).
    Denormal handle patterns survive the double round-trip exactly;
    non-finite payloads fall back to the numpy path."""
    try:
        return _UNPACK_I(_PACK_F(v))[0]
    except (OverflowError, TypeError, ValueError, struct.error):
        return int(_f32(v).view(_u32))


def u2f(bits: int) -> np.float32:
    return _u32(bits & 0xFFFFFFFF).view(_f32)


def IS_OBJ(v) -> bool:
    return bool(f2u(v) & 1)


def IS_VIEW(v) -> bool:
    return (f2u(v) & 3) == 3


def SCALAR(v) -> np.float32:
    """clear the object bit (reference t4base.h SCALAR: clears bit0 only)"""
    f = _f32(v)
    if not math.isfinite(float(f)):
        return f                      # NaN/Inf payload bits are not handles
    return u2f(f2u(f) & ~1)


def mk_obj(oid: int, view: bool = False) -> np.float32:
    """encode object id -> tagged DU"""
    return u2f((oid << 2) | (2 if view else 0) | 1)


def obj_id(v) -> int:
    return f2u(v) >> 2


def as_view(v) -> np.float32:
    return u2f(f2u(v) | 3)


def as_obj(v) -> np.float32:
    """strip the view bit, keep obj bit"""
    return u2f((f2u(v) | 1) & ~2)


# ---------------------------------------------------------------------------
# epsilon arithmetic comparison (reference ten4_types.h:85-102)
# ---------------------------------------------------------------------------
def ZEQ(d) -> bool:
    return abs(float(d)) < Config.DU_EPS


def EQ(a, b) -> bool:
    return ZEQ(float(a) - float(b))


def LT(a, b) -> bool:
    return (float(a) - float(b)) < -Config.DU_EPS


def GT(a, b) -> bool:
    return (float(a) - float(b)) > Config.DU_EPS


def BOOL(cond) -> np.float32:
    """Forth boolean: true == -1"""
    if isinstance(cond, (bool, np.bool_)):
        return _f32(-1.0) if cond else DU0
    return DU0 if ZEQ(cond) else _f32(-1.0)


def D2I(f) -> int:
    """DU -> signed int, C-style truncation toward zero"""
    return int(float(f))


def UINT(f) -> int:
    """DU -> unsigned 32-bit, C-style float->unsigned cast"""
    i = int(float(f))
    return i & 0xFFFFFFFF


def I2D(i) -> np.float32:
    return _f32(i)
