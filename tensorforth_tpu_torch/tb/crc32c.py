"""CRC32-C (Castagnoli) + TFRecord masking (reference tb/crc32c.h).

Uses the native slice-by-8 implementation (csrc/t4tb.cpp) when built;
the pure-Python table fallback keeps behavior identical.
"""

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)

_MASK_DELTA = 0xA282EAD8

try:
    from ..runtime.native import get_tb as _get_tb
    _native = _get_tb()
except Exception:
    _native = None


def crc32c(data: bytes, crc: int = 0) -> int:
    if _native is not None:
        return _native.t4_crc32c(data, len(data), crc)
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord masked crc (rotate right 15 + delta)"""
    if _native is not None:
        return _native.t4_masked_crc32c(data, len(data))
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF
