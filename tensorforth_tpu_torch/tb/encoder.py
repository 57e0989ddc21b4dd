"""Minimal protobuf wire-format encoder (reference tb/encoder.h)."""
from __future__ import annotations

import struct


def varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def key(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def f_varint(field: int, n: int) -> bytes:
    return key(field, 0) + varint(n)


def f_double(field: int, v: float) -> bytes:
    return key(field, 1) + struct.pack("<d", v)


def f_float(field: int, v: float) -> bytes:
    return key(field, 5) + struct.pack("<f", v)


def f_bytes(field: int, data: bytes) -> bytes:
    return key(field, 2) + varint(len(data)) + data


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_msg(field: int, msg: bytes) -> bytes:
    return f_bytes(field, msg)


def f_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return f_bytes(field, payload)
