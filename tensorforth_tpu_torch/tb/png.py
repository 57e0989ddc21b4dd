"""Dependency-free PNG encoder (reference tb/png.h, zlib-backed here)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def raw2png(px: np.ndarray) -> bytes:
    """px: [H, W, 3] uint8 -> PNG bytes"""
    h, w, c = px.shape
    assert c == 3
    # one prefixed filter byte (0 = None) per scanline, built in one
    # numpy op instead of a per-row Python join
    rows = np.zeros((h, 1 + w * 3), dtype=np.uint8)
    rows[:, 1:] = np.ascontiguousarray(px).reshape(h, w * 3)
    raw = rows.tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))
