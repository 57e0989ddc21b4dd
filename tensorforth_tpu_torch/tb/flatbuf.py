"""Minimal FlatBuffers builder (reference tb/flatbuf.h — auxiliary;
the event path uses the protobuf encoder, this exists for format parity
and ad-hoc binary tables).

Supports: scalar fields (int32/int64/float32), strings, vectors of
bytes/int32/float32, and table construction with a vtable — enough to
serialize simple record tables readable by flatc-generated code.
"""
from __future__ import annotations

import struct


class FlatBufferBuilder:
    def __init__(self, initial: int = 1024):
        self._buf = bytearray()          # built back-to-front
        self._minalign = 1
        self._vtables: list[int] = []
        self._current_vtable: list[int] | None = None
        self._object_start = 0

    # --- low-level -------------------------------------------------------
    def _prep(self, size: int, extra: int = 0):
        if size > self._minalign:
            self._minalign = size
        align = (~(len(self._buf) + extra)) + 1 & (size - 1)
        self._buf[:0] = b"\0" * align

    def _push(self, fmt: str, v):
        sz = struct.calcsize(fmt)
        self._prep(sz)
        self._buf[:0] = struct.pack(fmt, v)
        return len(self._buf)

    def offset(self) -> int:
        return len(self._buf)

    # --- scalars -----------------------------------------------------------
    def push_int32(self, v: int) -> int:
        return self._push("<i", v)

    def push_int64(self, v: int) -> int:
        return self._push("<q", v)

    def push_float32(self, v: float) -> int:
        return self._push("<f", v)

    # --- strings / vectors ----------------------------------------------------
    def create_string(self, s: str) -> int:
        raw = s.encode("utf-8") + b"\0"
        self._prep(4, len(raw))
        self._buf[:0] = raw
        return self._push("<I", len(raw) - 1)

    def create_vector_f32(self, vals) -> int:
        self._prep(4, 4 * len(vals))
        for v in reversed(list(vals)):
            self._buf[:0] = struct.pack("<f", float(v))
        return self._push("<I", len(vals))

    def create_vector_i32(self, vals) -> int:
        self._prep(4, 4 * len(vals))
        for v in reversed(list(vals)):
            self._buf[:0] = struct.pack("<i", int(v))
        return self._push("<I", len(vals))

    def create_vector_bytes(self, data: bytes) -> int:
        self._prep(4, len(data))
        self._buf[:0] = data
        return self._push("<I", len(data))

    # --- tables -------------------------------------------------------------------
    def start_table(self, n_fields: int):
        self._current_vtable = [0] * n_fields
        self._object_start = self.offset()

    def slot_scalar32(self, slot: int, v, default=0):
        if v != default:
            self.push_int32(int(v)) if isinstance(v, int) \
                else self.push_float32(float(v))
            self._current_vtable[slot] = self.offset()

    def slot_offset(self, slot: int, off: int):
        if off:
            self._prep(4)
            rel = self.offset() + 4 - off
            self._buf[:0] = struct.pack("<I", rel)
            self._current_vtable[slot] = self.offset()

    def end_table(self) -> int:
        # soffset placeholder to vtable
        self.push_int32(0)
        table_off = self.offset()
        vt = [0] * len(self._current_vtable)
        for i, o in enumerate(self._current_vtable):
            vt[i] = (table_off - o) if o else 0
        vt_len = 4 + 2 * len(vt)
        for fo in reversed(vt):
            self._buf[:0] = struct.pack("<H", fo)
        self._buf[:0] = struct.pack("<H", table_off - self._object_start)
        self._buf[:0] = struct.pack("<H", vt_len)
        vt_off = self.offset()
        # patch the soffset at table start: vtable is *before* the table
        pos = len(self._buf) - table_off
        struct.pack_into("<i", self._buf, pos, vt_off - table_off)
        self._current_vtable = None
        return table_off

    def finish(self, root: int) -> bytes:
        self._prep(self._minalign, 4)
        self._buf[:0] = struct.pack("<I", self.offset() + 4 - root)
        return bytes(self._buf)
