"""A reader of the event files tb/writer.py writes: the TFRecord framing
with both masked CRC32-Cs checked, and the protobuf fields of Event,
Summary and Histogram, enough to read the records back where the
tensorboard package is not installed.
"""
from __future__ import annotations

import struct

from .crc32c import masked_crc32c


def records(path: str) -> list[bytes]:
    """the file's records; raises ValueError on a bad length or data CRC"""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return out
            (ln,) = struct.unpack("<Q", hdr)
            (crc_h,) = struct.unpack("<I", f.read(4))
            data = f.read(ln)
            (crc_d,) = struct.unpack("<I", f.read(4))
            if crc_h != masked_crc32c(hdr) or crc_d != masked_crc32c(data):
                raise ValueError(f"{path}: record {len(out)} fails its CRC")
            out.append(data)


def _varint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, i


def fields(buf: bytes) -> dict:
    """one protobuf message: {field number: [values]} (varints as int,
    fixed64 as float, fixed32 as float, length-delimited as bytes)"""
    out: dict = {}
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        fid, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            (v,) = struct.unpack_from("<d", buf, i)
            i += 8
        elif wire == 5:
            (v,) = struct.unpack_from("<f", buf, i)
            i += 4
        elif wire == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"wire type {wire}")
        out.setdefault(fid, []).append(v)
    return out


def summaries(path: str) -> list[tuple]:
    """(step, tag, kind, value) of every Summary value in the file: kind
    "scalar" (a float), "image" (PNG bytes), "histo" (the Histogram's
    fields), "tensor" (text: the TensorProto's bytes)"""
    out = []
    for rec in records(path):
        ev = fields(rec)
        step = ev.get(2, [0])[0]
        for s in ev.get(5, []):
            for v in fields(s).get(1, []):
                val = fields(v)
                tag = val[1][0].decode()
                if 2 in val:
                    out.append((step, tag, "scalar", val[2][0]))
                elif 4 in val:
                    out.append((step, tag, "image", fields(val[4][0])[4][0]))
                elif 5 in val:
                    out.append((step, tag, "histo", fields(val[5][0])))
                elif 8 in val:
                    out.append((step, tag, "tensor", fields(val[8][0])))
    return out


def graphs(path: str) -> list[bytes]:
    """the GraphDef bytes of the file's graph events"""
    return [g for rec in records(path) for g in fields(rec).get(4, [])]
