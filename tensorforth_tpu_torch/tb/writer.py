"""TFRecord event writer — hand-built Event/Summary/Histogram protos (the
port of tensorforth_tpu/tb/writer.py).

Reference: tb/writer.h (TFRecord framing [len u64][masked-crc(len)]
[proto][masked-crc(data)]) + tb/schema.h proto layouts.

Event assembly, CRC framing and file writes run in the native library
(csrc/t4io.cpp) when available — per the blueprint's native-host-runtime
rule (SURVEY §7) — with this module's pure-Python encoder kept as the
byte-identical fallback (pinned by tests/test_native_io.py).
"""
from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from . import encoder as e
from .crc32c import masked_crc32c
from ..runtime import native


class EventWriter:
    def __init__(self, logdir: str, run_id: str | None = None):
        path = os.path.join(logdir, run_id) if run_id else logdir
        os.makedirs(path, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.0")
        self.path = os.path.join(path, fname)
        self.step = 0
        self._lib = native.get_io()
        self._h = 0
        self._fs = None
        if self._lib is not None:
            self._h = self._lib.t4_tb_open(self.path.encode())
        if not self._h:
            self._lib = None
            self._fs = open(self.path, "wb")
        self._file_version()


    def _ck(self, rc):
        """ADVICE r2: the native t4_tb_* calls return -1 on fwrite
        failure (disk full, bad handle); the pure-Python path raises
        OSError from file.write — match it instead of silently
        dropping TensorBoard events."""
        if rc < 0:
            raise OSError(f"native TB write failed (rc={rc}) on {self.path}")
        return rc

    def _file_version(self):
        if self._lib:
            self._ck(self._lib.t4_tb_file_version(self._h, time.time()))
        else:
            self._write_event(e.f_str(3, "brain.Event:2"))

    # --- framing (pure-Python fallback) -----------------------------------
    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._fs.write(hdr)
        self._fs.write(struct.pack("<I", masked_crc32c(hdr)))
        self._fs.write(data)
        self._fs.write(struct.pack("<I", masked_crc32c(data)))
        self._fs.flush()

    def _write_event(self, body: bytes, use_step: bool = True):
        if self._lib:
            self._ck(self._lib.t4_tb_raw_body(self._h, body, len(body),
                                     time.time(), self.step,
                                     1 if use_step else 0))
            return
        ev = e.f_double(1, time.time())
        if use_step:
            ev += e.f_varint(2, self.step)
        self._write_record(ev + body)

    def _write_summary(self, value_msgs: bytes):
        self._write_event(e.f_msg(5, value_msgs))

    # --- value builders ------------------------------------------------------
    def add_scalar(self, tag: str, v: float):
        if self._lib:
            self._ck(self._lib.t4_tb_scalar(self._h, tag.encode(), float(v),
                                   self.step, time.time()))
            return
        val = e.f_str(1, tag) + e.f_float(2, float(v))
        self._write_summary(e.f_msg(1, val))

    def add_text(self, tag: str, text: str):
        # TB text plugin: TensorProto(dtype=DT_STRING(7), string_val) +
        # SummaryMetadata{plugin_data{plugin_name:"text"}}
        if self._lib and "\0" not in text:
            self._ck(self._lib.t4_tb_text(self._h, tag.encode(), text.encode(),
                                 self.step, time.time()))
            return
        tensor = e.f_varint(1, 7) + e.f_bytes(8, text.encode("utf-8"))
        meta = e.f_msg(1, e.f_str(1, "text"))
        val = e.f_str(1, tag) + e.f_msg(8, tensor) + e.f_msg(9, meta)
        self._write_summary(e.f_msg(1, val))

    def add_image(self, tag: str, png: bytes, h: int, w: int):
        if self._lib:
            self._ck(self._lib.t4_tb_image(self._h, tag.encode(), png, len(png),
                                  h, w, self.step, time.time()))
            return
        img = (e.f_varint(1, h) + e.f_varint(2, w)
               + e.f_varint(3, 3) + e.f_bytes(4, png))
        val = e.f_str(1, tag) + e.f_msg(4, img)
        self._write_summary(e.f_msg(1, val))

    def add_histo(self, tag: str, data: np.ndarray, bins: int = 30):
        d = np.asarray(data, dtype=np.float64).reshape(-1)
        if d.size == 0:
            return
        mn, mx = float(d.min()), float(d.max())
        if mn == mx:
            mx = mn + 1.0
        counts, edges = np.histogram(d, bins=bins, range=(mn, mx))
        self.add_histo_stats(tag, (mn, mx, float(d.size), float(d.sum()),
                                   float((d * d).sum())), edges[1:], counts)

    def add_histo_stats(self, tag: str, head, right_edges, counts):
        """a histogram record from its fields: head = (min, max, num,
        sum, sum of squares), the bins' right edges and counts"""
        mn, mx, num, sm, sq = (float(v) for v in head)
        if not (np.isfinite(mn) and np.isfinite(mx)):
            raise ValueError(f"supplied range of [{mn}, {mx}] is not finite")
        ed = np.ascontiguousarray(right_edges, np.float64)
        ct = np.ascontiguousarray(counts, np.float64)
        if self._lib:
            import ctypes as C
            dp = C.POINTER(C.c_double)
            self._ck(self._lib.t4_tb_histo(
                self._h, tag.encode(), mn, mx, num, sm, sq,
                ed.ctypes.data_as(dp), ct.ctypes.data_as(dp),
                len(ct), self.step, time.time()))
            return
        msg = (e.f_double(1, mn) + e.f_double(2, mx)
               + e.f_double(3, num) + e.f_double(4, sm)
               + e.f_double(5, sq)
               + e.f_packed_doubles(6, ed)
               + e.f_packed_doubles(7, ct))
        val = e.f_str(1, tag) + e.f_msg(5, msg)
        self._write_summary(e.f_msg(1, val))

    def add_graph(self, nodes: list):
        """nodes: [(name, op, [inputs])] -> GraphDef event"""
        gd = b""
        for name, op, inputs in nodes:
            nd = e.f_str(1, name) + e.f_str(2, op)
            for i in inputs:
                nd += e.f_str(3, i)
            gd += e.f_msg(1, nd)
        self._write_event(e.f_bytes(4, gd), use_step=False)

    def close(self):
        if self._lib:
            self._lib.t4_tb_close(self._h)
            self._lib = None
            self._h = 0
        elif self._fs:
            self._fs.close()
            self._fs = None
