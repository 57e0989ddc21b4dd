"""AIO — host-side IO: tensor pretty-printers and persistence (the port
of tensorforth_tpu/io/aio.py; the model printer and the PNG export come
with their tiers).

Reference: src/io/aio.{h,cpp}, aio_tensor.cpp, aio_model.cpp.  Output
formats are byte-compatible with the reference (PyTorch-style edge-item
elision, ``+x.xxxx`` fixed 4-decimals, stack-cell ``T2[2,3]`` renders)
so verify-lines in the shipped .4th scripts diff cleanly.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..mu.tensor import Tensor, T4Type


class AIO:
    _inst = None

    def __init__(self, sys):
        self.sys = sys
        self._thres = Config.PRINT_THRES
        self._edge = Config.PRINT_EDGE
        self._prec = Config.PRINT_PREC

    @classmethod
    def get_io(cls, sys=None):
        if cls._inst is None:
            from ..system import System
            cls._inst = AIO(sys or System.get_sys())
        return cls._inst

    @classmethod
    def free_io(cls):
        cls._inst = None

    # =====================================================================
    # stack-cell renderer (reference aio_tensor.cpp:15-57)
    # =====================================================================
    def to_s_obj(self, t, view: bool = False) -> str:
        if t is None:
            return "(null)"
        tn = [["T", "N", "D", "X"], ["t", "n", "d", "x"]]
        s = tn[1 if view else 0][t.ttype]
        if t.rank:
            s += str(t.rank)
        return s + self.shape_s(t)

    def shape_s(self, t) -> str:
        if t.rank == 0:                       # network model
            return f"[{t.numel - 1}]"
        if t.rank == 1:
            return f"[{t.numel}]"
        if t.rank == 2:
            return f"[{t.H()},{t.W()}]"
        return f"[{t.N()},{t.H()},{t.W()},{t.C()}]"

    # =====================================================================
    # full object pretty-printer (reference marshall/_tensor/_vec/_mat)
    # =====================================================================
    def marshall(self, t) -> str:
        if t is None:
            return "(null)"
        if t.ttype in (T4Type.TENSOR, T4Type.DATASET):
            return self._tensor(t)
        return self.to_s_obj(t) + "\n"    # model printer: with the NN tier

    def _num(self, v) -> str:
        return f"{float(v):+.{self._prec}f}"

    def _vec(self, vd: np.ndarray, W: int, C: int) -> str:
        out = ["{"]
        rw = W if W <= self._thres else (W if W < self._edge else self._edge)

        def group(j):
            return "".join((" " if k == 0 else "_") + self._num(vd[j * C + k])
                           for k in range(C))

        for j in range(rw):
            out.append(group(j))
        x = W - rw
        if x > rw:
            out.append(" ...")
        for j in range(max(x, rw), W):
            out.append(group(j))
        out.append(" }")
        return "".join(out)

    def _mat(self, td: np.ndarray, H: int, W: int, C: int) -> str:
        rh = H if H < self._edge else self._edge
        WC = W * C
        out = []

        def row(y, last):
            out.append(self._vec(td[y * WC:(y + 1) * WC], W, C))
            out.append("" if last else "\n\t")

        for y in range(min(rh, H)):
            row(y, y + 1 == H)
        ym = rh if H <= self._thres else H - rh
        if ym > rh:
            out.append("...\n\t")
        else:
            ym = rh
        for y in range(ym, H):
            row(y, y + 1 == H)
        return "".join(out)

    def _tensor(self, t) -> str:
        td = t.numpy().reshape(-1)
        if t.rank == 1:
            s = f"vector{self.shape_s(t)} = " + self._vec(td, t.numel, 1)
        elif t.rank == 2:
            s = (f"matrix{self.shape_s(t)} = {{\n\t"
                 + self._mat(td, t.H(), t.W(), 1) + " }")
        elif t.rank == 4:
            N, HWC = t.N(), t.HWC()
            parts = [f"tensor{self.shape_s(t)} = {{ {{\n\t"]
            for n in range(N):
                parts.append(self._mat(td[n * HWC:(n + 1) * HWC], t.H(), t.W(), t.C()))
                if n + 1 < N:
                    parts.append(" } {\n\t")
            parts.append(" } }")
            s = "".join(parts)
        else:
            s = f"tensor rank={t.rank} not supported"
        return s + "\n"

    # =====================================================================
    # tensor persistence (reference aio_tensor.cpp:74-255)
    # =====================================================================
    def tsave(self, t, fname: str, raw: bool = False) -> int:
        try:
            if fname.endswith(".npy"):
                np.save(fname, t.numpy().reshape(t.shape))
            elif raw:
                with open(fname, "wb") as fs:
                    self._tsave_raw(fs, t)
            else:
                with open(fname, "w") as fs:
                    tmp = self._thres
                    self._thres = 1024
                    fs.write(self._tensor(t))
                    self._thres = tmp
            return 0
        except OSError as e:
            self.sys.perr("", f"tsave {fname}: {e} ")
            return 1

    def _tsave_raw(self, fs, t):
        fs.write(b"T4")
        shape = np.array([t.H(), t.W(), t.C(), t.N()], dtype=np.uint32)
        fs.write(shape.tobytes())
        d = np.clip(t.numpy().reshape(-1) * 256.0, 0, 255).astype(np.uint8)
        fs.write(d.tobytes())

    def tload(self, t, fname: str) -> int:
        try:
            if fname.endswith(".npy"):
                t.set_numpy(np.load(fname).astype(np.float32))
                return 0
            with open(fname, "rb") as fs:
                hdr = fs.read(2)
                if hdr == b"T4":
                    np.frombuffer(fs.read(16), dtype=np.uint32)
                    raw = np.frombuffer(fs.read(t.numel), dtype=np.uint8)
                    t.set_numpy(raw.astype(np.float32) / 256.0)
            return 0
        except OSError as e:
            self.sys.perr("", f"tload {fname}: {e} ")
            return 1
