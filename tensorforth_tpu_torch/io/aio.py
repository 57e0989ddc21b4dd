"""AIO — host-side IO: tensor/model pretty-printers, persistence and the
PNG export (the port of tensorforth_tpu/io/aio.py).

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
        if t.is_future():
            # a deferred scalar renders as its (now read back) value:
            # stack dumps look as if the value had been read at once
            from .fmt import gfmt
            return gfmt(np.float32(t.value()))
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
        if t.is_future():
            from .fmt import gfmt
            return gfmt(np.float32(t.value()))
        if t.ttype in (T4Type.TENSOR, T4Type.DATASET):
            return self._tensor(t)
        if t.ttype == T4Type.MODEL:
            return self._model(t)
        return ""

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
    # model printer (reference aio_model.cpp:65-141)
    # =====================================================================
    def _model(self, m) -> str:
        from ..nn.model import Model
        if not m.is_model():
            return "ERROR, not an NN Model!"
        n = m.numel
        out = [f"NN Model[{n - 1}/{Config.NET_SZ}]\n"]
        for i in range(n):
            t_in = m[i]
            t_out = m[i + 1] if i + 1 < n else t_in
            sz = sum(g.numel for g in t_in.grad if g is not None)
            out.append(f"[{i:3d}] {Model.nname(t_in.grad_fn)}: "
                       f"{self.to_s_obj(t_in)} #p={sz} ")
            for k in (0, 1):
                if t_in.grad[k] is not None:
                    out.append(self.to_s_obj(t_in.grad[k]) + " ")
            if t_in.grad[4] is not None:
                out.append(self.to_s_obj(t_in.grad[4]) + " ")
            out.append(self._parm(t_in, t_out) + "\n")
        return "".join(out)

    def _parm(self, t_in, t_out) -> str:
        from ..nn.ntypes import Layer
        fn = t_in.grad_fn
        S = t_in.stride[0]
        p = t_in.xparm
        g = lambda v: f"{float(v):g}"
        if fn in (Layer.CONV, Layer.DCONV):
            return (f"bias={g(p)}, C={t_out.C()}, K={t_in.grad[0].H()}, "
                    f"S={S}, P={t_in.stride[2]}")
        if fn == Layer.LINEAR:
            return f"bias={g(p)}, H={t_in.grad[0].H()}"
        if fn in (Layer.SELU, Layer.LEAKYRL, Layer.ELU):
            return f"bias={g(p)}"
        if fn == Layer.DROPOUT:
            return f"rate={g(p * 100.0)}%"
        if fn in (Layer.AVGPOOL, Layer.MAXPOOL, Layer.MINPOOL):
            return f"{S}x{S}"
        if fn == Layer.BATCHNM:
            return f"mtum={g(p)}"
        if fn == Layer.USAMPLE:
            nm = ["nearest", "linear", "bilinear", "cubic"]
            return f"{S}x{S} {nm[t_in.iparm]}"
        if fn == Layer.ATTN:
            c = ", causal" if float(t_in.xparm) > 0.5 else ""
            return f"heads={t_in.iparm}{c}"
        return ""

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

    def t2png(self, t, fname: str, n_per_row: int = 1) -> int:
        """export tensor as a tiled PNG (reference aio_tensor.cpp:98-136):
        the pixels are scaled where the tensor lies, and only they come
        to the host"""
        from ..tb.png import raw2png
        from ..tb.summary import tile_pixels
        px = tile_pixels(t.ensure_data(), (t.N(), t.H(), t.W(), t.C()),
                         n_per_row, border=0, offset=0.0)
        try:
            with open(fname, "wb") as fs:
                fs.write(raw2png(px.cpu().numpy()))
            return 0
        except OSError as e:
            self.sys.perr("", f"t2png {fname}: {e} ")
            return -1
