"""NN model persistence (the port of tensorforth_tpu/io/nnio.py).

Reference: src/io/aio_model.cpp.  Format (kept intentionally close):

  \\ tensorForth-tpu model        <- comment header
  <replayable Forth layer line>   <- one line per layer
  ...
  <blank line>                    <- section break
  --- w.<layer>\\n<raw f32 W>      <- per-layer binary parameter sections
  --- b.<layer>\\n<raw f32 B>
  \\n---\\n                         <- trailer

Deviation (documented): the reference's header lines are the `_parm`
debug strings ("bias=0.5, C=2, ...conv2d"), which are not themselves
interpretable Forth; here each line is *actual* Forth that rebuilds the
layer (e.g. "0.5 2 conv2d"), which realizes the documented intent of a
replayable model description.  Load is two-phase like the reference:
rebuild layers by feeding the header back through the interpreter, then
stream the binary parameters.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..nn.ntypes import Layer


def _fnum(v) -> str:
    """Forth-parseable float: the number parser (like the reference's,
    eforth.cpp:457-471) requires a '.' and takes no exponent notation"""
    s = f"{float(v):g}"
    if "e" in s or "E" in s:
        s = f"{float(v):.12f}".rstrip("0")
        if s.endswith("."):
            s += "0"
    return s


def _layer_forth(t_in, t_out) -> str:
    """one replayable Forth line for a configured layer"""
    fn = t_in.grad_fn
    g = _fnum
    if fn in (Layer.CONV, Layer.DCONV):
        K, S, P = t_in.grad[0].H(), t_in.stride[0], t_in.stride[2]
        word = "dconv2d" if fn == Layer.DCONV else (
            "conv1x1" if K == 1 else "conv2d")
        if fn == Layer.CONV and K not in (1, 3):
            return (f"4 vector{{ {K} {S} {P} 1 }} "
                    f"{g(t_in.xparm)} {t_out.C()} conv2d")
        return f"{g(t_in.xparm)} {t_out.C()} {word}"
    if fn == Layer.LINEAR:
        return f"{g(t_in.xparm)} {t_in.grad[0].H()} linear"
    if fn == Layer.FLATTEN:
        return "flatten"
    if fn == Layer.RELU:
        return "relu"
    if fn == Layer.TANH:
        return "tanh"
    if fn == Layer.SIGMOID:
        return "sigmoid"
    if fn == Layer.SELU:
        return "selu"
    if fn == Layer.LEAKYRL:
        return f"{g(t_in.xparm)} leakyrelu"
    if fn == Layer.ELU:
        return f"{g(t_in.xparm)} elu"
    if fn == Layer.DROPOUT:
        return f"{g(t_in.xparm)} dropout"
    if fn == Layer.SOFTMAX:
        return "softmax"
    if fn == Layer.LOGSMAX:
        return "logsoftmax"
    if fn == Layer.AVGPOOL:
        return f"{t_in.stride[0]} avgpool"
    if fn == Layer.MAXPOOL:
        return f"{t_in.stride[0]} maxpool"
    if fn == Layer.MINPOOL:
        return f"{t_in.stride[0]} minpool"
    if fn == Layer.BATCHNM:
        return f"{g(t_in.xparm)} batchnorm"
    if fn == Layer.USAMPLE:
        return f"{t_in.stride[0]} upsample"
    if fn == Layer.ATTN:
        flags = int(float(t_in.xparm))          # bit0 causal, bit1 rope
        pre = f"{flags} " if flags else ""
        return f"{pre}{t_in.iparm} nn.attn"
    if fn == Layer.MOE:
        return f"{t_in.stride[0]} {t_in.stride[1]} {t_in.iparm} nn.moe"
    if fn == Layer.LNORM:
        return f"{g(t_in.xparm)} layernorm"
    if fn == Layer.EMBED:
        return f"{t_in.grad[0].W()} {t_in.iparm} nn.embed"
    if fn == Layer.PROJ:
        return f"{g(t_in.xparm)} {t_in.grad[0].H()} nn.proj"
    return ""


def _param_layers(m):
    for i in range(m.numel - 1):
        t_in = m[i]
        fn = t_in.grad_fn
        if fn in (Layer.CONV, Layer.DCONV, Layer.LINEAR,
                  Layer.ATTN, Layer.MOE, Layer.LNORM,
                  Layer.EMBED, Layer.PROJ):
            yield t_in, ("w", "b")
        elif fn == Layer.BATCHNM:
            yield t_in, ("w",)


def _opt_kind(m) -> int:
    """0 = no resumable optimizer state, 1 = momentum (SGDM), 2 = adam
    (m+v) — derived from the mtum slot structure grad_alloc built"""
    if not getattr(m, "_opt_inited", False):
        return 0
    for t, s in m._trainables():
        if t.mtum[s + 2] is not None:
            return 2
        if t.mtum[s] is not None and t.mtum[s] is not t.grad[s]:
            return 1
    return 0


def nsave(m, fname: str, mode: int = 0) -> int:
    from ..system import System
    sys = System.get_sys()
    try:
        with open(fname, "wb") as fs:
            fs.write(f"\\ {Config.APP_NAME} model\n".encode())
            for i in range(m.numel - 1):
                fs.write((_layer_forth(m[i], m[i + 1]) + "\n").encode())
            fs.write(b"\n")
            for t_in, slots in _param_layers(m):
                nm = type(m).nname(t_in.grad_fn).strip()
                for k, s in enumerate(slots):
                    t = t_in.grad[0 if s == "w" else 1]
                    fs.write(f"\n--- {s}.{nm}\n".encode())
                    fs.write(t.numpy().astype("<f4").tobytes())
            # optimizer-state sections (EXTENSION: the reference loses
            # m/v on save/load — SURVEY §5 "No optimizer-state
            # persistence" — which silently breaks training resume).
            # Appended between params and trailer; old readers that
            # walk named sections sequentially simply never look here.
            kind = _opt_kind(m)
            if kind:
                fs.write(b"\n--- opt.meta\n")
                # int32, not float32: the step counter exceeds f32's
                # 2^24 integer range on long runs
                fs.write(np.asarray([kind, m._iter],
                                    dtype="<i4").tobytes())
                for t, s in m._trainables():
                    fs.write(f"\n--- om.{s}\n".encode())
                    fs.write(t.mtum[s].numpy().astype("<f4").tobytes())
                    if kind == 2:
                        fs.write(f"\n--- ov.{s}\n".encode())
                        fs.write(t.mtum[s + 2].numpy()
                                 .astype("<f4").tobytes())
            fs.write(b"\n---\n")
        return 0
    except OSError as e:
        sys.perr("", f"nsave {fname}: {e} ")
        return 1


def nload(vm, m, fname: str, mode: int = 0) -> int:
    from ..system import System
    sys = System.get_sys()
    try:
        with open(fname, "rb") as fs:
            raw = fs.read()
    except OSError as e:
        sys.perr("", f"nload {fname}: {e} ")
        return 1
    # phase 1: rebuild layers by interpreting the header (model on TOS)
    text, _, binary = raw.partition(b"\n\n")
    if m.numel <= 2:
        for line in text.decode().split("\n"):
            line = line.strip()
            if not line or line.startswith("\\"):
                continue
            save_line, save_idx = sys._line, sys._idx
            sys.load_line(line)
            vm.outer()
            sys._line, sys._idx = save_line, save_idx
    # phase 2: stream binary parameter sections
    pos = 0
    for t_in, slots in _param_layers(m):
        nm = type(m).nname(t_in.grad_fn).strip()
        for s in slots:
            t = t_in.grad[0 if s == "w" else 1]
            marker = f"--- {s}.{nm}\n".encode()
            idx = binary.find(marker, pos)
            if idx < 0:
                sys.perr("", "model format error ")
                return 1
            start = idx + len(marker)
            nbytes = t.numel * 4
            a = np.frombuffer(binary[start:start + nbytes], dtype="<f4")
            t.set_numpy(a.copy())
            pos = start + nbytes
    # phase 3 (extension): optimizer-state sections, when present —
    # restores the adam/momentum accumulators + step counter so
    # training RESUMES on the saved trajectory instead of restarting
    # the optimizer cold
    idx = binary.find(b"--- opt.meta\n", pos)
    if idx >= 0:
        from ..nn.ntypes import Optimizer
        meta = np.frombuffer(binary[idx + 13:idx + 21], dtype="<i4")
        kind, it = int(meta[0]), int(meta[1])
        if kind not in (1, 2):            # older files stored f32
            meta = np.frombuffer(binary[idx + 13:idx + 21], dtype="<f4")
            kind, it = int(meta[0]), int(meta[1])
        m.grad_alloc(Optimizer.ADAM if kind == 2 else Optimizer.SGDM)
        m._iter = it
        pos = idx + 21
        for t, s in m._trainables():
            for tag, tt in ((f"--- om.{s}\n", t.mtum[s]),) + (
                    ((f"--- ov.{s}\n", t.mtum[s + 2]),) if kind == 2
                    else ()):
                j = binary.find(tag.encode(), pos)
                if j < 0:
                    sys.perr("", "opt state format error ")
                    return 1
                start = j + len(tag)
                nb = tt.numel * 4
                tt.set_numpy(np.frombuffer(binary[start:start + nb],
                                           dtype="<f4").copy())
                pos = start + nb
    return 0
