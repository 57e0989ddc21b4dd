"""VM base class — state machine, data/return stacks, scalar ALU.

Reference: src/vm/vm.{h,cpp}.  Stacks are flat float32 arrays holding
tagged DUs (see du.py) so they can be shared zero-copy with a native
inner interpreter.  The deferred-scalar hooks (future_of, fval, fpop)
are kept: no object of this port is a future yet, so they resolve to
the plain cell.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Config
from ..du import (DU0, DU1, SCALAR, IS_OBJ, IS_VIEW, ZEQ)
from ..system import System


class VMState:
    STOP, HOLD, QUERY, NEST = range(4)


class MathOp:
    (ABS, NEG, EXP, LN, LOG, TANH, RELU, SIGM, SQRT, RCP, SAT,
     FILL, GFILL, SCALE, POW, SIN, COS, ADD, SUB, MUL, DIV, MOD,
     MAX, MIN, MUL2, MOD2, IDEN) = range(27)


GUARD = 16          # float32 slots of slack on EACH side of a stack


class Stack:
    """fixed-depth float32 stack (tagged DUs).  The payload is a view
    into a guard-padded allocation: the native engine clamps its
    indices (csrc/t4core.cpp sput/spop) but, like the reference's
    unchecked Vector, still performs bounded negative READS on
    underflowed words — the guard slack keeps those inside our own
    allocation instead of corrupting the heap (fuzz finding)."""
    __slots__ = ("_raw", "buf", "idx")

    def __init__(self, depth: int):
        self._raw = np.zeros(depth + 2 * GUARD, dtype=np.float32)
        self.buf = self._raw[GUARD:GUARD + depth]
        self.idx = 0

    def push(self, v):
        self.buf[self.idx] = v
        self.idx += 1

    def pop(self) -> np.float32:
        if self.idx <= 0:
            return np.float32(DU0)
        self.idx -= 1
        return np.float32(self.buf[self.idx])

    def __getitem__(self, i: int) -> np.float32:
        return np.float32(self.buf[self.idx + i if i < 0 else i])

    def __setitem__(self, i: int, v):
        self.buf[self.idx + i if i < 0 else i] = v

    def size(self) -> int:
        return self.idx

    def clear(self, n: int = 0):
        self.idx = n


class VM:
    """base VM: outer-interpreter shell + scalar ALU (tier 0)"""

    def __init__(self, vm_id: int, sys: System):
        self.id = vm_id
        self.sys = sys
        self.mmu = sys.mu
        self.state = VMState.STOP
        self.ss = Stack(Config.SS_SZ)
        self.rs = Stack(Config.RS_SZ)
        self.ip = 0
        self.tos = np.float32(-1.0)
        self.compile = False

    # --- life-cycle ------------------------------------------------------
    def init(self):
        pass

    def resume(self):
        pass

    def outer(self):
        while True:
            idiom = self.sys.fetch()
            if idiom is None:
                break
            if self.pre(idiom):
                continue
            if not self.process(idiom):
                self.sys.perr(idiom, "? ")
                self.sys.clrbuf()
                self.compile = False
                self.state = VMState.QUERY
                break
            if self.state == VMState.HOLD:
                break
        self.post()

    # --- subclass hooks ----------------------------------------------------
    def pre(self, idiom: str) -> bool:
        return False

    def process(self, idiom: str) -> bool:
        return False

    def post(self):
        return 0

    # --- stack helpers -----------------------------------------------------
    def PUSH(self, v):
        self.ss.push(self.tos)
        self.tos = np.float32(v)

    def POP(self) -> np.float32:
        t = self.tos
        self.tos = self.ss.pop()
        return t

    def POPi(self) -> int:
        return int(self.fpop())

    # --- deferred-scalar (future) resolution --------------------------------
    def future_of(self, v):
        """Future object behind a DU, or None"""
        if IS_OBJ(v) and self.mmu is not None:
            o = self.mmu.du2obj(v)
            if o is not None and o.is_future():
                return o
        return None

    def fval(self, v) -> float:
        """host value of a DU — synchronizes deferred device scalars"""
        f = self.future_of(v)
        return f.value() if f is not None else float(v)

    def fpop(self) -> float:
        """POP + resolve; a consumed owner future is marked for sweep"""
        return self._fconsume(self.POP())

    @property
    def SP(self) -> int:
        return self.ss.size() + 1

    def DUP_DU(self, v):
        """soft-copy a DU: views for objects, identity for scalars"""
        if IS_OBJ(v):
            from ..du import as_view
            return as_view(v)
        return v

    def DROP_DU(self, v):
        """release a DU: frees object storage unless it is a view"""
        if IS_OBJ(v) and not IS_VIEW(v) and self.mmu is not None:
            self.mmu.mark_free(v)

    def _fconsume(self, v) -> float:
        """host value of a consumed DU: resolves futures (marking the
        owner for sweep); raw float otherwise"""
        f = self.future_of(v)
        if f is None:
            return float(v)
        r = f.value()
        self.DROP_DU(v)
        return r

    # --- scalar ALU (reference vm.cpp:66-105) --------------------------------
    def xop1(self, op: int, v=DU0):
        t = self._fconsume(self.tos)
        M = MathOp
        if op == M.ABS:    t = abs(t)
        elif op == M.NEG:  t = -t
        elif op == M.EXP:  t = math.exp(t) if t < 88.0 else float("inf")
        elif op == M.LN:   t = math.log(t) if t > Config.DU_EPS else 0.0
        elif op == M.LOG:  t = math.log10(t) if t > Config.DU_EPS else 0.0
        elif op == M.TANH: t = math.tanh(t)
        elif op == M.RELU: t = max(t, 0.0)
        elif op == M.SIGM: t = 1.0 / (1.0 + math.exp(-t)) if t > -88.0 else 0.0
        elif op == M.SQRT: t = math.sqrt(t) if t >= 0.0 else float("nan")
        elif op == M.RCP:  t = (1.0 / t) if t != 0.0 else float("inf")
        elif op == M.SAT:  t = min(max(t, 0.0), 1.0)
        elif op == M.SIN:  t = math.sin(t)
        elif op == M.COS:  t = math.cos(t)
        else:
            self.sys.perr("", f"op={op}? ")
        self.tos = SCALAR(np.float32(t))

    def xop2(self, op: int, drop=None):
        t = self._fconsume(self.tos)
        n = self._fconsume(self.ss.pop())
        M = MathOp
        if op == M.ADD:    t = n + t
        elif op == M.MUL:  t = n * t
        elif op == M.SUB:  t = n - t
        elif op == M.DIV:
            # IEEE semantics like the reference's plain f32 division
            # (t4math.h DIV): 0/0 -> NaN, n/±0 -> ±inf by both signs
            if t != 0.0:
                t = n / t
            elif n == 0.0:
                t = float("nan")
            else:
                t = (math.copysign(float("inf"), n)
                     * math.copysign(1.0, t))
        elif op == M.MOD:  t = math.fmod(n, t) if t != 0.0 else float("nan")
        elif op == M.MAX:  t = max(n, t)
        elif op == M.MIN:  t = min(n, t)
        elif op == M.MUL2: t = n * t
        elif op == M.MOD2: t = math.fmod(n, t) if t != 0.0 else float("nan")
        elif op == M.POW:  t = math.pow(t, n) if (t >= 0 or n == int(n)) else float("nan")
        else:
            self.sys.perr("", f"op={op}? ")
        self.tos = SCALAR(np.float32(t))


def vm_factory(level: str, vm_id: int, sys: System) -> VM:
    """the VM of a tier: 'forth' (eForth) or 'tensor' (eForth + tensor
    words).  The NN tier ('net', vm/netvm.py) is not ported yet."""
    if level == "tensor" and Config.DO_OBJ:
        from .tenvm import TensorVM
        return TensorVM(vm_id, sys)
    if level == "forth":
        from .eforth import ForthVM
        return ForthVM(vm_id, sys)
    raise ValueError(f"VM level '{level}' is not available in this port")
