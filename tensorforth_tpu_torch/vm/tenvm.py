"""TensorVM — tensor/linear-algebra tier (tier 2; the port of
tensorforth_tpu/vm/tenvm.py).

Reference behavior: src/vm/tenvm.{h,cpp}.  Every tensor word runs torch
ops on the MMU's device (ops/engine.py, ops/linalg.py); the gemm2..4
words go through the hand-written CUDA kernels of ops/gemm.py.

Not ported yet: the deferred-scalar branches (mu/future.py: reductions
push plain scalars here), the device arena's fused paths, the
TensorBoard words and `.png`.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..du import DU0, DU1, SCALAR, IS_OBJ
from ..mu.tensor import Tensor
from ..system import System, IoOp
from .vm import VMState, MathOp
from .eforth import ForthVM

import math


class TenOp:
    """blas1/blas2 op tags (reference t4_ten_op)"""
    INV, LUINV, PLU, TRIU, TRIL, XPOS, DET, DOT, DIV, SOLV = range(10)


T_KEEP = 0
T_DROP = 1

# map MathOp id -> engine op string
_MAP_NAME = {
    MathOp.ABS: "abs", MathOp.NEG: "neg", MathOp.EXP: "exp", MathOp.LN: "ln",
    MathOp.LOG: "log", MathOp.TANH: "tanh", MathOp.RELU: "relu",
    MathOp.SIGM: "sigm", MathOp.SQRT: "sqrt", MathOp.RCP: "rcp",
    MathOp.SAT: "sat", MathOp.FILL: "fill", MathOp.GFILL: "gfill",
    MathOp.SCALE: "scale", MathOp.POW: "pow", MathOp.SIN: "sin",
    MathOp.COS: "cos",
}
_BIN_NAME = {
    MathOp.ADD: "add", MathOp.SUB: "sub", MathOp.MUL: "mul",
    MathOp.DIV: "div", MathOp.MAX: "max", MathOp.MIN: "min",
}

FAM_WO, FAM_RW, FAM_RAW = 0, 1, 2


class TensorVM(ForthVM):
    def __init__(self, vm_id: int, sys: System):
        super().__init__(vm_id, sys)
        self.ten_lvl = 0
        self.ten_off = 0
        self._staged = None        # host staging buffer for literal capture

    # --- tagged-object helpers --------------------------------------------
    def TTOS(self):
        return self.mmu.du2obj(self.tos)

    def TNOS(self):
        return self.mmu.du2obj(self.ss[-1])

    def is_ten(self, v) -> bool:
        if not IS_OBJ(v):
            return False
        o = self.mmu.du2obj(v)
        return o is not None and o.is_tensor()

    def TOS1T(self) -> bool:
        return self.is_ten(self.tos)

    def TOS2T(self) -> bool:
        return self.is_ten(self.tos) and self.is_ten(self.ss[-1])

    def TOS3T(self) -> bool:
        return self.TOS2T() and self.is_ten(self.ss[-2])

    def PUSH_OBJ(self, obj):
        self.PUSH(self.mmu.obj2du(obj))

    def COPY(self, v):
        return self.mmu.copy(self.mmu.du2obj(v))

    def FREE(self, t):
        self.mmu.free_obj(t)

    # ======================================================================
    # literal-capture mode: `3 vector{ 1 2 3 }` (reference ten_lvl/ten_off)
    # ======================================================================
    def process(self, idiom: str) -> bool:
        self.state = VMState.QUERY
        if self.parse(idiom):
            return True
        n, ok = self.number(idiom)
        if not ok:
            return False
        if self.compile:
            self.add_lit(n)
        elif self.ten_lvl > 0:
            if self._staged is None:
                self._staged = self.TTOS().numpy().reshape(-1)
            if self.ten_off < self._staged.size:
                self._staged[self.ten_off] = float(n)
                self.ten_off += 1
        else:
            self.PUSH(n)
        return True

    def _flush_staged(self):
        if self._staged is not None:
            t = self.TTOS()
            if t is not None:
                t.set_numpy(self._staged)
            self._staged = None

    # ======================================================================
    # 1-operand self math ops (destructive; reference tenvm.cpp:44-79)
    # ======================================================================
    def xop1(self, op: int, v=DU0):
        if not IS_OBJ(self.tos):
            return super().xop1(op, v)
        A = self.TTOS()
        if A is None or not A.is_tensor():
            self.sys.perr("", "tensor? ")
            return
        from ..ops import engine
        if op == MathOp.IDEN:
            A.replace_data(engine.identity(A.ensure_data()))
        elif op in _MAP_NAME:
            A.replace_data(engine.map_op(_MAP_NAME[op], A.ensure_data(), float(v)))
        else:
            self.sys.perr("", f"opn[{op}] not supported ")

    # ======================================================================
    # 2-operand ops with scalar/tensor dispatch (reference tenvm.cpp:83-130)
    # ======================================================================
    def xop2(self, op: int, x: int = T_KEEP):
        tt = (2 if IS_OBJ(self.ss[-1]) else 0) | (1 if IS_OBJ(self.tos) else 0)
        from ..ops import engine
        name = _BIN_NAME.get(op)
        if tt == 0:                                     # scalar-scalar
            return super().xop2(op)
        if tt == 1:                                     # scalar (+) tensor
            v = float(self.ss[-1])
            A = self.TTOS()
            O = self.COPY(self.tos) if x == T_KEEP else A
            flip = op in (MathOp.DIV, MathOp.SUB)
            if flip:
                O.replace_data(engine.ten_op_st(name, v, A.ensure_data()))
            else:
                O.replace_data(engine.ten_op_ts(name, A.ensure_data(), v))
            if x == T_KEEP:
                self.PUSH_OBJ(O)
            else:
                self.ss.pop()
            return
        if tt == 2:                                     # tensor (+) scalar
            A = self.TNOS()
            v = float(self.tos)
            O = self.mmu.copy(A) if x == T_KEEP else A
            O.replace_data(engine.ten_op_ts(name, A.ensure_data(), v))
            if x == T_KEEP:
                self.PUSH_OBJ(O)
            else:
                self.POP()
            return
        # tensor (+) tensor (Hadamard w/ N-broadcast)
        A, B = self.TNOS(), self.TTOS()
        O = self._tt_op(name, A, B)
        if O is not B:
            if x == T_DROP:
                self.DROP_DU(self.POP())
                self.DROP_DU(self.POP())
            self.PUSH_OBJ(O)

    def _tt_op(self, name: str, A: Tensor, B: Tensor):
        if (A.N() == 1 or B.N() == 1) and A.HWC() != B.HWC():
            self.sys.perr("", "dim? ")
            return B
        from ..ops import engine
        O = self.mmu.copy(B if A.N() == 1 and B.N() != 1 else A)
        O.replace_data(engine.ten_op_tt(name, A.ensure_data(),
                                        B.ensure_data(), O.shape))
        if B.rank == 1:
            O.reshape(O.numel)
        return O

    # ======================================================================
    # blas1 — 1-tensor ops creating new tensors (reference tenvm.cpp:134-185)
    # ======================================================================
    def blas1(self, op: int):
        A = self.TTOS()
        if A is None or not A.is_tensor() or A.rank != 2:
            self.sys.perr("", "tensor2? ")
            return
        from ..ops import linalg, engine
        T = self.mmu.copy(A)
        push_T = True
        if op in (TenOp.INV, TenOp.LUINV):
            I = self.mmu.tensor(A.H(), A.W())
            I.replace_data(linalg.inverse(T.ensure_data()))
            self.PUSH_OBJ(I)
            self.FREE(T)
            push_T = False
        elif op == TenOp.PLU:
            P = self.mmu.tensor(A.H(), A.W())
            p, lu = linalg.plu(T.ensure_data())
            P.replace_data(p)
            T.replace_data(lu)
            self.PUSH_OBJ(P)
        elif op == TenOp.TRIU:
            T.replace_data(linalg.tri_upper(T.ensure_data()))
        elif op == TenOp.TRIL:
            T.replace_data(linalg.tri_lower(T.ensure_data()))
        elif op == TenOp.XPOS:
            T.reshape(A.W(), A.H())
            T.replace_data(engine.transpose(A.ensure_data()))
        elif op == TenOp.DET:
            self.PUSH(SCALAR(np.float32(linalg.det(T.ensure_data()))))
            self.FREE(T)
            push_T = False
        else:
            self.sys.perr("", f"opn[{op}] not supported ")
            self.FREE(T)
            push_T = False
        if push_T:
            self.PUSH_OBJ(T)

    # ======================================================================
    # blas2 — 2-tensor ops (reference tenvm.cpp:189-222)
    # ======================================================================
    def blas2(self, op: int, x: int = T_KEEP):
        if not self.TOS2T():
            self.sys.perr("", "TNOS TTOS required! ")
            return
        A, B = self.TNOS(), self.TTOS()
        if op == TenOp.DOT:
            C = self._tdot(A, B)
            if C is not B and C is not A:
                if x == T_DROP:
                    self.DROP_DU(self.POP())
                    self.DROP_DU(self.POP())
                self.PUSH_OBJ(C)
        elif op == TenOp.DIV:
            C = self._tdiv(A, B)
            if C is not B:
                self.PUSH_OBJ(C)
        elif op == TenOp.SOLV:
            X = self._solv(B, A)
            if X is not A:
                self.PUSH_OBJ(X)

    def _tdot(self, A: Tensor, B: Tensor):
        from ..ops import engine
        if A.rank == 1 and B.rank == 1 and A.numel == B.numel:
            self.PUSH(SCALAR(np.float32(
                engine.t_dot(A.ensure_data(), B.ensure_data()))))
            return B
        if B.rank == 1 and A.rank == 2 and A.W() == B.numel:
            C = self.mmu.tensor(A.H())
            C.replace_data(engine.matmul(A.ensure_data(), A.shape,
                                         B.ensure_data(), B.shape))
            return C
        if A.rank == 2 and B.rank == 2 and A.W() == B.H():
            C = self.mmu.tensor(A.H(), B.W())
            C.replace_data(engine.matmul(A.ensure_data(), A.shape,
                                         B.ensure_data(), B.shape))
            return C
        Na, Nb = A.N(), B.N()
        if ((Na == 1 or Nb == 1) and Na != Nb and A.C() == B.C()
                and A.W() == B.H()):
            N = max(Na, Nb)
            C = self.mmu.tensor(N, A.H(), B.W(), A.C())
            C.replace_data(engine.matmul(A.ensure_data(), A.shape,
                                         B.ensure_data(), B.shape))
            return C
        self.sys.perr("", "A.W != B.H dim? ")
        return A

    def _tdiv(self, A: Tensor, B: Tensor):
        from ..ops import linalg, engine
        if B.H() != B.W() or A.W() != B.H():
            return B
        I = self.mmu.tensor(B.H(), B.W())
        I.replace_data(linalg.inverse(B.ensure_data()))
        O = self.mmu.tensor(A.H(), B.W())
        O.replace_data(engine.matmul(A.ensure_data(), A.shape,
                                     I.ensure_data(), I.shape))
        self.FREE(I)
        return O

    def _solv(self, A: Tensor, B: Tensor):
        """solve A X = B, called with (B=TNOS-vector flipped): reference _solv"""
        from ..ops import linalg
        if B.rank != 1 or A.H() != A.W() or A.W() != B.numel:
            return B
        O = self.mmu.tensor(A.W())
        O.replace_data(linalg.solve(A.ensure_data(), B.ensure_data()))
        return O

    def gemm(self, opt: int):
        if not self.TOS3T():
            self.sys.perr("", "tensors? ")
            return
        C, B = self.TTOS(), self.TNOS()
        A = self.mmu.du2obj(self.ss[-2])
        b = float(self.ss[-3])
        a = float(self.ss[-4])
        m, k, n = A.H(), A.W(), B.W()
        if k == B.H() and m == C.H() and n == C.W():
            from ..ops import engine
            O = self.mmu.copy(C)
            O.replace_data(engine.gemm(A.ensure_data(), B.ensure_data(),
                                       C.ensure_data(), a, b, variant=opt))
            self.PUSH_OBJ(O)
        else:
            self.sys.perr("", "dim? ")

    # ======================================================================
    # persistence
    # ======================================================================
    def _pickle(self, save: bool):
        mode = FAM_RW if not save else FAM_WO
        if self.ss.size() > 1 and IS_OBJ(self.ss[-2]):
            pass
        elif self.ss.size() > 2 and IS_OBJ(self.ss[-3]):
            mode = self.POPi()
        else:
            self.sys.perr("", "tensor adr len [mode]? ")
            return
        self.POPi()                         # string length
        tag = self.pmem.rd_str(self.POPi())
        from ..io.aio import AIO
        io = AIO.get_io(self.sys)
        t = self.TTOS()
        if save:
            io.tsave(t, tag, raw=bool(mode & FAM_RAW))
        else:
            io.tload(t, tag)

    # ======================================================================
    # vocabulary (reference tenvm.cpp:450-636)
    # ======================================================================
    def init(self):
        super().init()
        if self.id != 0 or self.dict.find("vector"):
            return
        CODE = lambda nm, fn: self.dict.add_code(nm, fn)
        M = MathOp

        CODE("\nTensor::", lambda vm: None)
        # --- creation -------------------------------------------------------
        def _vector(vm):
            sz = vm.POPi()
            vm.PUSH_OBJ(vm.mmu.tensor(sz))
        CODE("vector", _vector)
        def _matrix(vm):
            w = vm.POPi(); h = vm.POPi()
            vm.PUSH_OBJ(vm.mmu.tensor(h, w))
        CODE("matrix", _matrix)
        def _tensor(vm):
            c = vm.POPi(); w = vm.POPi(); h = vm.POPi(); n = vm.POPi()
            vm.PUSH_OBJ(vm.mmu.tensor(n, h, w, c))
        CODE("tensor", _tensor)
        def _vector_lit(vm):
            sz = vm.POPi()
            vm.PUSH_OBJ(vm.mmu.tensor(sz))
            vm.ten_off, vm.ten_lvl = 0, 1
            vm._staged = np.zeros(sz, dtype=np.float32)
        CODE("vector{", _vector_lit)
        def _matrix_lit(vm):
            w = vm.POPi(); h = vm.POPi()
            vm.PUSH_OBJ(vm.mmu.tensor(h, w))
            vm.ten_off, vm.ten_lvl = 0, 1
            vm._staged = np.zeros(h * w, dtype=np.float32)
        CODE("matrix{", _matrix_lit)
        CODE("view", lambda vm: vm.PUSH(vm.DUP_DU(vm.tos)))
        CODE("copy", lambda vm: vm.PUSH_OBJ(vm.COPY(vm.tos)))
        # --- shape ops -------------------------------------------------------
        def _flatten(vm):
            t = vm.TTOS()
            t.reshape(t.numel)
        CODE("flatten", _flatten)
        def _reshape2(vm):
            w = vm.POPi(); h = vm.POPi()
            vm.TTOS().reshape(h, w)
        CODE("reshape2", _reshape2)
        def _reshape4(vm):
            c = vm.POPi(); w = vm.POPi(); h = vm.POPi(); n = vm.POPi()
            vm.TTOS().reshape(n, h, w, c)
        CODE("reshape4", _reshape4)
        def _same_shape(vm):
            from ..du import BOOL
            if IS_OBJ(vm.tos) and IS_OBJ(vm.ss[-1]):
                vm.PUSH(BOOL(vm.TTOS().is_same_shape(vm.TNOS())))
            else:
                vm.sys.perr("", "TOS,NOS tensors? ")
        CODE("same_shape?", _same_shape)
        # --- fill ops ---------------------------------------------------------
        def _setlit(vm):                    # ( T -- ) or ( T n -- )
            vm.ten_off = 0 if IS_OBJ(vm.tos) else vm.POPi()
            vm.ten_lvl = 1 if IS_OBJ(vm.tos) else 0
            if vm.ten_lvl:
                vm._staged = vm.TTOS().numpy().reshape(-1)
        CODE("={", _setlit)
        CODE("zeros", lambda vm: vm.xop1(M.FILL, DU0))
        CODE("ones",  lambda vm: vm.xop1(M.FILL, DU1))
        CODE("fill",  lambda vm: vm.xop1(M.FILL, np.float32(vm.fpop())))
        CODE("gradfill", lambda vm: vm.xop1(M.GFILL, DU1))
        CODE("eye",   lambda vm: vm.xop1(M.IDEN))
        def _rand(vm):
            if IS_OBJ(vm.tos):
                vm.sys.rand_fill(vm.TTOS(), "uniform")
            else:
                vm.tos = SCALAR(np.float32(vm.sys.rand_scalar("uniform")))
        CODE("rand", _rand)
        def _randn(vm):
            if IS_OBJ(vm.tos):
                vm.sys.rand_fill(vm.TTOS(), "normal")
            else:
                vm.tos = SCALAR(np.float32(vm.sys.rand_scalar("normal")))
        CODE("randn", _randn)
        # --- slice & dice -------------------------------------------------------
        def _normalize(vm):
            std = vm.fpop(); avg = vm.fpop()
            if vm.TOS1T():
                t = vm.TTOS()
                from ..ops import engine
                d = t.ensure_data()
                mu, sd = engine.t_avg(d), engine.t_std(d) * d.numel() ** 0.5
                t.replace_data((d - mu) / max(sd, 1e-12) * std + avg)
        CODE("normalize", _normalize)
        from ..ops import engine as _e
        # reductions read their scalar back at once (the JAX package
        # pushes a deferred scalar that resolves on host use)
        def _reduce(vm, fn):
            if vm.TOS1T():
                vm.PUSH(SCALAR(np.float32(fn(vm.TTOS().ensure_data()))))
        CODE("sum",  lambda vm: _reduce(vm, _e.t_sum))
        CODE("avg",  lambda vm: _reduce(vm, _e.t_avg))
        CODE("std",  lambda vm: _reduce(vm, _e.t_std))
        CODE("norm", lambda vm: _reduce(vm, _e.t_norm))
        def _lbrace(vm):
            if vm.TOS1T() and vm.ten_lvl > 0:
                vm.ten_lvl += 1
        CODE("{", _lbrace)
        def _rbrace(vm):
            if vm.TOS1T() and vm.ten_lvl > 0:
                vm.ten_lvl -= 1
                if vm.ten_lvl == 0:
                    vm._flush_staged()
        CODE("}", _rbrace)
        def _slice(vm):
            y1 = vm.POPi(); y0 = vm.POPi(); x1 = vm.POPi(); x0 = vm.POPi()
            if vm.TOS1T():
                vm.PUSH_OBJ(vm.mmu.slice(vm.TTOS(), x0, x1, y0, y1))
        CODE("slice", _slice)
        def _dim(vm):
            t = vm.TTOS()
            if t is not None and (t.is_tensor() or t.is_dataset()):
                d = vm.mmu.tensor(4)
                d.set_numpy(np.array([t.N(), t.H(), t.W(), t.C()],
                                     dtype=np.float32))
                vm.PUSH_OBJ(d)
            else:
                vm.sys.perr("", "TOS tensor? ")
        CODE("dim", _dim)
        def _tat(vm):                       # ( T i -- T v )
            if IS_OBJ(vm.tos) or not IS_OBJ(vm.ss[-1]):
                return
            i = vm.POPi()
            v = float(vm.TTOS().numpy().reshape(-1)[i])
            vm.PUSH(SCALAR(np.float32(v)))
        CODE("t@", _tat)
        def _tbang(vm):                     # ( T v i -- T )
            i = vm.POPi(); v = vm.fpop()
            if IS_OBJ(vm.tos):
                t = vm.TTOS()
                a = t.numpy().reshape(-1)
                a[i] = v
                t.set_numpy(a)
        CODE("t!", _tbang)
        # --- 1-tensor math (destructive) ------------------------------------------
        if Config.DO_MATH:
            CODE("exp",     lambda vm: vm.xop1(M.EXP))
            CODE("ln",      lambda vm: vm.xop1(M.LN))
            CODE("log",     lambda vm: vm.xop1(M.LOG))
            CODE("tanh",    lambda vm: vm.xop1(M.TANH))
            CODE("relu",    lambda vm: vm.xop1(M.RELU))
            CODE("sigmoid", lambda vm: vm.xop1(M.SIGM))
            CODE("sqrt",    lambda vm: vm.xop1(M.SQRT))
            CODE("1/x",     lambda vm: vm.xop1(M.RCP))
            CODE("sat",     lambda vm: vm.xop1(M.SAT))
            CODE("pow",     lambda vm: ForthVM.xop2(vm, M.POW))
            CODE("sin",     lambda vm: vm.xop1(M.SIN))
            CODE("cos",     lambda vm: vm.xop1(M.COS))
            def _pi(vm):
                vm.PUSH(SCALAR(np.float32(math.pi)))
            CODE("PI", _pi)
        # --- BLAS-1 ------------------------------------------------------------------
        CODE("inverse",   lambda vm: vm.blas1(TenOp.INV))
        CODE("luinv",     lambda vm: vm.blas1(TenOp.LUINV))
        CODE("plu",       lambda vm: vm.blas1(TenOp.PLU))
        CODE("upper",     lambda vm: vm.blas1(TenOp.TRIU))
        CODE("lower",     lambda vm: vm.blas1(TenOp.TRIL))
        CODE("transpose", lambda vm: vm.blas1(TenOp.XPOS))
        CODE("det",       lambda vm: vm.blas1(TenOp.DET))
        # --- 2-tensor destructive -------------------------------------------------------
        CODE("+=", lambda vm: vm.xop2(M.ADD, T_DROP))
        CODE("-=", lambda vm: vm.xop2(M.SUB, T_DROP))
        CODE("*=", lambda vm: vm.xop2(M.MUL, T_DROP))
        CODE("/=", lambda vm: vm.xop2(M.DIV, T_DROP))
        # --- BLAS-2 / GEMM ------------------------------------------------------------------
        CODE("@=",     lambda vm: vm.blas2(TenOp.DOT, T_DROP))
        CODE("matmul", lambda vm: vm.blas2(TenOp.DOT))
        CODE("matdiv", lambda vm: vm.blas2(TenOp.DIV))
        CODE("solve",  lambda vm: vm.blas2(TenOp.SOLV))
        CODE("gemm",   lambda vm: vm.gemm(0))
        CODE("gemm1",  lambda vm: vm.gemm(1))
        CODE("gemm2",  lambda vm: vm.gemm(2))
        CODE("gemm3",  lambda vm: vm.gemm(3))
        CODE("gemm4",  lambda vm: vm.gemm(4))
        # --- persistence -------------------------------------------------------------------------
        CODE("bin", lambda vm: vm.PUSH(np.float32(FAM_RAW)))
        CODE("w/o", lambda vm: vm.PUSH(np.float32(FAM_WO)))
        CODE("r/w", lambda vm: vm.PUSH(np.float32(FAM_RW)))
        CODE("save", lambda vm: vm._pickle(True))
        CODE("load", lambda vm: vm._pickle(False))
        # --- redefined base words ----------------------------------------------------------------------
        CODE("boot", lambda vm: vm.dict.clear(vm.dict.find("load") + 1))
        def _at(vm):
            if vm.TOS2T():
                vm.blas2(TenOp.DOT)
            else:
                i = vm.POPi()
                vm.PUSH(vm.DUP_DU(vm.mmu.rd(i)))
        CODE("@", _at)
        def _max2(vm):
            if IS_OBJ(vm.tos):
                vm.PUSH(SCALAR(np.float32(_e.t_max(vm.TTOS().ensure_data()))))
            else:
                vm.xop2(M.MAX)
        CODE("max", _max2)
        def _min2(vm):
            if IS_OBJ(vm.tos):
                vm.PUSH(SCALAR(np.float32(_e.t_min(vm.TTOS().ensure_data()))))
            else:
                vm.xop2(M.MIN)
        CODE("min", _min2)
