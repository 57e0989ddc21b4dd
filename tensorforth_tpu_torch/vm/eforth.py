"""ForthVM — full eForth interpreter/compiler (tier 1).

Reference behavior: src/vm/eforth.{h,cpp} (token-threaded inner
interpreter over byte-addressed pmem, ~110 built-in words, colon
compiler with control-flow words, base-prefixed number parser).  The
port of tensorforth_tpu/vm/eforth.py: compiled words run on the native
inner interpreter (runtime/native.py over csrc/t4core, built into
build/torch_native/) when it loads, else on the Python loop (_py_nest,
T4_NO_NATIVE=1); both print the same.  The multitasking words come
from vm/multitask.py.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..du import (DU0, DU1, SCALAR, IS_OBJ, IS_VIEW, ZEQ, EQ, LT, GT, BOOL,
                  D2I, UINT, I2D, f2u)
from ..io.fmt import gfmt
from ..system import System, IoOp
from .pmem import Prim, Param, PMem, ALIGN, IU_SZ, DU_SZ
from .dict import Dictionary
from .vm import VM, VMState, MathOp, Stack

import contextlib
import math


_NO_LOCK = contextlib.nullcontext()      # reusable: it holds no state


class ForthVM(VM):
    # a task VM's lock, held around each built-in word it runs and each
    # prim that may read a deferred scalar, but the words that wait on
    # another VM (lock_free): no task touches the card while VM 0
    # captures a CUDA graph (runtime/capture.py, vm/multitask.py)
    word_lock = None
    lock_free = frozenset()

    def __init__(self, vm_id: int, sys: System):
        super().__init__(vm_id, sys)
        self.pmem: PMem = sys.mu.pmem
        self.dict: Dictionary = sys.mu.dict
        self.pmem.set_base(vm_id, 10)
        self._engine = None          # native inner interpreter (csrc/t4core)
        self._qdo_marks = []         # compile-time do/?do pairing for `loop`

    # --- base (radix) stored in pmem user area ----------------------------
    @property
    def base_addr(self) -> int:
        return self.id

    @property
    def BASE(self) -> int:
        return self.pmem.base(self.id)

    def set_BASE(self, b: int):
        self.pmem.set_base(self.id, b)

    # ======================================================================
    # outer interpreter
    # ======================================================================
    def process(self, idiom: str) -> bool:
        self.state = VMState.QUERY
        if self.parse(idiom):
            return True
        n, ok = self.number(idiom)
        if not ok:
            return False
        if self.compile:
            try:
                self.add_lit(n)
            except Exception as ex:        # pmem overflow mid-definition
                self.sys.perr("", f"ERROR in '{idiom}': {ex} ")
                self.compile = False
                self.state = VMState.QUERY
        else:
            self.PUSH(n)
        return True

    def post(self):
        if self.state != VMState.HOLD and not self.compile:
            self._ss_dump()
        return 0

    def resume(self):
        self.nest()
        if self.state == VMState.NEST:     # finished: back to input mode
            self.state = VMState.QUERY
        self.post()

    def _native(self):
        """the native engine (csrc/t4core), made on first use; None when
        the library does not load"""
        if self._engine is None and getattr(self.dict, "native", None):
            from ..runtime.native import NativeEngine, get_core
            if get_core() is not None:
                self._engine = NativeEngine(self)
        return self._engine

    def outer(self):
        """native token loop (csrc t4_outer) when available; the pure
        python loop (VM.outer) remains the fallback/reference path"""
        eng = self._native()
        if eng is not None and eng.can_outer():
            return eng.outer()
        return super().outer()

    def parse(self, idiom: str) -> int:
        w = self.dict.find(idiom)
        if not w:
            return 0
        c = self.dict[w]
        compiling = self.compile and not c.imm
        try:
            if compiling:
                self.add_w(w)              # may raise on pmem overflow
            else:
                self.ip = 0
                self.call(w)
                if self.state == VMState.NEST:
                    # interactive word completed: back to input mode.
                    # The reference leaves NEST here but its dispatcher
                    # runs NEST VMs anyway (ten4.cu:78-86 _vm_exec0);
                    # ours reserves NEST for genuinely thread-busy task
                    # VMs (vm/multitask.py), so a completed top-level
                    # call must hand the VM back to QUERY or the CLI
                    # sweep skips it and silently drains stdin.
                    self.state = VMState.QUERY
        except Exception as ex:            # keep the REPL alive on word errors
            self.sys.perr("", f"ERROR in '{idiom}': {ex} ")
            if self.sys.trace:
                import traceback
                traceback.print_exc(file=self.sys.fout)
            if compiling:                  # overflowed mid-definition:
                self.compile = False       # leave compile mode coherently
            self.state = VMState.QUERY
        return w

    def number(self, idiom: str):
        b = self.BASE
        s = idiom
        if s[:1] == "%":
            b, s = 2, s[1:]
        elif s[:1] in ("&", "#"):
            b, s = 10, s[1:]
        elif s[:1] == "$":
            b, s = 16, s[1:]
        try:
            if b == 10 and "." in s:
                return SCALAR(np.float32(float(s))), True
            return SCALAR(np.float32(int(s, b))), True
        except ValueError:
            return DU0, False

    # ======================================================================
    # inner interpreter
    # ======================================================================
    def nest(self):
        eng = self._native()
        return eng.nest() if eng is not None else self._py_nest()

    def _py_nest(self):
        self.state = VMState.NEST
        pm = self.pmem
        rs = self.rs
        while self.ip and self.state == VMState.NEST:
            ix = pm.rd_param(self.ip)
            self.ip += IU_SZ
            op = ix.op
            if op >= Prim.MAX_OP:                       # dictionary call
                if ix.udf:
                    rs.push(np.float32(self.ip))
                    self.ip = ix.ioff
                else:
                    with self._lock_for(self.dict[ix.ioff]):
                        self.dict[ix.ioff].fn(self)
            elif op == Prim.EXIT:
                self.ip = int(float(rs.pop()))
            elif op == Prim.LIT:
                self.ss.push(self.tos)
                self.tos = self.DUP_DU(pm.rd_du(self.ip))
                self.ip += DU_SZ
                if ix.exit:
                    self.ip = int(float(rs.pop()))
            elif op == Prim.NEXT:
                if IS_OBJ(self.tos) and rs.size() and IS_OBJ(rs[-1]):
                    self._locked(self._ds_next, ix.ioff)
                else:
                    v = float(rs[-1]) - 1.0
                    rs[-1] = v
                    if v > -1.0 + Config.DU_EPS:
                        self.ip = ix.ioff
                    else:
                        rs.pop()
            elif op == Prim.LOOP:
                v = float(rs[-1]) + 1.0
                rs[-1] = v
                if float(rs[-2]) - v > Config.DU_EPS:
                    self.ip = ix.ioff
                else:
                    rs.pop(); rs.pop()
            elif op == Prim.VAR:
                self.PUSH(np.float32(ALIGN(self.ip)))
                if ix.ioff:
                    self.ip = ix.ioff
                else:
                    self.ip = int(float(rs.pop()))
            elif op == Prim.STR:
                self.PUSH(np.float32(self.ip))
                self.PUSH(np.float32(ix.ioff))
                self.ip += ix.ioff
            elif op == Prim.DOTQ:
                self.sys.pstr(pm.rd_str(self.ip))
                self.ip += ix.ioff
            elif op == Prim.BRAN:
                self.ip = ix.ioff
            elif op == Prim.ZBRAN:
                if ZEQ(self._locked(self.fpop)):    # resolves deferred
                    self.ip = ix.ioff               # scalars
            elif op == Prim.FOR:
                rs.push(self._locked(self._loopval, self.POP()))
            elif op == Prim.DO:
                rs.push(self._locked(self._loopval, self.ss.pop()))
                rs.push(self._locked(self._loopval, self.POP()))
            elif op == Prim.KEY:
                self.PUSH(np.float32(ord(self.sys.key())))

    def _lock_for(self, c):
        """the lock the built-in word c runs under: a task VM's word_lock,
        or none (the call sites then read as the JAX package's, so an
        uncaught error's traceback has its frames)"""
        if self.word_lock is None or c.name in self.lock_free:
            return _NO_LOCK
        return self.word_lock

    def _locked(self, fn, *a):
        if self.word_lock is None:
            return fn(*a)
        with self.word_lock:
            return fn(*a)

    def call(self, w: int):
        c = self.dict[w]
        if c.udf:
            self.rs.push(np.float32(self.ip))
            self.ip = c.pfa
            self.nest()
        else:
            c.fn(self)

    def _ds_next(self, ioff: int):
        """dataset-aware FOR/NEXT — overridden by NetVM"""
        self.sys.perr("", "TOS is not a network model? ")
        return 0

    def _plus_into(self, i: int, addend):
        """`+!` core (shared with the trace-chunk macro serve): keep the
        accumulation ON DEVICE and LAZY — `nn.hit hit +!` epoch counters
        cost zero dispatches per batch (the addend chain collapses into
        one stacked device sum on first host read)"""
        cell = self.pmem.rd_du(i)
        fc, fa = self.future_of(cell), self.future_of(addend)
        if fc is not None or fa is not None:
            parts = []
            for du, f in ((cell, fc), (addend, fa)):
                if f is None:
                    parts.append(float(du))
                elif f.pending is not None:
                    parts.extend(f.pending)
                else:
                    parts.append(f.data)
            nf = self.mmu.future(None, pending=parts)
            self.pmem.wr_du(i, self.mmu.obj2du(nf))
            for old in (cell, addend):
                if self.future_of(old) is not None and not IS_VIEW(old):
                    self.mmu.mark_free(old)
        else:
            v = SCALAR(np.float32(float(cell) + float(addend)))
            self.pmem.wr_du(i, v)

    # ======================================================================
    # compiler helpers
    # ======================================================================
    @property
    def HERE(self) -> int:
        return self.pmem.here

    def add_p(self, op: int, ioff: int = 0, udf: bool = False, exit: bool = False) -> int:
        return self.pmem.add_p(op, ioff, udf, exit)

    def add_du(self, v) -> int:
        return self.pmem.add_du(v)

    def add_str(self, s: str) -> int:
        return self.pmem.add_str(s)

    def add_lit(self, n, exit: bool = False):
        self.add_p(Prim.LIT, 0, False, exit)
        self.add_du(n)

    def add_w(self, w: int):
        c = self.dict[w]
        if c.udf:
            self.add_p(Prim.MAX_OP, c.pfa, udf=True)
        else:
            self.add_p(Prim.MAX_OP, w, udf=False)

    def SETJMP(self, a: int):
        self.pmem.setjmp(a)

    # ======================================================================
    # misc core helpers (reference eforth.cpp:487-611)
    # ======================================================================
    def _word(self) -> int:
        name = self.sys.fetch()
        if not name:
            self.sys.pstr(" name?", cr=True)
            return 0
        if self.dict.find(name):
            self.sys.pstr(name)
            self.sys.pstr(" reDef? ", cr=True)
        self.dict.colon(name)
        return 1

    def _forget(self):
        name = self.sys.fetch()
        w = self.dict.find(name) if name else 0
        if not w:
            return
        b = self.dict.find("boot") + 1
        self.dict.clear(w if w > b else b)

    def _quote(self, op: int):
        s = self.sys.scan('"')[1:]            # skip single leading blank
        if self.compile:
            self.add_p(op, ALIGN(len(s.encode()) + 1))
            self.add_str(s)
        else:
            h0 = self.HERE
            ln = self.add_str(s)
            if op == Prim.STR:
                self.PUSH(np.float32(h0))
                self.PUSH(np.float32(ln))
            elif op == Prim.DOTQ:
                self.sys.pstr(self.pmem.rd_str(h0))
            self.pmem.set_here(h0)

    def _to_value(self):
        if self.state == VMState.QUERY:
            name = self.sys.fetch()
            w = self.dict.find(name) if name else 0
        else:
            w = self.POPi()
        if not w:
            return
        if self.compile:
            self.add_lit(np.float32(w))
            self.add_w(self.dict.find("to"))
        else:
            pfa = self.dict[w].pfa
            p = self.pmem.rd_param(pfa)
            if p.op == Prim.LIT:
                self.pmem.wr_du(pfa + IU_SZ, self.POP())

    def _is_alias(self):
        if self.state == VMState.QUERY:
            name = self.sys.fetch()
            w = self.dict.find(name) if name else 0
        else:
            w = self.POPi()
        if not w:
            return
        if self.compile:
            self.add_lit(np.float32(w))
            self.add_w(self.dict.find("is"))
        else:
            src = self.dict[w]
            widx = self.POPi()
            dst = self.dict[widx]
            dst.fn, dst.udf, dst.pfa = src.fn, src.udf, src.pfa
            self.dict.gen += 1                   # snapshot tables stale
            native = getattr(self.dict, "native", None)
            if native is not None:
                # retarget the native dispatch entry to match the alias
                if w in native:
                    native[widx] = native[w]
                else:
                    native.pop(widx, None)
                if self._engine is not None:
                    self._engine._table = None       # force table rebuild

    def _ss_dump(self):
        self.sys.db.ss_dump(self.id, self.tos, self.ss, self.BASE)

    def _print(self, op: int, v=DU0):
        self.sys.dot(op, v)
        if IS_OBJ(v) and not IS_VIEW(v):
            self.mmu.mark_free(v)

    def _sprintf(self):
        """( n1 [n2 ..] addr u -- addr' u' ) printf-style substitution"""
        self.POPi()                              # strlen, unused
        buf = self.pmem.rd_str(self.POPi())

        def t2s(c: str) -> str:
            if c == "d":
                return str(UINT(self.fpop()))
            if c in ("g", "f"):
                return gfmt(np.float32(self.fpop()))
            if c == "x":
                return "0x" + format(UINT(self.fpop()), "x")
            if c == "s":
                self.POP()
                return self.pmem.rd_str(self.POPi())
            if c == "p":
                return f"p {UINT(self.POP())} {UINT(self.POP())}"
            return c + "?"

        i = buf.rfind("%")
        while i != -1:
            if i > 0 and buf[i - 1] == "%":
                buf = buf[:i - 1] + buf[i:]
                i -= 1
            else:
                buf = buf[:i] + t2s(buf[i + 1] if i + 1 < len(buf) else "?") + buf[i + 2:]
            i = buf.rfind("%", 0, i if i > 0 else 0) if i > 0 else -1
        h0 = self.HERE
        ln = self.add_str(buf)
        self.PUSH(np.float32(h0))
        self.PUSH(np.float32(ln))
        self.pmem.set_here(h0)

    # ======================================================================
    # dictionary bootstrap
    # ======================================================================
    def init(self):
        super().init()
        if self.id != 0 or len(self.dict):
            return

        CODE = lambda nm, fn: self.dict.add_code(nm, fn)
        IMMD = lambda nm, fn: self.dict.add_code(nm, fn, imm=True)
        M = MathOp

        CODE("\nForth::", lambda vm: None)            # page-break sentinel
        CODE("nop", lambda vm: None)
        # --- stack ops ----------------------------------------------------
        CODE("dup",  lambda vm: vm.PUSH(vm.DUP_DU(vm.tos)))
        def _drop(vm):
            vm.DROP_DU(vm.tos); vm.tos = vm.ss.pop()
        CODE("drop", _drop)
        CODE("over", lambda vm: vm.PUSH(vm.DUP_DU(vm.ss[-1])))
        def _swap(vm):
            n = vm.ss.pop(); vm.PUSH(n)
        CODE("swap", _swap)
        def _rot(vm):
            n = vm.ss.pop(); m = vm.ss.pop()
            vm.ss.push(n); vm.PUSH(m)
        CODE("rot", _rot)
        def _rrot(vm):
            n = vm.ss.pop(); m = vm.ss.pop()
            vm.PUSH(m); vm.PUSH(n)
        CODE("-rot", _rrot)
        def _pick(vm):
            i = D2I(vm.tos)
            vm.tos = vm.DUP_DU(vm.ss[-i]) if i > 0 else vm.DUP_DU(vm.tos)
        CODE("pick", _pick)
        CODE("nip",  lambda vm: vm.ss.pop())
        def _qdup(vm):
            if float(vm.tos) != 0.0:
                vm.PUSH(vm.tos)
        CODE("?dup", _qdup)
        def _2dup(vm):
            v = vm.DUP_DU(vm.ss[-1]); vm.PUSH(v)
            v = vm.DUP_DU(vm.ss[-1]); vm.PUSH(v)
        CODE("2dup", _2dup)
        def _2drop(vm):
            s = vm.ss.pop(); vm.DROP_DU(s)
            vm.DROP_DU(vm.tos); vm.tos = vm.ss.pop()
        CODE("2drop", _2drop)
        def _2over(vm):
            v = vm.DUP_DU(vm.ss[-3]); vm.PUSH(v)
            v = vm.DUP_DU(vm.ss[-3]); vm.PUSH(v)
        CODE("2over", _2over)
        def _2swap(vm):
            n = vm.ss.pop(); m = vm.ss.pop(); l = vm.ss.pop()
            vm.ss.push(n); vm.PUSH(l); vm.PUSH(m)
        CODE("2swap", _2swap)
        # --- FPU ops --------------------------------------------------------
        CODE("+", lambda vm: vm.xop2(M.ADD))
        CODE("-", lambda vm: vm.xop2(M.SUB))
        CODE("*", lambda vm: vm.xop2(M.MUL))
        CODE("/", lambda vm: vm.xop2(M.DIV))
        def _mod(vm):
            t = int(vm._rtos()); n = int(vm._rnos())
            vm.tos = SCALAR(np.float32(math.fmod(n, t) if t else 0.0))
        CODE("mod", _mod)
        def _fmod(vm):
            t = vm._rtos(); n = vm._rnos()
            vm.tos = SCALAR(np.float32(math.fmod(n, t) if t else 0.0))
        CODE("fmod", _fmod)
        def _divmod(vm):
            t = vm._rtos(); n = vm._rnos()
            vm.ss.push(SCALAR(np.float32(math.fmod(n, t) if t else 0.0)))
            vm.tos = SCALAR(np.float32(n / t if t else 0.0))
        CODE("/mod", _divmod)
        def _muldiv(vm):                               # */  ( a b c -- a*b/c )
            n2 = vm._rnos() * vm._rnos()
            t = vm._rtos()
            vm.tos = SCALAR(np.float32(n2 / t if t else 0.0))
        CODE("*/", _muldiv)
        def _muldivmod(vm):                            # */mod ( a b c -- rem quo )
            n2 = vm._rnos() * vm._rnos()
            t = vm._rtos()
            m = math.fmod(n2, t) if t else 0.0
            vm.ss.push(SCALAR(np.float32(m)))
            vm.tos = SCALAR(np.float32(math.floor(n2 / t) if t else 0.0))
        CODE("*/mod", _muldivmod)
        # --- binary logic ---------------------------------------------------
        CODE("and", lambda vm: vm._ibin(lambda n, t: n & t))
        CODE("or",  lambda vm: vm._ibin(lambda n, t: n | t))
        CODE("xor", lambda vm: vm._ibin(lambda n, t: n ^ t))
        CODE("abs",    lambda vm: vm.xop1(M.ABS))
        CODE("negate", lambda vm: vm.xop1(M.NEG))
        CODE("invert", lambda vm: vm._iun(lambda t: ~t))
        CODE("rshift", lambda vm: vm._ibin(lambda n, t: (n & 0xFFFFFFFF) >> t))
        CODE("lshift", lambda vm: vm._ibin(lambda n, t: n << t))
        def _max(vm):
            n = vm.ss.pop()
            if vm.fval(n) > vm.fval(vm.tos):
                vm.DROP_DU(vm.tos)
                vm.tos = n
            else:
                vm.DROP_DU(n)
        CODE("max", _max)
        def _min(vm):
            n = vm.ss.pop()
            if vm.fval(n) < vm.fval(vm.tos):
                vm.DROP_DU(vm.tos)
                vm.tos = n
            else:
                vm.DROP_DU(n)
        CODE("min", _min)
        CODE("2*", lambda vm: vm._fun(lambda t: t * 2.0))
        CODE("2/", lambda vm: vm._fun(lambda t: t / 2.0))
        CODE("1+", lambda vm: vm._fun(lambda t: t + 1.0))
        CODE("1-", lambda vm: vm._fun(lambda t: t - 1.0))
        # --- conversion ------------------------------------------------------
        CODE("f>s",   lambda vm: vm._fun(lambda t: float(D2I(t))))
        CODE("round", lambda vm: vm._fun(lambda t: math.copysign(math.floor(abs(t) + 0.5), t)))
        CODE("ceil",  lambda vm: vm._fun(math.ceil))
        CODE("floor", lambda vm: vm._fun(math.floor))
        # --- logic (future-resolving: comparisons are host decisions) --------
        CODE("0=", lambda vm: vm._setb(ZEQ(vm._rtos())))
        CODE("0<", lambda vm: vm._setb(LT(vm._rtos(), 0.0)))
        CODE("0>", lambda vm: vm._setb(GT(vm._rtos(), 0.0)))
        CODE("=",  lambda vm: vm._setb(EQ(vm._rnos(), vm._rtos())))
        CODE(">",  lambda vm: vm._setb(GT(vm._rnos(), vm._rtos())))
        CODE("<",  lambda vm: vm._setb(LT(vm._rnos(), vm._rtos())))
        CODE("<>", lambda vm: vm._setb(not EQ(vm._rnos(), vm._rtos())))
        CODE(">=", lambda vm: vm._setb(not LT(vm._rnos(), vm._rtos())))
        CODE("<=", lambda vm: vm._setb(not GT(vm._rnos(), vm._rtos())))
        CODE("u<", lambda vm: vm._setb(UINT(int(vm._rnos())) < UINT(int(vm._rtos()))))
        CODE("u>", lambda vm: vm._setb(UINT(int(vm._rnos())) > UINT(int(vm._rtos()))))
        # --- IO ----------------------------------------------------------------
        CODE("base",    lambda vm: vm.PUSH(np.float32(vm.base_addr)))
        CODE("decimal", lambda vm: vm.set_BASE(10))
        CODE("hex",     lambda vm: vm.set_BASE(16))
        CODE("bl",      lambda vm: vm.PUSH(np.float32(0x20)))
        CODE("cr",      lambda vm: vm._print(IoOp.CR))
        CODE(".",       lambda vm: vm._print(IoOp.DOT, vm.POP()))
        CODE("u.",      lambda vm: vm._print(IoOp.UDOT,
                                             np.float32(vm.fpop())))
        def _dotr(vm):
            i = vm.POPi()
            vm.sys.dotr(i, np.float32(vm.fpop()), vm.BASE)
        CODE(".r", _dotr)
        def _udotr(vm):
            i = vm.POPi()
            vm.sys.dotr(i, np.float32(vm.fpop()), vm.BASE, unsigned=True)
        CODE("u.r", _udotr)
        def _type(vm):
            vm.POP(); vm.sys.pstr(vm.pmem.rd_str(vm.POPi()))
        CODE("type", _type)
        def _key(vm):
            if vm.compile:
                vm.add_p(Prim.KEY)
            else:
                vm.PUSH(np.float32(ord(vm.sys.key())))
        IMMD("key", _key)
        CODE("emit",   lambda vm: vm._print(IoOp.EMIT, vm.POP()))
        CODE("space",  lambda vm: vm._print(IoOp.SPCS, DU1))
        CODE("spaces", lambda vm: vm._print(IoOp.SPCS, vm.POP()))
        # --- literals ------------------------------------------------------------
        IMMD("(",   lambda vm: vm.sys.scan(")"))
        IMMD(".(",  lambda vm: vm.sys.pstr(vm.sys.scan(")")))
        IMMD("\\",  lambda vm: vm.sys.scan("\n"))
        IMMD('s"',  lambda vm: vm._quote(Prim.STR))
        IMMD('."',  lambda vm: vm._quote(Prim.DOTQ))
        # --- branching --------------------------------------------------------------
        def _if(vm):
            vm.PUSH(np.float32(vm.HERE)); vm.add_p(Prim.ZBRAN)
        IMMD("if", _if)
        def _else(vm):
            h = vm.HERE; vm.add_p(Prim.BRAN)
            vm.SETJMP(vm.POPi()); vm.PUSH(np.float32(h))
        IMMD("else", _else)
        IMMD("then", lambda vm: vm.SETJMP(vm.POPi()))
        # --- loops ---------------------------------------------------------------------
        IMMD("begin",  lambda vm: vm.PUSH(np.float32(vm.HERE)))
        IMMD("again",  lambda vm: vm.add_p(Prim.BRAN, vm.POPi()))
        IMMD("until",  lambda vm: vm.add_p(Prim.ZBRAN, vm.POPi()))
        def _while(vm):
            vm.PUSH(np.float32(vm.HERE)); vm.add_p(Prim.ZBRAN)
        IMMD("while", _while)
        def _repeat(vm):
            t = vm.POPi(); vm.add_p(Prim.BRAN, vm.POPi()); vm.SETJMP(t)
        IMMD("repeat", _repeat)
        def _for(vm):
            vm.add_p(Prim.FOR); vm.PUSH(np.float32(vm.HERE))
        IMMD("for", _for)
        IMMD("next", lambda vm: vm.add_p(Prim.NEXT, vm.POPi()))
        def _aft(vm):
            vm.POP(); h = vm.HERE; vm.add_p(Prim.BRAN)
            vm.PUSH(np.float32(vm.HERE)); vm.PUSH(np.float32(h))
        IMMD("aft", _aft)
        def _do(vm):
            vm.add_p(Prim.DO); vm.PUSH(np.float32(vm.HERE))
            vm._qdo_marks.append(None)    # pair marker for `loop` (?do)
        IMMD("do", _do)
        CODE("i", lambda vm: vm.PUSH(vm.rs[-1]))
        def _leave(vm):
            vm.rs.pop(); vm.rs.pop()
            vm.ip = int(float(vm.rs.pop()))
        CODE("leave", _leave)
        def _loop(vm):                 # closes both do and ?do
            vm.add_p(Prim.LOOP, vm.POPi())
            qa = vm._qdo_marks.pop() if vm._qdo_marks else None
            if qa is not None:         # ?do: emit the skip-path tail
                h = vm.HERE
                vm.add_p(Prim.BRAN)    # normal exit jumps the drops
                vm.SETJMP(qa)          # Lskip: discard limit start
                drop = vm.dict.find("drop")
                vm.add_w(drop); vm.add_w(drop)
                vm.SETJMP(h)           # Lend
        IMMD("loop", _loop)
        # --- return stack ----------------------------------------------------------------
        CODE(">r", lambda vm: vm.rs.push(vm.POP()))
        CODE("r>", lambda vm: vm.PUSH(vm.rs.pop()))
        CODE("r@", lambda vm: vm.PUSH(vm.DUP_DU(vm.rs[-1])))
        # --- compiler ------------------------------------------------------------------------
        CODE("[", lambda vm: setattr(vm, "compile", False))
        CODE("]", lambda vm: setattr(vm, "compile", True))
        CODE(":", lambda vm: setattr(vm, "compile", bool(vm._word())))
        def _semi(vm):
            vm.add_p(Prim.EXIT); vm.compile = False
        IMMD(";", _semi)
        def _variable(vm):
            if not vm._word():
                return
            vm.add_p(Prim.VAR, 0, True)
            vm.add_du(DU0)
        CODE("variable", _variable)
        def _constant(vm):
            if not vm._word():
                return
            vm.add_lit(vm.POP(), exit=True)
        CODE("constant", _constant)
        def _value(vm):
            if not vm._word():
                return
            vm.add_p(Prim.LIT, 0, True, True)
            vm.add_du(vm.POP())
        CODE("value", _value)
        IMMD("immediate", lambda vm: setattr(vm.dict.last(), "imm", True))
        CODE("exit", lambda vm: setattr(vm, "ip", int(float(vm.rs.pop()))))
        # --- metacompiler ---------------------------------------------------------------------
        def _exec(vm):
            vm.call(vm.POPi())
        CODE("exec", _exec)
        def _create(vm):
            if not vm._word():
                return
            vm.add_p(Prim.VAR, 0, True)
        CODE("create", _create)
        def _does(vm):
            pfa = vm.dict.last().pfa
            while pfa < vm.HERE and vm.pmem.rd_param(pfa).op != Prim.VAR:
                pfa += IU_SZ
            vm.pmem.setjmp(pfa, vm.ip)
            vm.add_p(Prim.BRAN, vm.ip)
            vm.ip = int(float(vm.rs.pop()))
        CODE("does>", _does)
        IMMD("to", lambda vm: vm._to_value())
        IMMD("is", lambda vm: vm._is_alias())
        def _bracket_to(vm):
            a = vm.pmem.rd_param(vm.ip).ioff + IU_SZ
            d = vm.POP()
            vm.ip += IU_SZ
            if a < Config.PMEM_SZ:
                vm.pmem.wr_du(a, d)
            else:
                vm.sys.perr("", f"is {a:x}? ")
                vm.state = VMState.STOP
        CODE("[to]", _bracket_to)
        # --- memory access ------------------------------------------------------------------------
        def _at(vm):
            i = vm.POPi(); vm.PUSH(vm.DUP_DU(vm.pmem.rd_du(i)))
        CODE("@", _at)
        def _store(vm):
            i = vm.POPi()
            old = vm.pmem.rd_du(i)
            vm.pmem.wr_du(i, vm.POP())
            # an overwritten deferred scalar can never be observed again
            if vm.future_of(old) is not None and not IS_VIEW(old):
                vm.mmu.mark_free(old)
        CODE("!", _store)
        def _cat(vm):
            i = vm.POPi(); vm.PUSH(np.float32(vm.pmem.rd_u8(i)))
        CODE("c@", _cat)
        def _cstore(vm):
            i = vm.POPi(); vm.pmem.wr_u8(i, vm.POPi())
        CODE("c!", _cstore)
        CODE("+!", lambda vm: vm._plus_into(vm.POPi(), vm.POP()))
        def _question(vm):
            # print a VIEW: `?` must not free the stored object
            i = vm.POPi(); vm._print(IoOp.DOT, vm.DUP_DU(vm.pmem.rd_du(i)))
        CODE("?", _question)
        CODE(",", lambda vm: vm.add_du(vm.POP()))
        def _cells(vm):
            i = vm.POPi(); vm.PUSH(np.float32(i * DU_SZ))
        CODE("cells", _cells)
        def _allot(vm):
            n = vm.POPi()
            for _ in range(0, n, DU_SZ):
                vm.add_du(DU0)
        CODE("allot", _allot)
        def _th(vm):
            i = vm.POPi()
            vm.tos = np.float32(float(vm.tos) + i * DU_SZ)
        CODE("th", _th)
        # --- debug -----------------------------------------------------------------------------------
        def _abort(vm):
            vm.tos = np.float32(-1.0); vm.ss.clear(); vm.rs.clear()
            vm.compile = False           # also leave any dangling input
            if hasattr(vm, "ten_lvl"):   # modes (unclosed { capture /
                vm.ten_lvl = 0           # colon def) — the REPL must
                vm._staged = None        # come back interpretable
        CODE("abort", _abort)
        CODE("here", lambda vm: vm.PUSH(np.float32(vm.HERE)))
        def _tick(vm):
            name = vm.sys.fetch()
            w = vm.dict.find(name) if name else 0
            if w:
                vm.PUSH(np.float32(w))
        CODE("'", _tick)
        CODE(".s",    lambda vm: vm._ss_dump())
        CODE("depth", lambda vm: vm.PUSH(np.float32(vm.ss.size() - 1)))
        CODE("words", lambda vm: vm.sys.db.words())
        CODE("dict",  lambda vm: vm.sys.db.dict_dump())
        CODE("dict_dump", lambda vm: vm.sys.db.dict_dump())
        def _see(vm):
            name = vm.sys.fetch()
            w = vm.dict.find(name) if name else 0
            if w:
                vm.sys.db.see(w, vm.BASE)
        CODE("see", _see)
        def _dump(vm):
            n = vm.POPi(); a = vm.POP()
            vm.sys.db.mem_dump(UINT(a), n)
        CODE("dump", _dump)
        CODE("forget", lambda vm: vm._forget())
        CODE("trace",  lambda vm: vm.sys.set_trace(vm.POPi()))
        # --- OS ----------------------------------------------------------------------------------------
        CODE("mstat", lambda vm: vm.mmu.status(True))
        CODE("ms",    lambda vm: System.delay(vm.POPi()))
        CODE("flush", lambda vm: vm.sys.flush())
        CODE("sprintf", lambda vm: vm._sprintf())
        def _clock(vm):
            if Config.DO_OBJ:                 # barrier: measure completed device work
                from ..ops.engine import sync
                sync()
            vm.PUSH(SCALAR(np.float32(System.clock())))
        CODE("clock", _clock)
        def _bye(vm):
            vm.state = VMState.STOP
        CODE("bye", _bye)
        CODE("boot", lambda vm: vm.dict.clear(vm.dict.find("boot") + 1))
        # --- the reference's #if 0 TODO words ------------------------------
        # (eforth.cpp:422-429 declares power/?do/roll/within but compiles
        # them out).  Like u< u> above, we realize the TODO list instead
        # of stubbing: silent no-ops would make scripts wrong, and the
        # unknown-word error would reject standard Forth.
        def _power(vm):                # ( a b -- a^b ) scalar float pow
            t = vm._rtos(); n = vm._rnos()
            try:
                r = math.pow(n, t)
            except (ValueError, OverflowError):
                r = float("nan")       # neg base + frac exp, like jnp.power
            vm.tos = SCALAR(np.float32(r))
        CODE("power", _power)
        def _within(vm):               # ( n lo hi -- f )  lo <= n < hi
            hi = vm._rtos(); lo = vm._rnos(); n = vm._rnos()
            vm._setb(not LT(n, lo) and LT(n, hi))
        CODE("within", _within)
        def _roll(vm):                 # ( xu..x0 u -- xu-1..x0 xu )
            u = vm.POPi()
            ss = vm.ss
            if u <= 0 or ss.size() < u:
                return                 # 0 roll / underflow: no-op
            a, b = ss.idx - u, ss.idx
            xu = np.float32(ss.buf[a])
            ss.buf[a:b - 1] = ss.buf[a + 1:b].copy()
            ss.buf[b - 1] = vm.tos     # x0 joins the stack body
            vm.tos = xu
        CODE("roll", _roll)
        # ?do ( limit start -- ) skips the body when start >= limit (the
        # entry form of LOOP's float continue test, limit-v > DU_EPS).
        # Compiled entirely from existing prims so the native inner
        # interpreter (csrc/t4core.cpp) runs it untouched:
        #   over over > ZBRAN->Lskip DO Lbody: ... LOOP->Lbody
        #   BRAN->Lend Lskip: drop drop Lend:
        # `loop` (redefined below) emits the tail when closing a ?do;
        # the pending ZBRAN patch address rides a compile-time side
        # stack (vm._qdo) so nesting and plain do/loop coexist.
        def _qdo(vm):
            for nm in ("over", "over", ">"):
                vm.add_w(vm.dict.find(nm))
            qa = vm.HERE
            vm.add_p(Prim.ZBRAN)       # patched to Lskip by `loop`
            vm.add_p(Prim.DO)
            vm.PUSH(np.float32(vm.HERE))
            vm._qdo_marks.append(qa)
        IMMD("?do", _qdo)

        # --- native inner-interpreter dispatch table -----------------------
        # record base (scalar) definitions for the C engine; later tiers'
        # redefinitions (tensor max/min/@ ...) keep their own indices and
        # trampoline back to Python.
        from ..runtime.native import NATIVE_WORDS
        self.dict.native = {}
        for nm, nid in NATIVE_WORDS.items():
            w = self.dict.find(nm)
            if w:
                self.dict.native[w] = nid

        # --- multitasking words (reference vm.h:62-79 DO_MULTITASK
        # scaffold, declared but compiled out there; realized here as a
        # host thread pool — device-level scaling goes through parallel/)
        from .multitask import register_multitask_words
        register_multitask_words(self.dict)

    def _loopval(self, v):
        """FOR/DO counter cell: futures resolve to host scalars; other
        objects (the dataset FOR/NEXT form) pass through untouched"""
        fo = self.future_of(v)
        if fo is None:
            return v
        r = np.float32(fo.value())
        self.DROP_DU(v)
        return SCALAR(r)

    # --- tiny ALU adapters --------------------------------------------------
    def _rtos(self) -> float:
        """resolve TOS to a host float (materializes futures; owner is
        marked for sweep since the caller overwrites/consumes TOS)"""
        return self._fconsume(self.tos)

    def _rnos(self) -> float:
        """pop+resolve NOS (below TOS)"""
        return self._fconsume(self.ss.pop())

    def _fun(self, f):
        self.tos = SCALAR(np.float32(f(self._rtos())))

    @staticmethod
    def _wrap32(r: int) -> int:
        r &= 0xFFFFFFFF
        return r - 0x100000000 if r >= 0x80000000 else r

    def _iun(self, f):
        self.tos = SCALAR(np.float32(self._wrap32(f(int(self._rtos())))))

    def _ibin(self, f):
        t = int(self._rtos())
        n = int(self._rnos())
        self.tos = SCALAR(np.float32(self._wrap32(f(n, t))))

    def _setb(self, cond):
        self.tos = BOOL(cond)
