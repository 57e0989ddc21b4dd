"""Debug/tracer — "JTAG" for the VM: words, see (decompiler), mem_dump,
ss_dump, dict_dump, tensor pretty-print proxy.

Reference: src/debug.{h,cpp}.
"""
from __future__ import annotations

import numpy as np

from .config import Config
from .du import IS_OBJ, IS_VIEW
from .io.fmt import to_s_scalar
from .vm.pmem import Prim, IU_SZ, DU_SZ, ALIGN


class Debug:
    _inst = None

    def __init__(self, sys):
        self.sys = sys
        self.mu = sys.mu
        self.fout = sys.fout

    @classmethod
    def get_db(cls, sys):
        if cls._inst is None:
            cls._inst = Debug(sys)
        return cls._inst

    @classmethod
    def free_db(cls):
        cls._inst = None

    # ------------------------------------------------------------------
    def print_obj(self, v):
        """pretty-print a tensor/model/dataset object (reference marshall)"""
        from .io.aio import AIO
        self.fout.write(AIO.get_io(self.sys).marshall(self.mu.du2obj(v)))

    def ss_dump(self, vm_id: int, tos, ss, base: int):
        w = self.fout.write
        from .io.aio import AIO
        io = AIO.get_io(self.sys)

        def show(v):
            if IS_OBJ(v):
                w(io.to_s_obj(self.mu.du2obj(v), IS_VIEW(v)))
            else:
                w(to_s_scalar(v, base))
            w(" ")

        for i in range(ss.size()):
            show(ss[i])
        show(tos)
        w("-> ok\n")
        self.fout.flush()

    def self_tests(self, level: int = 0) -> bool:
        """boot sanity (reference Debug::self_tests, debug.cpp:255-261,
        called unconditionally from ten4.cu:225 — but its body is
        compile-time gated behind T4_VERBOSE>1, so a default reference
        build checks nothing).  Here a cheap SILENT integrity pass
        always runs: dictionary findability of one word per VM tier,
        pmem HERE bounds, tagged-DU scalar masking, and object-table
        emptiness.  One summary line prints at -v1; the reference's
        full dumps (dict_dump/words/mem_dump) print at -v2.  Failures
        always print and return False."""
        from .du import SCALAR, IS_OBJ
        dic, pm = self.mu.dict, self.mu.pmem
        bad = []
        for name in ("dup", ":", "@", "+", "words"):
            i = dic.find(name)
            if not i or dic[i].name != name:
                bad.append(f"dict lookup '{name}' -> {i}")
        if not (16 <= pm.here <= pm.size):
            bad.append(f"pmem HERE {pm.here} outside [16,{pm.size}]")
        v = SCALAR(np.float32(3.1415926))
        if IS_OBJ(v) or abs(float(v) - 3.1415926) > 1e-5:
            bad.append(f"tagged-DU scalar masking broke: {float(v)!r}")
        for b in bad:
            self.fout.write(f"ERROR: self-test: {b}\n")
        if level > 0 and not bad:
            self.fout.write(f"\\ self-test ok: {len(dic.words)} words, "
                            f"pmem {pm.here}/{pm.size}\n")
        if level > 1:
            self.dict_dump()
            self.words()
            self.mem_dump(0, 256)
        return not bad

    def words(self):
        WIDTH = 72
        w = self.fout.write
        sz = 0
        for c in self.mu.dict.words:
            w("  " + c.name)
            sz += WIDTH if c.name.startswith("\n") else len(c.name) + 2
            if sz >= WIDTH:
                w("\n")
                sz = 0
        w("\n")

    def mem_dump(self, p0: int, sz: int):
        buf = self.mu.pmem.buf
        w = self.fout.write
        a0 = p0 & ~0xF
        a1 = (p0 + sz + 15) & ~0xF
        for i in range(a0, a1 + 1, 16):
            hexs = []
            chars = []
            for j in range(16):
                c = int(buf[i + j]) if i + j < len(buf) else 0
                hexs.append(f"{c:02x} " + (" " if j % 4 == 3 else ""))
                c &= 0x7F
                chars.append(chr(c) if 0x20 <= c < 0x7F else ".")
            w(f"{i & 0xFFFF:04x}: {''.join(hexs)}{''.join(chars)}\n")

    def dict_dump(self):
        w = self.fout.write
        w("Built-in Dictionary:\n")
        for i, c in enumerate(self.mu.dict.words):
            w(f"{i:4d}|{i:3x}> {'pf' if c.udf else 'xt'}="
              f"{c.pfa if c.udf else 0:6x}{'*' if c.imm else ' '} {c.name}\n")

    # --- see (decompiler) ----------------------------------------------
    def see(self, w: int, base: int = 10):
        out = self.fout.write
        dic = self.mu.dict
        pm = self.mu.pmem
        c = dic[w]
        out(f": {c.name}\n")
        if not c.udf:
            out(" ( built-ins ) ;\n")
            return

        def nfa_of(i):
            return dic[i].nfa if dic[i].udf else pm.here

        def nvar(i0, ioff, ip):
            if ioff:
                return ioff - ip - IU_SZ
            pfa0 = dic[i0].pfa
            nfa1 = pm.here
            for k in range(i0 + 1, len(dic)):
                if dic[k].udf:
                    nfa1 = dic[k].nfa
                    break
            return nfa1 - pfa0 - IU_SZ

        ip = c.pfa
        while True:
            p = pm.rd_param(ip)
            nv = nvar(w, p.ioff, ip) if p.op == Prim.VAR else 0
            if self._see_param(ip, p, nv, base) != 0:
                break
            out("\n")
            ip += IU_SZ
            if p.op == Prim.LIT:
                ip += DU_SZ
            elif p.op == Prim.VAR:
                ip = p.ioff if p.ioff else ip
                if not p.ioff:
                    break
            elif p.op in (Prim.STR, Prim.DOTQ):
                ip += p.ioff
        out("\n\n")

    def _see_param(self, addr: int, p, nv: int, base: int) -> int:
        out = self.fout.write
        dic = self.mu.dict
        pm = self.mu.pmem
        pm_op = p.op < Prim.MAX_OP
        if not pm_op:
            widx = dic.pfa2idx(p.ioff, True) if p.udf else p.ioff
            if widx < 0 or widx >= len(dic):
                return -1
            out(f"  ( {addr:04x} [{widx:3x}] ) {dic[widx].name}  ")
            return 0
        out(f"  ( {addr:04x} [{p.op:3x}] ) ")
        dp = addr + IU_SZ
        if p.op == Prim.LIT:
            out(to_s_scalar(pm.rd_du(dp), base))
        elif p.op == Prim.STR:
            out(f's" {pm.rd_str(dp)}"')
        elif p.op == Prim.DOTQ:
            out(f'." {pm.rd_str(dp)}"')
        elif p.op == Prim.VAR:
            for i in range(0, nv, DU_SZ):
                out(f"{float(pm.rd_du(dp + i)):g} ")
            out(Prim.NAMES[p.op])
        else:
            out(Prim.NAMES[p.op])
        if p.op in (Prim.NEXT, Prim.LOOP, Prim.BRAN, Prim.ZBRAN):
            out(f" \\ ${p.ioff:04x}")
        if (p.op == Prim.EXIT
                or (p.op == Prim.LIT and p.exit)
                or (p.op == Prim.VAR and not p.ioff)):
            return 1
        return 0
