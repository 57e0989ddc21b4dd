"""Parameter memory & compiled instruction cells.

The dictionary's code space is a flat byte array (reference src/mu/mmu.*
``pmem`` + src/vm/param.h).  Colon words compile into 32-bit Param cells;
literals/strings/variables live inline.  Keeping a real byte-addressed
pmem (instead of Python lists) gives exact semantics for ``@ ! c@ c!
here allot , dump see forget`` and lets a native inner interpreter mmap
the same buffer.

Param cell layout (u32, little-endian):

    bits  0..23  ioff   jump target / dict index / payload size
    bits 24..28  op     primitive opcode (see Prim)
    bit  30      udf    call target is a colon word (ioff = pfa)
    bit  31      exit   tail-call flag (constant/value LIT, does> VAR)
"""
from __future__ import annotations

import struct
import numpy as np

from ..config import Config


class Prim:
    """primitive opcodes executed by the inner interpreter"""
    EXIT  = 0
    NEXT  = 1
    LOOP  = 2
    LIT   = 3
    VAR   = 4
    STR   = 5
    DOTQ  = 6
    BRAN  = 7
    ZBRAN = 8
    FOR   = 9
    DO    = 10
    KEY   = 11
    MAX_OP = 12           # >= MAX_OP -> dictionary call

    NAMES = [";", "next ", "loop ", "lit", "var", "str", "dotq",
             "bran ", "0bran", "for  ", "do", "key"]


IU_SZ = 4                 # instruction unit = 4 bytes
DU_SZ = 4                 # data unit        = 4 bytes (f32)


def ALIGN(sz: int) -> int:
    return (sz + 3) & ~3


class Param:
    __slots__ = ("op", "ioff", "udf", "exit")

    def __init__(self, op: int, ioff: int = 0, udf: bool = False, exit: bool = False):
        self.op, self.ioff, self.udf, self.exit = op, ioff, udf, exit

    def pack(self) -> int:
        return ((self.ioff & 0xFFFFFF)
                | ((self.op & 0x1F) << 24)
                | (0x40000000 if self.udf else 0)
                | (0x80000000 if self.exit else 0))

    @staticmethod
    def unpack(u: int) -> "Param":
        return Param((u >> 24) & 0x1F, u & 0xFFFFFF,
                     bool(u & 0x40000000), bool(u & 0x80000000))


class PMem:
    """flat byte-addressed parameter memory"""

    def __init__(self, size: int = Config.PMEM_SZ):
        self.buf = np.zeros(size, dtype=np.uint8)
        self.midx = 16                      # HERE; first 16 bytes = user area (per-VM base)
        self.size = size

    # --- user area -------------------------------------------------------
    def base(self, vm_id: int) -> int:
        return int(self.buf[vm_id])

    def set_base(self, vm_id: int, b: int):
        self.buf[vm_id] = b

    # --- raw access ------------------------------------------------------
    def rd_u32(self, a: int) -> int:
        return int(struct.unpack_from("<I", self.buf, a)[0])

    def wr_u32(self, a: int, v: int):
        struct.pack_into("<I", self.buf, a, v & 0xFFFFFFFF)

    def rd_du(self, a: int) -> np.float32:
        return np.float32(struct.unpack_from("<f", self.buf, a)[0])

    def wr_du(self, a: int, v):
        struct.pack_into("<f", self.buf, a, float(v))

    def rd_u8(self, a: int) -> int:
        return int(self.buf[a])

    def wr_u8(self, a: int, v: int):
        self.buf[a] = v & 0xFF

    def rd_str(self, a: int) -> str:
        end = a
        while end < self.size and self.buf[end] != 0:
            end += 1
        return bytes(self.buf[a:end]).decode("utf-8", errors="replace")

    def rd_param(self, a: int) -> Param:
        return Param.unpack(self.rd_u32(a))

    def wr_param(self, a: int, p: Param):
        self.wr_u32(a, p.pack())

    # --- compiler --------------------------------------------------------
    @property
    def here(self) -> int:
        return self.midx

    def set_here(self, a: int):
        self.midx = a

    def _room(self, n: int):
        """pmem-overflow guard (fuzz finding: boundary colon defs used
        to crash the REPL with an uncaught struct.error; the native
        outer's compile path already bounces — this is the Python-side
        mirror).  Raises the word-error the trampolines report."""
        if self.midx < 0 or self.midx + n > self.size:
            raise MemoryError(f"pmem overflow (here={self.midx}, "
                              f"need {n}, size={self.size})")

    def add_p(self, op: int, ioff: int = 0, udf: bool = False, exit: bool = False) -> int:
        self._room(IU_SZ)
        a = self.midx
        self.wr_param(a, Param(op, ioff, udf, exit))
        self.midx += IU_SZ
        return a

    def add_du(self, v) -> int:
        self._room(DU_SZ)
        a = self.midx
        self.wr_du(a, v)
        self.midx += DU_SZ
        return a

    def add_str(self, s: str) -> int:
        """write nul-terminated string, 4-byte aligned; returns payload size"""
        raw = s.encode("utf-8") + b"\0"
        sz = ALIGN(len(raw))
        self._room(sz)
        self.buf[self.midx:self.midx + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        self.buf[self.midx + len(raw):self.midx + sz] = 0
        self.midx += sz
        return sz

    def setjmp(self, a: int, target: int | None = None):
        """backfill a branch target (reference SETJMP)"""
        p = self.rd_param(a)
        p.ioff = self.midx if target is None else target
        self.wr_param(a, p)
