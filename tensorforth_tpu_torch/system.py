"""System singleton — service hub owning IO streams, tokenizer, clock,
randomizer front-end, MMU and Debug (the port of tensorforth_tpu/
system.py; the TensorBoard writer comes with its tier).

Reference: src/sys.{h,cpp}.  The reference marshals every host-side
operation through a binary event queue (VM posts events, flush() drains
them after the VM HOLDs).  Since this runtime's interpreter already runs
on the host, host services execute synchronously — same observable
ordering, no queue round-trip (see SURVEY.md §3.5).

The seed stream is the JAX package's 63-bit LCG, and ``ops/rng.py`` turns
each seed into the same threefry numbers as ``jax.random``: with equal
seeds, ``rand``, ``randn`` and the Kaiming init are equal in both
packages.
"""
from __future__ import annotations

import os
import sys as _sys
import time

import numpy as np

from .config import Config
from .du import IS_OBJ, D2I, UINT
from .io.fmt import gfmt, to_base

_START = time.monotonic()


class IoOp:
    CR, DOT, UDOT, EMIT, SPCS, RDX = range(6)


class System:
    _inst = None

    def __init__(self, fin=None, fout=None, trace: int = 0):
        self.fin = fin if fin is not None else _sys.stdin
        self.fout = fout if fout is not None else _sys.stdout
        self._trace = trace
        self._line = ""          # current input line (Istream)
        self._idx = 0
        self.mu = None           # MMU, set by bootstrap
        self.db = None           # Debug
        self.tb = None           # TensorBoard writer: not ported yet
        self._rng_seed = int(os.environ.get(
            "T4_SEED", int(time.time()) & 0x7FFFFFFF))

    # --- singleton ---------------------------------------------------------
    @classmethod
    def get_sys(cls, fin=None, fout=None, trace: int = 0) -> "System":
        if cls._inst is None:
            cls._inst = System(fin, fout, trace)
        return cls._inst

    @classmethod
    def free_sys(cls):
        cls._inst = None

    # --- timing ------------------------------------------------------------
    @staticmethod
    def clock() -> float:
        """milliseconds since process start (reference: steady_clock ms)"""
        return (time.monotonic() - _START) * 1000.0

    @staticmethod
    def delay(ms: int):
        time.sleep(ms / 1000.0)

    # --- tracing -----------------------------------------------------------
    @property
    def trace(self) -> int:
        return self._trace

    def set_trace(self, lvl: int):
        self._trace = lvl

    # --- randomizer front-end (reference sys.cpp:77-95 / util.cu) ----------
    def seed(self, s: int):
        self._rng_seed = int(s) & 0x7FFFFFFF

    _LCG_MUL = 6364136223846793005
    _LCG_INC = 1442695040888963407

    def next_key(self):
        """fresh fold-in key for stateless device RNG"""
        self._rng_seed = (self._rng_seed * self._LCG_MUL
                          + self._LCG_INC) & 0x7FFFFFFFFFFFFFFF
        return self._rng_seed

    def peek_keys(self, n: int):
        """the next n seeds next_key() WILL return, without advancing"""
        s, out = self._rng_seed, []
        for _ in range(n):
            s = (s * self._LCG_MUL + self._LCG_INC) & 0x7FFFFFFFFFFFFFFF
            out.append(s)
        return out

    def rand_fill(self, t, dist: str, bias: float = 0.0, scale: float = 1.0):
        """fill tensor object t with random values: v = scale*(bias + u)"""
        from .ops import rng
        t.replace_data(rng.fill(t.shape, dist, bias, scale, self.next_key(),
                                device=t.device))

    def rand_scalar(self, dist: str) -> float:
        from .ops import rng
        return rng.scalar(dist, self.next_key())

    # --- input stream (Istream semantics, reference io/istream.h) ----------
    def load_line(self, s: str):
        self._line = s
        self._idx = 0

    def readline(self) -> bool:
        line = self.fin.readline()
        if line == "":
            return False
        self.load_line(line.rstrip("\n"))
        return True

    def fetch(self):
        """next whitespace-delimited idiom, or None at end of line"""
        n = len(self._line)
        i = self._idx
        while i < n and self._line[i] in " \t":
            i += 1
        if i >= n:
            self._idx = i
            return None
        j = i
        while j < n and self._line[j] not in " \t":
            j += 1
        self._idx = j
        return self._line[i:j]

    def scan(self, delim: str) -> str:
        """capture up to delim (no whitespace skip); reference Istream::get_idiom"""
        if delim == "\n":
            self._idx = len(self._line)
            return ""
        n = len(self._line)
        i = self._idx
        j = self._line.find(delim, i)
        if j < 0:
            self._idx = n
            return self._line[i:]
        self._idx = j + 1
        return self._line[i:j]

    def key(self) -> str:
        if self._idx < len(self._line):
            c = self._line[self._idx]
            self._idx += 1
            return c
        return "\n"

    def clrbuf(self):
        self._idx = len(self._line)

    # --- output ------------------------------------------------------------
    def pstr(self, s: str, cr: bool = False):
        self.fout.write(s)
        if cr:
            self.fout.write("\n")

    def perr(self, s: str, msg: str):
        self.fout.write(s + msg + "\n")
        self.fout.flush()

    def spaces(self, n: int):
        self.fout.write(" " * max(0, int(n)))

    def dot(self, op: int, v=np.float32(0)):
        """print literals (reference sys.h dot)"""
        w = self.fout.write
        if op == IoOp.CR:
            w("\n")
        elif op == IoOp.DOT:
            if IS_OBJ(v):
                self.db.print_obj(v)
                w(" ")
            else:
                w(gfmt(v) + " ")
        elif op == IoOp.UDOT:
            w(str(UINT(D2I(v))) + " ")
        elif op == IoOp.EMIT:
            w(chr(D2I(v) & 0xFF))
        elif op == IoOp.SPCS:
            self.spaces(D2I(v))

    def dotr(self, width: int, v, base: int, unsigned: bool = False):
        if unsigned or base != 10:
            s = to_base(UINT(v), base)
        else:
            s = gfmt(v)
        self.fout.write(s.rjust(int(width)))

    def flush(self):
        """drain deferred host ops (reference sys->flush), then stdout"""
        if self.tb is not None:
            self.tb.flush()
        self.fout.flush()
