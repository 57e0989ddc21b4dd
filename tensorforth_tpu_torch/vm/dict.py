"""Dictionary — word list shared by all VM tiers.

Reference: src/mu/code.h (Code entry) + src/mu/mmu.* dictionary ops.
A word is either a built-in (Python/native callable) or user-defined
(colon word with a parameter-field address into pmem).
"""
from __future__ import annotations

from .pmem import PMem, ALIGN


class Code:
    __slots__ = ("name", "fn", "imm", "udf", "pfa", "nfa")

    def __init__(self, name: str, fn=None, imm: bool = False,
                 udf: bool = False, pfa: int = 0, nfa: int = 0):
        self.name = name
        self.fn = fn              # callable(vm) for built-ins
        self.imm = imm
        self.udf = udf
        self.pfa = pfa            # parameter-field address (colon words)
        self.nfa = nfa            # name-field address (colon words)

    def __repr__(self):
        k = "u" if self.udf else ("*" if self.imm else " ")
        return f"<Code {self.name}{k}>"


class Dictionary:
    def __init__(self, pmem: PMem):
        self.pmem = pmem
        self.words: list[Code] = []
        self.gen = 0              # bumped on every mutation (native
        #                           outer/inner tables rebuild on change)

    def __len__(self):
        return len(self.words)

    def __getitem__(self, i: int) -> Code:
        return self.words[i]

    def add_code(self, name: str, fn, imm: bool = False) -> int:
        self.words.append(Code(name, fn, imm=imm))
        self.gen += 1
        return len(self.words) - 1

    def colon(self, name: str) -> int:
        """create a user-defined word: name goes into pmem, pfa = HERE"""
        nfa = self.pmem.here
        self.pmem.add_str(name)
        c = Code(name, None, udf=True, pfa=self.pmem.here, nfa=nfa)
        self.words.append(c)
        self.gen += 1
        return len(self.words) - 1

    def find(self, name: str) -> int:
        """reverse scan, returns index or 0 (entry 0 is a sentinel)"""
        for i in range(len(self.words) - 1, 0, -1):
            if self.words[i].name == name:
                return i
        return 0

    def last(self) -> Code:
        return self.words[-1]

    def pfa2idx(self, pfa: int, udf: bool) -> int:
        """map a compiled call cell back to a dictionary index (for see)"""
        for i in range(len(self.words) - 1, 0, -1):
            c = self.words[i]
            if udf and c.udf and c.pfa == pfa:
                return i
        return -1

    def clear(self, i: int):
        """forget words[i:] and reclaim their pmem"""
        if i >= len(self.words):
            return
        for c in self.words[i:]:
            if c.udf:
                self.pmem.set_here(c.nfa)
                break
        del self.words[i:]
        self.gen += 1
