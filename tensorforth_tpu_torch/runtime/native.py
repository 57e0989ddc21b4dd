"""Native runtime bindings (csrc/ -> ctypes; the port of
tensorforth_tpu/runtime/native.py).

t4core: the inner interpreter runs compiled words at native speed;
        primitive opcodes + the scalar word set execute in C++, object/
        IO words trampoline back into Python (reference analog: the
        host-mode eForth VM, src/vm/eforth.cpp nest()).
t4alloc: TLSF arena accounting + status (reference src/mu/tlsf.cpp).
t4io, t4tb: the TensorBoard event framing and the corpus readers.

The libraries are built on first use from the repo's csrc/ sources, read
as they are, with csrc/Makefile into build/torch_native/ (a directory of
the port's own, so that the port's TLSF state is not the JAX package's
library's).  Everything falls back to the pure-Python paths when no C++
compiler is there (set T4_NO_NATIVE=1 to force the fallback); both print
the same.
"""
from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import tempfile

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "csrc")
_BUILD = os.path.join(_ROOT, "build", "torch_native")

# native word ids — must match csrc/t4core.cpp enum order
_NAMES = [
    "nop", "dup", "drop", "over", "swap", "rot", "-rot", "pick", "nip",
    "?dup", "2dup", "2drop", "2over", "2swap",
    "+", "-", "*", "/", "mod", "fmod", "/mod", "*/",
    "*/mod", "and", "or", "xor", "abs", "negate", "invert", "rshift",
    "lshift", "max", "min", "2*", "2/", "1+", "1-",
    "f>s", "round", "ceil", "floor",
    "0=", "0<", "0>", "=", ">", "<", "<>", ">=", "<=", "u<", "u>",
    ">r", "r>", "r@", "i", "exit", "bl", "depth",
]
NATIVE_WORDS = {nm: i for i, nm in enumerate(_NAMES)}


class T4VMStruct(C.Structure):
    _fields_ = [
        ("pmem", C.POINTER(C.c_uint8)),
        ("ss", C.POINTER(C.c_float)),
        ("rs", C.POINTER(C.c_float)),
        ("ss_idx", C.c_int32),
        ("rs_idx", C.c_int32),
        ("ip", C.c_int32),
        ("tos", C.c_float),
        ("state", C.c_int32),
        ("ss_sz", C.c_int32),
        ("rs_sz", C.c_int32),
        ("dropped", C.c_uint32 * 256),
        ("n_dropped", C.c_int32),
        # outer-interpreter extension (must match csrc/t4core.cpp T4VM)
        ("in_", C.c_char_p),
        ("in_len", C.c_int32),
        ("in_idx", C.c_int32),
        ("vm_id", C.c_int32),
        ("compile", C.c_int32),
        ("here", C.c_int32),
        ("pmem_sz", C.c_int32),
        ("py_flags", C.c_int32),
    ]


class T4DictStruct(C.Structure):
    _fields_ = [
        ("nblob", C.c_char_p),
        ("noffs", C.POINTER(C.c_uint32)),
        ("nflags", C.POINTER(C.c_uint8)),
        ("npfa", C.POINTER(C.c_uint32)),
        ("nwords", C.c_int32),
    ]


_CB = C.CFUNCTYPE(None, C.c_int32)


def _build_and_load(name: str):
    """lib<name>.so from build/torch_native/, made there on first use.
    The build runs in a private directory and is renamed into place, so
    processes that start together (test workers) never load a library
    another one is still writing."""
    so = os.path.join(_BUILD, f"lib{name}.so")
    if not os.path.exists(so):
        try:
            os.makedirs(_BUILD, exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=f".{name}-", dir=_BUILD)
            try:
                subprocess.run(["make", "-C", _CSRC, f"OUT={tmp}",
                                f"{tmp}/lib{name}.so"],
                               check=True, capture_output=True)
                os.replace(os.path.join(tmp, f"lib{name}.so"), so)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        return C.CDLL(so)
    except OSError:
        return None


_core = None
_alloc = None
_tb = None
_io = None


def get_io():
    """libt4io: native TB event writer + corpus readers (csrc/t4io.cpp)"""
    global _io
    if _io is None and not os.environ.get("T4_NO_NATIVE"):
        lib = _build_and_load("t4io")
        if lib is not None:
            i64, u64, i32 = C.c_int64, C.c_uint64, C.c_int32
            dbl, u8p = C.c_double, C.POINTER(C.c_uint8)
            lib.t4_tb_open.restype = i64
            lib.t4_tb_open.argtypes = [C.c_char_p]
            lib.t4_tb_close.argtypes = [i64]
            lib.t4_tb_flush.argtypes = [i64]
            lib.t4_tb_raw_body.restype = i64
            lib.t4_tb_raw_body.argtypes = [i64, C.c_char_p, u64, dbl,
                                           i64, i32]
            lib.t4_tb_file_version.restype = i64
            lib.t4_tb_file_version.argtypes = [i64, dbl]
            lib.t4_tb_scalar.restype = i64
            lib.t4_tb_scalar.argtypes = [i64, C.c_char_p, C.c_float,
                                         i64, dbl]
            lib.t4_tb_text.restype = i64
            lib.t4_tb_text.argtypes = [i64, C.c_char_p, C.c_char_p,
                                       i64, dbl]
            lib.t4_tb_image.restype = i64
            lib.t4_tb_image.argtypes = [i64, C.c_char_p, C.c_char_p, u64,
                                        i32, i32, i64, dbl]
            lib.t4_tb_histo.restype = i64
            lib.t4_tb_histo.argtypes = [i64, C.c_char_p, dbl, dbl, dbl,
                                        dbl, dbl, C.POINTER(C.c_double),
                                        C.POINTER(C.c_double), i32, i64,
                                        dbl]
            lib.t4_ld_idx_info.restype = i64
            lib.t4_ld_idx_info.argtypes = [C.c_char_p,
                                           C.POINTER(C.c_uint32)]
            lib.t4_ld_idx_read.restype = i64
            lib.t4_ld_idx_read.argtypes = [C.c_char_p, u64, u8p, u64]
            lib.t4_ld_cifar.restype = i64
            lib.t4_ld_cifar.argtypes = [C.c_char_p, u8p, u8p, i64]
            _io = lib
    return _io


def get_tb():
    global _tb
    if _tb is None and not os.environ.get("T4_NO_NATIVE"):
        lib = _build_and_load("t4tb")
        if lib is not None:
            lib.t4_crc32c.restype = C.c_uint32
            lib.t4_crc32c.argtypes = [C.c_char_p, C.c_uint64, C.c_uint32]
            lib.t4_masked_crc32c.restype = C.c_uint32
            lib.t4_masked_crc32c.argtypes = [C.c_char_p, C.c_uint64]
            lib.t4_tfrecord_frame.restype = C.c_uint64
            lib.t4_tfrecord_frame.argtypes = [C.c_char_p, C.c_uint64,
                                              C.c_char_p]
            _tb = lib
    return _tb


def get_core():
    global _core
    if _core is None and not os.environ.get("T4_NO_NATIVE"):
        lib = _build_and_load("t4core")
        if lib is not None:
            lib.t4_nest.restype = C.c_int32
            lib.t4_nest.argtypes = [C.POINTER(T4VMStruct),
                                    C.POINTER(C.c_int16), C.c_int32, _CB]
            if hasattr(lib, "t4_outer"):
                lib.t4_outer.restype = C.c_int32
                lib.t4_outer.argtypes = [C.POINTER(T4VMStruct),
                                         C.POINTER(T4DictStruct),
                                         C.POINTER(C.c_int16), C.c_int32,
                                         _CB]
            _core = lib
    return _core


def get_alloc():
    global _alloc
    if _alloc is None and not os.environ.get("T4_NO_NATIVE"):
        lib = _build_and_load("t4alloc")
        if lib is not None:
            lib.t4_tlsf_init.argtypes = [C.c_uint64]
            lib.t4_tlsf_malloc.restype = C.c_uint64
            lib.t4_tlsf_malloc.argtypes = [C.c_uint64]
            lib.t4_tlsf_free.argtypes = [C.c_uint64]
            lib.t4_tlsf_free.restype = C.c_int32
            lib.t4_tlsf_status.argtypes = [C.POINTER(C.c_uint64)]
            lib.t4_tlsf_check.restype = C.c_int32
            _alloc = lib
    return _alloc


class NativeEngine:
    """drives t4_nest() over a Python VM's shared buffers"""

    def __init__(self, vm):
        self.vm = vm
        self.lib = get_core()
        self.st = T4VMStruct()
        self.st.pmem = vm.pmem.buf.ctypes.data_as(C.POINTER(C.c_uint8))
        self.st.ss = vm.ss.buf.ctypes.data_as(C.POINTER(C.c_float))
        self.st.rs = vm.rs.buf.ctypes.data_as(C.POINTER(C.c_float))
        self.st.ss_sz = vm.ss.buf.size
        self.st.rs_sz = vm.rs.buf.size
        self.st.vm_id = vm.id
        self.st.pmem_sz = vm.pmem.size
        self._table = None
        self._table_len = 0
        self._table_gen = -1
        self._dictst = None
        self._dict_gen = -1
        self._outer_active = False
        self._cb = _CB(self._callback)

    # --- dictionary dispatch table --------------------------------------
    def _ensure_table(self):
        d = self.vm.dict
        gen = getattr(d, "gen", len(d))
        if self._table is not None and self._table_gen == gen \
                and self._table_len == len(d):
            return
        t = np.full(len(d), -1, dtype=np.int16)
        native = getattr(d, "native", {})
        for idx, nid in native.items():
            if idx < len(d):
                t[idx] = nid
        self._table_np = t
        self._table = t.ctypes.data_as(C.POINTER(C.c_int16))
        self._table_len = len(d)
        self._table_gen = gen

    def _ensure_dict(self):
        """name/flags/pfa snapshot for the native outer interpreter"""
        d = self.vm.dict
        gen = getattr(d, "gen", None)
        if self._dictst is not None and self._dict_gen == gen:
            return
        blob = bytearray()
        offs = np.zeros(len(d), dtype=np.uint32)
        flags = np.zeros(len(d), dtype=np.uint8)
        pfa = np.zeros(len(d), dtype=np.uint32)
        for i, c in enumerate(d.words):
            offs[i] = len(blob)
            blob += c.name.encode("utf-8", errors="replace") + b"\0"
            flags[i] = (1 if c.imm else 0) | (2 if c.udf else 0)
            pfa[i] = c.pfa
        self._dict_blob = bytes(blob)
        self._dict_offs = offs
        self._dict_flags = flags
        self._dict_pfa = pfa
        st = T4DictStruct()
        st.nblob = self._dict_blob
        st.noffs = offs.ctypes.data_as(C.POINTER(C.c_uint32))
        st.nflags = flags.ctypes.data_as(C.POINTER(C.c_uint8))
        st.npfa = pfa.ctypes.data_as(C.POINTER(C.c_uint32))
        st.nwords = len(d)
        self._dictst = st
        self._dict_gen = gen

    # --- state marshalling ------------------------------------------------
    def _to_vm(self):
        vm = self.vm
        vm.ss.idx = self.st.ss_idx
        vm.rs.idx = self.st.rs_idx
        vm.ip = self.st.ip
        vm.tos = np.float32(self.st.tos)
        vm.state = self.st.state
        vm.compile = bool(self.st.compile)
        vm.pmem.set_here(self.st.here)
        if self._outer_active:
            vm.sys._idx = self.st.in_idx
        self._drain_dropped()

    def _from_vm(self):
        vm = self.vm
        self.st.ss_idx = vm.ss.idx
        self.st.rs_idx = vm.rs.idx
        self.st.ip = vm.ip
        self.st.tos = float(vm.tos)
        self.st.state = vm.state
        self.st.compile = 1 if vm.compile else 0
        self.st.here = vm.pmem.here
        if self._outer_active:
            self.st.in_idx = vm.sys._idx
        self.st.py_flags = ((1 if getattr(vm, "ten_lvl", 0) else 0)
                            | (2 if getattr(vm.dict, "gen", None)
                               != self._dict_gen else 0))

    def _drain_dropped(self):
        from ..du import u2f
        n = self.st.n_dropped
        if n:
            mmu = self.vm.mmu
            for i in range(n):
                mmu.mark_free(u2f(self.st.dropped[i]))
            self.st.n_dropped = 0

    # --- python trampoline ---------------------------------------------------
    def _callback(self, widx: int):
        vm = self.vm
        self._to_vm()
        try:
            if widx >= 0:
                with vm._lock_for(vm.dict[widx]):
                    vm.dict[widx].fn(vm)
            elif widx in (-2, -3):               # print, read a key
                self._prim(widx)
            else:                                # may touch the card
                vm._locked(self._prim, widx)
        except Exception as ex:                  # surface, don't crash C
            # mirror ForthVM.parse's word-error contract: report and
            # keep the REPL alive (QUERY), never hard-stop the VM
            name = vm.dict[widx].name if 0 <= widx < len(vm.dict) else "?"
            vm.sys.perr("", f"ERROR in '{name}': {ex} ")
            if vm.sys.trace:
                import traceback
                traceback.print_exc(file=vm.sys.fout)
            from ..vm.vm import VMState
            vm.state = VMState.QUERY
        self._from_vm()

    def _prim(self, widx: int):
        """a prim the C loop hands back: -1 dataset NEXT, -2 DOTQ, -3 KEY,
        -4 ZBRAN on an object flag, -5 FOR and -6 DO with object operands"""
        from ..vm.pmem import IU_SZ
        vm = self.vm
        if widx == -1:                       # dataset-aware NEXT
            p = vm.pmem.rd_param(vm.ip)
            vm.ip += IU_SZ
            vm._ds_next(p.ioff)
        elif widx == -2:                     # DOTQ
            p = vm.pmem.rd_param(vm.ip)
            vm.ip += IU_SZ
            vm.sys.pstr(vm.pmem.rd_str(vm.ip))
            vm.ip += p.ioff
        elif widx == -3:                     # KEY
            vm.ip += IU_SZ
            vm.PUSH(np.float32(ord(vm.sys.key())))
        elif widx == -4:                     # ZBRAN on an object flag
            from ..du import ZEQ
            p = vm.pmem.rd_param(vm.ip)
            vm.ip += IU_SZ
            if ZEQ(vm.fpop()):               # resolves deferred scalars
                vm.ip = p.ioff
        elif widx == -5:                     # FOR with an object count
            vm.ip += IU_SZ
            vm.rs.push(vm._loopval(vm.POP()))
        elif widx == -6:                     # DO with object operands
            vm.ip += IU_SZ
            vm.rs.push(vm._loopval(vm.ss.pop()))
            vm.rs.push(vm._loopval(vm.POP()))

    # --- crash containment (reference ten4.cu:258-272, exceeded) ---------
    PYF_FAULT = 4

    def _check_fault(self) -> bool:
        """a SIGSEGV/SIGBUS inside the native engine longjmp'd back to
        the t4_nest/t4_outer entry (csrc/t4core.cpp t4_fault_handler);
        the C side already aborted the line and set QUERY — here we
        mirror `abort` (clear stacks, leave input modes) and report, so
        the REPL keeps going where the reference exits(1)"""
        if not (self.st.py_flags & self.PYF_FAULT):
            return False
        self.st.py_flags &= ~self.PYF_FAULT
        from ..vm.vm import VMState
        vm = self.vm
        vm.ss.clear()
        vm.rs.clear()
        vm.compile = False
        if hasattr(vm, "ten_lvl"):
            vm.ten_lvl = 0
            vm._staged = None
        vm.state = VMState.QUERY
        self._from_vm()
        vm.sys.perr("", "native engine fault trapped — line aborted ")
        return True

    # --- entry ------------------------------------------------------------------
    def nest(self):
        from ..vm.vm import VMState
        self._ensure_table()
        self.vm.state = VMState.NEST
        self._from_vm()
        self.lib.t4_nest(C.byref(self.st), self._table,
                         self._table_len, self._cb)
        self._to_vm()
        self._check_fault()

    # --- native outer interpreter -----------------------------------------
    OUT_DONE, OUT_HOLD, OUT_TOKEN, OUT_REENTER = 0, 1, 2, 3

    def can_outer(self) -> bool:
        return (hasattr(self.lib, "t4_outer")
                and self.vm.sys._line.isascii())

    def outer(self):
        """token loop in C; python handles only the tokens C cannot
        (immediate-compiled tensor literals, unknown words, python-word
        side effects that mutate the dictionary).  Re-entrant: words
        like `load` interpret sub-lines through a nested outer() — the
        engine struct's input-buffer state is saved and restored so the
        suspended C loop resumes on its own line."""
        from ..vm.vm import VMState
        vm = self.vm
        sys_ = vm.sys
        prev_state = (getattr(self, "_line_buf", None), self.st.in_,
                      self.st.in_len, self._outer_active)
        self._outer_active = True
        try:
            while True:
                if getattr(vm, "ten_lvl", 0):
                    # tensor literal capture: python token-by-token
                    idiom = sys_.fetch()
                    if idiom is None:
                        break
                    if not self._py_token(idiom):
                        break
                    continue
                self._ensure_table()
                self._ensure_dict()
                lb = sys_._line.encode("ascii")
                self._line_buf = lb                      # keep alive
                self.st.in_ = lb
                self.st.in_len = len(lb)
                self._from_vm()
                rc = self.lib.t4_outer(C.byref(self.st),
                                       C.byref(self._dictst),
                                       self._table, self._table_len,
                                       self._cb)
                self._to_vm()
                if self._check_fault():
                    break
                if rc == self.OUT_HOLD:
                    break
                if rc == self.OUT_REENTER:
                    continue
                if rc == self.OUT_DONE:
                    break
                idiom = sys_.fetch()                     # OUT_TOKEN
                if idiom is None:
                    break
                if vm.pre(idiom):
                    continue
                if not self._py_token(idiom):
                    break
                if vm.state == VMState.HOLD:
                    break
        finally:
            (self._line_buf, self.st.in_, self.st.in_len,
             self._outer_active) = prev_state
        vm.post()

    def _py_token(self, idiom: str) -> bool:
        """one python-side token step (mirrors VM.outer's error path)"""
        from ..vm.vm import VMState
        vm = self.vm
        if not vm.process(idiom):
            vm.sys.perr(idiom, "? ")
            vm.sys.clrbuf()
            vm.compile = False
            vm.state = VMState.QUERY
            return False
        return True
