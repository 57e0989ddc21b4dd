"""MMU — memory/object controller (the port of tensorforth_tpu/mu/mmu.py).

Owns: the dictionary, parameter memory, the object table (tagged-DU
handle -> Tensor/Model/Dataset/Future), the deferred-free (mark/sweep)
list, and the byte accounting behind ``mstat``.

Reference: src/mu/mmu.{h,cu}, which sub-allocates a CUDA managed arena
with a TLSF allocator.  The native TLSF (csrc/t4alloc through
runtime/native.get_alloc) hands out the offsets of an arena of
Config.OSTORE_SZ bytes.  By default device memory is owned by PyTorch's
caching allocator and the TLSF is accounting only (``mstat`` prints
``Ostore(TLSF:accounting)``).  With ``T4_ARENA=1`` (Config.ARENA) the
TLSF is the owner: one device buffer of that size (mu/arena.py), each
tensor payload a view of it at the TLSF's offset (``Ostore(TLSF:owner)``,
and the payloads the pool owns against those PyTorch still does).  The
fused word ops (``arena_matmul``, ``arena_binop_tt``, ``arena_binop_ts``,
``arena_fill``) compute into the output's view.  Without the native
library (T4_NO_NATIVE=1, no compiler) there is no TLSF and no arena, and
``mstat`` prints the plain ``Ostore used/peak/alloc#`` line.

``device`` is where the tensor words make their tensors, datasets keep
their corpus and futures their values: None means the package default
(``cuda``; it raises without a GPU), the CLI sets it.
"""
from __future__ import annotations

import threading
import warnings

import numpy as np

from ..config import Config
from ..du import IS_OBJ, IS_VIEW, mk_obj, obj_id
from ..vm.dict import Dictionary
from ..vm.pmem import PMem
from .tensor import Tensor


class MMU:
    _inst = None

    def __init__(self, device=None):
        self.device = device
        self.pmem = PMem()
        self.dict = Dictionary(self.pmem)
        self._objs: dict[int, object] = {}
        self._next_id = 1
        self._marked: list[int] = []
        self._alloc_bytes = 0
        self._peak_bytes = 0
        self._num_alloc = 0
        self._regsz: dict[int, int] = {}      # oid -> bytes at register
        # task VM threads share this MMU: object-table mutation must be
        # atomic (free_obj recurses into grad chains -> RLock)
        self._mlock = threading.RLock()
        # native TLSF accounting (csrc/t4alloc; reference mu/tlsf)
        from ..runtime.native import get_alloc
        self._tlsf = get_alloc()
        if self._tlsf is not None:
            self._tlsf.t4_tlsf_init(Config.OSTORE_SZ)
        self._offs: dict[int, int] = {}       # oid -> arena byte offset
        self._arena = None
        self._arena_on = bool(Config.ARENA and self._tlsf is not None)
        if Config.ARENA and self._tlsf is None:
            warnings.warn("T4_ARENA=1 needs the native TLSF (csrc/t4alloc), "
                          "which did not load: payloads stay the caching "
                          "allocator's", RuntimeWarning, stacklevel=2)

    @property
    def arena(self):
        """the device pool under T4_ARENA=1 (None otherwise), made on the
        MMU's device at its first use: the CLI sets the device after it
        made the MMU"""
        if self._arena is None and self._arena_on:
            from ..config import resolve_device
            from .arena import DeviceArena
            self._arena = DeviceArena(Config.OSTORE_SZ,
                                      resolve_device(self.device))
        return self._arena

    @classmethod
    def get_mmu(cls) -> "MMU":
        if cls._inst is None:
            cls._inst = MMU()
        return cls._inst

    @classmethod
    def free_mmu(cls):
        cls._inst = None

    # --- handle scheme ------------------------------------------------------
    def register(self, obj):
        with self._mlock:
            obj.oid = self._next_id
            self._next_id += 1
            self._objs[obj.oid] = obj
            self._num_alloc += 1
            # stash the registered size: models grow after registration,
            # and free must subtract what was ADDED or mstat drifts
            nbytes = obj.numel * 4
            self._regsz[obj.oid] = nbytes
            self._alloc_bytes += nbytes
            self._peak_bytes = max(self._peak_bytes, self._alloc_bytes)
            self._tlsf_malloc(obj, nbytes)
        return obj

    _TLSF_NONE = (1 << 64) - 1               # t4_tlsf_malloc: no block

    def _tlsf_malloc(self, obj, nbytes: int, bind: bool = False):
        """take the object's arena offset (models and futures own no
        payload of their own and take none); under the arena a tensor's
        payload (a dataset's too, when `bind`) moves into the pool"""
        if self._tlsf is None or obj.is_model() or obj.is_future():
            return
        off = self._tlsf.t4_tlsf_malloc(max(nbytes, 4))
        if off != self._TLSF_NONE:
            self._offs[obj.oid] = off
            if self.arena is not None and (obj.is_tensor() or bind):
                self._bind(obj, off // 4)

    def _bind(self, obj, woff: int):
        """the payload into the pool at `woff` (a fresh slot is zeroed on
        its first read: a factory's result is mostly overwritten)"""
        obj.aoff = woff
        if obj.data is not None:
            d = obj.data
            obj.data = None
            obj.replace_data(d)
        else:
            obj._ainit = False

    def _tlsf_free(self, oid: int):
        off = self._offs.pop(oid, None)     # none without the library
        if off is not None:
            self._tlsf.t4_tlsf_free(off)
        obj = self._objs.get(oid)
        if obj is not None and getattr(obj, "aoff", None) is not None:
            obj.aoff = None                 # the slot goes back to the TLSF
            obj.data = None                 # and no view of it stays

    def rebind(self, obj):
        """re-dimension support: account the object at its CURRENT numel
        (a dataset learns its real shape on its first fetch, after it
        was registered; reference dataset.cu:64-121); under the arena
        its batch moves into the pool at the new slot"""
        with self._mlock:
            if obj.oid not in self._objs:
                return
            nbytes = obj.numel * 4
            self._alloc_bytes += nbytes - self._regsz.get(obj.oid, 0)
            self._regsz[obj.oid] = nbytes
            self._peak_bytes = max(self._peak_bytes, self._alloc_bytes)
            d = obj.data
            if d is not None and self.arena is not None \
                    and self.arena.owns(d):
                d = d.clone()               # the new slot may overlap
            self._tlsf_free(obj.oid)
            obj.data = d
            self._tlsf_malloc(obj, nbytes, bind=True)

    def du2obj(self, v):
        return self._objs.get(obj_id(v))

    def obj2du(self, obj) -> np.float32:
        return mk_obj(obj.oid)

    # --- factories -----------------------------------------------------------
    def tensor(self, *dims, device=None) -> Tensor:
        """payload materializes lazily on first read: factory-then-
        overwrite patterns (matmul results, literal capture) never
        allocate the zeros"""
        return self.register(Tensor(
            *dims, device=self.device if device is None else device))

    def model(self, device=None):
        from ..nn.model import Model
        return self.register(Model(
            self, device=self.device if device is None else device))

    def dataset(self, batch_sz: int, device=None):
        from .dataset import Dataset
        return self.register(Dataset(
            batch_sz, device=self.device if device is None else device))

    def future(self, data, pending=None):
        """deferred device scalar (mu/future.py): resolves on host use;
        pending=list makes it a lazy sum (`+!` chains)"""
        from .future import Future
        return self.register(Future(data, pending))

    def copy(self, src: Tensor) -> Tensor:
        """deep copy of payload + shape (not grads)"""
        t = Tensor(*src.shape, device=src.device)
        t.replace_data(src.ensure_data())     # payloads are mutable: copy
        t.stride = list(src.stride)
        t.xparm = src.xparm
        t.iparm = src.iparm
        return self.register(t)

    def slice(self, t0: Tensor, x0: int, x1: int, y0: int, y1: int) -> Tensor:
        t1 = Tensor(y1 - y0, x1 - x0, device=t0.device)
        t1.replace_data(t0.ensure_data()[y0:y1, x0:x1])
        return self.register(t1)

    # --- free / sweep ----------------------------------------------------------
    def free_obj(self, obj):
        with self._mlock:
            if obj is None or obj.oid not in self._objs:
                return
            self._alloc_bytes -= self._regsz.pop(obj.oid, obj.numel * 4)
            self._tlsf_free(obj.oid)
            del self._objs[obj.oid]
            # free grad/momentum chains (reference mmu.cu:247-265)
            if isinstance(obj, Tensor):
                for g in list(obj.grad) + list(obj.mtum):
                    if isinstance(g, Tensor) and g is not obj \
                            and g.oid in self._objs:
                        self.free_obj(g)
                obj.data = None
            elif obj.is_model():
                # all layer tensors + onehot (reference mmu free(Model&))
                for t in list(obj.data) + [obj._hot]:
                    if isinstance(t, Tensor) and t.oid in self._objs:
                        self.free_obj(t)
                obj.data = []
            # a future holds a 0-d value and no other object: nothing more

    # --- fused in-pool compute (reference: ops on arena payloads) -----------
    def _arena_ready(self, *ts) -> bool:
        """every tensor's payload is the pool's (its view, or not made
        yet): a payload set apart from `replace_data` is PyTorch's, and
        the word takes its torch path"""
        ar = self.arena
        return ar is not None and all(
            t is not None and t.aoff is not None
            and (t.data is None or t.data.data_ptr()
                 == ar.buf.data_ptr() + 4 * t.aoff) for t in ts)

    @staticmethod
    def _arena_in(*ts):
        """operands hold defined data (a fresh slot is zeroed now)"""
        for t in ts:
            t.ensure_data()

    def _arena_out(self, t):
        t.data = self.arena.read(t.aoff, t.shape)
        t._ainit = True

    def arena_matmul(self, C, A, B) -> bool:
        """C = A @ B into C's view of the pool"""
        if not self._arena_ready(C, A, B) or A.rank != 2 or B.rank != 2:
            return False
        self._arena_in(A, B)
        self.arena.matmul(A.aoff, A.shape, B.aoff, B.shape, C.aoff)
        self._arena_out(C)
        return True

    def arena_binop_tt(self, name: str, O, A, B) -> bool:
        if not self._arena_ready(O, A, B):
            return False
        self._arena_in(A, B)
        self.arena.binop_tt(name, A.aoff, A.shape, B.aoff, B.shape,
                            O.aoff, O.shape)
        self._arena_out(O)
        return True

    def arena_binop_ts(self, name: str, O, A, v: float,
                       flip: bool = False) -> bool:
        if not self._arena_ready(O, A):
            return False
        self._arena_in(A)
        self.arena.binop_ts(name, A.aoff, A.shape, float(v), O.aoff,
                            O.shape, flip)
        self._arena_out(O)
        return True

    def arena_fill(self, T, v: float) -> bool:
        if not self._arena_ready(T):
            return False
        self.arena.fill(T.aoff, float(v), T.numel)
        self._arena_out(T)
        return True

    def mark_free(self, v):
        """deferred free — swept per REPL cycle (reference mmu.cu:169-196)"""
        if IS_OBJ(v) and not IS_VIEW(v):
            with self._mlock:
                self._marked.append(obj_id(v))

    def sweep(self):
        with self._mlock:
            marked, self._marked = self._marked, []
        for oid in marked:
            self.free_obj(self._objs.get(oid))

    def rd(self, i: int):
        return self.pmem.rd_du(i)

    # --- stats (mstat) -------------------------------------------------------------
    def status(self, hdr: bool = False):
        from ..system import System
        sys = System.get_sys()
        if hdr:
            sys.pstr(
                f"\\ MMU.stat dict[{len(self.dict)}/{Config.DICT_SZ}], "
                f"pmem[{self.pmem.here}]="
                f"{100.0 * self.pmem.here / self.pmem.size:0.1f}%, "
                f"tfree[{len(self._marked)}/{Config.TFREE_SZ}]\n")
        sys.pstr(f"\\   Mpool obj#used[{len(self._objs)}] "
                 f"id#next[{self._next_id}]\n")
        if self._tlsf is None:
            sys.pstr(f"\\   Ostore used[{self._alloc_bytes}] "
                     f"peak[{self._peak_bytes}] "
                     f"alloc#[{self._num_alloc}]\n")
            return
        import ctypes
        st = (ctypes.c_uint64 * 5)()
        self._tlsf.t4_tlsf_status(st)
        kind = "owner" if self.arena is not None else "accounting"
        sys.pstr(f"\\   Ostore(TLSF:{kind}) arena[{st[0]}] "
                 f"used[{st[1]}] peak[{st[2]}] alloc#[{st[3]}] "
                 f"free#[{st[4]}]\n")
        # under the arena a payload bound into the pool (its view, or not
        # made yet) is the pool's; any other payload is PyTorch's and only
        # tracked by the TLSF
        own, torch_owned = self.payloads()
        sys.pstr(f"\\   payloads pool-owned[{len(own)}]={sum(own)}B "
                 f"torch-owned[{len(torch_owned)}]={sum(torch_owned)}B\n")

    def payloads(self):
        """(pool-owned, torch-owned) payload byte counts of live objects"""
        own, other = [], []
        with self._mlock:
            for o in self._objs.values():
                if o.is_model() or o.is_future():
                    continue
                nb = o.numel * 4
                if self._arena_ready(o):
                    own.append(nb)
                else:
                    other.append(nb)
        return own, other

    def clear(self, i: int):
        self.dict.clear(i)
