"""MMU — memory/object controller (the port of tensorforth_tpu/mu/mmu.py).

Owns: the dictionary, parameter memory, the object table (tagged-DU
handle -> Tensor/Model/Dataset/Future), the deferred-free (mark/sweep)
list, and the byte accounting behind ``mstat``.

Reference: src/mu/mmu.{h,cu}.  Where the reference sub-allocates a CUDA
managed arena with a TLSF allocator, device memory here is owned by
PyTorch's caching allocator; the MMU keeps the same object-handle scheme
and byte accounting (``mstat``) on top of it.  The native TLSF
(csrc/t4alloc through runtime/native.get_alloc) tracks the offsets a
2 GB arena (Config.OSTORE_SZ) would hand the tensors, as accounting only:
it owns no memory, and ``mstat`` prints its ``Ostore(TLSF:accounting)``
line.  Without the native library (T4_NO_NATIVE=1, no compiler) it
prints the plain ``Ostore used/peak/alloc#`` line.

``device`` is where the tensor words make their tensors, datasets keep
their corpus and futures their values: None means the package default
(``cuda``; it raises without a GPU), the CLI sets it.
"""
from __future__ import annotations

import threading

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

    def _tlsf_malloc(self, obj, nbytes: int):
        """take the object's arena offset (models and futures own no
        payload of their own and take none)"""
        if self._tlsf is None or obj.is_model() or obj.is_future():
            return
        off = self._tlsf.t4_tlsf_malloc(max(nbytes, 4))
        if off != self._TLSF_NONE:
            self._offs[obj.oid] = off

    def _tlsf_free(self, oid: int):
        off = self._offs.pop(oid, None)     # none without the library
        if off is not None:
            self._tlsf.t4_tlsf_free(off)

    def rebind(self, obj):
        """re-dimension support: account the object at its CURRENT numel
        (a dataset learns its real shape on its first fetch, after it
        was registered; reference dataset.cu:64-121)"""
        with self._mlock:
            if obj.oid not in self._objs:
                return
            nbytes = obj.numel * 4
            self._alloc_bytes += nbytes - self._regsz.get(obj.oid, 0)
            self._regsz[obj.oid] = nbytes
            self._peak_bytes = max(self._peak_bytes, self._alloc_bytes)
            self._tlsf_free(obj.oid)
            self._tlsf_malloc(obj, nbytes)

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
        sys.pstr(f"\\   Ostore(TLSF:accounting) arena[{st[0]}] "
                 f"used[{st[1]}] peak[{st[2]}] alloc#[{st[3]}] "
                 f"free#[{st[4]}]\n")
        # the TLSF owns no memory here: every payload is PyTorch's
        with self._mlock:
            live = [o.numel * 4 for o in self._objs.values()
                    if not (o.is_model() or o.is_future())]
        sys.pstr(f"\\   payloads pool-owned[0]=0B "
                 f"torch-owned[{len(live)}]={sum(live)}B\n")

    def clear(self, i: int):
        self.dict.clear(i)
