"""MMU — memory/object controller (the port of tensorforth_tpu/mu/mmu.py).

Owns: the dictionary, parameter memory, the object table (tagged-DU
handle -> Tensor/Model), the deferred-free (mark/sweep) list, and the
byte accounting behind ``mstat``.

Reference: src/mu/mmu.{h,cu}.  Where the reference sub-allocates a CUDA
managed arena with a TLSF allocator, device memory here is owned by
PyTorch's caching allocator; the MMU keeps the same object-handle scheme
and counts bytes in Python.  The native TLSF accounting (csrc/t4alloc)
comes with the native slice and the device arena with its own, so
``mstat`` prints the reference's plain ``Ostore used/peak/alloc#`` line.

``device`` is where the tensor words make their tensors: None means the
package default (``cuda``; it raises without a GPU), the CLI sets it.
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
        # free_obj recurses into grad chains -> RLock
        self._mlock = threading.RLock()

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
        return obj

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
        sys.pstr(f"\\   Ostore used[{self._alloc_bytes}] "
                 f"peak[{self._peak_bytes}] alloc#[{self._num_alloc}]\n")

    def clear(self, i: int):
        self.dict.clear(i)
