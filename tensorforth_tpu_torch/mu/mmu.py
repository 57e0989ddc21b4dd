"""MMU — object registry (the port of tensorforth_tpu/mu/mmu.py).

Keeps the reference's object-handle scheme: every tensor and model gets
an oid and a slot in the object table.  Parameter memory, the dictionary
and the native TLSF accounting (mmu.py:27-53 of the JAX package) come
with the REPL slice.
"""
from __future__ import annotations

import threading

from .tensor import Tensor


class MMU:
    _inst = None

    def __init__(self):
        self._objs: dict[int, object] = {}
        self._next_id = 1
        self._mlock = threading.Lock()

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
        return obj

    # --- factories -----------------------------------------------------------
    def tensor(self, *dims, device=None) -> Tensor:
        """payload materializes lazily on first read"""
        return self.register(Tensor(*dims, device=device))

    def model(self, device=None):
        from ..nn.model import Model
        return self.register(Model(self, device=device))
