"""Tensor — rank-1/2/4 row-major NHWC f32 tensor object backed by a torch
tensor on an explicit device (the port of tensorforth_tpu/mu/tensor.py).

The header (shape/rank/grad slots/stride/params) lives on the host; the
payload is a ``torch.Tensor`` of the logical shape, made lazily on first
read.  "Destructive" reference semantics are realized by swapping the
payload in place, so stack views (which alias the same Tensor object)
observe mutations exactly like the reference's shared-pointer views.

Under the device arena (`T4_ARENA=1`, mu/arena.py) a registered tensor
has a word offset `aoff` in the pool and its payload is the pool's view
there: made on first read (zeroed then, `_ainit`), written in place by
`replace_data`.

Under the word path's mesh (nn/funcs.word_mesh) a tensor of a model may
hold only a rank's part of its payload (`set_local`, `local`): a `spec`
names the part (`part(whole)`) and how the ranks put it back together
(`whole(part)`, a collective every rank calls at the same point, which
the REPL's ranks do: they run the same words).  `ensure_data` puts a
sharded payload back together first, so every reader outside the word
path sees the whole tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


class T4Type:
    TENSOR, MODEL, DATASET, XXX = range(4)


class Tensor:
    """host header + device payload"""

    def __init__(self, *dims, oid: int = 0, device=None):
        dims = tuple(int(d) for d in dims)
        if len(dims) not in (1, 2, 4):
            raise ValueError(f"rank {len(dims)} not supported")
        self.oid = oid
        self.ttype = T4Type.TENSOR
        self.rank = len(dims)
        self.shape = dims
        self.device = resolve_device(device)
        self._shard = None                 # (a rank's part, its spec)
        self.data: torch.Tensor | None = None  # payload, logical shape
        self.aoff = None                   # device-arena word offset
        self._ainit = True                 # arena slot holds defined data
        # layer-tensor extensions (reference tensor.h:53-57)
        self.grad_fn = None                # t4_layer tag when part of a model
        self.grad = [None] * 5             # w, b, dw, db, extra(mask/xhat)
        self.mtum = [None] * 5             # momentum/velocity (+tmp)
        self.stride = [1, 1, 1, 1]         # conv stride/padding storage
        self.xparm = 0.0
        self.iparm = 0
        self.train = 1

    # --- dimensional accessors (reference NHWC) ---------------------------
    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def N(self) -> int:
        return self.shape[0] if self.rank == 4 else 1

    def H(self) -> int:
        if self.rank == 4:
            return self.shape[1]
        if self.rank == 2:
            return self.shape[0]
        return 1

    def W(self) -> int:
        if self.rank == 4:
            return self.shape[2]
        if self.rank == 2:
            return self.shape[1]
        return self.numel

    def C(self) -> int:
        return self.shape[3] if self.rank == 4 else 1

    def HWC(self) -> int:
        return self.numel // self.N()

    def is_tensor(self) -> bool:
        return self.ttype == T4Type.TENSOR

    def is_model(self) -> bool:
        return self.ttype == T4Type.MODEL

    def is_dataset(self) -> bool:
        return self.ttype == T4Type.DATASET

    def is_future(self) -> bool:
        return False

    def is_same_shape(self, other: "Tensor") -> bool:
        return self.shape == other.shape

    # --- payload management ------------------------------------------------
    @property
    def data(self) -> torch.Tensor | None:
        """the whole payload (None while unmade or sharded)"""
        return self._data

    @data.setter
    def data(self, v):
        self._data = v
        self._shard = None

    def local(self, spec) -> torch.Tensor:
        """this rank's part of the payload under `spec` (None: the whole
        payload); a whole payload is cut to the part, which is kept"""
        if spec is None:
            return self.ensure_data()
        if self._shard is not None:
            if self._shard[1] == spec:
                return self._shard[0]
        part = spec.part(self.ensure_data()).clone()
        self._data, self._shard = None, (part, spec)
        return part

    def set_local(self, arr, spec) -> "Tensor":
        """the payload as this rank's part under `spec` (a copy; None:
        replace_data)"""
        if spec is None:
            return self.replace_data(arr)
        part = torch.as_tensor(arr).to(device=self.device,
                                       dtype=torch.float32, copy=True)
        self._data = None
        self._shard = (part.reshape(spec.shape(self.shape)), spec)
        return self

    def _arena(self):
        if self.aoff is None:
            return None
        from .mmu import MMU
        return MMU.get_mmu().arena

    def ensure_data(self) -> torch.Tensor:
        if self._shard is not None:        # the ranks' parts put together
            part, spec = self._shard
            self.replace_data(spec.whole(part))
        if self.data is None:
            ar = self._arena()
            if ar is not None:             # the payload is the pool's view
                self.data = ar.read(self.aoff, self.shape)
                if not self._ainit:        # a fresh slot is zeroed lazily
                    ar.fill(self.aoff, 0.0, self.numel)
                    self._ainit = True
                return self.data
            self.data = torch.zeros(self.shape, dtype=torch.float32,
                                    device=self.device)
        return self.data

    def data_as(self, *shape) -> torch.Tensor:
        """ensure_data() viewed as `shape` (a view: no copy, no launch)"""
        return self.ensure_data().view(shape)

    def replace_data(self, arr: torch.Tensor) -> "Tensor":
        """destructive update — views alias this object and see the
        change.  The payload is a copy: torch tensors are mutable, so
        sharing the caller's storage would let its in-place writes leak
        in (the JAX package could alias its immutable arrays)."""
        ar = self._arena()
        if ar is not None:                 # in place, into the pool
            src = torch.as_tensor(arr)
            if src.numel() != self.numel:
                raise ValueError(f"replace_data: {src.numel()} values for "
                                 f"{self.shape}")
            self.data = ar.write(self.aoff, src).view(self.shape)
            self._ainit = True
            return self
        arr = torch.as_tensor(arr).to(device=self.device,
                                      dtype=torch.float32, copy=True)
        self.data = arr.reshape(self.shape)
        return self

    def numpy(self) -> np.ndarray:
        """host copy of the payload (never an alias: the optimizers
        update payloads in place, so no host mirror is kept)"""
        return self.ensure_data().detach().cpu().numpy().copy()

    def set_numpy(self, a) -> "Tensor":
        a = np.ascontiguousarray(a, dtype=np.float32)
        if a.size != self.numel:
            raise ValueError(f"set_numpy: {a.size} values for {self.shape}")
        return self.replace_data(torch.from_numpy(a))

    # --- reshape (header and payload view; no copy) --------------------------
    def reshape(self, *dims) -> "Tensor":
        dims = tuple(int(d) for d in dims)
        n = 1
        for d in dims:
            n *= d
        if n != self.numel:
            raise ValueError(f"reshape {self.shape} -> {dims} numel mismatch")
        if self._shard is not None:        # a part's shape is not dims
            self.ensure_data()
        if self.data is not None:
            self.data = self.data.reshape(dims)
        self.shape = dims
        self.rank = len(dims)
        return self

    def __repr__(self):
        t = "TND?"[self.ttype]
        return f"<{t}{self.rank}{list(self.shape)} oid={self.oid}>"
