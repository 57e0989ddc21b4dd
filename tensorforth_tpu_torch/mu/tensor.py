"""Tensor — rank-1/2/4 row-major NHWC f32 tensor object backed by a torch
tensor on an explicit device (the port of tensorforth_tpu/mu/tensor.py;
the HBM-arena fields come with the arena slice).

The header (shape/rank/grad slots/stride/params) lives on the host; the
payload is a ``torch.Tensor`` of the logical shape, made lazily on first
read.  "Destructive" reference semantics are realized by swapping the
payload in place, so stack views (which alias the same Tensor object)
observe mutations exactly like the reference's shared-pointer views.
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
        self.data: torch.Tensor | None = None  # payload, logical shape
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
    def ensure_data(self) -> torch.Tensor:
        if self.data is None:
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
        if self.data is not None:
            self.data = self.data.reshape(dims)
        self.shape = dims
        self.rank = len(dims)
        return self

    def __repr__(self):
        t = "TND?"[self.ttype]
        return f"<{t}{self.rank}{list(self.shape)} oid={self.oid}>"
