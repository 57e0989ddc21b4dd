"""Device arena: tensor payloads live at TLSF offsets inside ONE flat f32
buffer on the MMU's device (the port of tensorforth_tpu/mu/arena.py).

Reference: src/mu/mmu.cu:37-53 + tlsf.cpp, where the CUDA build
sub-allocates every tensor payload from one managed arena.  With
`T4_ARENA=1` the MMU allocates `Config.OSTORE_SZ` bytes once, the native
TLSF (csrc/t4alloc through runtime/native.get_alloc) hands out the
offsets, and a payload is a view of the buffer at its offset: reads and
writes are the view's own.

The fused word ops (`binop_tt`, `binop_ts`, `matmul`, `fill`) read their
operands' views and leave the result in the output's view: `matmul` is
`torch.matmul(a, b, out=view)` (cuBLAS f32, TF32 off on the card, the
counterpart of the JAX package's `jnp.dot`); the elementwise ops are the
engine's own `ten_op_tt` / `_bin_op`, whose result (a tensor of the
caching allocator) is copied into the view.  The TLSF hands out
disjoint slots, so an output view never overlaps a live operand's;
`matmul` checks it all the same, since `out=` with an aliased operand
would be undefined.

The arena's work is queued on the device's one stream like any other, so
`engine.sync` (the `clock` word's barrier) covers it with no hook of its
own.  A lock keeps the
read-compute-write of the fused ops atomic across the task VMs' threads.
"""
from __future__ import annotations

import threading

import torch


class DeviceArena:
    """one preallocated device buffer; offsets in f32 words"""

    def __init__(self, n_bytes: int, device):
        self.n_words = n_bytes // 4
        self.device = torch.device(device)
        self.buf = torch.zeros(self.n_words, dtype=torch.float32,
                               device=self.device)
        self._lock = threading.Lock()

    # --- views ---------------------------------------------------------------
    def view(self, woff: int, shape) -> torch.Tensor:
        n = 1
        for d in shape:
            n *= int(d)
        if woff < 0 or woff + n > self.n_words:
            raise IndexError(f"arena view [{woff}, {woff + n}) outside "
                             f"{self.n_words} words")
        return self.buf[woff:woff + n].view(tuple(shape))

    def owns(self, t) -> bool:
        """is `t` a view of the pool (not a payload of its own)?"""
        return (isinstance(t, torch.Tensor)
                and t.device == self.buf.device
                and t.untyped_storage().data_ptr()
                == self.buf.untyped_storage().data_ptr())

    def pointer(self) -> int:
        """the pool's address: stable for the arena's life"""
        return self.buf.data_ptr()

    # --- choke points --------------------------------------------------------
    def write(self, woff: int, arr) -> torch.Tensor:
        src = torch.as_tensor(arr).to(device=self.device,
                                      dtype=torch.float32).reshape(-1)
        with self._lock:
            v = self.view(woff, (src.numel(),))
            v.copy_(src)
        return v

    def read(self, woff: int, shape) -> torch.Tensor:
        return self.view(woff, shape)

    def fill(self, woff: int, v: float, numel: int):
        with self._lock:
            self.view(woff, (numel,)).fill_(float(v))

    # --- fused ops (read, compute, write in place) -----------------------------
    def binop_tt(self, op: str, offa, sa, offb, sb, offo, so):
        from ..ops.engine import ten_op_tt
        with self._lock:
            r = ten_op_tt(op, self.view(offa, sa), self.view(offb, sb),
                          tuple(so))
            self.view(offo, so).copy_(r.reshape(tuple(so)))

    def binop_ts(self, op: str, offa, sa, v: float, offo, so,
                 flip: bool = False):
        from ..ops.engine import ten_op_st, ten_op_ts
        with self._lock:
            a = self.view(offa, sa)
            r = ten_op_st(op, v, a) if flip else ten_op_ts(op, a, v)
            self.view(offo, so).copy_(r.reshape(tuple(so)))

    def matmul(self, offa, sa, offb, sb, offo):
        so = (int(sa[0]), int(sb[1]))
        no = so[0] * so[1]
        for off, s in ((offa, sa), (offb, sb)):
            n = int(s[0]) * int(s[1])
            if offo < off + n and off < offo + no:
                raise ValueError("arena matmul: output slot overlaps an "
                                 "operand")
        with self._lock:
            torch.matmul(self.view(offa, sa), self.view(offb, sb),
                         out=self.view(offo, so))
