"""Deferred device scalars ("futures"; the port of
tensorforth_tpu/mu/future.py).

A Future is a tagged stack object (the same NaN-boxed handle scheme as
tensors, du.py) wrapping a 0-d tensor on the MMU's device that has been
computed but not read back.  The words that produce one (`loss.ce`,
`nn.hit`, `sum`, `avg`, `std`, `norm`) push a Future instead of reading
the value; scalar arithmetic on futures stays on the device; the value
is read only when the host needs it: printing (`.`), comparisons,
control flow, int conversion.  On the card no word between two such
reads synchronizes, so the canonical training loop (examples/t4_30e.4th
`for forward loss.ce lox ! nn.hit hit +! backprop nn.adam next`) reads
back once per epoch, at its `stat` print.

The reference (src/vm/netvm.cpp) reads `loss.ce` synchronously: its
kernels and its host share one address space.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.xla_reduce import xla_sum

# the err-bit NaN sentinel (nn/model.py sets it to Model._nan_alarm):
# called whenever a non-finite scalar is read back to the host, so that a
# NaN made inside a trace chunk stops the loop at the faulting batch, as
# the reference's err bit does, instead of flowing on unseen
NAN_HOOK = None


class LazyIdx:
    """deferred element `vec[i]` of a device vector: a lazy sum of
    LazyIdx addends over one vector collapses into one sum of its
    elements (the whole vector when the indices cover it).  The trace
    chunk's per-batch loss and hit vectors are served this way; each
    chunk hands out vectors of its own, which no later replay writes."""
    __slots__ = ("vec", "i")

    def __init__(self, vec, i: int):
        self.vec = vec
        self.i = int(i)


def _collapse_lazy(host: float, devs: list, lazies: list):
    """one device expression for (host + sum(devs) + sum(vec[i]...))"""
    groups: dict = {}
    for a in lazies:
        groups.setdefault(id(a.vec), (a.vec, []))[1].append(a.i)
    for vec, idxs in groups.values():
        if len(idxs) == int(vec.shape[0]) and sorted(idxs) == list(
                range(int(vec.shape[0]))):
            devs.append(xla_sum(vec))
        elif len(idxs) == 1:
            devs.append(vec[idxs[0]])
        else:
            devs.append(xla_sum(vec[torch.as_tensor(idxs,
                                                    device=vec.device)]))
    if devs:
        d = devs[0] if len(devs) == 1 else xla_sum(torch.stack(
            [torch.as_tensor(x, dtype=torch.float32) for x in devs]))
        return d + float(np.float32(host)) if host else d
    return np.float32(host)


class Future:
    """0-d device scalar pending host materialization.

    When ``pending`` is set (a list of addends, each a 0-d tensor or a
    host number) the future is a lazy sum: `+!` accumulation (the
    per-batch `nn.hit hit +!` counter) costs no device work per batch;
    the chain collapses into one sum on its first real use (typically
    the end-of-epoch `hit @ .`)."""
    __slots__ = ("data", "oid", "pending")

    def __init__(self, data, pending=None):
        self.data = data          # 0-d tensor, np scalar, or python number
        self.pending = pending    # lazy-sum addend list (data is None)
        self.oid = 0

    # --- the object duck-type of the MMU's table --------------------------
    @property
    def numel(self) -> int:
        return 1

    def is_tensor(self) -> bool:
        return False

    def is_model(self) -> bool:
        return False

    def is_dataset(self) -> bool:
        return False

    def is_future(self) -> bool:
        return True

    # --- resolution ---------------------------------------------------------
    def dev(self):
        """the value on the device: collapses a lazy sum (one sum of all
        accumulated addends) without reading it back"""
        if self.pending is not None:
            host = 0.0
            devs, lazies = [], []
            for a in self.pending:
                if isinstance(a, (int, float, np.floating, np.integer)):
                    host += float(a)
                elif isinstance(a, LazyIdx):
                    lazies.append(a)
                else:
                    devs.append(a)
            self.data = _collapse_lazy(host, devs, lazies)
            self.pending = None
        elif isinstance(self.data, LazyIdx):
            self.data = self.data.vec[self.data.i]
        return self.data

    def value(self) -> float:
        """read back: device -> host float32"""
        v = float(np.float32(float(self.dev())))
        if not math.isfinite(v) and NAN_HOOK is not None:
            NAN_HOOK()
        return v

    def __repr__(self):
        return f"Future(oid={self.oid})"
