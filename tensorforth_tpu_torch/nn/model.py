"""Model — sequential NN container, construction only (the port of the
layer factory in tensorforth_tpu/nn/model.py:213-517).

Holds per-layer activation Tensors like the reference; layer j's
parameters sit in ``self[j].grad[0]`` and ``.grad[1]``.  ``_program()``
and ``_params()`` return what the JAX package's do, so nn/funcs.py and
nn/serve.py read a model the same way.  Forward, backprop, the
optimizers and the fused-cycle/chunk machinery come with the training
slice; so do the gradient slots (grad[2..4]) the factories leave empty.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Config, resolve_device
from ..mu.tensor import T4Type, Tensor
from .ntypes import Layer

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)


class Model:
    def __init__(self, mmu, device=None):
        self.oid = 0
        self.ttype = T4Type.MODEL
        self.data: list[Tensor] = []          # layer tensors (activations)
        self.device = resolve_device(device)
        self._mmu = mmu

    @property
    def numel(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int) -> Tensor:
        return self.data[i if i >= 0 else self.numel + i]

    def npush(self, t: Tensor) -> "Model":
        self.data.append(t)
        return self

    # --- tensor helpers -------------------------------------------------------
    def _T4(self, *dims) -> Tensor:
        return self._mmu.tensor(*dims, device=self.device)

    def _rand(self, t: Tensor, scale: float):
        """uniform init in [-scale, scale) (reference Model::RAND)"""
        from ..system import System
        System.get_sys().rand_fill(t, "uniform", bias=-0.5, scale=scale * 2.0)

    # =========================================================================
    # layer factory (reference Model::add, model.cpp:83-310)
    # =========================================================================
    def add(self, fn: int, n: int = 0, bias: float = 0.0, opt=None) -> "Model":
        t_in = self[-1]
        if t_in.grad_fn is not None:
            return self
        if fn in _ACTS:
            self._iactivate(t_in, bias)
        elif fn == Layer.SOFTMAX:
            self._isoftmax(t_in)
        elif fn == Layer.ATTN:
            self._iattn(t_in, int(n), int(bias))
        elif fn == Layer.LNORM:
            self._ilnorm(t_in, bias)
        elif fn == Layer.EMBED:
            self._iembed(t_in, int(n), bias)
        elif fn == Layer.PROJ:
            self._iproj(t_in, int(n), bias)
        else:
            raise NotImplementedError(
                f"Model#add: layer '{Layer.NAMES[fn].strip()}' is not "
                f"ported yet")
        t_in.grad_fn = fn
        return self

    def _isoftmax(self, t_in: Tensor):
        self.npush(self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C()))

    def _iactivate(self, t_in: Tensor, alpha: float):
        t_in.xparm = alpha
        self.npush(self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C()))

    def _iattn(self, t_in: Tensor, heads: int, flags: int = 0):
        """multi-head self-attention layer: input [N,S,E,1]; wqkv
        [1,3E,E,1] in the weight slot, wo [1,E,E,1] in the bias slot.
        flags bit0 = causal mask, bit1 = rotary position embedding"""
        N1, S = t_in.N(), t_in.H()
        E = t_in.W() * t_in.C()
        if heads < 1 or E % heads:
            raise ValueError(f"attn E={E} not divisible by heads={heads}")
        if (flags & 2) and (E // heads) % 2:
            raise ValueError(f"attn rope needs even head dim, got {E // heads}")
        wqkv = self._T4(1, 3 * E, E, 1)
        wo = self._T4(1, E, E, 1)
        t_in.grad[0], t_in.grad[1] = wqkv, wo
        t_in.iparm = heads
        t_in.xparm = float(flags & 3)
        k = math.sqrt(1.0 / (2 * E))
        if Config.MM_DEBUG:
            wqkv.set_numpy(np.full(wqkv.numel, 0.5, np.float32))
            wo.set_numpy(np.full(wo.numel, 0.5, np.float32))
        else:
            self._rand(wqkv, k)
            self._rand(wo, k)
        self.npush(self._T4(N1, S, E, 1))

    def _ilnorm(self, t_in: Tensor, eps: float):
        """layer normalization over the feature axis (W*C), learnable
        gamma/beta"""
        E = t_in.W() * t_in.C()
        g = self._T4(E)
        g.set_numpy(np.ones(E, np.float32))
        t_in.grad[0] = g
        t_in.grad[1] = self._T4(E)
        t_in.xparm = eps if eps > 0.0 else 1.0e-5
        self.npush(self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C()))

    def _iembed(self, t_in: Tensor, vocab: int, dim: float):
        """token embedding: input [N,S,1,1] float ids -> [N,S,E,1];
        table [1,V,E,1] in the weight slot, bias [E]"""
        N1, S = t_in.N(), t_in.H()
        E = int(dim)
        if vocab < 2 or E < 1:
            raise ValueError(f"embed V={vocab} E={E}?")
        w = self._T4(1, vocab, E, 1)
        b = self._T4(E)
        t_in.grad[0], t_in.grad[1] = w, b
        t_in.iparm = vocab
        if Config.MM_DEBUG:
            w.set_numpy(np.full(w.numel, 0.5, np.float32))
        else:
            self._rand(w, math.sqrt(1.0 / E))
        b.set_numpy(np.zeros(E, np.float32))
        self.npush(self._T4(N1, S, E, 1))

    def _iproj(self, t_in: Tensor, V: int, bias: float):
        """position-wise projection (LM head): [N,S,E,1] -> [N,S,V,1];
        w [1,V,E,1], b [V]"""
        N1, S = t_in.N(), t_in.H()
        E = t_in.W() * t_in.C()
        w = self._T4(1, V, E, 1)
        b = self._T4(V)
        t_in.grad[0], t_in.grad[1] = w, b
        t_in.xparm = bias
        if Config.MM_DEBUG:
            w.set_numpy(np.full(w.numel, 0.5, np.float32))
            b.set_numpy(np.zeros(V, np.float32))
        else:
            self._rand(w, math.sqrt(1.0 / (V + E)))
            self._rand(b, bias)
        self.npush(self._T4(N1, S, V, 1))

    # =========================================================================
    # program assembly (the same tuples as the JAX package's)
    # =========================================================================
    def _program(self):
        prog = []
        for i in range(self.numel - 1):
            t_in, t_out = self[i], self[i + 1]
            kind = t_in.grad_fn
            if kind == Layer.ATTN:
                flags = int(float(t_in.xparm))
                opts = (t_in.iparm, bool(flags & 1), bool(flags & 2))
            elif kind == Layer.LNORM or kind in _ACTS:
                opts = (float(t_in.xparm),)
            else:
                opts = ()
            prog.append((kind, opts, t_out.shape))
        return tuple(prog)

    def _params(self):
        out = []
        for i in range(self.numel - 1):
            t_in = self[i]
            kind = t_in.grad_fn
            if kind == Layer.LNORM:
                out.append((t_in.grad[0].ensure_data(),
                            t_in.grad[1].ensure_data()))
            elif kind in (Layer.EMBED, Layer.PROJ, Layer.ATTN):
                w, b = t_in.grad[0], t_in.grad[1]
                bb = (b.data_as(b.H(), b.W()) if kind == Layer.ATTN
                      else b.ensure_data())
                out.append((w.data_as(w.H(), w.W()), bb))
            else:
                out.append(())
        return tuple(out)
