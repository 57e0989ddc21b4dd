"""Model — sequential NN container: the layer factory and the per-word
training methods on the tensor-input path (the port of
tensorforth_tpu/nn/model.py: forward, loss, backprop, sgd/adam/adamw).

Holds per-layer activation Tensors like the reference; layer j's
parameters sit in ``self[j].grad[0]`` and ``.grad[1]``, their gradients
in ``.grad[2]`` and ``.grad[3]``, an activation's derivative mask in
``.grad[4]``, and the optimizer's moments in ``self[j].mtum[0..3]``.
``_program()`` and ``_params()`` return what the JAX package's do, so
nn/funcs.py and nn/serve.py read a model the same way.  As in the
reference, ``backprop`` overwrites each layer's activation with its input
gradient.  The dataset input path, the fused training cycle and its trace
chunks come with a later slice.
"""
from __future__ import annotations

import math

import numpy as np

from ..config import Config, resolve_device
from ..mu.tensor import T4Type, Tensor
from . import funcs
from .ntypes import Layer, Loss, Optimizer

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)


class Model:
    def __init__(self, mmu, device=None):
        self.oid = 0
        self.ttype = T4Type.MODEL
        self.data: list[Tensor] = []          # layer tensors (activations)
        self.device = resolve_device(device)
        self.train = 1
        self._mmu = mmu
        self._hot: Tensor | None = None       # one-hot target vector
        self._hit = 0
        self._iter = 0
        self._opt_inited = False

    @property
    def numel(self) -> int:
        return len(self.data)

    def is_tensor(self) -> bool:
        return False

    def is_model(self) -> bool:
        return True

    def is_dataset(self) -> bool:
        return False

    def is_future(self) -> bool:
        return False

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
        t_in.grad[4] = self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C())
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
        t_in.grad[2] = self._T4(1, 3 * E, E, 1)
        t_in.grad[3] = self._T4(1, E, E, 1)
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
        t_in.grad[2] = self._T4(E)
        t_in.grad[3] = self._T4(E)
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
        t_in.grad[2] = self._T4(1, vocab, E, 1)
        t_in.grad[3] = self._T4(E)
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
        t_in.grad[2] = self._T4(1, V, E, 1)
        t_in.grad[3] = self._T4(V)
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

    # =========================================================================
    # forward (reference forward.cu), tensor input
    # =========================================================================
    def forward(self, inp: Tensor) -> "Model":
        n0 = self[0]
        if inp.numel != n0.numel:
            raise ValueError(f"nn#forward input wrong shape {inp.shape} != "
                             f"model input {n0.shape}")
        n0.replace_data(inp.data_as(*n0.shape))
        outs, masks = funcs.forward_pure(self._program(), n0.ensure_data(),
                                         self._params())
        self._apply_fwd_stash(outs, masks)
        return self

    def _apply_fwd_stash(self, outs, masks):
        """materialize a forward's outputs and derivative masks into the
        layer tensors"""
        for i, (o, m) in enumerate(zip(outs, masks)):
            self[i + 1].replace_data(o)
            if m is not None and self[i].grad[4] is not None:
                self[i].grad[4].replace_data(m)

    # =========================================================================
    # backprop (reference backprop.cu)
    # =========================================================================
    def backprop(self, tgt: Tensor | None = None,
                 flash: bool = True) -> "Model":
        """tgt: the one-hot target (default: the one set with onehot()).
        flash=False takes the attention layers' gradients through the
        einsum path instead of the flash kernels (a check of the kernels)"""
        if tgt is None:
            if self._hot is None:
                raise ValueError("nn#backprop missing onehot vector?")
            tgt = self._hot
        out = self[-1]
        if out.numel != tgt.numel:
            raise ValueError(f"Model#bprep: onehot wrong shape {tgt.shape} "
                             f"!= {out.shape}")
        outs = tuple(self[i + 1].ensure_data()
                     for i in range(self.numel - 1))
        dws, dbs = self._gather_grads()
        dout, dxs, ndws, ndbs = funcs.backward_pure(
            self._program(), bool(self.train), tgt.ensure_data(),
            self[0].ensure_data(), outs, self._params(),
            self._gather_masks(), dws, dbs, flash=flash)
        self._apply_bwd(dout, dxs, ndws, ndbs)
        return self

    def _apply_bwd(self, dout, dxs, ndws, ndbs):
        self[-1].replace_data(dout)
        for j in range(self.numel - 1):
            t_in = self[j]
            t_in.replace_data(dxs[j])
            if t_in.grad[2] is not None:
                t_in.grad[2].replace_data(ndws[j])
            if t_in.grad[3] is not None:
                t_in.grad[3].replace_data(ndbs[j])

    def _gather_masks(self):
        return tuple(self[i].grad[4].ensure_data()
                     if self[i].grad_fn in funcs._MASKED else None
                     for i in range(self.numel - 1))

    def _gather_grads(self):
        """accumulators in their rank-4 storage shapes (None for a layer
        without parameters)"""
        dws, dbs = [], []
        for i in range(self.numel - 1):
            t_in = self[i]
            has = t_in.grad[2] is not None
            dws.append(t_in.grad[2].ensure_data() if has else None)
            dbs.append(t_in.grad[3].ensure_data() if has else None)
        return tuple(dws), tuple(dbs)

    # =========================================================================
    # gradient descent (reference gradient.cu)
    # =========================================================================
    def _trainables(self):
        """[(layer tensor, 0), (layer tensor, 1), ...]: the weight slot and
        the bias slot of every layer that has parameters"""
        out = []
        for i in range(self.numel - 1):
            t_in = self[i]
            if t_in.grad_fn in (Layer.ATTN, Layer.LNORM, Layer.EMBED,
                                Layer.PROJ) and t_in.grad[0] is not None:
                out.append((t_in, 0))
                out.append((t_in, 1))
        return out

    def grad_alloc(self, op: int):
        for t_in, slot in self._trainables():
            g = t_in.grad[slot]
            if op == Optimizer.SGD:
                t_in.mtum[slot] = g
            elif t_in.mtum[slot] is None or t_in.mtum[slot] is g:
                t_in.mtum[slot] = self._T4(*g.shape)
                if op in (Optimizer.ADAM, Optimizer.ADAMW):
                    t_in.mtum[slot + 2] = self._T4(*g.shape)
        self._opt_inited = True

    def grad_zero(self):
        for t_in, slot in self._trainables():
            dg = t_in.grad[slot + 2]
            if dg is not None:
                dg.ensure_data().zero_()

    def _opt_apply(self, op: int, step_fn, *hyper):
        """one optimizer step; step_fn updates the payloads of the weight,
        gradient and moment tensors in place"""
        if not self._opt_inited:
            self.grad_alloc(op)
        self._iter += 1
        if not self.train:
            return self
        tr = self._trainables()
        state = [[t.grad[s].ensure_data() for t, s in tr],
                 [t.grad[s + 2].ensure_data() for t, s in tr],
                 [t.mtum[s].ensure_data() for t, s in tr]]
        if op in (Optimizer.ADAM, Optimizer.ADAMW):
            state.append([t.mtum[s + 2].ensure_data() for t, s in tr])
        step_fn(*state, *hyper)
        return self

    def _ndivs(self):
        """SGD batch-divisor quirk: g.N() of each weight tensor"""
        return tuple(float(t.grad[s].N() if t.grad[s].rank == 4 else 1)
                     for t, s in self._trainables())

    def sgd(self, lr: float, b: float = 0.0) -> "Model":
        momentum = abs(b) > Config.DU_EPS
        return self._opt_apply(
            Optimizer.SGDM if momentum else Optimizer.SGD, funcs.sgd_step,
            self._ndivs(), momentum, float(lr), float(b))

    def adam(self, lr: float, b1: float = 0.9, b2: float = 0.999) -> "Model":
        return self._opt_apply(Optimizer.ADAM, funcs.adam_step, False,
                               float(lr), float(b1), float(b2), 0.0)

    def adamw(self, lr: float, wd: float = 0.01, b1: float = 0.9,
              b2: float = 0.999) -> "Model":
        return self._opt_apply(Optimizer.ADAMW, funcs.adam_step, True,
                               float(lr), float(b1), float(b2), float(wd))

    # =========================================================================
    # loss & metrics (reference loss.cpp)
    # =========================================================================
    def onehot(self, t: Tensor | None = None) -> Tensor:
        """the one-hot target vector; with `t`, set it"""
        if t is None:
            if self._hot is None:
                raise ValueError("Model.onehot not set, pass a tensor")
            return self._hot
        out = self[-1]
        if t.N() != out.N() or t.HWC() != out.HWC():
            raise ValueError(f"Model.onehot dimension is not "
                             f"[{out.N()},1,{out.HWC()},1]")
        self._hot = t
        self._hit = self.hit(True)
        return self._hot

    def hit(self, recalc: bool = False) -> int:
        if not recalc:
            return int(self._hit)      # syncs only when the caller reads it
        if self._hot is None:
            return 0
        return funcs.hit_fn(self[-1].ensure_data(), self._hot.ensure_data())

    def loss_dev(self, op: int, tgt: Tensor | None = None):
        """device scalar loss, no host sync"""
        if tgt is None:
            tgt = self._hot
        out = self[-1]
        if tgt is None or out.numel != tgt.numel:
            raise ValueError("nn::loss shape mismatch")
        return funcs.loss_fn(Loss.NAMES[op].lower(), out.ensure_data(),
                             tgt.ensure_data())

    def loss(self, op: int, tgt: Tensor | None = None) -> float:
        return float(self.loss_dev(op, tgt))
