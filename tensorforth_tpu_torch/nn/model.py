"""Model — sequential NN container: the layer factory and the per-word
training methods on the tensor-input path (the port of
tensorforth_tpu/nn/model.py: forward, loss, backprop, sgd/adam/adamw).

Holds per-layer activation Tensors like the reference; layer j's
parameters sit in ``self[j].grad[0]`` and ``.grad[1]``, their gradients
in ``.grad[2]`` and ``.grad[3]``, an activation's derivative mask (a
batchnorm's xhat) in ``.grad[4]``, the optimizer's moments in
``self[j].mtum[0..3]`` and a batchnorm's 1/std in ``mtum[4]``.
``_program()`` and ``_params()`` return what the JAX package's do, so
nn/funcs.py and nn/serve.py read a model the same way.  As in the
reference, ``backprop`` overwrites each layer's activation with its input
gradient, and a word given bad input prints through ``_err`` and sets
``err`` instead of raising.  A dataset input takes the reference's
per-word path (what it runs under T4_NO_FUSE=1): one forward that also
makes the batch's one-hot and hit count from the device labels.  The
fused training cycle and its trace chunks are not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config, resolve_device
from ..mu.tensor import T4Type, Tensor
from ..ops import rng
from . import funcs
from .ntypes import Layer, Loss, Optimizer

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)
_POOLS = (Layer.AVGPOOL, Layer.MAXPOOL, Layer.MINPOOL)
_PARAMETERED = (Layer.CONV, Layer.DCONV, Layer.LINEAR, Layer.BATCHNM,
                Layer.ATTN, Layer.LNORM, Layer.EMBED, Layer.PROJ)


class Model:
    def __init__(self, mmu, device=None):
        self.oid = 0
        self.ttype = T4Type.MODEL
        self.rank = 0
        self.data: list[Tensor] = []          # layer tensors (activations)
        self.device = resolve_device(device)
        self.train = 1
        self.err = 0
        self._mmu = mmu
        self._hot: Tensor | None = None       # one-hot target vector
        self._hit = 0
        self._iter = 0
        self._opt_inited = False
        self.max_norm = 0.0
        self.epoch = 0

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

    @staticmethod
    def nname(i) -> str:
        """padded 7-char layer name (reference LAYER_OP strings)"""
        return Layer.NAMES[i if i is not None else 0]

    def __getitem__(self, i: int) -> Tensor:
        return self.data[i if i >= 0 else self.numel + i]

    def npush(self, t: Tensor) -> "Model":
        self.data.append(t)
        if self.numel >= Config.NET_SZ:
            from ..system import System
            System.get_sys().perr("", "Model layer storage maxed out ")
        return self

    def batch_size(self) -> int:
        return self.data[0].N() if self.data else 1

    def tick(self):
        self.epoch += 1

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
        t_in.grad = [None] * 5
        t_in.mtum = [None] * 5
        if fn in (Layer.CONV, Layer.DCONV):
            self._iconv(t_in, n, bias, opt or [3, 1, 0, 1], fn == Layer.DCONV)
        elif fn == Layer.LINEAR:
            self._ilinear(t_in, n, bias)
        elif fn == Layer.FLATTEN:
            self._iflatten(t_in)
        elif fn in _ACTS or fn == Layer.DROPOUT:
            self._iactivate(t_in, bias)
        elif fn in (Layer.SOFTMAX, Layer.LOGSMAX):
            self._isoftmax(t_in)
        elif fn in _POOLS:
            self._ipool(t_in, int(n))
        elif fn == Layer.BATCHNM:
            self._ibatchnorm(t_in, bias)
        elif fn == Layer.USAMPLE:
            self._iup(t_in, int(n), bias)
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

    def _err(self, msg: str):
        """the reference's layer-factory error: printed through
        System.perr, and the layer is not added"""
        from ..system import System
        System.get_sys().perr("", msg + " ")

    def _iconv(self, t_in: Tensor, C0: int, bias: float, opt, txn: bool):
        """conv2d (txn: dconv2d) C1 -> C0; opt = [K, S, P, D]: P 0 means
        'same' padding (K-1)/2; a dconv's output is sized as the
        reference's, (H1-1)S - 2P + K + (H1 + 2P - K) % S"""
        N1, H1, W1, C1 = t_in.N(), t_in.H(), t_in.W(), t_in.C()
        K, S = int(opt[0]), int(opt[1])
        P = int(opt[2]) if (K > 1 and opt[2]) else (K - 1) // 2
        if txn:
            P0 = (H1 + P * 2 - K) % S
            H0 = (H1 - 1) * S - P * 2 + K + P0
            W0 = (W1 - 1) * S - P * 2 + K + P0
        else:
            H0 = (H1 - K + P * 2) // S + 1
            W0 = (W1 - K + P * 2) // S + 1
        if (not txn and K not in (1, 3, 5)) or (txn and K != 4):
            self._err(f"conv kernel {K}x{K}? 1/3/5 (4 for dconv2d) only")
            return
        t_in.stride = [S, S, P, P]
        t_in.xparm = bias
        f = self._T4(C1, K, K, C0)
        b = self._T4(C0)
        t_in.grad[0], t_in.grad[1] = f, b
        t_in.grad[2] = self._T4(C1, K, K, C0)
        t_in.grad[3] = self._T4(C0)
        t_in.grad[4] = self._T4(N1, H1, W1, C1)
        if Config.MM_DEBUG:
            f.set_numpy(np.full(f.numel, 0.5, np.float32))
            b.set_numpy(np.full(b.numel, -0.5, np.float32))
        else:
            self._rand(f, math.sqrt(6.0 / (K * K * C1)))
            self._rand(b, bias)
        self.npush(self._T4(N1, H0, W0, C0))

    def _ilinear(self, t_in: Tensor, E0: int, bias: float):
        """linear [N, E1] -> [N, E0] over the flattened sample"""
        N1, E1 = t_in.N(), t_in.HWC()
        w = self._T4(1, E0, E1, 1)
        b = self._T4(E0)
        t_in.grad[0], t_in.grad[1] = w, b
        t_in.grad[2] = self._T4(1, E0, E1, 1)
        t_in.grad[3] = self._T4(E0)
        t_in.xparm = bias
        if Config.MM_DEBUG:
            a = np.full(w.numel, 0.5, np.float32)
            a[(w.numel >> 1) - 1] = 1.0
            w.set_numpy(a)
            b.set_numpy(np.zeros(E0, np.float32))
        else:
            self._rand(w, math.sqrt(1.0 / (E0 + E1)))
            self._rand(b, bias)
        self.npush(self._T4(N1, 1, E0, 1))

    def _iflatten(self, t_in: Tensor):
        self.npush(self._T4(t_in.N(), 1, t_in.HWC(), 1))

    def _ipool(self, t_in: Tensor, k: int):
        if k not in (2, 3):
            self._err(f"pool k={k}? 2x2 and 3x3 only")
            return
        t_in.stride = [k, 1, 1, 0]
        self.npush(self._T4(t_in.N(), (t_in.H() + k - 1) // k,
                            (t_in.W() + k - 1) // k, t_in.C()))

    def _ibatchnorm(self, t_in: Tensor, m: float):
        C = t_in.C()
        g = self._T4(C)
        g.set_numpy(np.ones(C, np.float32))
        t_in.grad[0] = g
        t_in.grad[1] = self._T4(C)
        t_in.grad[2] = self._T4(C)
        t_in.grad[3] = self._T4(C)
        t_in.grad[4] = self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C())
        t_in.mtum[4] = self._T4(C * 3)
        t_in.xparm = m
        self.npush(self._T4(t_in.N(), t_in.H(), t_in.W(), t_in.C()))

    def _iup(self, t_in: Tensor, k: int, method: float):
        if k not in (2, 3):
            self._err(f"upsample k={k}? 2x2 and 3x3 only")
            return
        t_in.iparm = int(method)
        t_in.stride = [k, 1, 1, 1]
        self.npush(self._T4(t_in.N(), t_in.H() * k, t_in.W() * k, t_in.C()))

    def _isoftmax(self, t_in: Tensor):
        t_in.grad[4] = self._T4(1, t_in.H(), t_in.W(), t_in.C())
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
            self._err(f"attn E={E} not divisible by heads={heads}")
            return
        if (flags & 2) and (E // heads) % 2:
            self._err(f"attn rope needs even head dim, got {E // heads}")
            return
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
            self._err(f"embed V={vocab} E={E}?")
            return
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
            if kind in (Layer.CONV, Layer.DCONV):
                opts = (t_in.stride[0], t_in.stride[2])
            elif kind == Layer.ATTN:
                flags = int(float(t_in.xparm))
                opts = (t_in.iparm, bool(flags & 1), bool(flags & 2))
            elif kind in (Layer.LNORM, Layer.DROPOUT) or kind in _ACTS:
                opts = (float(t_in.xparm),)
            elif kind in _POOLS or kind == Layer.USAMPLE:
                opts = (t_in.stride[0],)
            else:
                opts = ()
            prog.append((kind, opts, t_out.shape))
        return tuple(prog)

    def _params(self):
        out = []
        for i in range(self.numel - 1):
            t_in = self[i]
            kind = t_in.grad_fn
            if kind in (Layer.CONV, Layer.DCONV, Layer.BATCHNM, Layer.LNORM):
                out.append((t_in.grad[0].ensure_data(),
                            t_in.grad[1].ensure_data()))
            elif kind in (Layer.LINEAR, Layer.EMBED, Layer.PROJ, Layer.ATTN):
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
        from ..system import System
        sys = System.get_sys()
        n0 = self[0]
        if inp.numel != n0.numel:
            self._err(f"nn#forward dataset wrong shape {inp.shape} != "
                      f"model input {n0.shape}")
            self.err = 1
            return self
        prog = self._program()
        key = None               # only a dropout layer draws from the key
        if any(k == Layer.DROPOUT for k, _o, _s in prog):
            key = rng.PRNGKey(sys.next_key())
        n0.replace_data(inp.data_as(*n0.shape))
        hot = hit = None
        if inp.is_dataset():
            ld = inp.label_dev
            if ld is not None and ld.shape[0] == n0.N():
                labels = ld      # the batch's device slice: no upload
            else:
                labels = torch.as_tensor(
                    inp.label[:n0.N()].astype(np.int64), device=self.device)
            outs, masks, hot, hit = funcs.forward_with_metrics(
                prog, n0.ensure_data(), self._params(), key, labels)
        else:
            outs, masks = funcs.forward_pure(prog, n0.ensure_data(),
                                             self._params(), key)
        self._apply_fwd_stash(outs, masks, hot, hit)
        if sys.trace:
            self._trace_pass("forward", range(self.numel - 1))
        return self

    def _apply_fwd_stash(self, outs, masks, hot=None, hit=None):
        """materialize a forward's outputs and derivative masks into the
        layer tensors (a batchnorm's xhat in grad[4], its 1/std in
        mtum[4] followed by 2C zeros, as the reference keeps them); a
        dataset forward's one-hot into the model's and its hit count,
        kept on the device"""
        for i, (o, m) in enumerate(zip(outs, masks)):
            self[i + 1].replace_data(o)
            t_in = self[i]
            if m is None:
                continue
            if t_in.grad_fn == Layer.BATCHNM:
                xhat, rvar = m
                t_in.grad[4].replace_data(xhat)
                t_in.mtum[4].replace_data(torch.cat(
                    [rvar.reshape(-1), rvar.new_zeros(2 * t_in.C())]))
            elif t_in.grad[4] is not None:
                t_in.grad[4].replace_data(m)
        if hot is not None:
            if self._hot is None:
                out = self[-1]
                self._hot = self._T4(out.N(), 1, out.HWC(), 1)
            self._hot.replace_data(hot)
            self._hit = hit

    def _trace_pass(self, name: str, order):
        """per-layer trace (reference forward.cu:44-51/backprop.cu:41-47):
        the forward pass checks each layer's output for NaN, prints the
        faulting layer, sets err (the net words stop on it) and breaks;
        backprop keeps the check at trace > 1"""
        from ..ops import engine
        from ..system import System
        sys = System.get_sys()
        nan_check = name == "forward" or sys.trace > 1
        sys.pstr(f"\nModel::{name} trace {{")
        for i in order:
            t_in, t_out = self[i], self[i + 1]
            s = engine.t_sum(t_in.ensure_data()) / t_in.N() / max(t_in.C(), 1)
            sys.pstr(
                f"\n  {i:3d}> {Model.nname(t_in.grad_fn)} "
                f"[{t_in.N():2d},{t_in.H():2d},{t_in.W():2d},{t_in.C():2d}]"
                f" Σ/n={s:6.2f} p={float(t_in.xparm):6.3f}"
                f" => out[{t_out.N():2d},{t_out.H():2d},"
                f"{t_out.W():2d},{t_out.C():2d}]")
            if nan_check and engine.has_nan(t_out.ensure_data()):
                sys.pstr(f"\nERROR: nn#{name} NaN in "
                         f"{Model.nname(t_in.grad_fn)}")
                self.err = 1
                break
        sys.pstr("\n}\n")

    def broadcast(self, tgt: Tensor) -> "Model":
        """the target's first value of each sample, repeated over the
        output's width, as the one-hot vector"""
        out = self[-1]
        N, HWC = out.N(), out.HWC()
        if self._hot is None:
            self._hot = self._T4(N, 1, HWC, 1)
        v = tgt.numpy().reshape(N, -1)[:, :1]
        self._hot.set_numpy(np.repeat(v, HWC, axis=1))
        return self

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
                self._err("nn#backprop missing onehot vector?")
                return self
            tgt = self._hot
        out = self[-1]
        if out.numel != tgt.numel:
            self._err(f"Model#bprep: onehot wrong shape {tgt.shape} "
                      f"!= {out.shape}")
            self.err = 1
            return self
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
        from ..system import System
        if System.get_sys().trace:
            self._trace_pass("backprop", range(self.numel - 2, -1, -1))

    def _gather_masks(self):
        masks = []
        for i in range(self.numel - 1):
            t_in = self[i]
            if t_in.grad_fn == Layer.BATCHNM:
                masks.append((t_in.grad[4].ensure_data(),
                              t_in.mtum[4].ensure_data()[:t_in.C()]))
            elif t_in.grad_fn in funcs._MASKED:
                masks.append(t_in.grad[4].ensure_data())
            else:
                masks.append(None)
        return tuple(masks)

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
            if t_in.grad_fn in _PARAMETERED and t_in.grad[0] is not None:
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
        """the one-hot target vector; with `t`, set it (freeing the one
        it replaces)"""
        if t is None:
            if self._hot is None:
                self._err("Model.onehot not provided by dataset, "
                          "use nn.onehot= to setup!")
                return self[-1]
            return self._hot
        out = self[-1]
        if self._hot is not None:
            self._mmu.free_obj(self._hot)
        elif t.N() != out.N() or t.HWC() != out.HWC():
            self._err(f"Model.onehot dimension is not "
                      f"[{out.N()},1,{out.HWC()},1]")
            return t
        self._hot = t
        self._hit = self.hit(True)
        return self._hot

    def onehot_from_dataset(self, dset) -> Tensor:
        out = self[-1]
        E = out.HWC()
        if self._hot is None:
            self._hot = self._T4(out.N(), 1, E, 1)
        ld = getattr(dset, "label_dev", None)
        if ld is not None and ld.shape[0] == out.N():
            labels = ld                    # the device slice: no upload
        else:
            labels = torch.as_tensor(dset.label[:out.N()].astype(np.int64),
                                     device=self.device)
        self._hot.replace_data(funcs.onehot_fn(labels, E))
        return self._hot

    def hit(self, recalc: bool = False) -> int:
        """the last forward's hit count (read back here); with recalc,
        computed again from the output and the one-hot, on the device"""
        if not recalc:
            from ..mu.future import LazyIdx
            if isinstance(self._hit, LazyIdx):
                self._hit = self._hit.vec[self._hit.i]
            return int(self._hit)      # syncs only when the caller reads it
        if self._hot is None:
            return 0
        return funcs.hit_fn(self[-1].ensure_data(), self._hot.ensure_data())

    def hit_dev(self):
        """the hit count on the device, not read back (the nn.hit word
        wraps it in a future)"""
        return self._hit

    def loss_dev(self, op: int, tgt: Tensor | None = None):
        """device scalar loss, no host sync"""
        if tgt is None:
            tgt = self._hot
        out = self[-1]
        if tgt is None or out.numel != tgt.numel:
            self._err("nn::loss shape mismatch")
            return 0.0
        return funcs.loss_fn(Loss.NAMES[op].lower(), out.ensure_data(),
                             tgt.ensure_data())

    def loss(self, op: int, tgt: Tensor | None = None) -> float:
        return float(self.loss_dev(op, tgt))
