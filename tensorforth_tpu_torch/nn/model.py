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
``err`` instead of raising.

A dataset input takes the JAX package's default path.  The first
canonical `forward loss.X ... backprop nn.<opt>` cycle runs word by word
(one forward that also makes the batch's one-hot and hit count from the
device labels, then each word); it arms `_fuse_sig`.  The next cycle runs
as one fused program (nn/cycle.py: eager on the CPU, a captured CUDA
graph on the card) whose slices the words apply; after one such cycle
was consumed, a forward dispatches a trace chunk of up to T4_CHUNK
batches at once and the words serve from it.  What every word observes
is what the per-word path gives: anything out of the pattern (another
rate, a weight read or write, a stray draw of the RNG) rolls the chunk
back to the exact per-batch state.  Each fused batch carries a finite
status, the err-bit NaN sentinel's evidence (`_fin_check`).
T4_NO_FUSE=1 keeps every cycle on the per-word path.
"""
from __future__ import annotations

import itertools
import math
import os
import weakref

import numpy as np
import torch

from ..config import Config, resolve_device
from ..mu.tensor import T4Type, Tensor
from ..ops import rng
from . import cycle, funcs
from .ntypes import Layer, Loss, Optimizer

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)
_POOLS = (Layer.AVGPOOL, Layer.MAXPOOL, Layer.MINPOOL)
_PARAMETERED = (Layer.CONV, Layer.DCONV, Layer.LINEAR, Layer.BATCHNM,
                Layer.ATTN, Layer.MOE, Layer.LNORM, Layer.EMBED, Layer.PROJ)
_UIDS = itertools.count(1)       # a model's key in nn/cycle.py's cache
_DEV_F32 = {}                    # (value, device) -> 0-d f32 on the card


def _dev_f32(v: float, device):
    """a hyperparameter as a 0-d f32 on the card, kept per value (the
    card's word path steps with device scalars, as a captured cycle does)"""
    key = (float(v), str(device))
    r = _DEV_F32.get(key)
    if r is None:
        if len(_DEV_F32) > 4096:
            _DEV_F32.clear()
        r = _DEV_F32[key] = torch.tensor(v, dtype=torch.float32,
                                         device=device)
    return r


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
        # the fused paths' state (the JAX package's, model.py:90-111)
        self._cycle: list = []                # verbs since the last step
        self._fuse_sig = None                 # the last canonical cycle's
        self._pending = None                  # a fused cycle's outputs
        self._chunk = None                    # the trace chunk in flight
        self._fuse_hits = 0                   # fused cycles consumed in a row
        self._fin_tail = None                 # the last completed chunk
        self._fin_log = []                    # [(seq, pos, fin)] consumed
        self._fin_seq = 0                     # dispatch order of windows
        self._fwd_seed = None                 # the last forward's seed
        self._uid = next(_UIDS)
        Model._live.add(self)

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

    # --- the fused paths' bookkeeping (the JAX package's model.py:114-152)
    def fuse_break(self):
        """an out-of-cycle mutation (nn.w=, nn.zero, a one-hot swap, a new
        layer) voids the speculative results; what earlier words of the
        cycle applied stays"""
        self._chunk_abort()
        self._pending = None
        self._fuse_sig = None
        self._fuse_hits = 0
        self._fin_tail = None    # a rollback would undo the mutation
        self._fin_log.clear()
        if self._cycle and self._cycle[-1] != "dirty":
            self._cycle.append("dirty")

    def chunk_sync(self):
        """the exact per-batch tensor state before out-of-cycle
        introspection (nn.w, nn.dw, n@, network, save): the rollback of
        a trace chunk in flight; nothing otherwise"""
        self._chunk_abort()

    def _note_opt(self, opt: str, hyper: tuple):
        """an optimizer step ends a cycle: record whether it was
        canonical (and so may run fused next time)"""
        c = self._cycle
        canonical = (len(c) >= 1 and c[0] == "fwd_ds"
                     and c.count("fwd_ds") == 1
                     and c.count("bwd") == 1 and "dirty" not in c
                     and all(v in ("fwd_ds", "bwd") or v.startswith("loss:")
                             for v in c)
                     and c.index("bwd") > 0)
        loss_ops = {v[5:] for v in c if v.startswith("loss:")}
        if canonical and len(loss_ops) <= 1:
            self._fuse_sig = (self._program(), bool(self.train),
                              loss_ops.pop() if loss_ops else "ce",
                              opt, hyper)
        else:
            self._fuse_sig = None
        self._cycle = []

    def npush(self, t: Tensor) -> "Model":
        self.fuse_break()             # a new layer: drain any chunk
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
        self.fuse_break()             # a new layer: drain any chunk
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
        elif fn == Layer.MOE:
            self._imoe(t_in, int(n), int(bias), opt or [2])
        elif fn == Layer.LNORM:
            self._ilnorm(t_in, bias)
        elif fn == Layer.EMBED:
            self._iembed(t_in, int(n), bias)
        elif fn == Layer.PROJ:
            self._iproj(t_in, int(n), bias)
        else:
            self._err(f"Model#add layer {fn} not supported")
            return self
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

    def _imoe(self, t_in: Tensor, experts: int, hidden: int, opt):
        """mixture-of-experts FFN layer: input [N,S,D,1]; the router is
        packed into the weight slot's last column, w1aug [E,D,F+1,1] =
        the experts' w1 [E,D,F] ++ the router wr [E,D,1], and w2
        [E,F,D,1] sits in the bias slot, so the layer keeps the two-slot
        (w, b) optimizer and file contract"""
        N1, S = t_in.N(), t_in.H()
        D = t_in.W() * t_in.C()
        top_k = int(opt[0]) if opt else 2
        if experts < 1 or hidden < 1 or not (1 <= top_k <= experts):
            self._err(f"moe E={experts} F={hidden} k={top_k}?")
            return
        w1 = self._T4(experts, D, hidden + 1, 1)
        w2 = self._T4(experts, hidden, D, 1)
        t_in.grad[0], t_in.grad[1] = w1, w2
        t_in.grad[2] = self._T4(experts, D, hidden + 1, 1)
        t_in.grad[3] = self._T4(experts, hidden, D, 1)
        t_in.iparm = experts
        t_in.stride = [top_k, hidden, 0, 0]
        k = math.sqrt(1.0 / (D + hidden))
        if Config.MM_DEBUG:
            w1.set_numpy(np.full(w1.numel, 0.5, np.float32))
            w2.set_numpy(np.full(w2.numel, 0.5, np.float32))
        else:
            self._rand(w1, k)
            self._rand(w2, k)
        self.npush(self._T4(N1, S, D, 1))

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
            elif kind == Layer.MOE:
                opts = (t_in.iparm, t_in.stride[1], t_in.stride[0])
            elif kind in (Layer.LNORM, Layer.DROPOUT) or kind in _ACTS:
                opts = (float(t_in.xparm),)
            elif kind in _POOLS or kind == Layer.USAMPLE:
                opts = (t_in.stride[0],)
            else:
                opts = ()
            prog.append((kind, opts, t_out.shape))
        return tuple(prog)

    def _params(self, local: bool = False):
        """each layer's parameters in the JAX package's shapes; local=True:
        under the word mesh, this rank's shards of them (funcs.word_mesh)"""
        out = []
        for i in range(self.numel - 1):
            t_in = self[i]
            kind = t_in.grad_fn
            if kind not in _PARAMETERED:
                out.append(())
                continue
            w, b = (self._slot(t_in, "grad", k) if local
                    else t_in.grad[k].ensure_data() for k in (0, 1))
            if kind in (Layer.LINEAR, Layer.EMBED, Layer.PROJ, Layer.ATTN):
                # [1, E0, E1, 1] storage as [E0, E1] (wo's too)
                w = w.view(w.shape[1], w.shape[2])
                if kind == Layer.ATTN:
                    b = b.view(b.shape[1], b.shape[2])
            elif kind == Layer.MOE:          # [E,D,F+1] and [E,F,D] views
                w = w.view(w.shape[:3])
                b = b.view(b.shape[:3])
            out.append((w, b))
        return tuple(out)

    # --- a rank's shards under the word mesh (nn/funcs.word_mesh) -----------
    @staticmethod
    def _rows():
        """the spec of a rank's rows of an activation, or None (no mesh,
        or a mesh of one dp rank)"""
        mesh = funcs.word_mesh()
        if mesh is None or mesh.dp == 1:
            return None
        from ..parallel.mesh import Shard
        return Shard(mesh, "dp", 0)

    @staticmethod
    def _pspec(t_in, k: int):
        """the spec of a rank's shard of layer t_in's parameter k (0: w,
        1: b; their gradients and moments alike), or None: replicated"""
        mesh = funcs.word_mesh()
        if mesh is None:
            return None
        d = funcs.param_dims(mesh, t_in.grad_fn)[k % 2]
        if d is None:
            return None
        from ..parallel.mesh import Shard
        return Shard(mesh, *d)

    def _slot(self, t_in, which: str, k: int):
        """the rank's part of t_in.grad[k] or .mtum[k] (the whole payload
        without a mesh)"""
        return getattr(t_in, which)[k].local(self._pspec(t_in, k))

    def _put(self, t_in, which: str, k: int, arr):
        """the rank's part of t_in.grad[k] or .mtum[k] replaced"""
        getattr(t_in, which)[k].set_local(arr, self._pspec(t_in, k))


    # =========================================================================
    # forward (reference forward.cu)
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
        self._fwd_seed = None    # _chunk_fwd holds it against the chunk's
        if any(k == Layer.DROPOUT for k, _o, _s in prog):
            self._fwd_seed = sys.next_key()
            key = rng.PRNGKey(self._fwd_seed)
        hot = hit = None
        if inp.is_dataset():
            spec = inp._fetch_spec
            if self._chunk is not None and self._chunk_fwd(inp, spec, prog):
                self._cycle.append("fwd_ds")
                return self
            if self._pending is not None:
                # the last fused cycle's step was never taken (an eval
                # loop): drop it and stop paying for fused forwards
                self._pending = None
                self._fuse_sig = None
                self._fuse_hits = 0
            fused = None
            if spec is not None and inp.data is None:
                if self._maybe_chunk_dispatch(prog, inp, spec):
                    inp._fetch_spec = None
                    self._cycle.append("fwd_ds")
                    return self
                if self.err:          # the eager sentinel found a fault:
                    return self       # leave its rolled-back state
                # the batch is still a corpus offset: its slice and
                # normalize run inside the fused program
                r = self._try_fused_ds(prog, inp, spec)
                if r is not None:
                    x0, lab, outs, masks, hot, hit = r
                    inp._fetch_spec = None
                    inp.replace_data(x0)
                    inp.label_dev = lab
                    n0.replace_data(inp.data_as(*n0.shape))
                    fused = True
            if fused is None:
                n0.replace_data(inp.data_as(*n0.shape))
                ld = inp.label_dev
                if ld is not None and ld.shape[0] == n0.N():
                    labels = ld      # the batch's device slice: no upload
                else:
                    labels = torch.as_tensor(
                        inp.label[:n0.N()].astype(np.int64),
                        device=self.device)
                fused = self._try_fused(prog, n0, labels)
                if fused is not None:
                    outs, masks, hot, hit = fused
                else:
                    outs, masks, hot, hit = funcs.forward_with_metrics(
                        prog, n0.ensure_data(), self._params(True), key,
                        labels)
            self._cycle.append("fwd_ds")
        else:
            self._chunk_abort()               # the weights must be current
            n0.replace_data(inp.data_as(*n0.shape))
            outs, masks = funcs.forward_pure(prog, n0.ensure_data(),
                                             self._params(True), key)
            self._cycle.append("dirty")       # tensor-input cycles unfused
        self._apply_fwd_stash(outs, masks, hot, hit)
        if sys.trace:
            self._trace_pass("forward", range(self.numel - 1))
        return self

    def _apply_fwd_stash(self, outs, masks, hot=None, hit=None):
        """materialize a forward's outputs and derivative masks into the
        layer tensors (a batchnorm's xhat in grad[4], its 1/std in
        mtum[4] followed by 2C zeros, as the reference keeps them); a
        dataset forward's one-hot into the model's and its hit count,
        kept on the device.  Under the word mesh the outputs and masks
        are the rank's rows"""
        rows = self._rows()
        for i, (o, m) in enumerate(zip(outs, masks)):
            self[i + 1].set_local(o, rows)
            t_in = self[i]
            if m is None:
                continue
            if t_in.grad_fn == Layer.BATCHNM:
                xhat, rvar = m
                t_in.grad[4].set_local(xhat, rows)
                t_in.mtum[4].replace_data(torch.cat(
                    [rvar.reshape(-1), rvar.new_zeros(2 * t_in.C())]))
            elif t_in.grad[4] is not None:
                t_in.grad[4].set_local(m, rows)
        if hot is not None:
            if self._hot is None:
                out = self[-1]
                self._hot = self._T4(out.N(), 1, out.HWC(), 1)
            self._hot.replace_data(hot)
            self._hit = hit

    # =========================================================================
    # the fused cycle (the JAX package's model.py:634-714)
    # =========================================================================
    def _fusable(self, prog, sig) -> bool:
        """the last cycle was canonical for this program, and may run
        fused (T4_NO_FUSE=1 says no)"""
        return (sig is not None and self._opt_inited and bool(self.train)
                and sig[0] == prog and sig[1] == bool(self.train)
                and os.environ.get("T4_NO_FUSE", "0") != "1"
                and (sig[3] not in ("adam", "adamw")
                     or all(t.mtum[s + 2] is not None
                            for t, s in self._trainables())))

    def _fused_state(self):
        """(ws, ms, vs, dws, dbs): the live weights, moments and gradient
        accumulators a fused cycle starts from"""
        tr = self._trainables()
        ws = [self._slot(t, "grad", s) for t, s in tr]
        ms = [self._slot(t, "mtum", s) for t, s in tr]
        vs = [self._slot(t, "mtum", s + 2) for t, s in tr
              if t.mtum[s + 2] is not None]
        dws, dbs = self._gather_grads()
        return ws, ms, vs, list(dws), list(dbs)

    @staticmethod
    def _kmax() -> int:
        try:
            return int(os.environ.get("T4_CHUNK", "100"))
        except ValueError:
            return 100

    def _cycle_of(self, sig, inp=None):
        """the Cycle of this signature: over the dataset's resident
        corpus, or (inp None) over an input copied in"""
        prog, train, loss_op, opt, _hyper = sig
        if inp is not None:
            buf, labels = inp._resident()
            src = ("ds", buf, labels, inp.batch_sz, float(inp._mean),
                   float(inp._scale), tuple(self[0].shape))
        else:
            src = ("x", tuple(self[0].shape))
        return cycle.get(self, prog, train, loss_op, opt, self._ndivs(),
                         src, max(self._kmax(), 1))

    def _seeds(self, prog, k: int):
        """the dropout seeds k forwards from this one will burn, or None"""
        if not any(kind == Layer.DROPOUT for kind, _o, _s in prog):
            return None
        from ..system import System
        return [self._fwd_seed] + System.get_sys().peek_keys(k - 1)

    def _stash_pending(self, what, st, lval, fin, pos, seq=None):
        """the speculative results of one fused cycle (st: its outputs
        less x and labels) for the words that follow; what = (loss op,
        optimizer, hyperparameters) it assumed"""
        (_outs, _masks, _hot, _hit, _lval, dout, dxs, ndws, ndbs, nws, nms,
         nvs, zdws, _fin) = st
        self._pending = {
            "loss_op": what[0], "opt": what[1], "hyper": what[2],
            "lval": lval, "dout": dout, "dxs": dxs, "ndws": ndws,
            "ndbs": ndbs, "nws": nws, "nms": nms, "nvs": nvs, "zdws": zdws,
            "fin": fin, "pos": pos,
            "seq": self._next_fin_seq() if seq is None else seq,
            "bwd_done": False}

    def _try_fused(self, prog, n0, labels):
        """the whole canonical cycle as one program on an input already
        made, when the last cycle proved the pattern: (outs, masks, hot,
        hit), or None for the per-word path"""
        sig = self._fuse_sig
        if not self._fusable(prog, sig):
            return None
        cyc = self._cycle_of(sig)
        cyc.load(self._fused_state(), seeds=self._seeds(prog, 1),
                 hyper=sig[4], x=n0.ensure_data(), labels=labels)
        cyc.run(1)
        lvals, hits, fins = cyc.results(0, 1)
        cycle.COUNTS["fused"] += 1
        self._stash_pending(sig[2:], cyc.stash[2:], lvals[0], fins[0], None)
        outs, masks, hot = cyc.stash[2:5]
        return outs, masks, hot, hits[0]

    def _try_fused_ds(self, prog, inp, pos):
        """the fetch-folded fused cycle: the batch's slice and normalize
        run inside the one program.  (x, labels, outs, masks, hot, hit)
        or None"""
        sig = self._fuse_sig
        if not self._fusable(prog, sig) or inp._resident() is None:
            return None
        cyc = self._cycle_of(sig, inp)
        cyc.load(self._fused_state(), pos, self._seeds(prog, 1), sig[4])
        cyc.run(1)
        lvals, hits, fins = cyc.results(0, 1)
        cycle.COUNTS["fused"] += 1
        x0, lab = cyc.stash[:2]
        self._stash_pending(sig[2:], cyc.stash[2:], lvals[0], fins[0],
                            int(pos))
        outs, masks, hot = cyc.stash[2:5]
        return x0, lab.clone(), outs, masks, hot, hits[0]

    # =========================================================================
    # trace chunks: K canonical cycles at one dispatch (the JAX package's
    # model.py:727-979).  Once the pattern was seen AND one fused cycle
    # consumed, a forward dispatches K batches and the words serve from
    # per-batch loss/hit vectors (LazyIdx futures).  The tensors show the
    # chunk's last batch; any out-of-cycle introspection rolls back to
    # the dispatch-time snapshot and replays batch by batch (chunk_sync).
    # =========================================================================
    def _chunk_plan(self, inp, pos: int) -> int:
        """chunk length: the full batches left in the (T4_MAX_BATCH-cut)
        corpus window, at most T4_CHUNK"""
        kmax = self._kmax()
        if kmax <= 1:
            return 0
        cp = inp._corpus
        if cp is None:
            return 0
        b = inp.batch_sz
        size = cp.size
        max_b = int(os.environ.get("T4_MAX_BATCH", "0") or 0)
        if max_b:                     # as Corpus.fetch windows it
            size = min(size, max_b * b)
        return min(kmax, max(0, (size - int(pos)) // b))

    def _maybe_chunk_dispatch(self, prog, inp, pos) -> bool:
        from ..system import System
        sig = self._fuse_sig
        if (self._fuse_hits < 1 or not self._fusable(prog, sig)
                or System.get_sys().trace or inp._resident() is None):
            return False
        k = self._chunk_plan(inp, pos)
        if k < 2:
            return False
        # this forward burned seed s1; the served forwards of batches
        # 2..K will each burn one more: the chunk takes that exact run,
        # and _chunk_fwd holds each served forward's seed against it, so
        # a stray RNG consumer in the loop forces a rollback
        seeds = self._seeds(prog, k)
        # err-bit NaN sentinel: T4_NAN_GUARD=eager reads the retained
        # windows' statuses at every chunk boundary; the default reads
        # them only when a non-finite value reaches the host
        if os.environ.get("T4_NAN_GUARD", "") == "eager" \
                and self._fin_check():
            return False                     # fault handled; err set
        # the dispatch-time state: the Cycle's buffers are overwritten by
        # every run, and a rollback starts again from this copy
        snap = tuple([t.clone() if t is not None else None for t in part]
                     for part in self._fused_state())
        cyc = self._cycle_of(sig, inp)
        cyc.load(snap, pos, seeds, sig[4])
        cyc.run(k)
        lvals, hits, fins = cyc.results(0, k)
        cycle.COUNTS["chunks"] += 1
        self._chunk = {
            "ds": inp, "pos0": int(pos), "batch": inp.batch_sz, "k": k,
            "j": 0, "stage": "idle", "lvals": lvals, "hits": hits,
            "fins": fins, "loss_op": sig[2], "opt": sig[3],
            "hyper": sig[4], "snap": snap, "seeds": seeds, "cycle": cyc,
            "runs": cyc.runs, "seq": self._next_fin_seq()}
        self._serve_chunk_cycle()
        return True

    def _chunk_fwd(self, inp, spec, prog) -> bool:
        """serve the next cycle's forward from the chunk in flight; any
        mismatch (another dataset or position, an unfinished cycle, a
        topology or train-flag change, a dropout seed other than the
        chunk's: a stray RNG consumer) rolls back first"""
        ck = self._chunk
        sig = self._fuse_sig
        expected = ck["pos0"] + ck["j"] * ck["batch"]
        if not (inp is ck["ds"] and spec is not None
                and int(spec) == expected and ck["stage"] == "idle"
                and ck["j"] < ck["k"] and sig is not None
                and sig[0] == prog and sig[1] == bool(self.train)
                and (ck["seeds"] is None
                     or self._fwd_seed == ck["seeds"][ck["j"]])):
            self._chunk_abort()
            return False
        inp._fetch_spec = None
        self._serve_chunk_cycle()
        return True

    def _serve_chunk_cycle(self):
        from ..mu.future import LazyIdx
        ck = self._chunk
        j = ck["j"]
        if j == ck["k"] - 1:
            self._chunk_apply_last()   # the last batch: the full stash
            return
        self._hit = LazyIdx(ck["hits"], j)
        self._pending = {
            "loss_op": ck["loss_op"], "opt": ck["opt"],
            "hyper": ck["hyper"], "lval": LazyIdx(ck["lvals"], j),
            "bwd_done": False, "chunk": True}
        ck["stage"] = "fwd"

    def _chunk_apply_last(self):
        ck, self._chunk = self._chunk, None
        cyc = ck["cycle"]
        if cyc.runs != ck["runs"]:
            raise RuntimeError("trace chunk: its cycle ran again before "
                               "its last batch was served")
        (x0, lab, outs, masks, hot, *_rest) = cyc.stash
        k = ck["k"]
        # the completed chunk, less its vectors, is the NaN sentinel's
        # rollback window
        self._fin_tail = {key: v for key, v in ck.items()
                          if key not in ("lvals", "hits")}
        inp, n0 = ck["ds"], self[0]
        inp.replace_data(x0)
        inp.label_dev = lab.clone()
        n0.replace_data(inp.data_as(*n0.shape))
        # the last batch's status is fins[k-1] of the retained window: no
        # single-cycle entry for it
        self._stash_pending((ck["loss_op"], ck["opt"], ck["hyper"]),
                            cyc.stash[2:], ck["lvals"][k - 1], None, None,
                            ck["seq"])
        self._apply_fwd_stash(outs, masks, hot, ck["hits"][k - 1])

    def _chunk_abort(self):
        """rollback-replay: run the cycles already served again from the
        dispatch-time snapshot, one by one, so that the tensors (weights,
        moments, gradients, activations) are what per-batch execution
        leaves.  Only out-of-cycle introspection or a broken pattern
        lands here; the loss and hit futures already handed out keep the
        chunk's values (the same arithmetic)."""
        ck, self._chunk = self._chunk, None
        if ck is None:
            return
        self._fuse_hits = 0
        j, stage = ck["j"], ck["stage"]
        if j == 0 and stage == "idle":
            return                    # nothing served: a plain discard
        res = self._chunk_replay(ck, j, want_stash=(stage != "idle"))
        if stage == "idle":
            self._pending = None
            return
        # a cycle half served: its stash again, at the right state, so
        # the rest of its words serve as usual
        st, lval, hit, fin = res
        inp, n0 = ck["ds"], self[0]
        inp.replace_data(st[0])
        inp.label_dev = st[1].clone()
        n0.replace_data(inp.data_as(*n0.shape))
        self._stash_pending((ck["loss_op"], ck["opt"], ck["hyper"]), st[2:],
                            lval, fin, ck["pos0"] + j * ck["batch"])
        self._pending["bwd_done"] = stage == "bwd"
        outs, masks, hot = st[2:5]
        self._apply_fwd_stash(outs, masks, hot, hit)
        if stage == "bwd":
            self._apply_bwd(*st[7:11])

    def _chunk_replay(self, ck, j: int, want_stash: bool):
        """run j complete cycles of a dispatched chunk again from its
        snapshot and apply the state they leave to the live tensors; when
        want_stash, also run cycle j and return (its outputs, lval, hit,
        fin)"""
        cyc = ck["cycle"]
        cyc.load(ck["snap"], ck["pos0"], ck["seeds"], ck["hyper"])
        if j:
            cyc.run(j)
            nws, zws, nms, nvs = cyc.threaded()
            self._put_state(ck["opt"], nws, zws, nms, nvs)
        if not want_stash:
            return None
        cyc.run(1)
        lvals, hits, fins = cyc.results(j, 1)
        return cyc.stash, lvals[0], hits[0], fins[0]

    # =========================================================================
    # err-bit NaN sentinel (the JAX package's model.py:990-1146): the
    # analog of the reference's per-layer _check_nan and err STOP
    # (forward.cu:60-66, netvm.cpp:235).  Each fused batch has a finite
    # status; the last completed chunk is kept (_fin_tail), so a
    # non-finite value reaching the host can still be traced, and rolled
    # back, to the exact faulting batch.
    # =========================================================================
    def _next_fin_seq(self) -> int:
        self._fin_seq += 1
        return self._fin_seq

    def _fin_check(self) -> bool:
        """read every retained finite status in dispatch order (consumed
        single cycles, the retained and the active chunk, the pending
        cycle: oldest first, so the first fault wins); on a fault, roll
        back to the faulting batch where a chunk's snapshot allows it,
        print the per-layer trace and set err (the net words stop on it,
        as the reference's netvm.cpp:235).  True when a fault was found.
        (The JAX package can skip a status not ready yet; a read here
        waits for it.)"""
        wins = [(seq, ("single", i)) for i, (seq, _p, _f)
                in enumerate(self._fin_log)]
        for ck in (self._fin_tail, self._chunk):
            if ck is not None:
                wins.append((ck["seq"], ("chunk", ck)))
        p = self._pending
        if p is not None and p.get("fin") is not None:
            wins.append((p["seq"], ("pending", p)))
        for _seq, (kind, win) in sorted(wins, key=lambda w: w[0]):
            if kind == "single":
                seq, pos, f = self._fin_log[win]
                code = int(f)
                self._fin_log[win] = (seq, pos, code)    # read once
                if code:
                    self._fin_single_fault(pos, code, advanced=True)
                    return True
                continue
            if kind == "pending":
                code = int(win["fin"])
                if code:
                    # the pending cycle's forward is the live state
                    # already: report, no replay
                    self._fin_single_fault(win.get("pos"), code,
                                           advanced=False)
                    return True
                continue
            fa = win["fins"]
            if torch.is_tensor(fa):
                fa = win["fins"] = fa.cpu().numpy()      # read once
            if not fa.any():
                continue
            # the active chunk is unserved speculation atop the fault, or
            # is the fault: a discard either way
            self._chunk = None
            self._fin_fault(win, fa)
            return True
        return False

    def _fin_single_fault(self, pos, code: int, advanced: bool):
        """a single-cycle window (a consumed arming cycle or the pending
        one) made a non-finite batch; there is no snapshot to replay
        from, so report it and set err"""
        from ..system import System
        sys = System.get_sys()
        self._fuse_hits = 0
        self._fuse_sig = None
        self._pending = None
        self._chunk = None       # unserved speculation atop the fault
        self._fin_tail = None
        self._fin_log.clear()
        at = f" at corpus offset {pos}" if pos is not None \
            else " in the current batch"
        if code == 2:
            sys.pstr(f"\nERROR: nn#opt non-finite weights after the "
                     f"optimizer step{at}")
        else:
            sys.pstr(f"\nERROR: nn#forward non-finite{at}")
        if advanced:
            sys.pstr("\n(state has advanced past the faulting batch; "
                     "rerun with trace=1 for per-batch checks)")
        self._trace_pass("forward", range(self.numel - 1), nan_check=True)
        self.err = 1

    def _fin_fault(self, ck, fa):
        """a dispatched chunk made a non-finite batch: report it, replay
        to that batch, run its forward with the per-layer trace (which
        prints the first NaN layer as the reference's traced forward
        does) and set err"""
        from ..system import System
        sys = System.get_sys()
        fwd_bad = np.nonzero(fa == 1)[0]
        w_bad = np.nonzero(fa == 2)[0]
        # the faulting batch: the first forward with a non-finite loss,
        # the batch the reference's per-layer check flags; a weight
        # explosion (2) is reported as itself
        i = int(fwd_bad[0]) if fwd_bad.size else int(w_bad[0])
        b = ck["batch"]
        pos = ck["pos0"] + i * b
        self._fuse_hits = 0
        self._fuse_sig = None
        self._pending = None
        self._fin_tail = None
        self._fin_log.clear()
        if w_bad.size and (not fwd_bad.size or w_bad[0] < fwd_bad[0]):
            sys.pstr(f"\nERROR: nn#opt non-finite weights after the "
                     f"optimizer step at corpus offset "
                     f"{ck['pos0'] + int(w_bad[0]) * b}")
        if i == 0:
            sys.pstr(f"\nERROR: non-finite at the retained window's "
                     f"first batch (offset {pos}) — the fault may "
                     f"predate it; rerun with trace=1 or "
                     f"T4_NAN_GUARD=eager to localize")
        st, _lval, hit, _fin = self._chunk_replay(ck, i, want_stash=True)
        inp, n0 = ck["ds"], self[0]
        inp.replace_data(st[0])
        inp.label_dev = st[1].clone()
        n0.replace_data(inp.data_as(*n0.shape))
        self._apply_fwd_stash(st[2], st[3], st[4], hit)
        sys.pstr(f"\nERROR: nn#forward non-finite at corpus offset "
                 f"{pos} (batch {i} of the chunk at {ck['pos0']}); "
                 f"state rolled back to the faulting batch")
        self._trace_pass("forward", range(self.numel - 1), nan_check=True)
        self.err = 1

    _live: "weakref.WeakSet" = weakref.WeakSet()
    _alarm_busy = False

    @classmethod
    def _nan_alarm(cls):
        """mu/future.NAN_HOOK: a non-finite scalar reached the host; read
        the live models' retained windows and turn the first fault into
        the err-bit stop.  Free on healthy reads; guarded against its own
        reads."""
        if cls._alarm_busy:
            return
        cls._alarm_busy = True
        try:
            for m in list(cls._live):
                if (m._chunk is not None or m._fin_tail is not None
                        or m._fin_log
                        or (m._pending is not None
                            and m._pending.get("fin") is not None)):
                    if m._fin_check():
                        return
        finally:
            cls._alarm_busy = False

    def _trace_pass(self, name: str, order, nan_check: bool | None = None):
        """per-layer trace (reference forward.cu:44-51/backprop.cu:41-47):
        the forward pass checks each layer's output for NaN, prints the
        faulting layer, sets err (the net words stop on it) and breaks;
        backprop keeps the check at trace > 1"""
        from ..ops import engine
        from ..system import System
        sys = System.get_sys()
        if nan_check is None:
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
        self.fuse_break()                     # the one-hot swaps mid-cycle
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
        p = self._pending
        if p is not None and tgt is self._hot and not p["bwd_done"]:
            p["bwd_done"] = True
            self._cycle.append("bwd")
            if p.get("chunk"):
                # a chunk batch: its gradients exist in the chunk only;
                # the tensors show the chunk's last batch (or a rollback)
                if self._chunk is not None:
                    self._chunk["stage"] = "bwd"
                return self
            # the fused cycle computed the backward: apply its slice
            self._apply_bwd(p["dout"], p["dxs"], p["ndws"], p["ndbs"])
            return self
        if p is not None:                     # off the pattern: drop it
            self._pending = None
            self.fuse_break()
        self._chunk_abort()                   # outs and weights current
        rows = self._rows()
        outs = tuple(self[i + 1].local(rows) for i in range(self.numel - 1))
        dws, dbs = self._gather_grads()
        dout, dxs, ndws, ndbs = funcs.backward_pure(
            self._program(), bool(self.train), tgt.ensure_data(),
            self[0].local(rows), outs, self._params(True),
            self._gather_masks(), dws, dbs, flash=flash)
        self._cycle.append("bwd")
        self._apply_bwd(dout, dxs, ndws, ndbs)
        return self

    def _apply_bwd(self, dout, dxs, ndws, ndbs):
        rows = self._rows()
        self[-1].set_local(dout, rows)
        for j in range(self.numel - 1):
            t_in = self[j]
            t_in.set_local(dxs[j], rows)
            if t_in.grad[2] is not None:
                self._put(t_in, "grad", 2, ndws[j])
            if t_in.grad[3] is not None:
                self._put(t_in, "grad", 3, ndbs[j])
        from ..system import System
        if System.get_sys().trace:
            self._trace_pass("backprop", range(self.numel - 2, -1, -1))

    def _gather_masks(self):
        """the derivative masks (the rank's rows under the word mesh)"""
        rows = self._rows()
        masks = []
        for i in range(self.numel - 1):
            t_in = self[i]
            if t_in.grad_fn == Layer.BATCHNM:
                masks.append((t_in.grad[4].local(rows),
                              t_in.mtum[4].ensure_data()[:t_in.C()]))
            elif t_in.grad_fn in funcs._MASKED:
                masks.append(t_in.grad[4].local(rows))
            else:
                masks.append(None)
        return tuple(masks)

    def _gather_grads(self):
        """accumulators in their rank-4 storage shapes (the rank's shards
        under the word mesh; None for a layer without parameters)"""
        dws, dbs = [], []
        for i in range(self.numel - 1):
            t_in = self[i]
            has = t_in.grad[2] is not None
            dws.append(self._slot(t_in, "grad", 2) if has else None)
            dbs.append(self._slot(t_in, "grad", 3) if has else None)
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
        self.fuse_break()
        for t_in, slot in self._trainables():
            if t_in.grad[slot + 2] is not None:
                self._slot(t_in, "grad", slot + 2).zero_()

    def _opt_apply(self, op: int, opt: str, hyper: tuple):
        """one optimizer step, updating the payloads of the weight,
        gradient and moment tensors in place.  On the card the
        hyperparameters go as device scalars, as a captured cycle's do"""
        if not self._opt_inited:
            self.grad_alloc(op)
        self._iter += 1
        if not self.train:
            return self
        tr = self._trainables()
        ws = [self._slot(t, "grad", s) for t, s in tr]
        dws = [self._slot(t, "grad", s + 2) for t, s in tr]
        ms = [self._slot(t, "mtum", s) for t, s in tr]
        hy = funcs.hypers(opt, hyper)
        if self.device.type == "cuda":
            hy = tuple(_dev_f32(v, self.device) for v in hy)
        if opt in ("adam", "adamw"):
            vs = [self._slot(t, "mtum", s + 2) for t, s in tr]
            funcs.adam_step(ws, dws, ms, vs, opt == "adamw", *hy)
        else:
            funcs.sgd_step(ws, dws, ms, self._ndivs(), opt == "sgdm", *hy)
        return self

    def _ndivs(self):
        """SGD batch-divisor quirk: g.N() of each weight tensor"""
        return tuple(float(t.grad[s].N() if t.grad[s].rank == 4 else 1)
                     for t, s in self._trainables())

    def _try_fused_opt(self, opt: str, hyper: tuple) -> bool:
        """apply the fused cycle's speculative step if the call is the
        one it assumed (the same word and hyperparameters, the backward
        consumed)"""
        p = self._pending
        if (p is None or not p["bwd_done"] or p["opt"] != opt
                or p["hyper"] != hyper):
            return False
        self._pending = None
        self._iter += 1
        if p.get("chunk"):
            # a chunk batch: the weights moved inside the chunk; the
            # tensors show its last batch
            ck = self._chunk
            if ck is not None:
                ck["j"] += 1
                ck["stage"] = "idle"
            self._fuse_hits += 1
            self._note_opt(opt, hyper)
            return True
        if p.get("fin") is not None:
            # keep the consumed cycle's status: the sentinel's exact
            # attribution for the cycles that arm a chunk
            self._fin_log.append((p["seq"], p.get("pos"), p["fin"]))
            del self._fin_log[:-8]
        self._put_state(opt, p["nws"], p["zdws"], p["nms"], p["nvs"])
        self._fuse_hits += 1
        self._note_opt(opt, hyper)
        return True

    def _put_state(self, opt: str, nws, zws, nms, nvs):
        """a fused cycle's weights, zeroed gradients and moments into the
        trainables' tensors"""
        adamlike = opt in ("adam", "adamw")
        for i, (t, s) in enumerate(self._trainables()):
            self._put(t, "grad", s, nws[i])
            self._put(t, "grad", s + 2, zws[i])
            if adamlike:
                self._put(t, "mtum", s, nms[i])
                self._put(t, "mtum", s + 2, nvs[i])
            elif t.mtum[s] is not t.grad[s]:
                self._put(t, "mtum", s, nms[i])

    def _step(self, op: int, opt: str, hyper: tuple) -> "Model":
        """an optimizer word: the fused cycle's step when it assumed this
        one, else the per-word step on the current state"""
        if self._try_fused_opt(opt, hyper):
            return self
        self._chunk_abort()                   # the gradients current
        self._pending = None
        r = self._opt_apply(op, opt, hyper)
        self._note_opt(opt, hyper)
        return r

    def sgd(self, lr: float, b: float = 0.0) -> "Model":
        momentum = abs(b) > Config.DU_EPS
        return self._step(Optimizer.SGDM if momentum else Optimizer.SGD,
                          "sgdm" if momentum else "sgd",
                          (float(lr), float(b), 0.0, 0.0))

    def adam(self, lr: float, b1: float = 0.9, b2: float = 0.999) -> "Model":
        return self._step(Optimizer.ADAM, "adam",
                          (float(lr), float(b1), float(b2), 0.0))

    def adamw(self, lr: float, wd: float = 0.01, b1: float = 0.9,
              b2: float = 0.999) -> "Model":
        return self._step(Optimizer.ADAMW, "adamw",
                          (float(lr), float(b1), float(b2), float(wd)))

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
        self.fuse_break()                     # the one-hot swaps mid-cycle
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
        """device scalar loss, no host sync; a fused cycle's own slice
        when the call is the one it assumed"""
        if tgt is None:
            tgt = self._hot
        out = self[-1]
        if tgt is None or out.numel != tgt.numel:
            self._err("nn::loss shape mismatch")
            return 0.0
        name = Loss.NAMES[op].lower()
        self._cycle.append("loss:" + name)
        p = self._pending
        if p is not None and tgt is self._hot and name == p["loss_op"]:
            return p["lval"]
        if self._chunk is not None or (p is not None and p.get("chunk")):
            # another loss during a chunk: the real per-batch state first,
            # then the stash again
            self._chunk_abort()
            p = self._pending
            if p is not None and tgt is self._hot \
                    and name == p["loss_op"]:
                return p["lval"]
        return funcs.loss_fn(name, out.ensure_data(), tgt.ensure_data())

    def loss(self, op: int, tgt: Tensor | None = None) -> float:
        return float(self.loss_dev(op, tgt))


from ..mu import future as _future  # noqa: E402  (after the class body)
_future.NAN_HOOK = Model._nan_alarm
