"""NetVM — neural-network tier (tier 3; the port of
tensorforth_tpu/vm/netvm.py).

Reference behavior: src/vm/netvm.{h,cpp}: layer words with stack-pattern
dispatch, forward/backprop handlers (incl. the for/next dataset form),
loss words, optimizer words, dataset words, model persistence, and the
LM tier's `nn.gen` and `nn.train`.  The words take the JAX package's
default path: the fused training cycle and its trace chunks (nn/model.py),
and at the dataset NEXT the macro serve of a canonical loop body while a
chunk is in flight.  T4_NO_FUSE=1 T4_NO_MACRO=1 keeps them on the
per-word path; every word that reads a model's tensors drains a chunk
first (Model.chunk_sync).

`prof.start` and `prof.stop` trace the card with torch.profiler
(runtime/prof.py).  `nn.pipe` trains over local pipeline ranks
(parallel/pipeline.py).
"""
from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..du import DU0, IS_OBJ, IS_VIEW
from ..nn.model import Model
from ..nn.ntypes import Layer, Loss
from ..system import IoOp
from .tenvm import FAM_RAW, TensorVM
from .vm import MathOp, VMState


class NetVM(TensorVM):

    # --- stack-pattern predicates (reference netvm.h:18-25) ---------------
    def IS_M(self, v) -> bool:
        o = self.mmu.du2obj(v)
        return o is not None and o.is_model() if IS_OBJ(v) else False

    def MTOS(self) -> Model:
        return self.mmu.du2obj(self.tos)

    def MNOS(self) -> Model:
        return self.mmu.du2obj(self.ss[-1])

    def IS_V(self, v) -> bool:
        """numeric value cell: a plain scalar OR a deferred device
        scalar (futures count as values everywhere a word wants a
        number — fpop()/POPi resolve them)"""
        return not IS_OBJ(v) or self.future_of(v) is not None

    def M1V(self) -> bool:
        return self.IS_M(self.ss[-1]) and self.IS_V(self.tos)

    def M2V(self) -> bool:
        return (self.ss.size() > 1 and self.IS_M(self.ss[-2])
                and self.IS_V(self.ss[-1]) and self.IS_V(self.tos))

    def MTV(self) -> bool:
        return (self.ss.size() > 1 and self.IS_M(self.ss[-2])
                and IS_OBJ(self.ss[-1])
                and self.future_of(self.ss[-1]) is None
                and self.IS_V(self.tos))

    def TOS1D(self) -> bool:
        """TOS is a tensor or dataset (reference netvm.h TOS1D)"""
        o = self.mmu.du2obj(self.tos) if IS_OBJ(self.tos) else None
        return o is not None and (o.is_tensor() or o.is_dataset())

    # ======================================================================
    # layer-word dispatcher (reference netvm.cpp:20-133)
    # ======================================================================
    def _nnop(self, op: int):
        from ..ops import engine
        if self.TOS1T():                         # tensor math (destructive)
            t = self.TTOS()
            if op == Layer.FLATTEN:
                t.reshape(t.numel)
                return
            if op == Layer.RELU:
                return self.xop1(MathOp.RELU)
            if op == Layer.TANH:
                return self.xop1(MathOp.TANH)
            if op == Layer.SIGMOID:
                return self.xop1(MathOp.SIGM)
            if op == Layer.SOFTMAX:
                d = t.ensure_data()
                mx = engine.t_max(d)
                e = engine.map_op("exp", d - mx)
                t.replace_data(e / engine.t_sum(e))
                return
            if op == Layer.LOGSMAX:
                d = t.ensure_data()
                s = engine.t_sum(d)
                if s > Config.DU_EPS:
                    t.replace_data(d - np.log(s))
                else:
                    self.sys.perr("", "logsoftmax tensor sum < 0! ")
                return
        if self.IS_M(self.tos):                   # zero-parameter layers
            m = self.MTOS()
            if op in (Layer.FLATTEN, Layer.RELU, Layer.TANH, Layer.SIGMOID,
                      Layer.SELU, Layer.SOFTMAX, Layer.LOGSMAX):
                m.add(op)
                return
            if op == Layer.LEAKYRL:
                m.add(op, 0, 0.01)
                return
            if op == Layer.ELU:
                m.add(op, 0, 1.0)
                return
            if op == Layer.BATCHNM:
                m.add(op, 0, 0.1)
                return
        if self.M1V():                            # one-parameter layers
            a = self.fpop()
            m = self.MTOS()
            if op == Layer.LINEAR:
                m.add(op, int(a), 1.0)
                return
            if op in (Layer.LEAKYRL, Layer.ELU, Layer.DROPOUT):
                m.add(op, 0, a)
                return
            if op in (Layer.AVGPOOL, Layer.MAXPOOL, Layer.MINPOOL):
                m.add(op, int(a))
                return
            if op == Layer.BATCHNM:
                m.add(op, 0, a)
                return
            if op == Layer.USAMPLE:
                from ..nn.ntypes import Upsample
                m.add(op, int(a), float(Upsample.NEAREST))
                return
            self.PUSH(np.float32(a))              # restore, try 2-param form
        if op == Layer.LINEAR:
            if self.M2V():
                c = self.POPi()
                bias = self.fpop()
                self.MTOS().add(op, c, bias)
            else:
                self.sys.perr("", "( N [bias] n -- ) for linear required! ")
            return
        if op == Layer.USAMPLE:
            if self.M2V():
                n = self.POPi()
                mth = self.fpop()
                self.MTOS().add(op, n, mth)
            else:
                self.sys.perr("", "( N [mtum] n -- ) for upsample required? ")
            return
        if not IS_OBJ(self.tos):
            if op == Layer.RELU:
                return self.xop1(MathOp.RELU, DU0)
            if op == Layer.TANH:
                return self.xop1(MathOp.TANH)
            if op == Layer.SIGMOID:
                return self.xop1(MathOp.SIGM)
        self.sys.perr("", f"layer {op} not supported ")

    # --- conv (reference netvm.cpp:203-226) ---------------------------------
    def _conv(self, k: int = 3, txn: bool = False, s: int = 1,
              p: int = 0, d: int = 1):
        opt = [k, s, p, d]
        if self.TOS1T():                          # optional config vector
            t = self.TTOS()
            if t.rank == 1:
                vals = t.numpy().reshape(-1)[:4]
                self.DROP_DU(self.POP())
                for i, v in enumerate(vals):
                    opt[i] = int(v)
            else:
                self.sys.perr("", "vec? ")
                return
        if not self.M2V():
            self.sys.perr("", "Model#add bias c for conv2d required! ")
            return
        c = self.POPi()
        bias = self.fpop()
        self.MTOS().add(Layer.DCONV if txn else Layer.CONV, c, bias, opt)

    # --- forward / backprop (reference netvm.cpp:230-264) -------------------
    def _forward(self):
        if self.IS_M(self.ss[-1]) and self.TOS1D():
            x = self.POP()
            self.MTOS().forward(self.mmu.du2obj(x))
            if self.MTOS().err:
                self.state = VMState.STOP
            self.DROP_DU(x)
        elif self.IS_M(self.tos) and self.rs.size() and IS_OBJ(self.rs[-1]):
            t = self.mmu.du2obj(self.rs[-1])
            if t is not None and t.is_dataset():
                self.MTOS().forward(t)
                if self.MTOS().err:
                    self.rs.pop()
                    self.state = VMState.STOP
            else:
                self.sys.perr("", "rs[-1] is not a dataset? ")
        else:
            self.sys.perr("", "no NN model nor a dataset? ")

    def _backprop(self):
        if self.IS_M(self.ss[-1]) and self.TOS1T():
            t = self.TTOS()
            self.MNOS().backprop(t)
            if self.MNOS().err:
                self.state = VMState.STOP
            x = self.POP()
            self.DROP_DU(x)
        elif self.IS_M(self.tos):
            self.MTOS().backprop()
            if self.MTOS().err:
                self.state = VMState.STOP
        else:
            self.sys.perr("", "TOS not a NN model? ")

    def _loss(self, op: int):
        """pushes a deferred device scalar (mu/future.py) — the training
        loop never blocks on the loss readback; printing/compares resolve"""
        if self.TOS2T():
            from ..nn import funcs
            n = funcs.loss_fn(Loss.NAMES[op].lower(),
                              self.TNOS().ensure_data(),
                              self.TTOS().ensure_data())
            self.PUSH_OBJ(self.mmu.future(n))
        elif self.TOS1T() and self.IS_M(self.ss[-1]):
            n = self.MNOS().loss_dev(op, self.TTOS())
            self.POP()
            self.PUSH_OBJ(self.mmu.future(n))
        elif self.IS_M(self.tos):
            self.PUSH_OBJ(self.mmu.future(self.MTOS().loss_dev(op)))
        else:
            self.sys.perr("", "model? ")

    # --- dataset-aware FOR/NEXT (reference eforth.cpp:614-635) ---------------
    def _ds_next(self, ioff: int):
        m = self.mmu.du2obj(self.tos)
        if m is None or not m.is_model():
            self.sys.perr("", "TOS is not a network model? ")
            return 0
        d = self.mmu.du2obj(self.rs[-1])
        if d is None or not d.is_dataset():
            self.sys.perr("", "RTOS is not a dataset? ")
            return 0
        if d.done:
            v = self.rs.pop()
            self.DROP_DU(v)
            m.tick()
        else:
            end = self.ip - 4            # the NEXT cell: the body ends here
            d.fetch(None, 0, self.sys.trace)
            self.ip = ioff
            if m._chunk is not None:
                self._macro_serve(m, d, ioff, end)
        return 1

    # --- trace-chunk macro serve (the JAX package's netvm.py:243-441) --------
    # While a K-batch trace chunk is in flight, the canonical cycle's words
    # (`forward loss.ce lox ! nn.hit hit +! backprop 0.001 nn.adam`) are
    # host bookkeeping only: stage advances, the chunk's LazyIdx futures,
    # variable stores, lazy-sum appends.  At the dataset NEXT the loop body
    # is decoded once per (ioff, end); when it matches the canonical
    # grammar, the chunk's remaining batches but its last are served in
    # one tight loop with no interpreter dispatch, with the per-word
    # path's semantics (the same futures' values, mark_free order, RNG
    # burn and _cycle/_note_opt bookkeeping).  The last batch is left to
    # the interpreter, so the tensors materialize through _chunk_fwd and
    # _chunk_apply_last; a body that does not match (another word, a
    # hyperparameter that is not a literal or a value, t4_30e's `hint`)
    # keeps the per-word path.  T4_NO_MACRO=1 turns it off.
    def _body_plan(self, ioff: int, end: int):
        """decode and match the loop body [ioff, end): (actions, value
        addresses, optimizer word) or None.  actions: ("loss", op, sink,
        addr) / ("hit", sink, addr), sink in {"store", "plus", "drop"}"""
        from .pmem import ALIGN, DU_SZ, IU_SZ, Prim
        cache = getattr(self, "_mplan_cache", None)
        if cache is None:
            cache = self._mplan_cache = {}
        raw = bytes(self.pmem.buf[ioff:end])
        hit = cache.get((ioff, end))
        if hit is not None and hit[1] == raw:
            return hit[0]
        toks = []
        a = ioff
        ok = True
        while a < end:
            p = self.pmem.rd_param(a)
            a += IU_SZ
            if p.op == Prim.LIT and not p.exit:
                toks.append(("val", a))
                a += DU_SZ
            elif p.op >= Prim.MAX_OP and not p.udf:
                if p.ioff >= len(self.dict):
                    ok = False
                    break
                toks.append(("word", self.dict[p.ioff].name))
            elif p.op >= Prim.MAX_OP and p.udf:
                t = self.pmem.rd_param(p.ioff)
                if t.op == Prim.VAR and t.ioff == 0:
                    toks.append(("addr", ALIGN(p.ioff + IU_SZ)))
                elif t.op == Prim.LIT and t.exit:
                    toks.append(("val", p.ioff + IU_SZ))
                else:
                    ok = False
                    break
            else:
                ok = False
                break
        plan = self._match_plan(toks) if ok and a == end else None
        cache[(ioff, end)] = (plan, raw)
        if len(cache) > 64:
            cache.pop(next(iter(cache)))
        return plan

    @staticmethod
    def _match_plan(toks):
        """grammar: forward (metric sink)* backprop val{1,2} opt"""
        n = len(toks)
        if n < 3 or toks[0] != ("word", "forward"):
            return None
        actions, i = [], 1
        while i < n and toks[i][0] == "word" and (
                toks[i][1].startswith("loss.") or toks[i][1] == "nn.hit"):
            kind = ("hit",) if toks[i][1] == "nn.hit" \
                else ("loss", toks[i][1][5:])
            i += 1
            if i < n and toks[i] == ("word", "drop"):
                actions.append(kind + ("drop", 0))
                i += 1
            elif (i + 1 < n and toks[i][0] == "addr"
                    and toks[i + 1][0] == "word"
                    and toks[i + 1][1] in ("!", "+!")):
                sink = "store" if toks[i + 1][1] == "!" else "plus"
                actions.append(kind + (sink, toks[i][1]))
                i += 2
            else:
                return None
        if i >= n or toks[i] != ("word", "backprop"):
            return None
        i += 1
        vals = []
        while i < n and toks[i][0] == "val" and len(vals) < 2:
            vals.append(toks[i][1])
            i += 1
        if not vals or i != n - 1 or toks[i][0] != "word" \
                or toks[i][1] not in ("nn.sgd", "nn.adam", "nn.adamw"):
            return None
        addrs = [a[-1] for a in actions if a[-2] != "drop"]
        if len(addrs) != len(set(addrs)):
            return None          # two sinks on one cell: per-word path
        return (tuple(actions), tuple(vals), toks[i][1])

    def _plan_opt(self, plan):
        """(opt, hyper) the plan's optimizer call will make: the arity of
        Model.sgd/adam/adamw and of the M1V/M2V dispatch"""
        _actions, vals, optw = plan
        v = [float(self.pmem.rd_du(a)) for a in vals]
        if optw == "nn.sgd":
            lr, b = (v[0], 0.0) if len(v) == 1 else (v[0], v[1])
            eps = Config.DU_EPS
            return ("sgdm" if abs(b) > eps else "sgd", (lr, b, 0.0, 0.0))
        if optw == "nn.adam":
            lr, b1 = (v[0], 0.9) if len(v) == 1 else (v[0], v[1])
            return ("adam", (lr, b1, 0.999, 0.0))
        lr, wd = (v[0], 0.01) if len(v) == 1 else (v[0], v[1])
        return ("adamw", (lr, 0.9, 0.999, wd))

    def _macro_serve(self, m: Model, d, ioff: int, end: int):
        if os.environ.get("T4_NO_MACRO", "0") == "1":
            return
        ck = m._chunk
        if ck is None or ck["stage"] != "idle" or ck["ds"] is not d \
                or ck["j"] >= ck["k"] - 1:
            return
        plan = self._body_plan(ioff, end)
        if plan is None:
            return
        try:
            opt, hyper = self._plan_opt(plan)
        except Exception:
            return
        if opt != ck["opt"] or hyper != ck["hyper"]:
            return
        for act in plan[0]:
            if act[0] == "loss" and act[1] != ck["loss_op"]:
                return
        from ..mu.future import LazyIdx
        mmu, pm, sys_ = self.mmu, self.pmem, self.sys
        # one future per sink, advanced in place: the batches between the
        # first served one and the chunk's last are not observable (no
        # word runs), so the end-of-chunk values are the per-word path's;
        # only the objects' ids differ (mstat's counts)
        cached = [None] * len(plan[0])
        seeds, lvals, hits = ck["seeds"], ck["lvals"], ck["hits"]
        kk, pos0, bsz = ck["k"] - 1, ck["pos0"], ck["batch"]
        while m._chunk is ck and ck["stage"] == "idle":
            j = ck["j"]
            if j >= kk or d.done:
                break
            spec = d._fetch_spec
            if spec is None or int(spec) != pos0 + j * bsz:
                break
            if seeds is not None:
                if sys_.peek_keys(1)[0] != seeds[j]:
                    break             # a stray RNG consumer: per word
                sys_.next_key()       # the seed this forward burns
                m._fwd_seed = seeds[j]
            else:
                m._fwd_seed = None
            d._fetch_spec = None
            for i, act in enumerate(plan[0]):
                vec = lvals if act[0] == "loss" else hits
                sink, addr = act[-2], act[-1]
                f = cached[i]
                if sink == "store":
                    if f is None:
                        f = mmu.future(LazyIdx(vec, j))
                        old = pm.rd_du(addr)
                        pm.wr_du(addr, mmu.obj2du(f))
                        if self.future_of(old) is not None \
                                and not IS_VIEW(old):
                            mmu.mark_free(old)
                        cached[i] = f
                    else:
                        f.data = LazyIdx(vec, j)
                elif sink == "plus":
                    if f is None:
                        f = mmu.future(LazyIdx(vec, j))
                        self._plus_into(addr, mmu.obj2du(f))
                        cached[i] = self.future_of(pm.rd_du(addr))
                    else:
                        f.pending.append(LazyIdx(vec, j))
                # "drop": the per-word path makes and frees a future no
                # one sees
            m._hit = LazyIdx(hits, j)
            m._pending = None
            m._iter += 1
            ck["j"] = j + 1
            m._fuse_hits += 1
            # _note_opt would give back the chunk's own signature (held
            # at dispatch; no word ran since): end the cycle only
            m._cycle = []
            self._macro_count = getattr(self, "_macro_count", 0) + 1
            d.fetch(None, 0, 0)       # the NEXT: stage batch j + 1

    # --- parameter access (reference netvm.cpp:157-193) ----------------------
    def _get_parm(self, n: int):
        if not self.M1V() or n > 4:
            self.sys.perr("", "N n(<5) required? ")
            return
        i = self.POPi()
        self.MTOS().chunk_sync()     # the exact per-batch state
        t = self.MTOS()[i]
        p = t.grad[n] if n else (t.grad[0] if t.grad[0] is not None
                                 else t.grad[4])
        if p is not None:
            self.PUSH(self.DUP_DU(self.mmu.obj2du(p)))
        else:
            self.PUSH(DU0)

    def _set_parm(self, n: int):
        if not self.MTV():
            self.sys.perr("", "N T n required? ")
            return
        i = self.POPi()
        t = self.TTOS()
        mt = self.MNOS()[i]
        p = mt.grad[n] if n else (mt.grad[0] if mt.grad[0] is not None
                                  else mt.grad[4])
        if p is not None and t.numel == p.numel:
            if p is not t:
                self.MNOS().fuse_break()      # a direct weight write
                p.replace_data(t.ensure_data().reshape(p.shape))
                x = self.POP()
                self.DROP_DU(x)
            else:
                self.sys.perr("", "Updating the same param tensor ")
        else:
            self.PUSH(np.float32(i))
            self.sys.perr("", "Tensor and model parameter shape mismatch ")

    # --- model persistence --------------------------------------------------
    def _npickle(self, save: bool):
        mode = 0
        if self.ss.size() > 1 and IS_OBJ(self.ss[-2]):
            pass
        elif self.ss.size() > 2 and IS_OBJ(self.ss[-3]):
            mode = self.POPi()
        else:
            self.sys.perr("", "(model|tensor) adr len [mode]? ")
            return
        self.POPi()
        fn = self.pmem.rd_str(self.POPi())
        from ..io.nnio import nsave, nload
        if self.IS_M(self.tos):
            self.MTOS().chunk_sync()
            if save:
                nsave(self.MTOS(), fn, mode)
            else:
                nload(self, self.MTOS(), fn, mode)
        else:
            from ..io.aio import AIO
            io = AIO.get_io(self.sys)
            if save:
                io.tsave(self.TTOS(), fn, raw=bool(mode & FAM_RAW))
            else:
                io.tload(self.TTOS(), fn)

    # ======================================================================
    # vocabulary (reference netvm.cpp:291-485)
    # ======================================================================
    def init(self):
        super().init()
        if self.id != 0 or self.dict.find("nn.model"):
            return
        CODE = lambda nm, fn: self.dict.add_code(nm, fn)

        CODE("\nNetwork::", lambda vm: None)
        # --- model creation ----------------------------------------------------
        def _model(vm):
            if (vm.ss.size() < 3 or IS_OBJ(vm.tos) or IS_OBJ(vm.ss[-1])
                    or IS_OBJ(vm.ss[-2]) or IS_OBJ(vm.ss[-3])):
                vm.sys.perr("", "n h w c? ")
                return
            c = vm.POPi(); w = vm.POPi(); h = vm.POPi(); n = vm.POPi()
            m = vm.mmu.model()
            t = vm.mmu.tensor(n, h, w, c)
            m.npush(t)
            vm.PUSH_OBJ(m)
        CODE("nn.model", _model)
        # --- conv / linear -------------------------------------------------------
        CODE("conv1x1", lambda vm: vm._conv(1))
        CODE("conv2d",  lambda vm: vm._conv(3))
        CODE("dconv2d", lambda vm: vm._conv(4, True, 2))
        CODE("linear",  lambda vm: vm._nnop(Layer.LINEAR))
        # --- activations -----------------------------------------------------------
        CODE("relu",      lambda vm: vm._nnop(Layer.RELU))
        CODE("tanh",      lambda vm: vm._nnop(Layer.TANH))
        CODE("sigmoid",   lambda vm: vm._nnop(Layer.SIGMOID))
        CODE("selu",      lambda vm: vm._nnop(Layer.SELU))
        CODE("leakyrelu", lambda vm: vm._nnop(Layer.LEAKYRL))
        CODE("elu",       lambda vm: vm._nnop(Layer.ELU))
        CODE("softmax",   lambda vm: vm._nnop(Layer.SOFTMAX))
        CODE("logsoftmax", lambda vm: vm._nnop(Layer.LOGSMAX))
        CODE("batchnorm", lambda vm: vm._nnop(Layer.BATCHNM))
        # --- pooling / dropout / upsample ----------------------------------------------
        def _attn(vm):
            """( M [flags] h -- M' ) multi-head self-attention layer over
            the model's [N, S, E, 1] activations; optional flags:
            bit0 (1) = causal mask, bit1 (2) = rotary position embedding
            (RoPE) on q/k — e.g. `3 8 nn.attn` is a causal RoPE layer
            (extension word; the reference's roadmap tier — see
            nn/funcs.py _mha_fwd)"""
            if vm.M2V():
                h = vm.POPi()
                flags = float(vm.POPi() & 3)
                vm.MTOS().add(Layer.ATTN, h, flags)
            elif vm.M1V():
                h = vm.POPi()
                vm.MTOS().add(Layer.ATTN, h)
            else:
                vm.sys.perr("", "( M [causal] heads -- ) for nn.attn! ")
        CODE("nn.attn", _attn)
        def _moe(vm):
            """( M [k] F E -- M' ) mixture-of-experts FFN layer: E
            experts with hidden dim F, top-k routing (default k=2) over
            the model's [N, S, D, 1] activations (nn/funcs.py _moe_fwd)"""
            if (vm.ss.size() > 2 and vm.IS_M(vm.ss[-3])
                    and not IS_OBJ(vm.ss[-2]) and not IS_OBJ(vm.ss[-1])
                    and not IS_OBJ(vm.tos)):
                e = vm.POPi(); f = vm.POPi(); k = vm.POPi()
                vm.MTOS().add(Layer.MOE, e, float(f), [k])
            elif vm.M2V():
                e = vm.POPi(); f = vm.POPi()
                vm.MTOS().add(Layer.MOE, e, float(f), [2])
            else:
                vm.sys.perr("", "( M [k] F E -- ) for nn.moe! ")
        CODE("nn.moe", _moe)
        def _lnorm(vm):
            """( M [eps] -- M' ) layer normalization over the feature
            axis with learnable gamma/beta (extension word — the
            transformer-tier norm; eps defaults to 1e-5)"""
            if vm.M1V():
                eps = vm.fpop()
                vm.MTOS().add(Layer.LNORM, 0, eps)
            elif vm.IS_M(vm.tos):
                vm.MTOS().add(Layer.LNORM)
            else:
                vm.sys.perr("", "( M [eps] -- ) for layernorm! ")
        CODE("layernorm", _lnorm)
        def _embed(vm):
            """( M E V -- M' ) token-embedding layer: vocab V, dim E
            (extension word, LM/serving tier; input is [N,S,1,1] ids)"""
            if vm.M2V():
                v = vm.POPi()
                e = vm.POPi()
                vm.MTOS().add(Layer.EMBED, v, float(e))
            else:
                vm.sys.perr("", "( M E V -- ) for nn.embed! ")
        CODE("nn.embed", _embed)
        def _proj(vm):
            """( M [b] V -- M' ) position-wise projection (LM head):
            [N,S,E,1] -> [N,S,V,1]"""
            if vm.M2V():
                v = vm.POPi()
                b = vm.fpop()
                vm.MTOS().add(Layer.PROJ, v, b)
            elif vm.M1V():
                v = vm.POPi()
                vm.MTOS().add(Layer.PROJ, v)
            else:
                vm.sys.perr("", "( M [b] V -- ) for nn.proj! ")
        CODE("nn.proj", _proj)
        CODE("maxpool",  lambda vm: vm._nnop(Layer.MAXPOOL))
        CODE("avgpool",  lambda vm: vm._nnop(Layer.AVGPOOL))
        CODE("minpool",  lambda vm: vm._nnop(Layer.MINPOOL))
        CODE("dropout",  lambda vm: vm._nnop(Layer.DROPOUT))
        CODE("upsample", lambda vm: vm._nnop(Layer.USAMPLE))
        # --- loss -------------------------------------------------------------------------
        CODE("loss.mse", lambda vm: vm._loss(Loss.MSE))
        CODE("loss.bce", lambda vm: vm._loss(Loss.BCE))
        CODE("loss.ce",  lambda vm: vm._loss(Loss.CE))
        CODE("loss.nll", lambda vm: vm._loss(Loss.NLL))
        def _nn_loss(vm):
            if vm.IS_M(vm.tos) or (vm.TOS1T() and vm.IS_M(vm.ss[-1])):
                m = vm.MTOS() if vm.IS_M(vm.tos) else vm.MNOS()
                fn = m[-2].grad_fn
                if fn in (Layer.TANH, Layer.SIGMOID):
                    vm._loss(Loss.BCE)
                elif fn == Layer.SOFTMAX:
                    vm._loss(Loss.CE)
                elif fn == Layer.LOGSMAX:
                    vm._loss(Loss.NLL)
                else:
                    vm._loss(Loss.MSE)
            else:
                vm.sys.perr("", "TOS is not a tensor or NOS not a model! ")
        CODE("nn.loss", _nn_loss)
        def _nn_onehot(vm):
            if vm.IS_M(vm.tos):
                hot = vm.MTOS().onehot()
                vm.PUSH(vm.DUP_DU(vm.mmu.obj2du(hot)))
            else:
                vm.sys.perr("", "TOS is not a model! ")
        CODE("nn.onehot", _nn_onehot)
        def _nn_onehot_set(vm):
            if IS_OBJ(vm.tos) and vm.IS_M(vm.ss[-1]):
                hot = vm.mmu.du2obj(vm.POP())
                vm.MTOS().onehot(hot)
            else:
                vm.sys.perr("", "model tensor? ")
        CODE("nn.onehot=", _nn_onehot_set)
        def _nn_hit(vm):
            if vm.IS_M(vm.tos):
                # deferred device scalar: `nn.hit hit +!` accumulates on
                # device; the epoch-end print is the only readback
                vm.PUSH_OBJ(vm.mmu.future(vm.MTOS().hit_dev()))
            else:
                vm.sys.perr("", "TOS is not a model! ")
        CODE("nn.hit", _nn_hit)
        # --- gradient ops ----------------------------------------------------------------------
        def _nn_zero(vm):
            if vm.IS_M(vm.tos):
                vm.MTOS().grad_zero()
            else:
                vm.sys.perr("", "TOS is not a model! ")
        CODE("nn.zero", _nn_zero)
        def _nn_sgd(vm):
            if vm.M2V():
                b = vm.fpop(); lr = vm.fpop()
                vm.MTOS().sgd(lr, b)
            elif vm.M1V():
                lr = vm.fpop()
                vm.MTOS().sgd(lr)
            else:
                vm.sys.perr("", "rate mtum nn.sgd? ")
        CODE("nn.sgd", _nn_sgd)
        def _nn_adam(vm):
            if vm.M2V():
                b1 = vm.fpop(); lr = vm.fpop()
                vm.MTOS().adam(lr, b1)
            elif vm.M1V():
                lr = vm.fpop()
                vm.MTOS().adam(lr)
            else:
                vm.sys.perr("", "rate [beta1] nn.adam? ")
        CODE("nn.adam", _nn_adam)
        def _nn_adamw(vm):
            if vm.M2V():
                wd = vm.fpop(); lr = vm.fpop()
                vm.MTOS().adamw(lr, wd)
            elif vm.M1V():
                lr = vm.fpop()
                vm.MTOS().adamw(lr)
            else:
                vm.sys.perr("", "rate [wd] nn.adamw? ")
        CODE("nn.adamw", _nn_adamw)
        def _max_norm(vm):
            if vm.M1V():
                vm.MTOS().max_norm = vm.fpop()
            else:
                vm.sys.perr("", "norm model? ")
        CODE("nn.max_norm", _max_norm)
        # --- batch control --------------------------------------------------------------------------
        def _trainable(vm):
            if vm.M1V():
                flag = vm.POPi()
                vm.MTOS().chunk_sync()
                vm.MTOS().train = 1 if flag else 0
            else:
                vm.sys.perr("", "N [1|0] required ")
        CODE("trainable", _trainable)
        def _batchsize(vm):
            if vm.IS_M(vm.tos):
                vm.PUSH(np.float32(vm.MTOS().batch_size()))
            else:
                vm.sys.perr("", "TOS a model? ")
        CODE("batchsize", _batchsize)
        def _dataset(vm):
            dsn = vm.sys.fetch()
            ds = vm.mmu.dataset(vm.POPi())
            vm.PUSH(vm.mmu.obj2du(ds))
            ds.fetch(dsn, 0, vm.sys.trace)
        CODE("dataset", _dataset)
        def _normalize(vm):
            t = vm.mmu.du2obj(vm.ss[-2]) if vm.ss.size() > 1 else None
            if t is not None and t.is_dataset():
                scale = vm.fpop(); mean = vm.POPi()
                t.normalize(mean, scale)
                t.rewind(vm.sys.trace)
            else:
                vm.sys.perr("", "DS mean scale? ")
        CODE("normalize", _normalize)
        def _fetch(vm):
            d = vm.mmu.du2obj(vm.tos)
            if d is not None and d.is_dataset():
                d.fetch(None, 0, vm.sys.trace)
        CODE("fetch", _fetch)
        def _rewind(vm):
            d = vm.mmu.du2obj(vm.tos)
            if d is not None and d.is_dataset():
                d.rewind(vm.sys.trace)
        CODE("rewind", _rewind)
        def _ds_tell(vm):
            """( D -- D pos ) corpus sample position — with ds.seek this
            checkpoints MID-EPOCH progress (extension: the reference
            never persists batch_id, SURVEY §5, so its resumes restart
            the epoch)"""
            d = vm.mmu.du2obj(vm.tos)
            if d is None or not d.is_dataset():
                vm.sys.perr("", "D ds.tell? ")
                return
            vm.PUSH(np.float32(d._corpus._pos if d._corpus else 0))
        CODE("ds.tell", _ds_tell)
        def _ds_seek(vm):
            """( D pos -- D ) reposition the corpus; the next fetch
            serves the batch starting at sample `pos`"""
            # validate BOTH operands before popping anything so the
            # usage-error path leaves the stack untouched, matching
            # ds.tell and the other words
            if vm.ss.size() < 1 or IS_OBJ(vm.tos):
                vm.sys.perr("", "D pos ds.seek? ")
                return
            d = vm.mmu.du2obj(vm.ss[-1])
            if d is None or not d.is_dataset() or d._corpus is None:
                vm.sys.perr("", "D pos ds.seek? ")
                return
            pos = vm.POPi()
            cp = d._corpus
            cp._pos = max(0, min(int(pos), cp.size))
            cp.eof = cp._pos >= cp.size
            d.done = cp.eof
            d.batch_id = cp._pos // max(d.batch_sz, 1) - 1
        CODE("ds.seek", _ds_seek)
        CODE("forward",  lambda vm: vm._forward())
        CODE("backprop", lambda vm: vm._backprop())
        def _broadcast(vm):
            if vm.IS_M(vm.ss[-1]) and vm.TOS1T():
                y = vm.POP()
                vm.MTOS().broadcast(vm.mmu.du2obj(y))
                vm.DROP_DU(y)
            else:
                vm.sys.perr("", "TOS not a tensor nor NOS a model? ")
        CODE("broadcast", _broadcast)
        # --- debugging -------------------------------------------------------------------------------------
        def _network(vm):
            if vm.IS_M(vm.tos):
                vm.MTOS().chunk_sync()
                vm.sys.dot(IoOp.DOT, vm.tos)
        CODE("network", _network)
        def _npush(vm):
            if vm.M1V():
                t = vm.POP()
                vm.MTOS().npush(vm.mmu.du2obj(t))
        CODE(">n", _npush)
        def _nat(vm):
            if not vm.M1V():
                return
            i = vm.POPi()
            vm.MTOS().chunk_sync()   # the exact per-batch state
            t = vm.MTOS()[i]
            vm.PUSH(vm.DUP_DU(vm.mmu.obj2du(t)))
        CODE("n@", _nat)
        def _nn_len(vm):
            if IS_OBJ(vm.tos):
                t = vm.mmu.du2obj(vm.tos)
                if t.is_model():
                    vm.PUSH(np.float32(t.numel))
                elif t.is_dataset():
                    vm.PUSH(np.float32(t.dataset_size))
                else:
                    vm.PUSH(np.float32(t.N()))
            else:
                vm.sys.perr("", "TOS a tensor, dataset, or model? ")
        CODE("nn.len", _nn_len)
        CODE("nn.w",  lambda vm: vm._get_parm(0))
        CODE("nn.b",  lambda vm: vm._get_parm(1))
        CODE("nn.dw", lambda vm: vm._get_parm(2))
        CODE("nn.db", lambda vm: vm._get_parm(3))
        CODE("nn.ex", lambda vm: vm._get_parm(4))
        CODE("nn.w=", lambda vm: vm._set_parm(0))
        CODE("nn.b=", lambda vm: vm._set_parm(1))
        # --- extension: fused epoch training, pipeline training ----------
        def _nn_train(vm):
            """( M D lr epochs -- M ) extension word: train the model on
            the dataset with Adam for n epochs, each epoch a loop of one
            batch step over the corpus on the device (nn/train.py: a
            captured CUDA graph replayed once a batch on the card).
            Under T4_MESH each rank steps its dp rows of a batch
            (funcs.word_mesh), uncaptured."""
            if not (vm.ss.size() > 2 and vm.IS_M(vm.ss[-3])):
                vm.sys.perr("", "M D lr epochs nn.train? ")
                return
            epochs = vm.POPi()
            lr = vm.fpop()
            dsv = vm.POP()
            ds = vm.mmu.du2obj(dsv)
            m = vm.MTOS()
            m.chunk_sync()
            from ..nn.train import train_epochs
            loss = train_epochs(m, ds, lr=lr, epochs=epochs,
                                trace=vm.sys.trace)
            vm.DROP_DU(dsv)
            vm.sys.pstr(f"\\ nn.train {epochs} epochs done, "
                        f"final loss={loss:.6g}\n")
        CODE("nn.train", _nn_train)
        def _nn_pipe(vm):
            """( M D lr epochs stages -- M ) extension word: pipeline-
            parallel training — the model's repeated body (e.g. stacked
            nn.attn blocks) runs GPipe-style over a 'pp' mesh axis of
            `stages` local ranks (parallel/launch.py), microbatches
            passing from rank to rank; the head replicates.  Needs a body
            of `stages` identical blocks (parallel/pipeline.py
            train_pipeline)."""
            if not (vm.ss.size() > 3 and vm.IS_M(vm.ss[-4])):
                vm.sys.perr("", "M D lr epochs stages nn.pipe? ")
                return
            stages = vm.POPi()
            epochs = vm.POPi()
            lr = vm.fpop()
            dsv = vm.POP()
            ds = vm.mmu.du2obj(dsv)
            m = vm.MTOS()
            m.chunk_sync()       # params must reflect any in-flight chunk
            from ..parallel.pipeline import train_pipeline
            loss = train_pipeline(m, ds, lr=lr, epochs=epochs,
                                  stages=stages, trace=vm.sys.trace)
            vm.DROP_DU(dsv)
            vm.sys.pstr(f"\\ nn.pipe {epochs} epochs over pp{stages} done, "
                        f"final loss={loss:.6g}\n")
        CODE("nn.pipe", _nn_pipe)
        def _nn_gen(vm):
            """( M T n [temp [topk [topp]]] -- M T' ) extension word:
            autoregressive generation — extend the id sequence T by n
            tokens with a KV-cache decode loop (nn/serve.py; its prefill
            runs the flash forward kernel).  temp=0/omitted is greedy; with
            temp>0, optional top-k then nucleus top-p filtering shape
            the categorical draw (0 disables either)."""
            # count the trailing scalars above T (1..4: n temp k p);
            # deepest needed probe is ss[-5] (T and M under 4 scalars)
            vals = [vm.tos] + [vm.ss[-i]
                               for i in range(1, min(vm.ss.size(), 5) + 1)]
            c = 0
            while c < min(len(vals), 4) and not IS_OBJ(vals[c]):
                c += 1
            if not (1 <= c <= 4 and c + 1 < len(vals)
                    and IS_OBJ(vals[c]) and vm.IS_M(vals[c + 1])):
                vm.sys.perr("", "M T n [temp [topk [topp]]] nn.gen? ")
                return
            sc = [vm.fpop() for _ in range(c)]    # top-of-stack first
            n_new = int(sc[-1])
            temp = float(sc[-2]) if c >= 2 else 0.0
            top_k = int(sc[-3]) if c >= 3 else 0
            top_p = float(sc[-4]) if c >= 4 else 0.0
            tv = vm.POP()
            t = vm.mmu.du2obj(tv)
            m = vm.MTOS()
            m.chunk_sync()       # generate() reads _params(): drain a chunk
            from ..nn.serve import generate
            # a matrix prompt [N, S0] decodes N sequences in one program
            ids = t.numpy().reshape(t.H(), t.W()) if t.rank == 2 \
                else t.numpy().reshape(-1)
            out = generate(m, ids, n_new, temp=temp,
                           seed=vm.sys.next_key() & 0x7FFFFFFF,
                           top_k=top_k, top_p=top_p)
            ot = vm.mmu.tensor(*out.shape)
            ot.set_numpy(out.astype(np.float32))
            vm.DROP_DU(tv)
            vm.PUSH(vm.mmu.obj2du(ot))
        CODE("nn.gen", _nn_gen)
        def _prof_start(vm):
            """( -- ) start a device profiler trace (torch.profiler:
            host operators and, on the card, its kernels).  Extension
            beyond the reference: its `trace` word (src/sys/debug.cpp)
            prints per-layer activation stats; this captures the
            timeline into <tb-logdir>/plugins/profile — or ./t4_profile
            without -t — for TensorBoard's profiler"""
            from ..runtime import prof
            logdir = vm.sys.tb.path if vm.sys.tb else "t4_profile"
            try:
                prof.start_trace(logdir)
                vm._prof_dir = logdir
            except Exception as e:               # noqa: BLE001
                vm.sys.perr("", f"prof.start failed ({e}) ")
        CODE("prof.start", _prof_start)
        def _prof_stop(vm):
            """( -- ) stop the profiler trace and report its location"""
            from ..runtime import prof
            try:
                prof.stop_trace()
                vm.sys.pstr("\\ profile -> "
                            f"{getattr(vm, '_prof_dir', 't4_profile')}\n")
            except Exception as e:               # noqa: BLE001
                vm.sys.perr("", f"prof.stop failed ({e}) ")
        CODE("prof.stop", _prof_stop)
        # --- overrides ------------------------------------------------------------------------------------------
        CODE("boot", lambda vm: vm.dict.clear(vm.dict.find("network") + 1))
        CODE("flatten", lambda vm: vm._nnop(Layer.FLATTEN))
        CODE("save", lambda vm: vm._npickle(True))
        CODE("load", lambda vm: vm._npickle(False))
        CODE("nn.load", lambda vm: vm._npickle(False))
        CODE("\nUser::", lambda vm: None)
