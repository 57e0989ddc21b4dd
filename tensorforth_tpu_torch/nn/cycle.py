"""The fused training cycle over buffers of its own, replayed as a captured
CUDA graph on the card (the port of the JAX package's get_fused_cycle,
get_fused_cycle_ds and get_fused_chunk_ds, nn/funcs.py:718-912).

A Cycle runs `funcs.fused_cycle_body` on tensors it owns: the trainables'
weights and moments, the gradient accumulators, the batch's source (a
slice of the resident corpus, or an input and labels copied in), a
position, a counter, the dropout keys of up to `kcap` batches and the
optimizer's hyperparameters.  One run of the body takes batch j = the
counter: it reads its corpus offset pos0 + j * batch and its keys from
the buffers, steps the weights and moments in place, zeroes the
accumulators, writes its loss, hit count and finite status into slot j of
three vectors and adds one to the counter.  So k runs in a row are k
canonical cycles threaded through one state: the JAX package's scan,
and a single run is its fused cycle.  `stash` holds the last run's other
outputs (activations, masks, one-hot, gradients), which the words read.

On the CPU a run calls the body.  On the card the body is captured once
into a torch.cuda.CUDAGraph (after two warm-up runs on the capture
stream, which load the kernels and cuBLAS's workspace), and a run
replays it: the hyperparameters live in a device buffer, so a new rate
needs no new capture.  A failed capture or replay raises; nothing falls
back to the eager body on the card.

The buffers are overwritten by every run.  What the words keep must be
copied out before the next one: Tensor.replace_data copies, and
`results` hands out fresh copies of the loss, hit and status vectors.
Cycles are cached per model and signature, at most CACHE_SIZE of them,
as the JAX package's lru_cache keeps its programs.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..config import Config
from ..parallel import moe
from ..runtime.capture import CAPTURE_LOCK
from . import funcs
from .ntypes import Layer

CACHE_SIZE = 64
WARMUP = 2               # runs on the capture stream before the capture
_CACHE: OrderedDict = OrderedDict()

# what the fused paths did since the last reset_counts(): single fused
# cycles, chunks dispatched, batches run through a Cycle (graph replays on
# the card), graphs captured
COUNTS = {"fused": 0, "chunks": 0, "runs": 0, "captures": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


class Cycle:
    def __init__(self, model, program, train: bool, loss_op: str, opt: str,
                 ndivs: tuple, src: tuple, kcap: int):
        dev = model.device
        self.device = dev
        # captured on the card, but for a mesh: gloo's collectives run on
        # the host and cannot be captured (funcs.word_mesh)
        self.on_card = dev.type == "cuda" and funcs.word_mesh() is None
        self.program, self.train = program, train
        self.loss_op, self.opt, self.ndivs = loss_op, opt, ndivs
        self.src = src
        tr = model._trainables()
        # the rank's shards under the word mesh (Model._slot)
        zeros = lambda t, w, k: torch.zeros_like(  # noqa: E731
            model._slot(t, w, k))
        self.W = [zeros(t, "grad", s) for t, s in tr]
        self.adamlike = opt in ("adam", "adamw")
        self.M = [zeros(t, "grad", s) for t, s in tr] if opt != "sgd" \
            else self.W
        self.V = [zeros(t, "grad", s) for t, s in tr] if self.adamlike \
            else []
        # accumulators of the layers with parameters, in their storage
        # shapes (Model._gather_grads); None for the others
        self.DW = [zeros(model[j], "grad", 2) if model[j].grad[2] is not None
                   else None for j in range(len(program))]
        self.DB = [zeros(model[j], "grad", 3) if model[j].grad[3] is not None
                   else None for j in range(len(program))]
        # the program-indexed params the layers read: views of W in the
        # shapes Model._params() gives
        flat, params = iter(self.W), []
        for pl in model._params(True):
            params.append(tuple(next(flat).view(p.shape) for p in pl))
        self.params = tuple(params)
        self.kcap = kcap
        self.ctr = torch.zeros((), dtype=torch.int64, device=dev)
        self.pos0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.L = torch.zeros(kcap, dtype=torch.float32, device=dev)
        self.H = torch.zeros(kcap, dtype=torch.float32, device=dev)
        self.F = torch.zeros(kcap, dtype=torch.int8, device=dev)
        self.drop = [j for j, spec in enumerate(program)
                     if spec[0] == Layer.DROPOUT]
        self.KEYS = torch.zeros((kcap, max(len(self.drop), 1), 2),
                                dtype=torch.int64, device=dev)
        n_hy = 6 if self.adamlike else 3
        self.HY = torch.zeros(n_hy, dtype=torch.float32, device=dev)
        self.hy_host = (0.0,) * n_hy
        if src[0] == "ds":
            _, self.buf, self.labels, self.batch, mean, scale, self.in_shape \
                = src
            self.AR = torch.arange(self.batch, device=dev)
            self.MEAN = torch.tensor(mean, dtype=torch.float32, device=dev)
            self.SCALE = torch.tensor(scale, dtype=torch.float32, device=dev)
        else:
            _, self.in_shape = src
            self.X = torch.zeros(self.in_shape, device=dev)
            self.LAB = torch.zeros(self.in_shape[0], dtype=torch.int64,
                                   device=dev)
        self.n = 0               # the counter's value, on the host
        self.runs = 0            # runs since the Cycle was made
        self.graph = None
        self.stash = None

    # --- the body ----------------------------------------------------------
    def _fetch(self, j):
        if self.src[0] != "ds":
            return self.X, self.LAB
        idx = self.pos0 + j * self.batch + self.AR
        d = self.buf.index_select(0, idx)
        x = ((d.to(torch.float32) - self.MEAN) * self.SCALE).reshape(
            self.in_shape)
        return x, self.labels.index_select(0, idx)

    def _key(self, j):
        """batch j's dropout keys, per layer, as pairs of 0-d tensors"""
        kj = self.KEYS.index_select(0, j.view(1))[0]
        at = {layer: i for i, layer in enumerate(self.drop)}
        return lambda layer: (kj[at[layer], 0], kj[at[layer], 1])

    def _body(self):
        j = self.ctr
        x, lab = self._fetch(j)
        key = self._key(j) if self.drop else None
        hy = (tuple(self.HY[i] for i in range(self.HY.numel()))
              if self.on_card else self.hy_host)
        st = funcs.fused_cycle_body(
            self.program, self.train, self.loss_op, self.opt, self.ndivs,
            x, self.params, self.DW, self.DB, self.W, self.M, self.V, lab,
            key, hy)
        for acc in self.DW + self.DB:        # the next batch's start
            if acc is not None:
                acc.zero_()
        jj = j.view(1)
        self.L.index_copy_(0, jj, st[4].reshape(1))
        self.H.index_copy_(0, jj, st[3].reshape(1).to(torch.float32))
        self.F.index_copy_(0, jj, st[13].reshape(1))
        self.ctr.add_(1)
        self.stash = (x, lab) + st

    # --- loading state, running --------------------------------------------
    def load(self, state, pos: int = 0, seeds=None, hyper=(0.0,) * 4,
             x=None, labels=None):
        """copy in the state to start from: state = (ws, ms, vs, dws, dbs)
        (Model._fused_state), the corpus offset of batch 0 (or the input
        and labels), the dropout seeds of the batches to run, and the
        optimizer's (lr, h1, h2, h3); the counter starts at 0"""
        if self.on_card and self.graph is None:
            # the warm-up writes every buffer
            self.graph = capture(self._body, self.ctr, self.device)
            COUNTS["captures"] += 1
        ws, ms, vs, dws, dbs = state
        for dst, src in zip(self.W, ws):
            dst.copy_(src)
        if self.M is not self.W:
            for dst, src in zip(self.M, ms):
                dst.copy_(src)
        for dst, src in zip(self.V, vs):
            dst.copy_(src)
        for dst, src in zip(self.DW + self.DB, dws + dbs):
            if dst is not None:
                dst.copy_(src)
        if x is not None:
            self.X.copy_(x.reshape(self.in_shape))
            self.LAB.copy_(labels)
        self.pos0.fill_(int(pos))
        self.ctr.zero_()
        self.n = 0
        if seeds is not None:
            keys = torch.tensor([[funcs.layer_key((0, s & 0xFFFFFFFF), j)
                                  for j in self.drop] for s in seeds],
                                dtype=torch.int64)
            self.KEYS[:len(seeds)].copy_(keys)
        self.hy_host = funcs.hypers(self.opt, hyper)
        self.HY.copy_(torch.tensor(self.hy_host, dtype=torch.float32))

    def run(self, k: int = 1):
        """k batches, from the counter on"""
        if self.n + k > self.kcap:
            raise ValueError(f"fused cycle: {self.n + k} batches for "
                             f"{self.kcap} slots")
        for _ in range(k):
            if self.on_card:
                self.graph.replay()
            else:
                self._body()
        self.n += k
        self.runs += k
        COUNTS["runs"] += k

    def results(self, j0: int, k: int):
        """fresh copies of slots [j0, j0 + k) of the loss, hit and status
        vectors: what the words keep outlives the next runs"""
        return (self.L[j0:j0 + k].clone(), self.H[j0:j0 + k].clone(),
                self.F[j0:j0 + k].clone())

    def threaded(self):
        """the weights and moments after the runs so far, and zeroed
        gradients, per trainable (copies: the words keep them)"""
        return ([w.clone() for w in self.W],
                [torch.zeros_like(w) for w in self.W],
                [m.clone() for m in self.M], [v.clone() for v in self.V])


def capture(body, ctr, device, pool=None):
    """a torch.cuda.CUDAGraph of body(): WARMUP runs on a side stream
    first (they build and load the kernels, and set up cuBLAS's workspace
    and autograd's threads, none of which a capture may do), each from
    counter 0, then one captured run; ctr is left at 0.  Graphs that
    never run at once may share a memory pool (`pool`).  It holds the
    capture lock throughout (runtime/capture.py): no task thread or host
    worker touches the card while it captures"""
    with CAPTURE_LOCK:
        return _capture(body, ctr, device, pool)


def _capture(body, ctr, device, pool):
    cur = torch.cuda.current_stream(device)
    s = torch.cuda.Stream(device)
    s.wait_stream(cur)
    with torch.cuda.stream(s):
        for _ in range(WARMUP):
            ctr.zero_()
            body()
    cur.wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        ctr.zero_()
    with torch.cuda.graph(g, pool=pool, stream=s):
        body()
    ctr.zero_()
    return g


def get(model, program, train: bool, loss_op: str, opt: str, ndivs: tuple,
        src: tuple, kcap: int) -> Cycle:
    """the model's Cycle of this signature, made on first use.  src is
    ("ds", corpus bytes, labels, batch, mean, scale, input shape) or
    ("x", input shape); the corpus is keyed by identity, the class of
    the dots, the attention's and the MoE routing's by their settings (a
    capture bakes them in), the word mesh by identity (its buffers are
    the rank's shards)"""
    skey = (src[0], id(src[1]), id(src[2])) + tuple(src[3:]) \
        if src[0] == "ds" else src
    key = (model._uid, program, train, loss_op, opt, ndivs, skey, kcap,
           Config.PRECISION, funcs._attn_hybrid(), moe.capture_key(),
           id(funcs.word_mesh()))
    c = _CACHE.get(key)
    if c is None:
        c = Cycle(model, program, train, loss_op, opt, ndivs, src, kcap)
        _CACHE[key] = c
        if len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    return c
