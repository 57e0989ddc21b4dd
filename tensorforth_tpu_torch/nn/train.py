"""Epoch training behind the `nn.train` word (the port of
tensorforth_tpu/nn/train.py).

The corpus goes to the device once (raw bytes and labels; a dataset's
resident corpus when it has one), and each epoch is a loop of one batch
step over it: the batch's slice, normalize and one-hot, `forward_pure`,
the CE loss, `backward_pure` from zeroed accumulators and the
reference's uncorrected Adam (funcs.adam_step: no bias correction, no
batch division, eps 1e-6; gradient.cu:144-157), all on buffers the loop
owns.  So a step is the word path's `forward loss.ce backprop nn.adam`
on the same numbers.  On the card the step is captured once into a CUDA
graph (nn/cycle.capture) and an epoch replays it once a batch; on the CPU
the step runs eagerly.  The trained parameters are written back into
every parameter tensor of the model (`write_back`), so `nn.w`, `forward`
and `save` see them.

As in the JAX package, dropout draws from one key an epoch,
PRNGKey(epoch), where the word path draws a seed a forward.  Under
T4_MESH (and, across hosts, T4_COORD: the global mesh of parallel/dist.py)
the step is `funcs.forward_pure`/`backward_pure` over the mesh (the batch
over dp, the features over tp or the MoE experts over ep;
funcs.word_mesh) on the rank's shards of the weights and moments, run
eagerly.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from ..config import Config
from ..parallel import moe
from . import cycle, funcs
from .ntypes import Layer

ADAM_B1 = 0.9
ADAM_B2 = 0.999
CACHE_SIZE = 32          # epoch loops kept, as the JAX package's lru_cache
_EPOCHS: OrderedDict = OrderedDict()
_RAW_CACHE: dict = {}


def _stage_raw(ds, device):
    """the corpus on the device, at least its first n_batches * batch
    records: (raw bytes, int64 labels, n_batches).  A dataset's resident
    corpus when it has one; otherwise staged here, once per (corpus,
    span): the value
    keeps the corpus and a hit checks that it is the same object, so a
    new corpus at a reused address is not served old data"""
    cp = ds._corpus
    if cp is None:
        raise ValueError("dataset has no corpus bound")
    batch = ds.batch_sz
    max_b = int(os.environ.get("T4_MAX_BATCH", "0") or 0)
    n_batches = cp.size // batch
    if max_b:
        n_batches = min(n_batches, max_b)
    n = n_batches * batch
    if hasattr(ds, "_upload") and ds.device == device:
        res = ds._upload()
        if res is not None:
            return res[0], res[1], n_batches
    key = (id(cp), cp.size, n, str(device))
    hit = _RAW_CACHE.get(key)
    if hit is None or hit[0] is not cp:
        data, labels = cp._read(0, n)
        buf = torch.from_numpy(np.ascontiguousarray(data)).to(device)
        lab = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        if len(_RAW_CACHE) > 8:          # bound what stays on the device
            _RAW_CACHE.clear()
        _RAW_CACHE[key] = hit = (cp, buf, lab)
    return hit[1], hit[2], n_batches


def batch_step(program, x, hot, params, ws, ms, vs, key, hy):
    """one word-path batch step (the JAX package's make_ref_batch_step):
    forward, CE loss, backward from zeroed accumulators, Adam on ws, ms,
    vs IN PLACE (params views ws; hy = funcs.hypers("adam", ...)).
    Returns the loss"""
    outs, masks = funcs.forward_pure(program, x, params, key)
    mesh = funcs.word_mesh()             # the batch's loss: the rows put
    loss = funcs.loss_fn("ce", outs[-1] if mesh is None    # together
                         else funcs._gather_rows(mesh, outs[-1]), hot)
    zero = [torch.zeros_like(pl[0]) if pl else None for pl in params]
    zerob = [torch.zeros_like(pl[1]) if pl else None for pl in params]
    _, _, dws, dbs = funcs.backward_pure(program, True, hot, x, outs,
                                         params, masks, zero, zerob)
    gs = [g for j, pl in enumerate(params) if pl for g in (dws[j], dbs[j])]
    funcs.adam_step(ws, gs, ms, vs, False, *hy)
    return loss


def write_back(model, params, local: bool = False):
    """the trained parameters into the model's tensors, for every layer
    with parameters (copies: the loop's buffers are its own); local:
    they are the rank's shards under the word mesh"""
    for j in range(model.numel - 1):
        for k, w in enumerate(params[j]):
            if local:
                model._put(model[j], "grad", k, w)
            else:
                model[j].grad[k].replace_data(w)


class _Epoch:
    """one model's epoch loop over one corpus span: its weights, moments,
    batch counter, per-batch losses, dropout keys and hyperparameters in
    buffers of its own"""

    def __init__(self, model, program, batch, in_shape, classes, n_batches,
                 buf, lab):
        dev = model.device
        # uncaptured under a mesh (its collectives run on the host)
        self.device = dev
        self.on_card = dev.type == "cuda" and funcs.word_mesh() is None
        self.program, self.batch, self.in_shape = program, batch, in_shape
        self.classes, self.n_batches = classes, n_batches
        self.buf, self.lab = buf, lab
        # the rank's shards under the word mesh (Model._params(True))
        local = model._params(True)
        self.W = [torch.zeros_like(w) for pl in local for w in pl]
        self.M = [torch.zeros_like(w) for w in self.W]
        self.V = [torch.zeros_like(w) for w in self.W]
        flat, params = iter(self.W), []
        for pl in local:
            params.append(tuple(next(flat) for _ in pl))
        self.params = tuple(params)
        self.drop = [j for j, spec in enumerate(program)
                     if spec[0] == Layer.DROPOUT]
        self.KEYS = torch.zeros((max(len(self.drop), 1), 2),
                                dtype=torch.int64, device=dev)
        self.AR = torch.arange(batch, device=dev)
        self.ctr = torch.zeros((), dtype=torch.int64, device=dev)
        self.L = torch.zeros(n_batches, dtype=torch.float32, device=dev)
        self.NORM = torch.zeros(2, dtype=torch.float32, device=dev)
        self.HY = torch.zeros(6, dtype=torch.float32, device=dev)
        self.hy_host = (0.0,) * 6
        self.norm_host = (0.0, 1.0)
        self.graph = None

    def _body(self):
        i = self.ctr
        idx = i * self.batch + self.AR
        d = self.buf.index_select(0, idx)
        mean, scale = ((self.NORM[0], self.NORM[1]) if self.on_card
                       else self.norm_host)
        x = ((d.to(torch.float32) - mean) * scale).reshape(self.in_shape)
        hot = funcs.onehot_fn(self.lab.index_select(0, idx),
                              self.classes).reshape(self.batch, 1,
                                                    self.classes, 1)
        key = None
        if self.drop:
            at = {layer: n for n, layer in enumerate(self.drop)}
            key = lambda j: (self.KEYS[at[j], 0], self.KEYS[at[j], 1])  # noqa: E731
        hy = (tuple(self.HY[n] for n in range(6)) if self.on_card
              else self.hy_host)
        loss = batch_step(self.program, x, hot, self.params, self.W, self.M,
                          self.V, key, hy)
        self.L.index_copy_(0, i.view(1), loss.reshape(1))
        self.ctr.add_(1)

    def load(self, params, lr: float, mean: float, scale: float):
        """start from the model's parameters, zero moments"""
        if self.on_card and self.graph is None:
            self.graph = cycle.capture(self._body, self.ctr, self.device)
            cycle.COUNTS["captures"] += 1
        for dst, src in zip(self.W, (w for pl in params for w in pl)):
            dst.copy_(src)
        for t in self.M + self.V:
            t.zero_()
        self.hy_host = funcs.hypers("adam", (lr, ADAM_B1, ADAM_B2, 0.0))
        self.HY.copy_(torch.tensor(self.hy_host, dtype=torch.float32))
        # f32 mean and scale, as the dataset's own slice takes them
        self.norm_host = (float(np.float32(mean)), float(np.float32(scale)))
        self.NORM.copy_(torch.tensor(self.norm_host, dtype=torch.float32))

    def epoch(self, e: int):
        """one epoch, its dropout keys from PRNGKey(e)"""
        if self.drop:
            self.KEYS.copy_(torch.tensor(
                [funcs.layer_key((0, e), j) for j in self.drop],
                dtype=torch.int64))
        self.ctr.zero_()
        for _ in range(self.n_batches):
            if self.on_card:
                self.graph.replay()
            else:
                self._body()
        cycle.COUNTS["runs"] += self.n_batches


def _make_epoch(model, program, batch, in_shape, classes, n_batches, buf,
                lab):
    """the model's epoch loop of this signature and corpus, made on first
    use (a capture bakes the dots' class, the attention's and the MoE
    routing in)"""
    key = (model._uid, program, batch, in_shape, classes, n_batches,
           id(buf), id(lab), Config.PRECISION, funcs._attn_hybrid(),
           moe.capture_key())
    ep = _EPOCHS.get(key)
    if ep is None:
        ep = _EPOCHS[key] = _Epoch(model, program, batch, in_shape, classes,
                                   n_batches, buf, lab)
        if len(_EPOCHS) > CACHE_SIZE:
            _EPOCHS.popitem(last=False)
    else:
        _EPOCHS.move_to_end(key)
    return ep


def train_epochs(model, ds, lr: float = 1e-3, epochs: int = 1,
                 trace: int = 0) -> float:
    """train `model` on `ds` for `epochs` epochs with Adam at `lr`; the
    last epoch's mean batch loss"""
    if epochs <= 0:                    # `0 nn.train` is a no-op
        return 0.0
    from ..system import System
    program = model._program()
    buf, lab, n_batches = _stage_raw(ds, model.device)
    batch = ds.batch_sz
    in_shape = (batch,) + tuple(model[0].shape[1:])
    ep = _make_epoch(model, program, batch, in_shape, model[-1].HWC(),
                     n_batches, buf, lab)
    ep.load(model._params(True), float(lr), ds._mean, ds._scale)
    sys = System.get_sys()
    for e in range(epochs):
        ep.epoch(e)
        if trace:
            sys.pstr(f"\\   epoch {e}: {n_batches} batches, "
                     f"loss={float(ep.L.mean()):.6g}\n")
    loss = float(ep.L.mean())
    model.tick()
    model._iter += n_batches * epochs
    write_back(model, ep.params, local=True)
    return loss
