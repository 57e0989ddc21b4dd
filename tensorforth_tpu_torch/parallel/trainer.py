"""Sharded functional trainer: one train step over a (dp, tp) mesh of
ranks (the port of tensorforth_tpu/parallel/trainer.py).

The JAX package compiles forward -> loss -> grads -> Adam to one XLA
program partitioned over its mesh.  Here each rank holds its tp shards
of the parameters and of Adam's moments (`mesh.shard_params`), all-gathers
the whole parameters for its step, runs the forward and autograd's
backward on its dp rows of the batch, sums the gradients over dp (the
loss is the global batch's sum over N, so the per-rank gradients add up
to the one-device gradient), and updates its own shards.  The loss is
summed over dp the same way.  `remat=True` recomputes the forward in the
backward (`torch.utils.checkpoint`), as `jax.checkpoint` does.

As in the JAX package this is the generic scaling trainer: autodiff
gradients of the mean loss and textbook bias-corrected Adam (eps 1e-8),
not the word path's update (`nn.train` keeps that, nn/train.py).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..nn import funcs
from ..nn.ntypes import Layer
from ..ops import rng
from .mesh import Mesh, gather_params, make_mesh, shard_batch, shard_params


def _forward_pure(program, x, params, key, rows=None):
    """the program's forward on x's rows; rows=(lo, n): they are rows
    lo.. of a batch of n (a dp rank's part), and a dropout layer keeps
    its slice of the whole batch's mask"""
    k = x.shape[0]
    lo, n = rows or (0, k)
    for j, (kind, opts, shape) in enumerate(program):
        spec = (kind, opts, (k,) + tuple(shape[1:]))
        if n != k and kind in (Layer.BATCHNM, Layer.MOE):
            raise NotImplementedError(
                f"ShardedTrainer: {funcs._kind_name(kind)} couples the "
                f"batch's rows; it has no dp split yet")
        if kind == Layer.DROPOUT and n != k:
            u = rng.uniform(rng.fold_in(key, j), (n,) + tuple(x.shape[1:]),
                            x.device)
            x = x * (u > opts[0]).to(torch.float32)[lo:lo + k]
        else:
            x, _m = funcs._apply_layer(spec, x, params[j],
                                       rng.fold_in(key, j))
        x = x.reshape(spec[2])
    return x


def _loss_pure(program, params, x, tgt, key, loss: str, rows=None):
    """the summed loss over the rows of x, over the batch's n (x's rows
    by default; rows=(lo, n) for a dp rank's part)"""
    out = _forward_pure(program, x, params, key, rows)
    n = None if rows is None else rows[1]
    rows = out.shape[0]
    o = out.reshape(rows, -1)
    t = tgt.reshape(rows, -1)
    if loss == "ce":
        z = -torch.sum(t * torch.log(torch.clamp(o, min=1e-12)))
    elif loss == "bce":
        z = -torch.sum(t * torch.log(o + 1e-6)
                       + (1.0 - t) * torch.log(1.0 - o + 1e-6))
    else:
        z = torch.sum((o - t) ** 2)
    return z / (rows if n is None else n)


def init_opt_state(params):
    zeros = tuple(tuple(torch.zeros_like(w) for w in pl) for pl in params)
    return (zeros, tuple(tuple(torch.zeros_like(w) for w in pl)
                         for pl in params), 0)


def _adam(params, grads, opt_state, lr, b1, b2):
    m, v, t = opt_state
    t = t + 1
    lr_t = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
    new_p, new_m, new_v = [], [], []
    for pl, gl, ml, vl in zip(params, grads, m, v):
        np_l, nm_l, nv_l = [], [], []
        for pw, gw, mw, vw in zip(pl, gl, ml, vl):
            mw = b1 * mw + (1 - b1) * gw
            vw = b2 * vw + (1 - b2) * gw * gw
            np_l.append(pw - lr_t * mw / (torch.sqrt(vw) + 1e-8))
            nm_l.append(mw)
            nv_l.append(vw)
        new_p.append(tuple(np_l))
        new_m.append(tuple(nm_l))
        new_v.append(tuple(nv_l))
    return tuple(new_p), (tuple(new_m), tuple(new_v), t)


def _grads(program, params, x, tgt, key, loss, remat, rows=None):
    leaves = tuple(tuple(w.detach().requires_grad_(True) for w in pl)
                   for pl in params)
    flat = [w for pl in leaves for w in pl]
    if remat:
        lval = checkpoint(lambda *ws: _loss_pure(
            program, _nest(ws, leaves), x, tgt, key, loss, rows), *flat,
            use_reentrant=False)
    else:
        lval = _loss_pure(program, leaves, x, tgt, key, loss, rows)
    gs = torch.autograd.grad(lval, flat, allow_unused=True)
    gs = [torch.zeros_like(w) if g is None else g for g, w in zip(gs, flat)]
    return lval.detach(), _nest(gs, leaves)


def _nest(flat, like):
    out, i = [], 0
    for pl in like:
        out.append(tuple(flat[i:i + len(pl)]))
        i += len(pl)
    return tuple(out)


def make_train_step(program, loss: str = "ce", lr: float = 1e-3,
                    b1: float = 0.9, b2: float = 0.999, remat: bool = False):
    """step(params, opt_state, x, tgt, key) -> (params', opt_state', loss)
    on one device"""
    def step(params, opt_state, x, tgt, key):
        lval, grads = _grads(program, params, x, tgt, key, loss, remat)
        new_p, new_s = _adam(params, grads, opt_state, lr, b1, b2)
        return new_p, new_s, lval
    return step


class ShardedTrainer:
    """drives a Model's program over a (dp, tp) mesh: call it on every
    rank of the group with the same global batch"""

    def __init__(self, model, mesh: Mesh | None = None, loss: str = "ce",
                 lr: float = 1e-3, remat: bool = False):
        self.mesh = mesh or make_mesh()
        self.program = model._program()
        self.params = shard_params(
            tuple(tuple(w.detach().clone() for w in pl)
                  for pl in model._params()), self.program, self.mesh)
        self.opt_state = init_opt_state(self.params)
        self.loss, self.lr, self.remat = loss, lr, remat
        self._i = 0

    def full_params(self):
        return gather_params(self.params, self.program, self.mesh)

    def grads(self, x, tgt, key):
        """(global loss, the whole gradient summed over dp)"""
        mesh = self.mesh
        n = x.shape[0]
        lval, grads = _grads(self.program, self.full_params(),
                             shard_batch(x, mesh), shard_batch(tgt, mesh),
                             key, self.loss, self.remat,
                             (mesh.dp_idx * (n // mesh.dp), n))
        lval = mesh.all_reduce(lval.clone(), "dp")
        grads = tuple(tuple(mesh.all_reduce(g, "dp") for g in gl)
                      for gl in grads)
        return lval, grads

    def step(self, x, tgt, seed: int = 0):
        key = rng.PRNGKey(seed + self._i)
        self._i += 1
        lval, grads = self.grads(x, tgt, key)
        local = shard_params(grads, self.program, self.mesh)
        self.params, self.opt_state = _adam(self.params, local,
                                            self.opt_state, self.lr,
                                            0.9, 0.999)
        return float(lval)

    def write_back(self, model):
        """the trained parameters into the interpreter's model"""
        from ..nn.train import write_back
        write_back(model, self.full_params())
