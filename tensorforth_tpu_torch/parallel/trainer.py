"""Sharded functional trainer: one train step over a (dp, tp) mesh of
ranks, or a (dp, sp, tp) mesh of a sequence model (the port of
tensorforth_tpu/parallel/trainer.py).

The JAX package compiles forward -> loss -> grads -> Adam to one XLA
program partitioned over its mesh.  Here each rank holds its tp shards
of the parameters and of Adam's moments (`mesh.shard_params`), all-gathers
the whole parameters for its step, runs the forward and autograd's
backward on its dp rows of the batch, sums the gradients over dp (the
loss is the global batch's sum over N, so the per-rank gradients add up
to the one-device gradient), and updates its own shards.  The loss is
summed over dp the same way.  `remat=True` recomputes the forward in the
backward (`torch.utils.checkpoint`), as `jax.checkpoint` does.

On a (dp, sp, tp) mesh (`mesh.make_mesh3`) a rank holds the [N/dp,
S/sp] block of a sequence batch.  The position-wise layers run on the
rank's positions; an attention layer all-gathers its input over sp (the
JAX package lets XLA insert the gather of K and V), runs as on one rank
(`funcs._apply_layer`, so its core is the flash kernels' on the card) and
keeps the rank's positions of its output; the first layer that mixes
positions otherwise (a flatten, a linear over the sample) gathers the
sequence for good.  The gathers' cotangents are summed over sp (their
transpose), each rank's loss is its part of the whole (a replicated loss
over sp ranks), and the gradients are summed over sp and dp.  Ring
attention (parallel/ring.py) is a function of its own, as in the JAX
package.

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
from .mesh import (Mesh, gather, gather_params, make_mesh, param_axes,
                   seq_param_axes, shard_batch, shard_params,
                   shard_seq_batch)

# the layers that act on each position alone: on an sp rank's positions
_POSWISE = (Layer.LNORM, Layer.MOE, Layer.EMBED, Layer.PROJ, Layer.SOFTMAX,
            Layer.LOGSMAX, Layer.DROPOUT) + funcs._ACTS


def _forward_pure(program, x, params, key, rows=None, mesh=None):
    """the program's forward on x's rows; rows=(lo, n): they are rows
    lo.. of a batch of n (a dp rank's part), and a dropout layer keeps
    its slice of the whole batch's mask.  With a mesh of sp > 1, x is the
    rank's [rows, S/sp] block (see the module docstring); the output is
    (y, whether y is still the rank's positions only)"""
    k = x.shape[0]
    lo, n = rows or (0, k)
    sp = mesh is not None and mesh.sp > 1
    local = sp                           # x holds the rank's positions
    for j, (kind, opts, shape) in enumerate(program):
        if local and kind not in _POSWISE + (Layer.ATTN,):
            x = gather(x.contiguous(), mesh, 1, "sp")
            local = False
        s_loc = x.shape[1] if local else None
        spec = (kind, opts, (k,) + ((s_loc,) if local else
                                    tuple(shape[1:2])) + tuple(shape[2:]))
        if n != k and kind in (Layer.BATCHNM, Layer.MOE):
            raise NotImplementedError(
                f"ShardedTrainer: {funcs._kind_name(kind)} couples the "
                f"batch's rows; it has no dp split yet")
        if kind == Layer.DROPOUT and (n != k or local):
            u = rng.uniform(rng.fold_in(key, j), (n,) + tuple(shape[1:]),
                            x.device)[lo:lo + k]
            if local:
                u = mesh.chunk(u, 1, "sp")
            x = x * (u > opts[0]).to(torch.float32)
        elif kind == Layer.ATTN and local:
            whole = (kind, opts, (k,) + tuple(shape[1:]))
            y, _m = funcs._apply_layer(whole, gather(x.contiguous(), mesh, 1,
                                                     "sp"),
                                       params[j], rng.fold_in(key, j))
            x = mesh.chunk(y.reshape(whole[2]), 1, "sp")
        else:
            x, _m = funcs._apply_layer(spec, x, params[j],
                                       rng.fold_in(key, j))
        x = x.reshape(spec[2])
    return (x, local) if sp else x


def _loss_pure(program, params, x, tgt, key, loss: str, rows=None,
               mesh=None):
    """the summed loss over the rows of x, over the batch's n (x's rows
    by default; rows=(lo, n) for a dp rank's part).  With a mesh of sp >
    1, this rank's part of it: its positions' share, or the loss over
    sp ranks where the output holds the whole sequence"""
    out = _forward_pure(program, x, params, key, rows, mesh)
    share = 1
    if mesh is not None and mesh.sp > 1:
        out, local = out
        if local:
            tgt = mesh.chunk(tgt, 1, "sp")
        else:
            share = mesh.sp
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
    return z / (rows if n is None else n) / share


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


def _grads(program, params, x, tgt, key, loss, remat, rows=None,
           mesh=None):
    leaves = tuple(tuple(w.detach().requires_grad_(True) for w in pl)
                   for pl in params)
    flat = [w for pl in leaves for w in pl]
    if remat:
        lval = checkpoint(lambda *ws: _loss_pure(
            program, _nest(ws, leaves), x, tgt, key, loss, rows, mesh),
            *flat, use_reentrant=False)
    else:
        lval = _loss_pure(program, leaves, x, tgt, key, loss, rows, mesh)
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
    """drives a Model's program over a (dp, tp) mesh, or a (dp, sp, tp)
    mesh: call it on every rank of the group with the same global batch"""

    def __init__(self, model, mesh: Mesh | None = None, loss: str = "ce",
                 lr: float = 1e-3, remat: bool = False):
        self.mesh = mesh or make_mesh()
        self.seq = "sp" in self.mesh.axis_names
        self.program = model._program()
        self.axes = (seq_param_axes(self.program) if self.seq
                     else param_axes(self.program, self.mesh))
        self.params = shard_params(
            tuple(tuple(w.detach().clone() for w in pl)
                  for pl in model._params()), self.program, self.mesh,
            self.axes)
        self.opt_state = init_opt_state(self.params)
        self.loss, self.lr, self.remat = loss, lr, remat
        self._i = 0

    def full_params(self):
        return gather_params(self.params, self.program, self.mesh,
                             self.axes)

    def grads(self, x, tgt, key):
        """(global loss, the whole gradient summed over dp and sp)"""
        mesh = self.mesh
        n = x.shape[0]
        xl = shard_seq_batch(x, mesh) if self.seq else shard_batch(x, mesh)
        lval, grads = _grads(self.program, self.full_params(), xl,
                             shard_batch(tgt, mesh), key, self.loss,
                             self.remat, (mesh.dp_idx * (n // mesh.dp), n),
                             mesh if self.seq else None)
        lval = mesh.all_reduce(mesh.all_reduce(lval.clone(), "dp"), "sp")
        grads = tuple(tuple(mesh.all_reduce(mesh.all_reduce(g, "dp"), "sp")
                            for g in gl) for gl in grads)
        return lval, grads

    def forward(self, x, seed: int = 0):
        """the forward of the global batch x on the rank's part of it,
        the output gathered whole (every rank returns it)"""
        mesh = self.mesh
        n = x.shape[0]
        xl = shard_seq_batch(x, mesh) if self.seq else shard_batch(x, mesh)
        with torch.no_grad():
            out = _forward_pure(self.program, xl, self.full_params(),
                                rng.PRNGKey(seed),
                                (mesh.dp_idx * (n // mesh.dp), n),
                                mesh if self.seq else None)
            if self.seq:
                out, local = out
                if local:
                    out = mesh.all_gather(out, 1, "sp")
            return mesh.all_gather(out, 0, "dp")

    def step(self, x, tgt, seed: int = 0):
        key = rng.PRNGKey(seed + self._i)
        self._i += 1
        lval, grads = self.grads(x, tgt, key)
        local = shard_params(grads, self.program, self.mesh, self.axes)
        self.params, self.opt_state = _adam(self.params, local,
                                            self.opt_state, self.lr,
                                            0.9, 0.999)
        return float(lval)

    def write_back(self, model):
        """the trained parameters into the interpreter's model"""
        from ..nn.train import write_back
        write_back(model, self.full_params())
