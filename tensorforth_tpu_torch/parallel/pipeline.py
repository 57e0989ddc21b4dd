"""Pipeline parallelism: a GPipe microbatch pipeline over a 'pp' mesh axis
(the port of tensorforth_tpu/parallel/pipeline.py).

S identical stages (repeated attention or linear blocks) run on S ranks,
stage i holding its own parameters only.  Microbatches move from stage to
stage with `mesh.ppermute` (one hop a tick, the activation staged through
the host on the card), so stage i works on microbatch j while stage i+1
works on microbatch j-1.  The schedule is an autograd Function whose
backward runs the reverse schedule, each cotangent going the reverse hop
(ppermute's transpose), so autograd through a pipelined loss trains every
stage.

Schedule: T = n_micro + S - 1 ticks; stage d applies itself at tick t to
the microbatch that entered the pipe at tick t - d.  A stage skips its
compute on the ticks where no microbatch is in its window (the JAX
package computes and discards it), and the last tick sends nothing.

`train_pipeline` is the `nn.pipe` word's engine: the model's repeated
body pipelines over pp, the stem and head replicate, every segment's
backward is the word path's (`funcs.backward_segment`: the reference's
backprop quirks), the loss cotangent is out - tgt and the update is the
reference's uncorrected Adam (funcs.adam_step), so the pipeline takes the
step the word loop takes, up to the order of f32 sums.  It starts its S
ranks with parallel/launch.py, from a plain REPL on one card as on the
CPU, and writes the trained parameters back into the model.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..nn import funcs
from ..nn.ntypes import Layer
from ..ops import rng
from . import launch
from .mesh import Mesh

COUNTS = {"ticks": 0}       # pipeline ticks this rank ran


def make_pp_mesh(n_stages: int) -> Mesh:
    return Mesh(("pp",), (n_stages,))


def _nest(flat, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(tuple(flat[i:i + n]))
        i += n
    return out


class _Pipe(torch.autograd.Function):
    """the GPipe schedule on one rank, forward and backward.  A rank's
    autograd graph cannot see what its activations do on the next rank,
    so each tick's stage runs on a leaf (the received activation), and
    the backward runs the reverse schedule itself: at tick t a rank
    receives the cotangent of what it sent from the next rank (the
    reverse hop), adds the last stage's banked part, takes its stage's
    vjp and sends its input's cotangent back one rank"""

    @staticmethod
    def forward(ctx, xs, run, ridx_base, *flat):
        stage_fn, mesh, n_stages, with_ridx, sizes = run
        stage = mesh.index("pp")
        n_micro = xs.shape[0]
        T = n_micro + n_stages - 1
        leaves = [w.detach().requires_grad_(True) for w in flat]
        params = _nest(leaves, sizes)
        acc = torch.zeros_like(xs[0])
        ys, ticks = [None] * n_micro, []
        with torch.enable_grad():
            for t in range(T):
                mi = t - stage              # my microbatch
                active = 0 <= mi < n_micro
                src = stage == 0 and active
                x_in = (xs[mi] if src else acc).detach().requires_grad_(True)
                y = x_in
                if active:
                    y = (stage_fn(params, x_in,
                                  ridx_base + mi * n_stages + stage)
                         if with_ridx else stage_fn(params, x_in))
                ticks.append((x_in, y, src, mi))
                done = t - (n_stages - 1)
                if stage == n_stages - 1 and done >= 0:
                    ys[done] = y.detach()
                COUNTS["ticks"] += 1
                if t < T - 1:
                    acc = mesh.ppermute(y.detach(), "pp", tag=_TAG)
        out = (torch.stack(ys) if stage == n_stages - 1 else
               torch.empty((n_micro,) + tuple(xs.shape[1:]),
                           dtype=xs.dtype, device=xs.device))
        ctx.run, ctx.ticks, ctx.leaves = run, ticks, leaves
        ctx.xs_shape = xs.shape
        # the last stage's outputs on every rank
        return mesh.broadcast(out, "pp", n_stages - 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        _stage_fn, mesh, n_stages, _wr, _sizes = ctx.run
        stage = mesh.index("pp")
        leaves, ticks = ctx.leaves, ctx.ticks
        T = len(ticks)
        g_xs = g.new_zeros(ctx.xs_shape)
        g_p = [torch.zeros_like(w) for w in leaves]
        g_acc = None                        # cotangent of acc(t + 1)
        for t in range(T - 1, -1, -1):
            x_in, y, src, mi = ticks[t]
            gy = (mesh.ppermute(g_acc, "pp", shift=-1, tag=_TAG)
                  if t < T - 1 else torch.zeros_like(y))
            done = t - (n_stages - 1)
            if stage == n_stages - 1 and done >= 0:
                gy = gy + g[done]
            if y is x_in:
                gx = gy
            else:
                gs = torch.autograd.grad(y, [x_in] + leaves, gy,
                                         allow_unused=True)
                gx = gs[0]
                for acc_, gw in zip(g_p, gs[1:]):
                    if gw is not None:
                        acc_.add_(gw)
            if src:
                g_xs[mi] += gx
                g_acc = torch.zeros_like(gx)
            else:
                g_acc = gx
        return (g_xs, None, None, *g_p)


_TAG = 7                    # the pipeline's hops' message tag


def pipeline_apply(stage_fn, mesh: Mesh, n_stages: int,
                   with_ridx: bool = False):
    """f(params, xs) -> ys (with_ridx: f(params, xs, ridx_base)) on every
    rank of the pp axis: params are this rank's stage's (a list of tuples
    of tensors), xs [n_micro, mb, ...] the microbatches (read by stage 0),
    ys the last stage's outputs, on every rank, and differentiable in
    params and xs.  stage_fn(params, x) -> x', or stage_fn(params, x,
    ridx) with ridx = ridx_base + micro * n_stages + stage: a per
    (microbatch, stage) index that dropout layers fold into their keys.
    What follows the pipeline must run alike on every rank (the cotangent
    of ys is taken from the last stage's)."""

    def run(params, xs, ridx_base=0):
        flat = [w for pl in params for w in pl]
        meta = (stage_fn, mesh, n_stages, with_ridx,
                tuple(len(pl) for pl in params))
        return _Pipe.apply(xs, meta, int(ridx_base), *flat)

    if with_ridx:
        return run
    return lambda params, xs: run(params, xs)


def pipeline_loss_fn(stage_fn, head_fn, mesh: Mesh, n_stages: int):
    """loss over a pipelined body and a replicated head; differentiable"""
    pipe = pipeline_apply(stage_fn, mesh, n_stages)

    def loss(params, head_params, x_micro, y_micro):
        return head_fn(head_params, pipe(params, x_micro), y_micro)

    return loss


def pipeline_serve(stage_fn, mesh: Mesh, n_stages: int):
    """steady-state streaming inference: serve(params, reqs [R, n_micro,
    mb, ...]) runs all R requests as one stream of microbatches, so the
    fill/drain bubble (S - 1 ticks) is paid once: R * n_micro + S - 1
    ticks against fill-drain's R * (n_micro + S - 1)"""
    pipe = pipeline_apply(stage_fn, mesh, n_stages)

    def serve(params, reqs):
        r, nm = reqs.shape[0], reqs.shape[1]
        ys = pipe(params, reqs.reshape((r * nm,) + tuple(reqs.shape[2:])))
        return ys.reshape(tuple(reqs.shape[:2]) + tuple(ys.shape[1:]))

    return serve


def pipeline_serve_filldrain(stage_fn, mesh: Mesh, n_stages: int):
    """the reference schedule of the serving comparison: a fill/drain
    pass, bubble included, for each request"""
    pipe = pipeline_apply(stage_fn, mesh, n_stages)

    def serve(params, reqs):
        return torch.stack([pipe(params, req) for req in reqs])

    return serve


# =============================================================================
# the product path: `nn.pipe` trains a repeated-block model over 'pp'
# =============================================================================
def split_stages(program, params, stages: int):
    """(stem, block): program = stem ++ stages * block ++ head, the body's
    `stages` blocks identical (kinds, options and parameter shapes); the
    stem and head replicate.  Raises if the model has no such body."""
    L = len(program)
    for stem in range(0, L - stages + 1):
        best = 0
        for blk in range(1, (L - stem) // stages + 1):
            b = blk * stages
            ok = all(program[stem + i][:2] == program[stem + i % blk][:2]
                     for i in range(b))
            if ok:
                ok = all(tuple(w.shape for w in params[stem + i])
                         == tuple(w.shape for w in params[stem + i % blk])
                         for i in range(b))
            if ok:
                best = blk
        if best:
            return stem, best
    raise ValueError(
        f"nn.pipe: model body is not {stages} repeated blocks")


def _rebatch(spec, mb: int):
    kind, opts, shape = spec
    return (kind, opts, (mb,) + tuple(shape[1:]))


class _Segment(torch.autograd.Function):
    """a program segment's forward through funcs._apply_layer; its backward
    is the word path's (funcs.backward_segment), so a pipeline made of
    segments takes the sequential word loop's gradients"""

    @staticmethod
    def forward(ctx, x, seg, ridx, *flat):
        prog, key_base, tail, sizes = seg
        p = _nest(flat, sizes)
        kmb = rng.fold_in(rng.PRNGKey(0), ridx)
        outs, masks, xi = [], [], x
        for j, spec in enumerate(prog):
            xi, m = funcs._apply_layer(spec, xi, p[j],
                                       rng.fold_in(kmb, key_base + j))
            xi = xi.reshape(spec[2])
            outs.append(xi)
            masks.append(m)
        ctx.seg, ctx.p, ctx.outs, ctx.masks = seg, p, outs, masks
        ctx.save_for_backward(x)
        return xi

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        prog, _kb, tail, _sizes = ctx.seg
        x, = ctx.saved_tensors
        p = ctx.p
        dws0 = [torch.zeros_like(pl[0]) if pl else None for pl in p]
        dbs0 = [torch.zeros_like(pl[1]) if pl else None for pl in p]
        dx, _, dws, dbs = funcs.backward_segment(
            prog, True, dy, x, ctx.outs, p, ctx.masks, dws0, dbs0,
            tail=tail)
        flat = []
        for j, pl in enumerate(p):
            if pl:
                flat += [dws[j].reshape(pl[0].shape),
                         dbs[j].reshape(pl[1].shape)]
        return (dx, None, None, *flat)


def make_wordpath_segment(seg_prog, key_base: int, tail: bool = False):
    """apply(p, x, ridx) over a program segment with the word path's
    backward (see _Segment).  `ridx` picks the dropout key stream:
    fold_in(PRNGKey(0), ridx), then fold_in(key_base + layer), so masks
    vary per microbatch, stage, batch and epoch.  tail=True marks the
    segment that ends the network (the final-linear pass-through)."""
    seg_prog = tuple(seg_prog)

    def apply(p, x, ridx):
        if not seg_prog:
            return x
        seg = (seg_prog, key_base, tail, tuple(len(pl) for pl in p))
        return _Segment.apply(x, seg, int(ridx), *[w for pl in p for w in pl])

    return apply


def _host_batches(ds, in_shape):
    """the epoch's batches of the dataset on the host: (u8 or f32 data,
    int64 labels, n_batches), cut by T4_MAX_BATCH as nn.train's"""
    cp = ds._corpus
    if cp is None:
        raise ValueError("dataset has no corpus bound")
    batch = ds.batch_sz
    n_batches = cp.size // batch
    max_b = int(os.environ.get("T4_MAX_BATCH", "0") or 0)
    if max_b:
        n_batches = min(n_batches, max_b)
    data, labels = cp._read(0, n_batches * batch)
    return (np.ascontiguousarray(data), np.asarray(labels, np.int64),
            n_batches)


def _check(program, params, batch: int, stages: int):
    """(stem, blk, n_micro) of a model for `stages`, or the JAX package's
    refusal"""
    if any(kind == Layer.BATCHNM for kind, _o, _s in program):
        # per-microbatch statistics would diverge from the full batch's
        raise ValueError("nn.pipe: batchnorm layers are not supported "
                         "(per-microbatch stats would diverge; "
                         "use layernorm)")
    stem, blk = split_stages(program, params, stages)
    n_micro = stages * 2 if batch % (stages * 2) == 0 else stages
    if batch % n_micro:
        raise ValueError(f"nn.pipe: batch {batch} not divisible into "
                         f"{n_micro} microbatches")
    return stem, blk, n_micro


def train_pipeline(model, ds, lr: float, epochs: int, stages: int,
                   trace: int = 0) -> float:
    """train `model` on `ds` for `epochs` epochs over `stages` pipeline
    ranks (started here, local processes on this device); the last
    epoch's mean batch loss.  The trained parameters are written back."""
    from ..nn.train import write_back
    from ..system import System
    program = model._program()
    params = model._params()
    batch = model[0].N()
    _check(program, params, batch, stages)
    in_shape = (batch,) + tuple(model[0].shape[1:])
    data, labels, n_batches = _host_batches(ds, in_shape)
    host = [tuple(w.detach().cpu().numpy() for w in pl) for pl in params]
    # f32 mean and scale, as the dataset's own slice takes them
    args = (str(model.device), program, host, data, labels, batch,
            float(np.float32(ds._mean)), float(np.float32(ds._scale)),
            in_shape, model[-1].HWC(),
            float(lr), int(epochs), int(stages), n_batches)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        # a rank of a mesh REPL: rank 0 starts the pipeline's ranks, and
        # every rank takes its result
        box = [launch.run(_pipe_rank, stages, *args)
               if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        loss, full, losses = box[0]
    else:
        loss, full, losses = launch.run(_pipe_rank, stages, *args)
    if trace:
        for e, lv in enumerate(losses):
            System.get_sys().pstr(
                f"\\   nn.pipe epoch {e}: {n_batches} batches over "
                f"pp{stages}, loss={lv:.6g}\n")
    write_back(model, tuple(tuple(torch.from_numpy(w) for w in pl)
                            for pl in full))
    model.tick()
    model._iter += n_batches * epochs
    return loss


def _pipe_rank(rank, world, device, program, host, data, labels, batch,
               mean, scale, in_shape, classes, lr, epochs, stages,
               n_batches):
    """one pipeline rank: its stage's parameters, the replicated stem and
    head, `epochs` epochs; rank 0 returns (loss, the whole trained
    parameters, each epoch's mean loss)"""
    dev = torch.device(device)
    params = tuple(tuple(torch.from_numpy(np.array(w)).to(dev) for w in pl)
                   for pl in host)
    x_all = torch.from_numpy(data).to(dev)
    lab_all = torch.from_numpy(labels).to(dev)
    res = pipe_train(make_pp_mesh(stages), program, params, x_all, lab_all,
                     batch, mean, scale, in_shape, classes, lr, epochs,
                     n_batches)
    loss, full, losses = res
    return loss, [tuple(w.cpu().numpy() for w in pl) for pl in full], losses


def pipe_train(mesh: Mesh, program, params, x_all, lab_all, batch: int,
               mean: float, scale: float, in_shape, classes: int, lr: float,
               epochs: int, n_batches: int, counts: dict | None = None):
    """train_pipeline's body on a rank of a pp mesh: (the last epoch's
    mean loss, the whole trained parameters on every rank, the epochs'
    mean losses)"""
    stages = mesh.pp
    s = mesh.pp_idx
    stem, blk, n_micro = _check(program, params, batch, stages)
    body_n = stem + blk * stages
    mb = batch // n_micro
    block_prog = tuple(_rebatch(program[stem + i], mb) for i in range(blk))

    def leaves(pls):
        return [tuple(w.detach().clone().requires_grad_(True) for w in pl)
                for pl in pls]

    stem_p = leaves(params[:stem])
    block_p = leaves(params[stem + s * blk + i] for i in range(blk))
    head_p = leaves(params[body_n:])
    # dropout key streams: the block's layers use 0..blk-1, the stem 500..,
    # the head 99.. (as the JAX package spaces them)
    stem_apply = make_wordpath_segment(program[:stem], 500)
    block_apply = make_wordpath_segment(block_prog, 0)
    head_apply = make_wordpath_segment(program[body_n:], 99, tail=True)
    pipe = pipeline_apply(block_apply, mesh, stages, with_ridx=True)
    final_fused = program[-1][0] in (Layer.LINEAR, Layer.SIGMOID,
                                     Layer.SOFTMAX, Layer.LOGSMAX)
    groups = (stem_p, block_p, head_p)
    flat = [w for g in groups for pl in g for w in pl]
    ms = [torch.zeros_like(w) for w in flat]
    vs = [torch.zeros_like(w) for w in flat]
    n_stem = sum(len(pl) for pl in stem_p)
    hy = funcs.hypers("adam", (lr, 0.9, 0.999, 0.0))
    if x_all.is_cuda:
        hy = tuple(torch.tensor(v, dtype=torch.float32, device=x_all.device)
                   for v in hy)
    ridx_stride = n_micro * stages
    losses = []
    for e in range(epochs):
        ls = []
        for b in range(n_batches):
            ridx_base = (e * n_batches + b) * ridx_stride
            sl = slice(b * batch, (b + 1) * batch)
            x = ((x_all[sl].to(torch.float32) - mean) * scale).reshape(
                in_shape)
            hot = funcs.onehot_fn(lab_all[sl], classes).reshape(
                batch, 1, classes, 1)
            h0 = stem_apply(stem_p, x, ridx_base)
            h = pipe(block_p, h0.reshape((n_micro, mb) + tuple(h0.shape[1:])),
                     ridx_base)
            out = head_apply(head_p, h.reshape(
                (batch,) + tuple(program[body_n - 1][2][1:])), ridx_base)
            with torch.no_grad():
                ls.append(funcs.loss_fn("ce", out.detach(), hot))
            hotr = hot.reshape(out.shape)
            torch.autograd.backward(out, out.detach() - hotr if final_fused
                                    else hotr)
            grads = [torch.zeros_like(w) if w.grad is None else w.grad
                     for w in flat]
            # the stem feeds stage 0 alone: its gradient is rank 0's
            for g in grads[:n_stem]:
                mesh.all_reduce(g, "pp")
            with torch.no_grad():
                funcs.adam_step([w.data for w in flat], grads, ms, vs,
                                False, *hy)
            for w in flat:
                w.grad = None
        losses.append(float(torch.stack(ls).mean()))
    full = list(params)
    for j, pl in enumerate(stem_p):
        full[j] = tuple(w.detach() for w in pl)
    for i in range(blk):
        stacked = [mesh.all_gather(w.detach()[None], 0, "pp")
                   for w in block_p[i]]
        for st in range(stages):
            full[stem + st * blk + i] = tuple(a[st] for a in stacked)
    for j, pl in enumerate(head_p):
        full[body_n + j] = tuple(w.detach() for w in pl)
    return losses[-1] if losses else 0.0, tuple(full), losses
