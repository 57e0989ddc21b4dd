"""NN compute on torch tensors — the layer forwards, the per-layer
backward, the optimizer steps and the loss functions of the LM path (the
port of tensorforth_tpu/nn/funcs.py).

Layouts are the JAX package's: activations [N, S, E, 1], attention cores
[B*h, S, dh], wqkv [3E, E].  Every dot is strict f32 (TF32 is off, see
the package __init__).  The attention core routes long aligned sequences
on the card through the hand-written flash kernels, forward and backward
(ops/attn.py); everything else uses the exact einsum path and PyTorch's
own autograd.  Dropout, MoE, the conv/pool tier and the fused training
cycle come with later slices.
"""
from __future__ import annotations

import math
import os

import torch

from ..ops import attn as _attn
from .ntypes import Layer

SELU_L = 1.0507009873554805
SELU_LA = SELU_L * 1.6732632423543772
NEG_INF = -1.0e30
LN_CLAMP = 1.0e-12        # floor inside log(): CE of a zero probability

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)


# ===========================================================================
# per-layer forward primitives
# ===========================================================================
def _activate_fwd(kind, x, alpha):
    """returns (y, derivative-mask) — reference k_activate"""
    if kind == Layer.RELU:
        m = (x > 0.0).to(torch.float32)
        return x * m, m
    if kind == Layer.TANH:
        t = torch.tanh(x)
        return t, 1.0 - t * t
    if kind == Layer.SIGMOID:
        s = torch.sigmoid(x)
        return s, s * (1.0 - s)
    if kind == Layer.SELU:
        neg_f = SELU_LA * torch.exp(torch.clamp(x, max=0.0))
        y = torch.where(x > 0.0, x, neg_f - SELU_LA)
        m = torch.where(x > 0.0, torch.full_like(x, SELU_L), neg_f)
        return y, m
    if kind == Layer.LEAKYRL:
        m = torch.where(x > 0.0, torch.ones_like(x), torch.full_like(x, alpha))
        return x * m, m
    if kind == Layer.ELU:
        neg_f = alpha * torch.exp(torch.clamp(x, max=0.0))
        y = torch.where(x > 0.0, x, neg_f - alpha)
        m = torch.where(x > 0.0, torch.ones_like(x), neg_f)
        return y, m
    raise ValueError(kind)


def _softmax_fwd(x):
    """softmax over the feature axis (W*C) per (N, H) position"""
    n, h = x.shape[0], (x.shape[1] if x.dim() == 4 else 1)
    return torch.softmax(x.reshape(n, h, -1), dim=-1).reshape(x.shape)


def rope_apply(x, pos):
    """rotary position embedding on q/k heads: x [..., S, dh] rotated
    pairwise by angle pos * 10000^(-2i/dh) (half-split convention);
    pos [S] absolute positions"""
    dh = x.shape[-1]
    half = dh // 2
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = torch.pow(10000.0, -2.0 * i / dh)   # no host-to-device copy
    ang = pos.to(torch.float32)[:, None] * inv[None, :]      # [S, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _flash_shape_ok(s: int, dh: int) -> bool:
    """shapes the flash kernels take: long, aligned sequences at a head
    dim they are compiled for.  (The JAX gate admits any dh % 128 == 0,
    funcs.py:163-165; other head dims take the einsum path here.)"""
    return s >= 512 and s % 256 == 0 and dh in _attn.KERNEL_DH


def _flash_ok(q) -> bool:
    """the flash kernels' gate: a CUDA tensor of an eligible shape.  (The
    JAX gate tests for a TPU backend instead.)"""
    return q.is_cuda and _flash_shape_ok(q.shape[1], q.shape[2])


def _attn_hybrid() -> bool:
    """T4_ATTN_HYBRID=1 opts the flash path into bf16 multiplicands
    (f32 softmax and accumulator); default strict f32"""
    return os.environ.get("T4_ATTN_HYBRID", "0") == "1"


def _sdpa_ref(q, k, v, causal):
    """exact softmax attention, [B, S, dh] (the einsum path)"""
    s, dh = q.shape[1], q.shape[2]
    sc = torch.einsum("nqd,nkd->nqk", q, k) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return torch.einsum("nqk,nkd->nqd", w, v)


def _sdpa_flash(q, k, v, causal: bool = False):
    """the flash branch of sdpa: the autograd Function that pairs the
    forward kernel with the two backward kernels (it saves q, k, v, o and
    lse in between), with its lse output dropped"""
    return _attn.flash_attention_lse(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal,
                                     _attn_hybrid())[0]


def sdpa(q, k, v, causal: bool = False):
    """softmax-attention core with the flash forward AND backward kernels
    for long aligned sequences on the card (S x S never reaches device
    memory in either direction); other shapes take the exact einsum path
    and PyTorch's own autograd"""
    if _flash_ok(q):
        return _sdpa_flash(q, k, v, causal)
    return _sdpa_ref(q, k, v, causal)


def _mha_fwd(x, wqkv, wo, heads: int, flash: bool = True,
             causal: bool = False, rope: bool = False):
    """multi-head self-attention layer: x [N, S, E, 1], wqkv [3E, E],
    wo [E, E] -> [N, S, E, 1]"""
    n, s, e, _ = x.shape
    dh = e // heads
    qkv = (x.reshape(n, s, e) @ wqkv.T).reshape(n, s, 3, heads, dh)
    q = qkv[:, :, 0].transpose(1, 2)                # [N, h, S, dh]
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    if rope:
        pos = torch.arange(s, device=x.device)
        q = rope_apply(q, pos)
        k = rope_apply(k, pos)
    core = sdpa if flash else _sdpa_ref
    o = core(q.reshape(n * heads, s, dh), k.reshape(n * heads, s, dh),
             v.reshape(n * heads, s, dh), causal)
    o = o.reshape(n, heads, s, dh).transpose(1, 2).reshape(n, s, e)
    return (o @ wo.T).reshape(n, s, e, 1)


def _vjp(fn, inputs, dy):
    """cotangents of `inputs` for the cotangent dy of fn(*inputs).  fn is
    run again, on detached inputs with grad enabled: the eager counterpart
    of taking jax.vjp at backprop time."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return torch.autograd.grad(out, leaves, dy.reshape(out.shape))


class _AttnOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wqkv, wo, heads, causal, rope):
        ctx.save_for_backward(x, wqkv, wo)
        ctx.opts = (heads, causal, rope)
        return _mha_fwd(x, wqkv, wo, heads, flash=True, causal=causal,
                        rope=rope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        heads, causal, rope = ctx.opts
        return (*_vjp(lambda x, w1, w2: _mha_fwd(
            x, w1, w2, heads, flash=True, causal=causal, rope=rope),
            ctx.saved_tensors, g), None, None, None)


def attn_op(x, wqkv, wo, heads: int, causal: bool = False,
            rope: bool = False):
    """differentiable MHA that keeps only its inputs: the forward runs
    without a graph, the backward runs the layer again with one (the
    sdpa core supplies the flash backward kernels for eligible shapes)"""
    return _AttnOp.apply(x, wqkv, wo, heads, causal, rope)


def _embed_fwd(x, table, b):
    """token embedding: x [N,S,1,1] float ids -> [N,S,E,1]"""
    n, s = x.shape[0], x.shape[1]
    ids = x.reshape(n, s).to(torch.int64)
    e = table.shape[1]
    return (table[ids] + b).reshape(n, s, e, 1)


def _proj_fwd(x, w, b):
    """position-wise projection: x [N,S,E,1] @ w^T [E,V] + b -> [N,S,V,1]"""
    n, s, e, _ = x.shape
    return (x.reshape(n, s, e) @ w.T + b).reshape(n, s, -1, 1)


def _lnorm_fwd(x, gamma, beta, eps: float):
    """layer normalization over the feature axis (W*C) per (N, H)
    position: x [N,H,W,C] -> same shape"""
    n, h, w, c = x.shape
    f = x.reshape(n, h, w * c)
    mean = f.mean(dim=-1, keepdim=True)
    var = ((f - mean) ** 2).mean(dim=-1, keepdim=True)
    xhat = (f - mean) / torch.sqrt(var + eps)
    return (xhat * gamma + beta).reshape(x.shape)


# ===========================================================================
# whole-network forward
# ===========================================================================
def _attn_opts(opts):
    """(heads, causal, rope) of an ATTN layer's program options"""
    return (opts[0], bool(opts[1]) if len(opts) > 1 else False,
            bool(opts[2]) if len(opts) > 2 else False)


def _apply_layer(spec, x, p):
    kind, opts, _out_shape = spec
    if kind in _ACTS:
        return _activate_fwd(kind, x, opts[0])
    if kind == Layer.SOFTMAX:
        return _softmax_fwd(x), None
    if kind == Layer.ATTN:
        return attn_op(x, p[0], p[1], *_attn_opts(opts)), None
    if kind == Layer.LNORM:
        return _lnorm_fwd(x, p[0], p[1], opts[0]), None
    if kind == Layer.EMBED:
        return _embed_fwd(x, p[0], p[1]), None
    if kind == Layer.PROJ:
        return _proj_fwd(x, p[0], p[1]), None
    raise NotImplementedError(
        f"forward: layer '{Layer.NAMES[kind].strip()}' is not ported yet")


@torch.no_grad()
def forward_pure(program, x, params):
    """whole-network forward: x [N,S,1,1] ids -> (per-layer outputs,
    derivative masks).  The JAX version's `key` feeds dropout only,
    which this slice does not run."""
    outs, masks = [], []
    for spec, p in zip(program, params):
        x, m = _apply_layer(spec, x, p)
        x = x.reshape(spec[2])
        outs.append(x)
        masks.append(m)
    return tuple(outs), tuple(masks)


# ===========================================================================
# whole-network backward
# ===========================================================================
_PASS_THRU = (Layer.SIGMOID, Layer.SOFTMAX)
_MASKED = (Layer.RELU, Layer.TANH, Layer.SELU, Layer.LEAKYRL, Layer.ELU)


def _acc(a, g):
    """accumulate a gradient into an accumulator of any equal-numel shape
    (the model hands over its rank-4 storage tensors); returns a new
    tensor and leaves the accumulator as it was"""
    return a + g.reshape(a.shape)


@torch.no_grad()
def backward_pure(program, train, tgt, x0, outs, params, masks, dws, dbs,
                  flash: bool = True):
    """whole-network backward with the reference quirks (pass-through
    sigmoid/softmax, masked activations): (dout, dxs, dws', dbs').
    flash=False sends the attention layers through the einsum path, as a
    check of the kernels.  (The JAX package's _bwd_body: with no jit
    wrapper to share it with, the body lives here.)"""
    # dLoss prep (reference _bprep, backprop.cu:75-109): the fused
    # final-activation+loss pairs become out-tgt; any other final layer
    # means tgt already IS dLoss
    if program[-1][0] in _PASS_THRU:
        dy = outs[-1] - tgt.reshape(outs[-1].shape)
    else:
        dy = tgt.reshape(outs[-1].shape)
    _, dxs, ndws, ndbs = backward_segment(
        program, train, dy, x0, outs, params, masks, dws, dbs, flash=flash)
    return dy, dxs, ndws, ndbs


@torch.no_grad()
def backward_segment(program, train, dy, x0, outs, params, masks, dws, dbs,
                     flash: bool = True):
    """per-layer backward over a program segment given the cotangent dy at
    the segment's output (no dLoss prep): (dx0, dxs, dws', dbs').  With
    train false only the input gradients are taken."""
    L = len(program)
    dxs = [None] * L
    ndws, ndbs = list(dws), list(dbs)
    for j in range(L - 1, -1, -1):
        kind, opts, out_shape = program[j]
        x_in = outs[j - 1] if j > 0 else x0
        dw = db = None
        if kind in _PASS_THRU:
            dx = dy
        elif kind in _MASKED:
            # masks may carry a stale header shape if the user reshaped a
            # layer view between forward and backprop
            dx = dy * masks[j].reshape(dy.shape)
        elif kind == Layer.ATTN:
            heads, causal, rope = _attn_opts(opts)
            dx, dw, db = _vjp(
                lambda x_, w1, w2: _mha_fwd(x_, w1, w2, heads, flash=flash,
                                            causal=causal, rope=rope),
                (x_in, *params[j]), dy.reshape(out_shape))
        elif kind == Layer.LNORM:
            dx, dw, db = _vjp(
                lambda x_, g_, b_: _lnorm_fwd(x_, g_, b_, opts[0]),
                (x_in, *params[j]), dy.reshape(out_shape))
        elif kind == Layer.EMBED:
            # token ids get no input gradient; the table's gradient is
            # the scatter-add of dy over the looked-up rows.  On the card
            # index_add_ sums with atomics, so this one gradient may
            # differ in its last bits from run to run.
            table = params[j][0]
            dyf = dy.reshape(-1, table.shape[1])
            dw = torch.zeros_like(table).index_add_(
                0, x_in.reshape(-1).to(torch.int64), dyf)
            db = dyf.sum(dim=0)
            dx = torch.zeros_like(x_in)
        elif kind == Layer.PROJ:
            n, s, e, _ = x_in.shape
            dyf = dy.reshape(n * s, -1)
            dw = dyf.T @ x_in.reshape(n * s, e)
            db = dyf.sum(dim=0)
            dx = dyf @ params[j][0]
        else:
            raise NotImplementedError(
                f"backprop: layer '{Layer.NAMES[kind].strip()}' is not "
                f"ported yet")
        if train and dw is not None:
            ndws[j] = _acc(ndws[j], dw)
            ndbs[j] = _acc(ndbs[j], db)
        dy = dxs[j] = dx.reshape(x_in.shape)
    return dy, tuple(dxs), tuple(ndws), tuple(ndbs)


# ===========================================================================
# optimizers (reference k_sgd / k_adam / k_adamw semantics)
# ===========================================================================
@torch.no_grad()
def sgd_step(ws, dws, ms, ndivs, momentum: bool, lr: float, b: float):
    """one SGD step over lists of tensors, IN PLACE (the JAX version
    returns new arrays; updating where the state lies saves a copy of
    every weight, gradient and momentum per step).  The gradient is
    divided by its weight tensor's batch divisor; with momentum
    m = b*m + (1-b)*g and w -= lr*m.  Gradients are zeroed."""
    for w, dw, m, nd in zip(ws, dws, ms, ndivs):
        dg = dw / nd
        if momentum:
            m.mul_(b).add_(dg, alpha=1.0 - b)
            w.sub_(m, alpha=lr)
        else:
            w.sub_(dg, alpha=lr)
        dw.zero_()


@torch.no_grad()
def adam_step(ws, dws, ms, vs, adamw: bool, lr: float, b1: float,
              b2: float, wd: float):
    """one Adam or AdamW step over lists of tensors, IN PLACE (see
    sgd_step).  The reference's form: no bias correction, eps = 1e-6
    outside the square root; AdamW's decay is decoupled (added to the
    update, not to the gradient).  Gradients are zeroed."""
    for w, dg, m, v in zip(ws, dws, ms, vs):
        m.mul_(b1).add_(dg, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(dg, dg, value=1.0 - b2)
        upd = m / (torch.sqrt(v) + 1.0e-6)
        if adamw:
            upd.add_(w, alpha=wd)
        w.sub_(upd, alpha=lr)
        dg.zero_()


# ===========================================================================
# loss / metrics (reference Tensor::loss, Model::hit)
# ===========================================================================
@torch.no_grad()
def loss_fn(op: str, out, tgt):
    """summed loss over all elements divided by the batch N (not by N*S)"""
    n = out.shape[0] if out.dim() > 1 else 1
    o = out.reshape(-1)
    t = tgt.reshape(-1)
    if op == "mse":
        z = torch.sum((o - t) ** 2)
    elif op == "bce":
        z = -torch.sum(t * torch.log(o + 1.0e-6)
                       + (1.0 - t) * torch.log(1.0 - o + 1.0e-6))
    elif op == "ce":
        z = -torch.sum(t * torch.log(torch.clamp(o, min=LN_CLAMP)))
    elif op == "nll":
        z = -torch.sum(o * t)
    else:
        raise ValueError(op)
    return z / n


@torch.no_grad()
def hit_fn(out, hot):
    """how many samples' argmax (over all of a sample's outputs) falls on
    a one of the one-hot target"""
    n = out.shape[0]
    idx = torch.argmax(out.reshape(n, -1), dim=-1)
    return torch.sum(torch.gather(hot.reshape(n, -1), 1, idx[:, None]))


def onehot_fn(labels, classes: int):
    return torch.nn.functional.one_hot(labels.to(torch.int64),
                                       classes).to(torch.float32)
