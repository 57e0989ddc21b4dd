"""NN compute on torch tensors — the layer forwards, the per-layer
backward, the optimizer steps and the loss functions of the word path
(the port of tensorforth_tpu/nn/funcs.py).

Layouts are the JAX package's: activations NHWC ([N, S, E, 1] on the LM
tier), conv filters [C1, K, K, C0], linear weights [E0, E1], wqkv
[3E, E].  On a CPU tensor every dot is exact f32, as XLA CPU computes
it.  On the card every dot of the NN and LM tiers (forward and backward:
conv, dconv, linear; the attention layer's qkv and wo, the einsum
attention's two products, PROJ, the MoE einsums) runs in the class
Config.PRECISION names at call time, the class of the reference's dots
on its chip: 'fast' multiplies operands rounded to bf16 (XLA's default
class), 'strict' sums the three products of their bf16 hi/lo parts
(XLA's 'high'); both accumulate in f32 with TF32 off.  The flash
kernels keep their own class (T4_ATTN_HYBRID).  The attention core
routes long aligned sequences on the card through the hand-written flash
kernels, forward and backward (ops/attn.py); the other layers take explicit
backward rules.  exp, log, tanh and the logistic are ops/xla_math.py's:
XLA CPU's bits on a CPU tensor.  The fused training cycle is built from
these functions in nn/cycle.py; nothing here reads a value back to the
host or copies one from it, so every function may run inside a captured
CUDA graph.  The MoE layer's routing lives in parallel/moe.py.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops import attn as _attn
from ..ops import rng, xla_dot, xla_math, xla_reduce
from .ntypes import Layer

SELU_L = 1.0507009873554805
SELU_LA = SELU_L * 1.6732632423543772
NEG_INF = -1.0e30
BN_EPS = 1.0e-6           # reference DU_EPS in k_batchnorm_2
LN_CLAMP = 1.0e-12        # floor inside log(): CE of a zero probability

_ACTS = (Layer.RELU, Layer.TANH, Layer.SIGMOID, Layer.SELU,
         Layer.LEAKYRL, Layer.ELU)


# ===========================================================================
# per-layer forward primitives
# ===========================================================================
def _activate_fwd(kind, x, alpha):
    """returns (y, derivative-mask) — reference k_activate"""
    if kind == Layer.RELU:
        # XLA compiles x * (x > 0) to select(x > 0, x, 0) and flushes
        # subnormal inputs: +0 for -0, negatives, NaN and subnormals
        m = (x > 0.0).to(torch.float32)
        return torch.where(x >= xla_math._TINY, x, torch.zeros_like(x)), m
    if kind == Layer.TANH:
        t = xla_math.tanh(x)
        return t, 1.0 - t * t
    if kind == Layer.SIGMOID:
        s = xla_math.logistic(x)
        return s, s * (1.0 - s)
    if kind == Layer.SELU:
        neg_f = SELU_LA * xla_math.exp(torch.clamp(x, max=0.0))
        y = torch.where(x > 0.0, x, neg_f - SELU_LA)
        m = torch.where(x > 0.0, torch.full_like(x, SELU_L), neg_f)
        return y, m
    if kind == Layer.LEAKYRL:
        m = torch.where(x > 0.0, torch.ones_like(x), torch.full_like(x, alpha))
        return x * m, m
    if kind == Layer.ELU:
        neg_f = alpha * xla_math.exp(torch.clamp(x, max=0.0))
        y = torch.where(x > 0.0, x, neg_f - alpha)
        m = torch.where(x > 0.0, torch.ones_like(x), neg_f)
        return y, m
    raise ValueError(kind)


def _rows(x):
    """the feature axis (W*C) of each (N, H) position as the last axis"""
    n, h = x.shape[0], (x.shape[1] if x.dim() == 4 else 1)
    return x.reshape(n, h, -1)


def _softmax_fwd(x):
    """softmax over the feature axis (W*C) per (N, H) position, in
    jax.nn.softmax's steps: exp(x - max) / sum"""
    f = _rows(x)
    e = xla_math.exp(f - f.amax(dim=-1, keepdim=True))
    return (e / xla_reduce.row_sum(e)).reshape(x.shape)


class _RouterSoftmax(torch.autograd.Function):
    """softmax over the last axis of [S, E] with _softmax_fwd's values
    (XLA CPU's exp on a CPU tensor) and softmax's vjp, y * (g - Σ g·y)"""

    @staticmethod
    def forward(ctx, x):
        y = _softmax_fwd(x.reshape(x.shape[0], 1, -1, 1)).reshape(x.shape)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return y * (g - (g * y).sum(dim=-1, keepdim=True))


def router_softmax(x):
    """the MoE router's gates from its scores [S, E]"""
    return _RouterSoftmax.apply(x)


def _logsoftmax_fwd(x):
    """jax.nn.log_softmax's steps: (x - max) - log(sum(exp(x - max)))"""
    f = _rows(x)
    sh = f - f.amax(dim=-1, keepdim=True)
    lse = xla_math.log(xla_math.exp(sh).sum(dim=-1, keepdim=True))
    return (sh - lse).reshape(x.shape)


# ---------------------------------------------------------------------------
# the conv, dconv and linear dots in the precision class of the reference's
# NN tier (see the module docstring)
# ---------------------------------------------------------------------------
def _bf16(x):
    """x rounded to bf16 (to nearest even), held in f32"""
    return x.to(torch.bfloat16).to(torch.float32)


def class_dot(op, a, b, cls=None):
    """op(a, b) for a bilinear op of f32 tensors: exact f32 on the CPU; on
    the card in Config.PRECISION's class (read now, so one process can run
    both).  A caller may name the class (`cls`; 'f32' is exact f32), on
    either device.  The products of bf16 values are exact in f32, so each
    op below is the class's own arithmetic.  Any other class raises."""
    if cls is None:
        if a.device.type != "cuda":
            return op(a, b)
        cls = Config.PRECISION
    if cls == "f32":
        return op(a, b)
    if cls not in ("fast", "strict"):
        raise ValueError(f"T4_PRECISION={cls!r}: 'fast' or 'strict'")
    ah, bh = _bf16(a), _bf16(b)
    y = op(ah, bh)
    if cls == "strict":              # XLA's 'high': hi*hi + hi*lo + lo*hi
        y = (op(_bf16(a - ah), bh) + op(ah, _bf16(b - bh))) + y
    return y


def _mm(a, b):
    return a @ b


def _linear_mm(a, b):
    """a @ b of the linear layer, forward and backward (the JAX package's
    jnp.dot of x and w.T, dy.T and x, dy and w): on CPU tensors in XLA
    CPU's order where ops/xla_dot.py has the class, else a @ b.  Under the
    word mesh (T4_MESH, and chip_smoke's emulation of it) a @ b: the JAX
    package's mesh runs are programs partitioned over devices, whose dots
    are others.  The conv's products (XLA's convolution, not a dot) and
    the LM tier's keep _mm"""
    y = xla_dot.mm(a, b) if word_mesh() is None else None
    return a @ b if y is None else y


def _einsum_op(spec):
    return lambda a, b: torch.einsum(spec, a, b)


def _grad_specs(spec):
    """the einsums of a two-operand einsum's cotangents: 'A,B->O' gives
    'O,B->A' (of g and b) and 'A,O->B' (of a and g).  Every index of an
    operand must appear in the other operand or in the output, which
    holds for each product of the LM tier"""
    ins, out = spec.replace(" ", "").split("->")
    a, b = ins.split(",")
    return f"{out},{b}->{a}", f"{a},{out}->{b}"


class _ClassEinsum(torch.autograd.Function):
    """einsum(spec, a, b) in a precision class, forward AND backward: the
    cotangents are class products too (autograd through the bf16 casts
    would take f32 products of rounded operands, a class the reference
    never computes)"""

    @staticmethod
    def forward(ctx, spec, cls, a, b):
        ctx.save_for_backward(a, b)
        ctx.spec, ctx.cls = spec, cls
        return class_dot(_einsum_op(spec), a, b, cls)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb = _grad_specs(ctx.spec)
        da = (class_dot(_einsum_op(sa), g, b, ctx.cls)
              if ctx.needs_input_grad[2] else None)
        db = (class_dot(_einsum_op(sb), a, g, ctx.cls)
              if ctx.needs_input_grad[3] else None)
        return None, None, da, db


class _ClassMatmul(torch.autograd.Function):
    """a [..., K] @ b [K, M] in a precision class, forward and backward"""

    @staticmethod
    def forward(ctx, cls, a, b):
        ctx.save_for_backward(a, b)
        ctx.cls = cls
        return class_dot(_mm, a, b, cls)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = (class_dot(_mm, g, b.T, ctx.cls)
              if ctx.needs_input_grad[1] else None)
        db = (class_dot(_mm, a.reshape(-1, a.shape[-1]).T,
                        g.reshape(-1, g.shape[-1]), ctx.cls)
              if ctx.needs_input_grad[2] else None)
        return None, da, db


def class_einsum(spec, a, b, cls=None):
    """torch.einsum(spec, a, b) of the LM tier: on the CPU the plain op
    (exact f32); on the card in Config.PRECISION's class, its gradients
    too (a named `cls` holds on either device)"""
    if cls == "f32" or (cls is None and a.device.type != "cuda"):
        return torch.einsum(spec, a, b)
    return _ClassEinsum.apply(spec, cls, a, b)


def class_matmul(a, b, cls=None):
    """a @ b of the LM tier (b a matrix): the plain op on the CPU, the
    class's products forward and backward on the card (or `cls`'s)"""
    if cls == "f32" or (cls is None and a.device.type != "cuda"):
        return a @ b
    return _ClassMatmul.apply(cls, a, b)


def _blocks(h: int, w: int, k: int, s: int, p: int):
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def _patches(x, k: int, s: int, p: int):
    """x NHWC -> [N, C*K*K, L] conv patches (zeros in the padding), rows
    in (c, ky, kx) order: one strided copy (F.unfold launches once per
    sample on the card)"""
    n, h, w, c = x.shape
    h0, w0 = _blocks(h, w, k, s, p)
    xp = F.pad(x, (0, 0, p, p, p, p))
    sn, sh, sw, sc = xp.stride()
    v = xp.as_strided((n, c, k, k, h0, w0), (sn, sc, sh, sw, sh * s, sw * s))
    return v.reshape(n, c * k * k, h0 * w0)


def _fold(cols, h: int, w: int, k: int, s: int, p: int):
    """the adjoint of _patches: [N, C*K*K, L] patches summed into NHWC
    [N, H, W, C], one strided add per filter tap"""
    n = cols.shape[0]
    h0, w0 = _blocks(h, w, k, s, p)
    c = cols.shape[1] // (k * k)
    cols = cols.reshape(n, c, k, k, h0, w0).permute(0, 2, 3, 4, 5, 1)
    out = cols.new_zeros(n, h + 2 * p, w + 2 * p, c)
    for ky in range(k):
        for kx in range(k):
            out[:, ky:ky + s * (h0 - 1) + 1:s,
                kx:kx + s * (w0 - 1) + 1:s] += cols[:, ky, kx]
    return out[:, p:p + h, p:p + w]


def _filter2d(w):
    """[C1, K, K, C0] filter -> [C0, C1*K*K], the patches' row order"""
    return w.permute(3, 0, 1, 2).reshape(w.shape[3], -1)


def _tfilter2d(w):
    """[C1, K, K, C0] filter -> [C0*K*K, C1]: the transposed conv's map
    from input channels to the output's patches"""
    return w.permute(3, 1, 2, 0).reshape(-1, w.shape[0])


def _conv_fwd(x, w, b, S, P):
    """x NHWC, w [C1,K,K,C0] (reference filter layout), stride S, pad P:
    one product of the filter with the input's patches"""
    n, h, wd, _ = x.shape
    k = w.shape[1]
    h0, w0 = _blocks(h, wd, k, S, P)
    y = class_dot(_mm, _filter2d(w), _patches(x, k, S, P))   # [N, C0, L]
    return y.reshape(n, -1, h0, w0).permute(0, 2, 3, 1) + b


def _dconv_fwd(x, w, b, S, P):
    """transposed conv C1 -> C0 of size (H1-1)S - 2P + K, as the JAX
    package's dilated conv with the flipped kernel: the patches of the
    output are the filter's transpose times the input, folded"""
    n, h, wd, c1 = x.shape
    k = w.shape[1]
    h0, w0 = (h - 1) * S - 2 * P + k, (wd - 1) * S - 2 * P + k
    xf = x.permute(0, 3, 1, 2).reshape(n, c1, h * wd)
    cols = class_dot(_mm, _tfilter2d(w), xf)                # [N, C0KK, L]
    return _fold(cols, h0, w0, k, S, P) + b


def _linear_fwd(x, w, b):
    """y[N,E0] = x[N,E1] @ w^T[E1,E0] + b (reference _flinear)"""
    n = x.shape[0]
    return class_dot(_linear_mm, x.reshape(n, -1), w.T) + b


def _dropout_fwd(x, rate, key):
    """keep where u > rate, no rescale (the reference's quirk); u is
    jax.random.uniform of the layer's key"""
    u = rng.uniform(key, x.shape, x.device)
    m = (u > rate).to(torch.float32)
    return x * m, m


def _pool_pad(x, k, fill):
    n, h, w, c = x.shape
    h0, w0 = -(-h // k), -(-w // k)
    xp = F.pad(x, (0, 0, 0, w0 * k - w, 0, h0 * k - h), value=fill)
    return xp.reshape(n, h0, k, w0, k, c)


_POOL_FILL = {Layer.MAXPOOL: float("-inf"), Layer.MINPOOL: float("inf"),
              Layer.AVGPOOL: 0.0}


def _pool_fwd(kind, x, k):
    """kxk pool, stride k, ceil-mode: the edge pads with -inf (max), +inf
    (min) or 0 (avg), and the avg divides the padded sum by k*k
    (reference k_pool, H0 = (H+k-1)/k)"""
    xw = _pool_pad(x, k, _POOL_FILL[kind])
    if kind == Layer.MAXPOOL:
        return xw.amax(dim=(2, 4))
    if kind == Layer.MINPOOL:
        return xw.amin(dim=(2, 4))
    return xw.sum(dim=(2, 4)) / (k * k)


def _pool_bwd(kind, x, k, dy):
    """the JAX vjp of the pool: max and min send each window's gradient to
    its FIRST extreme element in row-major order (select_and_scatter_add
    with a >= / <= select); avg spreads dy / (k*k) over the window"""
    n, h, w, c = x.shape
    xw = _pool_pad(x, k, _POOL_FILL[kind])
    h0, w0 = xw.shape[1], xw.shape[3]
    dy = dy.reshape(n, h0, 1, w0, 1, c)
    if kind == Layer.AVGPOOL:
        g = (dy / (k * k)).expand(n, h0, k, w0, k, c)
    else:
        # the first extreme of each window: the extremes weighted k*k - i
        # by their place i leave one largest weight (argmax's choice
        # among ties would be the device's own)
        win = xw.permute(0, 1, 3, 5, 2, 4).reshape(n, h0, w0, c, k * k)
        ext = (win.amax(dim=-1, keepdim=True) if kind == Layer.MAXPOOL
               else win.amin(dim=-1, keepdim=True))
        rank = (win == ext) * torch.arange(k * k, 0, -1, device=x.device,
                                           dtype=dy.dtype)
        hot = (rank == rank.amax(dim=-1, keepdim=True)).to(dy.dtype)
        hot = hot.reshape(n, h0, w0, c, k, k).permute(0, 1, 4, 2, 5, 3)
        g = hot * dy
    g = g.reshape(n, h0 * k, w0 * k, c)
    return g[:, :h, :w, :]


def _upsample_fwd(x, k):
    """nearest-neighbour k-x upsampling"""
    return x.repeat_interleave(k, dim=1).repeat_interleave(k, dim=2)


def _upsample_bwd(k, dy):
    n, h, w, c = dy.shape
    return dy.reshape(n, h // k, k, w // k, k, c).sum(dim=(2, 4))


def _batchnorm_fwd(x, gamma, beta):
    """train-mode BN; rvar = 1/(sqrt(pop-var)+eps) with the population
    variance as mean(x^2) - mean^2 (reference k_batchnorm_2)"""
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = (x * x).mean(dim=(0, 1, 2), keepdim=True) - mean * mean
    rvar = 1.0 / (torch.sqrt(torch.clamp_min(var, 0.0)) + BN_EPS)
    xhat = (x - mean) * rvar
    return xhat * gamma + beta, xhat, rvar


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
    dim they are built for, 128 to 1024 in steps of 128 (dh 384 to 1024
    on clusters of dh / 128 CTAs, 8 at most).  (The JAX gate admits any
    dh % 128 == 0, funcs.py:163-165; dh 1152 and wider take the einsum
    path here.)"""
    return s >= 512 and s % 256 == 0 and dh in _attn.KERNEL_DH


def _flash_ok(q) -> bool:
    """the flash kernels' gate: a CUDA tensor of an eligible shape.  (The
    JAX gate tests for a TPU backend instead.)"""
    return q.is_cuda and _flash_shape_ok(q.shape[1], q.shape[2])


def _attn_hybrid() -> bool:
    """T4_ATTN_HYBRID=1 opts the flash path into bf16 multiplicands
    (f32 softmax and accumulator); default strict f32"""
    return os.environ.get("T4_ATTN_HYBRID", "0") == "1"


def _sdpa_ref(q, k, v, causal, cls=None):
    """softmax attention, [B, S, dh] (the einsum path): f32 scores and
    softmax, its two products in the LM tier's class (or `cls`)"""
    s, dh = q.shape[1], q.shape[2]
    sc = class_einsum("nqd,nkd->nqk", q, k, cls) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1)
    return class_einsum("nqk,nkd->nqd", w, v, cls)


def _sdpa_plain(q, k, v, causal):
    """the flash kernels' plain version: the einsum path in the kernels'
    class (exact f32; T4_ATTN_HYBRID's bf16 operands), whatever
    Config.PRECISION says"""
    return _sdpa_ref(q, k, v, causal, "fast" if _attn_hybrid() else "f32")


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
    memory in either direction); other shapes take the einsum path in
    the LM tier's class and PyTorch's own autograd"""
    if _flash_ok(q):
        return _sdpa_flash(q, k, v, causal)
    return _sdpa_ref(q, k, v, causal)


def _mha_fwd(x, wqkv, wo, heads: int, flash: bool = True,
             causal: bool = False, rope: bool = False):
    """multi-head self-attention layer: x [N, S, E, 1], wqkv [3E, E],
    wo [E, E] -> [N, S, E, 1].  flash=False takes the core through the
    flash kernels' plain version (_sdpa_plain), as a check of them"""
    n, s, e, _ = x.shape
    dh = e // heads
    qkv = class_matmul(x.reshape(n, s, e), wqkv.T).reshape(n, s, 3, heads,
                                                          dh)
    q = qkv[:, :, 0].transpose(1, 2)                # [N, h, S, dh]
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    if rope:
        pos = torch.arange(s, device=x.device)
        q = rope_apply(q, pos)
        k = rope_apply(k, pos)
    core = sdpa if flash else _sdpa_plain
    o = core(q.reshape(n * heads, s, dh), k.reshape(n * heads, s, dh),
             v.reshape(n * heads, s, dh), causal)
    o = o.reshape(n, heads, s, dh).transpose(1, 2).reshape(n, s, e)
    return class_matmul(o, wo.T).reshape(n, s, e, 1)


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


def _moe_fwd(x, w1aug, w2, top_k: int, mesh=None):
    """mixture-of-experts FFN layer: x [N,S,D,1]; w1aug [E,D,F+1] packs
    the experts' w1 [E,D,F] with the router wr [E,D] in the last column
    (the generic two-slot layer contract); w2 [E,F,D].  The route is
    parallel/moe.moe_select's for this call's token count.  Under a word
    mesh (see word_mesh) x is a dp rank's rows and the experts are the
    rank's along the mesh's expert axis; the dispatch route, whose
    capacity is the batch's, routes the whole batch's tokens"""
    from ..parallel.moe import (capacity_factor, moe_fwd, moe_fwd_dispatch,
                                moe_select)
    n, s, d, _ = x.shape
    f = w1aug.shape[2] - 1
    ax = _expert_axis(mesh)
    e = w1aug.shape[0] * (mesh.axis_size(ax) if ax else 1)
    dp = mesh.dp if mesh is not None else 1
    xx = x.reshape(n, s, d)
    dispatch = moe_select((n * dp, s), e, top_k)
    if dispatch and dp > 1:
        from ..parallel.mesh import gather
        xx = gather(xx.contiguous(), mesh, 0, "dp")
    args = (xx, w1aug[:, :, f], w1aug[:, :, :f], w2, top_k)
    kw = dict(mesh=mesh, axis=ax) if ax else {}
    if dispatch:
        y = moe_fwd_dispatch(*args, capacity_factor=capacity_factor(), **kw)
        if dp > 1:
            y = mesh.chunk(y, 0, "dp")
    else:
        y = moe_fwd(*args, **kw)
    return y.reshape(n, s, d, 1)


def _embed_fwd(x, table, b):
    """token embedding: x [N,S,1,1] float ids -> [N,S,E,1]"""
    n, s = x.shape[0], x.shape[1]
    ids = x.reshape(n, s).to(torch.int64)
    e = table.shape[1]
    return (table[ids] + b).reshape(n, s, e, 1)


def _proj_fwd(x, w, b):
    """position-wise projection: x [N,S,E,1] @ w^T [E,V] + b -> [N,S,V,1]"""
    n, s, e, _ = x.shape
    return (class_matmul(x.reshape(n, s, e), w.T) + b).reshape(n, s, -1, 1)


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


def _apply_layer(spec, x, p, key=None):
    kind, opts, out_shape = spec
    if kind == Layer.CONV:
        return _conv_fwd(x, p[0], p[1], opts[0], opts[1]), None
    if kind == Layer.DCONV:
        return _dconv_fwd(x, p[0], p[1], opts[0], opts[1]), None
    if kind == Layer.LINEAR:
        return _linear_fwd(x, p[0], p[1]).reshape(out_shape), None
    if kind == Layer.FLATTEN:
        return x.reshape(out_shape), None
    if kind in _ACTS:
        return _activate_fwd(kind, x, opts[0])
    if kind == Layer.DROPOUT:
        return _dropout_fwd(x, opts[0], key)
    if kind == Layer.SOFTMAX:
        return _softmax_fwd(x), None
    if kind == Layer.LOGSMAX:
        return _logsoftmax_fwd(x), None
    if kind in _POOL_FILL:
        return _pool_fwd(kind, x, opts[0]), None
    if kind == Layer.BATCHNM:
        y, xhat, rvar = _batchnorm_fwd(x, p[0], p[1])
        return y, (xhat, rvar)
    if kind == Layer.USAMPLE:
        return _upsample_fwd(x, opts[0]), None
    if kind == Layer.ATTN:
        return attn_op(x, p[0], p[1], *_attn_opts(opts)), None
    if kind == Layer.MOE:
        return _moe_fwd(x, p[0], p[1], opts[2]), None
    if kind == Layer.LNORM:
        return _lnorm_fwd(x, p[0], p[1], opts[0]), None
    if kind == Layer.EMBED:
        return _embed_fwd(x, p[0], p[1]), None
    if kind == Layer.PROJ:
        return _proj_fwd(x, p[0], p[1]), None
    raise NotImplementedError(f"forward: layer {_kind_name(kind)} has no "
                              f"forward")


def _kind_name(kind) -> str:
    ok = isinstance(kind, int) and 0 <= kind < len(Layer.NAMES)
    return f"'{Layer.NAMES[kind].strip()}'" if ok else f"kind {kind}"


def layer_key(key, j: int):
    """the key dropout layer j draws from: fold_in(key, j) of a key pair,
    or key(j) where the caller made the layers' keys already (a captured
    cycle reads them from a device buffer)"""
    return key(j) if callable(key) else rng.fold_in(key, j)


# ===========================================================================
# the word path over a mesh (T4_MESH; the JAX package's word_mesh)
# ===========================================================================
_MESHES: dict = {}
# layers whose output features split over tp: the raw output's feature
# axis and the parameters' (w, b) feature axes in the [E0, E1] / filter
# views funcs takes
_TP_SPLIT = {Layer.LINEAR: (1, 0, 0), Layer.PROJ: (2, 0, 0),
             Layer.CONV: (3, 3, 0)}


def word_mesh():
    """the mesh of the interactive word path: T4_MESH=dp4[,tp2] (or
    dpX,epY) over the ranks of the process group (parallel/launch.py
    starts them, as the REPL does under T4_MESH; across hosts
    parallel/dist.py under T4_COORD), or None: no spec, one rank, or a
    spec needing more ranks than the group has (as the JAX package
    degrades to one device).

    Under a mesh a rank holds its part of the state, as the JAX package's
    shardings lay it out (parallel/mesh.shard_params): every layer's
    output, input gradient and mask its dp rows; the parameters of the
    linear, proj and conv layers, their dW/dB and their optimizer moments
    its tp shard (the output features); an MoE layer's experts its shard
    over ep (over tp on a dp/tp mesh); the rest replicated.  The model
    keeps these as shards (mu/tensor.Tensor.local) and gathers a tensor
    whole only where a word reads it (`nn.w`, `n@`, the trace, the loss
    and hit readbacks, save).  `forward_pure` takes the rank's shards of
    the parameters and the whole batch and returns the rank's rows: a
    split layer computes its features and all-gathers them over tp,
    batchnorm's moments are all-reduced over dp, a dropout layer keeps
    its rows of the whole batch's mask.  `backward_pure` takes the rank's
    rows and computes the rank's shard of each gradient: a split layer's
    dW/dB from its features' cotangent, its input gradient all-reduced
    over tp, every dW/dB summed over dp.  The fused cycle, trace chunks
    and `nn.train` are built from the two, and run uncaptured under a mesh
    (gloo's collectives run on the host).  A batch or a layer's features
    that do not divide the mesh raise, as the JAX package's sharding
    does."""
    spec = os.environ.get("T4_MESH", "")
    if not spec:
        return None
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    key = (spec, dist.get_world_size() if up else 1)
    if key not in _MESHES:
        from ..parallel.mesh import mesh_from_spec, parse_spec
        if up and int(os.environ.get("T4_NPROC", "1") or 1) > 1:
            from ..parallel.dist import make_global_mesh
            _MESHES[key] = make_global_mesh(**parse_spec(spec))
        else:
            _MESHES[key] = mesh_from_spec(spec)
    return _MESHES[key]


def _expert_axis(mesh):
    """the axis an MoE layer's experts shard over: ep, else tp"""
    if mesh is None:
        return None
    for ax in ("ep", "tp"):
        if mesh.axis_size(ax) > 1:
            return ax
    return None


def param_dims(mesh, kind) -> tuple:
    """(mesh axis, dim) of a layer's (w, b) in their storage shapes under
    the word mesh (None: replicated): linear/proj W [1, E0, E1, 1] and
    conv filters [C1, K, K, C0] on their output features over tp, their
    biases on their only axis; MoE w1aug [E, D, F+1, 1] and w2 [E, F, D,
    1] on the experts"""
    if mesh is None:
        return (None, None)
    if kind in _TP_SPLIT and mesh.tp > 1:
        return (("tp", 1 if kind != Layer.CONV else 3), ("tp", 0))
    if kind == Layer.MOE and _expert_axis(mesh):
        ax = _expert_axis(mesh)
        return ((ax, 0), (ax, 0))
    return (None, None)


def _check_mesh(mesh, program):
    """the split layers' output features divide over tp, and an MoE
    layer's experts over its axis"""
    for kind, opts, shape in program:
        if kind in _TP_SPLIT and mesh.tp > 1:
            f = {Layer.LINEAR: math.prod(shape[1:]), Layer.PROJ: shape[2],
                 Layer.CONV: shape[3]}[kind]
            if f % mesh.tp:
                raise ValueError(f"T4_MESH: {_kind_name(kind)}'s {f} output "
                                 f"features do not divide over tp{mesh.tp}")
        if kind == Layer.MOE and _expert_axis(mesh):
            ax = _expert_axis(mesh)
            if opts[0] % mesh.axis_size(ax):
                raise ValueError(f"T4_MESH: {opts[0]} experts do not divide "
                                 f"over {ax}{mesh.axis_size(ax)}")


def _mesh_for(program, n: int):
    """the word mesh for a batch of n (None without one)"""
    mesh = word_mesh()
    if mesh is None:
        return None
    if n % mesh.dp:
        raise ValueError(f"T4_MESH: a batch of {n} does not divide over "
                         f"dp{mesh.dp}")
    _check_mesh(mesh, program)
    return mesh


def _local_spec(spec, k: int):
    return (spec[0], spec[1], (k,) + tuple(spec[2][1:]))


def _tp_layer(mesh, spec, x, p):
    """a split layer's output from the rank's shard of its parameters:
    its features, all-gathered over tp"""
    ax = _TP_SPLIT[spec[0]][0]
    if spec[0] == Layer.CONV:
        y = _conv_fwd(x, p[0], p[1], spec[1][0], spec[1][1])
    elif spec[0] == Layer.LINEAR:
        y = _linear_fwd(x, *p)
    else:
        y = _proj_fwd(x, *p)
    return mesh.all_gather(y, ax, "tp")


def _batchnorm_dp(mesh, x, gamma, beta, n):
    """_batchnorm_fwd on this rank's rows with the whole batch's moments:
    the sums of x and x^2 all-reduced over dp"""
    cnt = n * x.shape[1] * x.shape[2]
    s = torch.stack((x.sum(dim=(0, 1, 2)), (x * x).sum(dim=(0, 1, 2))))
    s = mesh.all_reduce(s, "dp") / cnt
    mean = s[0].reshape(1, 1, 1, -1)
    var = s[1].reshape(1, 1, 1, -1) - mean * mean
    rvar = 1.0 / (torch.sqrt(torch.clamp_min(var, 0.0)) + BN_EPS)
    xhat = (x - mean) * rvar
    return xhat * gamma + beta, xhat, rvar


def _gather_rows(mesh, t):
    """the whole batch of a rank's rows (an all-gather over dp)"""
    return mesh.all_gather(t, 0, "dp")


def _rows_of(mesh, t, k):
    """this rank's rows of t, whole (k * dp rows) or the rank's already"""
    if t is None or t.shape[0] == k:
        return t
    return mesh.chunk(t, 0, "dp")


def _forward_mesh(mesh, program, x, params, key):
    """forward_pure on the rank's rows with the rank's parameter shards:
    (its rows of each output, of each mask)"""
    n = x.shape[0]
    k = n // mesh.dp
    lo = mesh.dp_idx * k
    xl = _rows_of(mesh, x, k)
    outs, masks = [], []
    for j, (spec, p) in enumerate(zip(program, params)):
        ls = _local_spec(spec, k)
        if spec[0] == Layer.DROPOUT:
            # the global mask from the layer's key, this rank's rows of it
            u = rng.uniform(layer_key(key, j), (n,) + tuple(xl.shape[1:]),
                            xl.device)
            m = (u > spec[1][0]).to(torch.float32)[lo:lo + k]
            y = xl * m
        elif spec[0] in _TP_SPLIT and mesh.tp > 1:
            y, m = _tp_layer(mesh, ls, xl, p), None
        elif spec[0] == Layer.BATCHNM:
            y, xhat, rvar = _batchnorm_dp(mesh, xl, p[0], p[1], n)
            m = (xhat, rvar)
        elif spec[0] == Layer.MOE:
            y, m = _moe_fwd(xl, p[0], p[1], spec[1][2], mesh), None
        else:
            y, m = _apply_layer(ls, xl, p, None)
        xl = y.reshape(ls[2])
        outs.append(xl)
        masks.append(m)
    return tuple(outs), tuple(masks)


@torch.no_grad()
def forward_pure(program, x, params, key=None):
    """whole-network forward: (per-layer outputs, derivative masks).
    `key` (a jax.random key pair, default PRNGKey(0)) feeds dropout only:
    layer j draws from fold_in(key, j), as in the JAX package (see
    layer_key).  Under T4_MESH see word_mesh."""
    key = rng.PRNGKey(0) if key is None else key
    mesh = _mesh_for(program, x.shape[0])
    if mesh is not None:
        return _forward_mesh(mesh, program, x, params, key)
    outs, masks = [], []
    for j, (spec, p) in enumerate(zip(program, params)):
        kj = layer_key(key, j) if spec[0] == Layer.DROPOUT else None
        x, m = _apply_layer(spec, x, p, kj)
        x = x.reshape(spec[2])
        outs.append(x)
        masks.append(m)
    return tuple(outs), tuple(masks)


@torch.no_grad()
def forward_with_metrics(program, x, params, key, labels):
    """a dataset input's forward with its one-hot target and hit count
    from the batch's device labels (reference forward.cu:71-75 collects
    both after the pass); nothing is read back.  Under the word mesh the
    one-hot is the whole batch's and the hit count the whole batch's
    (the last output gathered)"""
    outs, masks = forward_pure(program, x, params, key)
    out = outs[-1]
    mesh = word_mesh()
    if mesh is not None:
        out = _gather_rows(mesh, out)
    n = out.shape[0]
    classes = out.numel() // n
    hot = onehot_fn(labels, classes).reshape(n, 1, classes, 1)
    return outs, masks, hot, hit_fn(out, hot)


# ===========================================================================
# whole-network backward
# ===========================================================================
_PASS_THRU = (Layer.SIGMOID, Layer.SOFTMAX, Layer.LOGSMAX)
_MASKED = (Layer.RELU, Layer.TANH, Layer.SELU, Layer.LEAKYRL, Layer.ELU,
           Layer.DROPOUT)


def _acc(a, g):
    """accumulate a gradient into an accumulator of any equal-numel shape
    (the model hands over its rank-4 storage tensors); returns a new
    tensor and leaves the accumulator as it was"""
    return a + g.reshape(a.shape)


@torch.no_grad()
def backward_pure(program, train, tgt, x0, outs, params, masks, dws, dbs,
                  flash: bool = True):
    """whole-network backward with the reference quirks (pass-through
    sigmoid/softmax/logsmax and final linear, masked activations):
    (dout, dxs, dws', dbs').  flash=False sends the attention layers
    through the einsum path, as a check of the kernels.  (The JAX
    package's _bwd_body: with no jit wrapper to share it with, the body
    lives here.)  Under T4_MESH see word_mesh."""
    k = outs[-1].shape[0]
    mesh = word_mesh()
    if mesh is not None:
        mesh = _mesh_for(program, k * mesh.dp)
        return _backward_mesh(mesh, program, train, tgt, x0, outs, params,
                              masks, dws, dbs, flash)
    return _backward_body(program, train, tgt, x0, outs, params, masks, dws,
                          dbs, flash)


def _backward_body(program, train, tgt, x0, outs, params, masks, dws, dbs,
                   flash, mesh=None):
    # dLoss prep (reference _bprep, backprop.cu:75-109): the fused
    # final-activation+loss pairs and a final linear become out-tgt; any
    # other final layer means tgt already IS dLoss (e.g. GAN G <- D
    # input grad)
    if program[-1][0] in _PASS_THRU + (Layer.LINEAR,):
        dy = outs[-1] - tgt.reshape(outs[-1].shape)
    else:
        dy = tgt.reshape(outs[-1].shape)
    _, dxs, ndws, ndbs = backward_segment(
        program, train, dy, x0, outs, params, masks, dws, dbs, tail=True,
        flash=flash, mesh=mesh)
    return dy, dxs, ndws, ndbs


def _backward_mesh(mesh, program, train, tgt, x0, outs, params, masks,
                   dws, dbs, flash):
    """backward_pure on the rank's rows (outs and masks; the target and
    the input whole or the rank's) and the rank's parameter shards: the
    rank's shard of each dW/dB, its contribution summed over dp (the
    batch's sum, in another order), dout and the input gradients its
    rows"""
    k = outs[-1].shape[0]
    n = k * mesh.dp
    zw = [None if d is None else torch.zeros_like(d) for d in dws]
    zb = [None if d is None else torch.zeros_like(d) for d in dbs]
    dout, dxs, cw, cb = _backward_body(
        tuple(_local_spec(spec, k) for spec in program), train,
        _rows_of(mesh, tgt.reshape((-1,) + tuple(outs[-1].shape[1:])), k),
        _rows_of(mesh, x0, k), outs, params, masks, zw, zb, flash,
        mesh=(mesh, n))
    ndws = [None if c is None else _acc(d, mesh.all_reduce(
        c.contiguous(), "dp")) for d, c in zip(dws, cw)]
    ndbs = [None if c is None else _acc(d, mesh.all_reduce(
        c.contiguous(), "dp")) for d, c in zip(dbs, cb)]
    return dout, dxs, type(cw)(ndws), type(cb)(ndbs)


def _conv_grads(x, w, dy, S, P):
    """(dx, dw, db) of _conv_fwd for the cotangent dy (NHWC), each dot in
    the forward's class"""
    n, h, wd, c1 = x.shape
    k, c0 = w.shape[1], w.shape[3]
    dyf = dy.permute(0, 3, 1, 2).reshape(n, c0, -1)          # [N, C0, L]
    cols = _patches(x, k, S, P)                              # [N, C1KK, L]
    dcols = class_dot(_mm, _filter2d(w).T, dyf)
    dx = _fold(dcols, h, wd, k, S, P)
    dw2 = class_dot(_mm, dyf.permute(1, 0, 2).reshape(c0, -1),
                    cols.permute(0, 2, 1).reshape(-1, cols.shape[1]))
    dw = dw2.reshape(c0, c1, k, k).permute(1, 2, 3, 0)
    return dx, dw, dy.sum(dim=(0, 1, 2))


def _dconv_grads(x, w, dy, S, P):
    """(dx, dw, db) of _dconv_fwd: the output's patches carry the
    cotangent back through the filter"""
    n, h, wd, c1 = x.shape
    k, c0 = w.shape[1], w.shape[3]
    dcols = _patches(dy, k, S, P)                            # [N, C0KK, L]
    dx = class_dot(_mm, _tfilter2d(w).T, dcols)              # [N, C1, L]
    xf = x.permute(0, 3, 1, 2).reshape(n, c1, -1)
    dw2 = class_dot(_mm, dcols.permute(1, 0, 2).reshape(dcols.shape[1], -1),
                    xf.permute(0, 2, 1).reshape(-1, c1))     # [C0KK, C1]
    dw = dw2.reshape(c0, k, k, c1).permute(3, 1, 2, 0)
    return (dx.reshape(n, c1, h, wd).permute(0, 2, 3, 1), dw,
            dy.sum(dim=(0, 1, 2)))


def _split_grads(m, kind, x_in, w, dy, opts, out_shape):
    """(dx, dw, db) of a linear, proj or conv layer (w its weight in the
    shape _params gives); on a tp rank of the word mesh (m) from its
    output features' part of dy and its shard of w, dx summed over tp"""
    if kind == Layer.CONV:
        dyc = dy.reshape(out_shape)
        if m is not None:               # the rank's output features
            dyc = m.chunk(dyc, 3, "tp").contiguous()
        dx, dw, db = _conv_grads(x_in, w, dyc, *opts)
    else:
        rows = x_in.shape[0] * (x_in.shape[1] if kind == Layer.PROJ else 1)
        dyf = dy.reshape(rows, -1)
        if m is not None:
            dyf = m.chunk(dyf, 1, "tp")
        db = dyf.sum(dim=0)
        # a linear layer's products as the JAX package's jnp.dot sums them
        # on the CPU (one process: a rank's shards are other dots)
        op = _linear_mm if kind == Layer.LINEAR and m is None else _mm
        dw = class_dot(op, dyf.T, x_in.reshape(rows, -1))
        dx = class_dot(op, dyf, w)
    if m is not None:                   # the features' parts of dx
        dx = m.all_reduce(dx.contiguous(), "tp")
    return dx, dw, db


@torch.no_grad()
def backward_segment(program, train, dy, x0, outs, params, masks, dws, dbs,
                     tail: bool = False, flash: bool = True, mesh=None):
    """per-layer backward over a program segment given the cotangent dy at
    the segment's output (no dLoss prep): (dx0, dxs, dws', dbs').  With
    train false only the input gradients are taken.  tail=True enables
    the final-LINEAR pass-through quirk (no weight gradient), right only
    for the segment that ends the network.  mesh=(mesh, n): the rows are
    a dp rank's of a batch of n (batchnorm's means are the batch's) and
    the parameters the rank's shards (see word_mesh)."""
    L = len(program)
    dxs = [None] * L
    ndws, ndbs = list(dws), list(dbs)
    m = mesh[0] if mesh is not None else None
    for j in range(L - 1, -1, -1):
        kind, opts, out_shape = program[j]
        x_in = outs[j - 1] if j > 0 else x0
        dw = db = None
        split = m is not None and kind in _TP_SPLIT and m.tp > 1
        if kind in _PASS_THRU or kind == Layer.FLATTEN or (
                kind == Layer.LINEAR and tail and j == L - 1):
            dx = dy
        elif kind in _MASKED:
            # masks may carry a stale header shape if the user reshaped a
            # layer view between forward and backprop
            dx = dy * masks[j].reshape(dy.shape)
        elif kind in _TP_SPLIT:
            dx, dw, db = _split_grads(m if split else None, kind, x_in,
                                      params[j][0], dy, opts, out_shape)
        elif kind == Layer.DCONV:
            dx, dw, db = _dconv_grads(x_in, params[j][0],
                                      dy.reshape(out_shape), *opts)
        elif kind in _POOL_FILL:
            dx = _pool_bwd(kind, x_in, opts[0], dy)
        elif kind == Layer.USAMPLE:
            dx = _upsample_bwd(opts[0], dy.reshape(out_shape))
        elif kind == Layer.BATCHNM:
            # dgamma/dbeta accumulate channel MEANs (k_dbatchnorm_2)
            xhat, rvar = masks[j]
            dyr = dy.reshape(out_shape)
            if mesh is None:
                db = dbm = dyr.mean(dim=(0, 1, 2))
                dw = dwm = (dyr * xhat).mean(dim=(0, 1, 2))
            else:
                # this rank's part of the batch's means; the means
                # themselves are their sum over dp
                cnt = mesh[1] * out_shape[1] * out_shape[2]
                db = dyr.sum(dim=(0, 1, 2)) / cnt
                dw = (dyr * xhat).sum(dim=(0, 1, 2)) / cnt
                dbm, dwm = m.all_reduce(torch.stack((db, dw)),
                                        "dp").unbind(0)
            dx = params[j][0] * rvar * (dyr - dbm - xhat * dwm)
        elif kind == Layer.ATTN:
            heads, causal, rope = _attn_opts(opts)
            dx, dw, db = _vjp(
                lambda x_, w1, w2: _mha_fwd(x_, w1, w2, heads, flash=flash,
                                            causal=causal, rope=rope),
                (x_in, *params[j]), dy.reshape(out_shape))
        elif kind == Layer.MOE:
            dx, dw, db = _vjp(
                lambda x_, w1, w2: _moe_fwd(x_, w1, w2, opts[2], m),
                (x_in, *params[j]), dy.reshape(out_shape))
            if _expert_axis(m):          # the rank's experts' part of dx
                dx = m.all_reduce(dx.contiguous(), _expert_axis(m))
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
        else:
            raise NotImplementedError(
                f"backprop: layer {_kind_name(kind)} has no backward")
        if train and dw is not None:
            ndws[j] = _acc(ndws[j], dw)
            ndbs[j] = _acc(ndbs[j], db)
        dy = dxs[j] = dx.reshape(x_in.shape)
    return dy, tuple(dxs), tuple(ndws), tuple(ndbs)


# ===========================================================================
# optimizers (reference k_sgd / k_adam / k_adamw semantics)
# ===========================================================================
def _one_minus(b: float) -> float:
    """1 - b in f32, as the reference computes it from its f32
    hyperparameters (1 - 0.999 is 0.00099998713 there, not 0.001)"""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(b, dtype=torch.float32))


def hypers(opt: str, hyper: tuple):
    """an optimizer's arguments from its (lr, h1, h2, h3): (lr, b) for
    sgd/sgdm, (lr, b1, b2, wd) for adam/adamw, each with its 1 - b"""
    lr, h1, h2, h3 = hyper
    if opt in ("sgd", "sgdm"):
        return lr, h1, _one_minus(h1)
    return lr, h1, h2, h3, _one_minus(h1), _one_minus(h2)


def _add_(y, x, a, sign: float = 1.0):
    """y += sign * a * x in place.  A float a is add_'s alpha; a 0-d
    tensor (a captured cycle keeps its hyperparameters on the device, and
    the word path on the card takes them from there too, so that both
    round alike) multiplies first"""
    if torch.is_tensor(a):
        return y.add_(x * a) if sign > 0 else y.sub_(x * a)
    return y.add_(x, alpha=a) if sign > 0 else y.sub_(x, alpha=a)


@torch.no_grad()
def sgd_step(ws, dws, ms, ndivs, momentum: bool, lr, b, omb):
    """one SGD step over lists of tensors, IN PLACE (the JAX version
    returns new arrays; updating where the state lies saves a copy of
    every weight, gradient and momentum per step).  The gradient is
    divided by its weight tensor's batch divisor; with momentum
    m = b*m + (1-b)*g and w -= lr*m (omb = 1 - b, see hypers).  Gradients
    are zeroed.  The hyperparameters are floats or 0-d tensors (_add_)."""
    for w, dw, m, nd in zip(ws, dws, ms, ndivs):
        dg = dw / nd
        if momentum:
            _add_(m.mul_(b), dg, omb)
            _add_(w, m, lr, -1.0)
        else:
            _add_(w, dg, lr, -1.0)
        dw.zero_()


@torch.no_grad()
def adam_step(ws, dws, ms, vs, adamw: bool, lr, b1, b2, wd, om1, om2):
    """one Adam or AdamW step over lists of tensors, IN PLACE (see
    sgd_step; om1, om2 = 1 - b1, 1 - b2).  The reference's form: no bias
    correction, eps = 1e-6 outside the square root; AdamW's decay is
    decoupled (added to the update, not to the gradient).  Gradients are
    zeroed."""
    for w, dg, m, v in zip(ws, dws, ms, vs):
        _add_(m.mul_(b1), dg, om1)
        if torch.is_tensor(om2):
            v.mul_(b2).addcmul_(dg * om2, dg)
        else:
            v.mul_(b2).addcmul_(dg, dg, value=om2)
        upd = m / (torch.sqrt(v) + 1.0e-6)
        if adamw:
            _add_(upd, w, wd)
        _add_(w, upd, lr, -1.0)
        dg.zero_()


# ===========================================================================
# the canonical word cycle as one body (the JAX package's _fused_cycle_body)
# ===========================================================================
@torch.no_grad()
def fused_cycle_body(program, train, loss_op, opt, ndivs, x, params, dws,
                     dbs, ws, ms, vs, labels, key, hy):
    """`forward loss.X ... backprop nn.<opt>` of one batch, built from
    the word path's own functions in the words' order, so it computes
    what the words compute: the forward with the one-hot and hit count,
    the loss, the input-gradient chain with dW/dB accumulated into
    dws/dbs, the optimizer step, the zeroed gradients and the int8 finite
    status.  ws, ms, vs are the trainables' flat weights and moments in
    Model._trainables() order and are stepped IN PLACE (`params` views
    ws); hy is hypers(opt, hyper), floats or 0-d tensors.  Returns (outs,
    masks, hot, hit, lval, dout, dxs, ndws, ndbs, nws, nms, nvs, zdws,
    fin) as the reference's does; nws, nms, nvs are ws, ms, vs."""
    outs, masks, hot, hit = forward_with_metrics(program, x, params, key,
                                                 labels)
    mesh = word_mesh()
    # the loss over the whole batch (the last output gathered on a mesh)
    lval = loss_fn(loss_op, outs[-1] if mesh is None
                   else _gather_rows(mesh, outs[-1]), hot)
    dout, dxs, ndws, ndbs = backward_pure(program, train, hot, x, outs,
                                          params, masks, dws, dbs)
    # the optimizer zeroes what it is given; the backprop word's dW/dB
    # stay in ndws, ndbs
    zdws = [g.clone() for j in range(len(program)) if params[j]
            for g in (ndws[j], ndbs[j])]
    if opt in ("adam", "adamw"):
        adam_step(ws, zdws, ms, vs, opt == "adamw", *hy)
    else:
        sgd_step(ws, zdws, ms, ndivs, opt == "sgdm", *hy)
    # 0 ok, 1 the forward's loss is not finite, 2 the step's weights are
    # not (the forward was) -- the err-bit sentinel's status, made on the
    # device so the word path pays no readback
    w_ok = (torch.stack([torch.isfinite(w).all() for w in ws]).all()
            if ws else torch.ones((), dtype=torch.bool, device=x.device))
    if mesh is not None:
        # every rank of the mesh takes one status: its shards' and the
        # other ranks' (a rank's own would part the ranks' words)
        bad = (~w_ok).to(torch.float32).reshape(1)
        for ax in mesh.axis_names:
            mesh.all_reduce(bad, ax)
        w_ok = bad[0] == 0
    fin = torch.where(torch.isfinite(lval), torch.where(w_ok, 0, 2),
                      1).to(torch.int8)
    return (outs, masks, hot, hit, lval, dout, dxs, ndws, ndbs, tuple(ws),
            tuple(ms), tuple(vs), tuple(zdws), fin)


# ===========================================================================
# loss / metrics (reference Tensor::loss, Model::hit)
# ===========================================================================
@torch.no_grad()
def loss_fn(op: str, out, tgt):
    """summed loss over all elements divided by the batch N (not by N*S);
    on CPU tensors XLA CPU's bits (`ops/xla_reduce.py`)"""
    if out.device.type == "cpu":
        return xla_reduce.xla_loss(op, out, tgt, LN_CLAMP)
    n = out.shape[0] if out.dim() > 1 else 1
    o = out.reshape(-1)
    t = tgt.reshape(-1)
    if op == "mse":
        z = torch.sum((o - t) ** 2)
    elif op == "bce":
        z = -torch.sum(t * xla_math.log(o + 1.0e-6)
                       + (1.0 - t) * xla_math.log(1.0 - o + 1.0e-6))
    elif op == "ce":
        z = -torch.sum(t * xla_math.log(torch.clamp(o, min=LN_CLAMP)))
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
    """class ids [...] -> [..., classes] f32 one-hot, as a compare: no
    check of the labels, so nothing is read back inside a capture"""
    return (labels.to(torch.int64).unsqueeze(-1) == torch.arange(
        classes, device=labels.device)).to(torch.float32)
