"""NN compute on torch tensors — the layer forwards the LM serving path
runs (the port of tensorforth_tpu/nn/funcs.py, forward only).

Layouts are the JAX package's: activations [N, S, E, 1], attention cores
[B*h, S, dh], wqkv [3E, E].  Every dot is strict f32 (TF32 is off, see
the package __init__).  The attention core routes long aligned causal
prompts on the card through the hand-written flash kernel
(ops/attn.py); everything else uses the exact einsum path.  Backward
passes, dropout, MoE and the conv/pool tier come with later slices.
"""
from __future__ import annotations

import math
import os

import torch

from .ntypes import Layer

SELU_L = 1.0507009873554805
SELU_LA = SELU_L * 1.6732632423543772
NEG_INF = -1.0e30

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


def _flash_ok(q) -> bool:
    """the flash kernel's gate: a CUDA tensor of a long, aligned shape.
    (The JAX gate tests for a TPU backend instead, funcs.py:163-165.)"""
    _, s, dh = q.shape
    return q.is_cuda and s >= 512 and s % 256 == 0 and dh % 128 == 0


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


def sdpa(q, k, v, causal: bool = False):
    """softmax-attention core, forward: the flash kernel for long aligned
    sequences on the card (S x S never reaches device memory), the exact
    einsum path otherwise"""
    if _flash_ok(q):
        from ..ops.attn import flash_attention
        o, _lse = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  hybrid=_attn_hybrid())
        return o
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
def _apply_layer(spec, x, p):
    kind, opts, _out_shape = spec
    if kind in _ACTS:
        return _activate_fwd(kind, x, opts[0])
    if kind == Layer.SOFTMAX:
        return _softmax_fwd(x), None
    if kind == Layer.ATTN:
        return _mha_fwd(x, p[0], p[1], opts[0], flash=True,
                        causal=bool(opts[1]) if len(opts) > 1 else False,
                        rope=bool(opts[2]) if len(opts) > 2 else False), None
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
