"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions.

The forward kernel, ``csrc/flash_fwd.cu``, replaces the Pallas TPU kernel
tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (launched by that
module's ``flash_attention``).  It computes o = softmax(q k^T/sqrt(dh)) v
and the per-row log-sum-exp in nats over [B*h, S, dh], causal or not,
with the S x S scores kept on chip.  On this card it is bound by
operations: strict-f32 products run on the CUDA cores, so it keeps the
FMA units fed from shared-memory tiles with register blocking (the
source's header says how).  lse is stored [B*h, S]; the Pallas kernel's
128-lane copy was a TPU layout artefact.

The two backward kernels, ``csrc/flash_bwd.cu``, replace
attn_pallas.py:_flash_bwd_dkv_kernel and :_flash_bwd_dq_kernel (launched
by that module's ``flash_attention_bwd``): dK/dV with the KV tile
stationary and dQ with the Q tile stationary, each recomputing its
probability tile from the saved log-sum-exp.  They too are bound by
operations (4 and 3 strict-f32 products per visited tile).
``flash_attention_lse`` pairs forward and backward as a
``torch.autograd.Function`` that returns (o, lse), differentiable in both
(attn_pallas.py:flash_attention_lse).

``flash_attention`` and ``flash_attention_bwd`` launch their kernels for
CUDA tensors and use the plain versions only for CPU tensors; anything
else raises.  There is no fallback on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1.0e30          # the mask value of attn_pallas.py:25
KERNEL_DH = (128, 256)     # head dims the kernel is compiled for
TILE = 64                  # S must be a multiple of the kernel's tile


def flash_attention_ref(q, k, v, causal: bool = False, hybrid: bool = False):
    """plain PyTorch version: (o [B,S,dh], lse [B,S] in nats).

    f32: the exact einsum attention (nn/funcs.py _sdpa_ref) plus its
    log-sum-exp.  hybrid: the kernel's bf16 treatment — q*scale*log2(e),
    k and v rounded to bf16, base-2 softmax in f32, P rounded to bf16
    before the PV product, f32 sums."""
    s, dh = q.shape[1], q.shape[2]
    keep = (torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    if not hybrid:
        sc = torch.einsum("nqd,nkd->nqk", q, k) / math.sqrt(dh)
        if causal:
            sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        lse = torch.logsumexp(sc, dim=-1)
        o = torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1), v)
        return o, lse
    bf = torch.bfloat16
    q2 = (q * (LOG2E / math.sqrt(dh))).to(bf).float()
    s2 = torch.einsum("nqd,nkd->nqk", q2, k.to(bf).float())
    if causal:
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nqk,nkd->nqd", p.to(bf).float(), v.to(bf).float()) / l
    return o, ((m + torch.log2(l)) * LN2)[..., 0]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {   # library -> exported function -> ctypes signature
    "flash_fwd": {"t4_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _P]},
    "flash_bwd": {"t4_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _P],
                  "t4_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _F, _P]},
}


def _lib(name: str):
    """the built library csrc/<name>.cu, its functions' argtypes set"""
    from . import _build
    lib = _build.load(name)
    for fname, argtypes in _ARGTYPES[name].items():
        fn = getattr(lib, fname)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_cuda(what: str, tensors):
    """the kernels' contract: equal-shape contiguous f32 [B*h, S, dh] on
    one CUDA device, dh in KERNEL_DH, S % TILE == 0"""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or not tensors[0].is_cuda:
        raise ValueError(f"{what}: tensors on {sorted(map(str, devs))}")
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         f", want equal [B*h, S, dh]")
    _, s, dh = shape
    if dh not in KERNEL_DH or s % TILE:
        raise ValueError(f"{what}: kernel takes dh in {KERNEL_DH} "
                         f"and S % {TILE} == 0, got S={s} dh={dh}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous f32, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")


def flash_attention(q, k, v, causal: bool = False, hybrid: bool = False):
    """q, k, v [B*h, S, dh] f32 -> (o [B*h, S, dh] f32, lse [B*h, S] f32
    in nats).  CUDA tensors launch the kernel; CPU tensors take the plain
    version; anything else raises."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal, hybrid)
    _check_cuda("flash_attention", (q, k, v))
    b, s, dh = q.shape
    scale = LOG2E / math.sqrt(dh)
    if hybrid:
        # bf16 multiplicands: scale in f32, then round, as attn_pallas.py
        # does outside its kernel; the kernel then loads Q unscaled
        q = (q * scale).to(torch.bfloat16)
        k = k.to(torch.bfloat16)
        v = v.to(torch.bfloat16)
        scale = 1.0
    lib = _lib("flash_fwd")
    o = torch.empty((b, s, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), b, s, dh,
                               int(causal), int(hybrid), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0   # kernel launches since the last reset


# ===========================================================================
# backward
# ===========================================================================
def _bwd_operands(q, k, v, o, lse, do, hybrid, dlse):
    """what both backward kernels and their plain version read: (q, k, v,
    do, delta, qscale), with q still to be multiplied by qscale.
    delta = sum_d do*o - dlse is taken in f32 before any hybrid cast
    (attn_pallas.py:407-415); hybrid rounds q*scale*log2e, k, v and do to
    bf16 out here, as attn_pallas.py:416-421 does."""
    delta = (do * o).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse
    qscale = LOG2E / math.sqrt(q.shape[-1])
    if hybrid:
        bf = torch.bfloat16
        q, k, v, do = (q * qscale).to(bf), k.to(bf), v.to(bf), do.to(bf)
        qscale = 1.0
    return q, k, v, do, delta, qscale


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = False,
                            hybrid: bool = False, dlse=None):
    """plain PyTorch version of the two backward kernels: (dq, dk, dv)
    from the forward's residuals, with the S x S tiles materialised.  The
    same arithmetic as the kernels: base-2 scores from q*scale*log2e,
    p = exp2(s2 - lse*log2e), ds = p*(dp - delta); hybrid rounds the same
    multiplicands to bf16 (p and ds before their products, ds formed from
    the unrounded p) and sums in f32."""
    s, dh = q.shape[1], q.shape[2]
    q2, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                hybrid, dlse)
    q2 = q2.float() * qscale
    k, v, do = k.float(), v.float(), do.float()

    def rnd(x):
        return x.to(torch.bfloat16).float() if hybrid else x

    s2 = torch.einsum("nqd,nkd->nqk", q2, k)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    dv = torch.einsum("nqk,nqd->nkd", rnd(p), do)
    dp = torch.einsum("nqd,nkd->nqk", do, v)
    ds = rnd(p * (dp - delta[..., None]))
    dk = torch.einsum("nqk,nqd->nkd", ds, q2) * LN2
    dq = torch.einsum("nqk,nkd->nqd", ds, k) / math.sqrt(dh)
    return dq, dk, dv


def _launch_bwd(which: str, ops, lse, delta, qscale, causal, hybrid):
    """launch one backward kernel on prepared operands: "dkv" -> (dk, dv),
    "dq" -> (dq,)"""
    q, k, v, do = ops
    b, s, dh = q.shape
    lib = _lib("flash_bwd")
    outs = tuple(torch.empty((b, s, dh), dtype=torch.float32,
                             device=q.device)
                 for _ in range(2 if which == "dkv" else 1))
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta) + outs]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "dkv":
            err = lib.t4_flash_bwd_dkv(*ptrs, b, s, dh, int(causal),
                                       int(hybrid), qscale, stream)
        else:
            err = lib.t4_flash_bwd_dq(*ptrs, b, s, dh, int(causal),
                                      int(hybrid), qscale,
                                      1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{which} kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd.launches[which] += 1
    return outs


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        hybrid: bool = False, dlse=None, only=None):
    """(dq, dk, dv) [B*h, S, dh] f32 from q, k, v, the forward's o and
    lse [B*h, S] (nats), the output cotangent do and, optionally, the lse
    cotangent dlse [B*h, S], which folds into delta.  CUDA tensors launch
    the dK/dV kernel and the dQ kernel; CPU tensors take the plain
    version; anything else raises.  only="dkv" or "dq" launches that one
    kernel alone and returns its outputs (for timing each by itself)."""
    extra = (lse,) if dlse is None else (lse, dlse)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do) + extra):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, hybrid,
                                       dlse)
    _check_cuda("flash_attention_bwd", (q, k, v, o, do))
    for t in extra:
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: lse/dlse must be f32 "
                             f"{tuple(q.shape[:2])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    *ops, delta, qscale = _bwd_operands(q, k, v, o, lse, do, hybrid, dlse)
    args = (ops, lse.contiguous(), delta.contiguous(), qscale, causal,
            hybrid)
    if only is not None:
        return _launch_bwd(only, *args)
    dk, dv = _launch_bwd("dkv", *args)
    dq, = _launch_bwd("dq", *args)
    return dq, dk, dv


# launches of each kernel since the last reset
flash_attention_bwd.launches = {"dkv": 0, "dq": 0}


class _FlashAttentionLse(torch.autograd.Function):
    """(o, lse) with both outputs differentiable: the forward kernel, and
    the two backward kernels with the lse cotangent folded into delta"""

    @staticmethod
    def forward(ctx, q, k, v, causal, hybrid):
        o, lse = flash_attention(q, k, v, causal=causal, hybrid=hybrid)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.hybrid = causal, hybrid
        ctx.set_materialize_grads(False)   # do or dlse may be None
        return o, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.hybrid, dlse=dlse)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = False, hybrid: bool = False):
    """flash attention that returns (o [B*h, S, dh], lse [B*h, S] in nats)
    and is differentiable in both outputs (what a softmax merge over
    sequence chunks consumes).  q, k, v contiguous f32."""
    return _FlashAttentionLse.apply(q, k, v, causal, hybrid)
