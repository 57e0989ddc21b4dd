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

The fused backward kernel, ``csrc/flash_bwd_fused.cu``, replaces
attn_pallas.py:_flash_bwd_fused_kernel (launched by that module's
``flash_attention_bwd_fused``): dQ, dK and dV in one launch with five
products per tile pair where the split has seven, dK and dV leaving as
per-Q-block partials [B*h, n_q, S, dh] that one ``sum(dim=1)`` reduces.
It is a measurement path (``attn_bench``): ``flash_attention_lse`` keeps
the two-kernel backward, as in the JAX package.

The dots-only probe, ``csrc/attn_dots.cu``, replaces the Pallas kernel
inside bench.py:_attn_dots_probe: the forward kernel's two products with
the softmax taken out, on bf16 operands.

Every wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors; anything else raises.  There is no
fallback on the card.
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
    "flash_bwd_fused": {"t4_flash_bwd_fused": [_P] * 9 + [_I] * 6
                        + [_F, _F, _P]},
    "attn_dots": {"t4_attn_dots": [_P] * 4 + [_I] * 3 + [_P]},
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


def _check_shape(what: str, tensors):
    """the kernels' shapes: equal [B*h, S, dh], dh in KERNEL_DH,
    S % TILE == 0"""
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         f", want equal [B*h, S, dh]")
    _, s, dh = shape
    if dh not in KERNEL_DH or s % TILE:
        raise ValueError(f"{what}: kernel takes dh in {KERNEL_DH} "
                         f"and S % {TILE} == 0, got S={s} dh={dh}")


def _check_cuda(what: str, tensors, dtype=torch.float32):
    """the kernels' contract: _check_shape, contiguous `dtype`, on one
    CUDA device"""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or not tensors[0].is_cuda:
        raise ValueError(f"{what}: tensors on {sorted(map(str, devs))}")
    _check_shape(what, tensors)
    for t in tensors:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous {dtype}, "
                             f"got {t.dtype} contiguous={t.is_contiguous()}")


def _check_rows(what: str, q, tensors):
    """lse, dlse: f32 [B*h, S] beside q"""
    for t in tensors:
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{what}: lse/dlse must be f32 "
                             f"{tuple(q.shape[:2])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_fwd(q, k, v, causal: bool, hybrid: bool, qscale: float):
    """launch the forward kernel on prepared operands (f32, or bf16 when
    hybrid), q multiplied by qscale as the kernel loads it: (o, lse)"""
    b, s, dh = q.shape
    lib = _lib("flash_fwd")
    o = torch.empty((b, s, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), b, s, dh,
                               int(causal), int(hybrid), qscale, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, causal: bool = False, hybrid: bool = False):
    """q, k, v [B*h, S, dh] f32 -> (o [B*h, S, dh] f32, lse [B*h, S] f32
    in nats).  CUDA tensors launch the kernel; CPU tensors take the plain
    version; anything else raises."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal, hybrid)
    _check_cuda("flash_attention", (q, k, v))
    scale = LOG2E / math.sqrt(q.shape[-1])
    if hybrid:
        # bf16 multiplicands: scale in f32, then round, as attn_pallas.py
        # does outside its kernel; the kernel then loads Q unscaled
        q = (q * scale).to(torch.bfloat16)
        k = k.to(torch.bfloat16)
        v = v.to(torch.bfloat16)
        scale = 1.0
    return _launch_fwd(q, k, v, causal, hybrid, scale)


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
    _check_rows("flash_attention_bwd", q, extra)
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


# ===========================================================================
# the fused single-kernel backward
# ===========================================================================
def _fit_block(s: int, pref: int) -> int:
    """largest multiple of 256 <= pref that divides s, else min(s, 256):
    the JAX package's default block sizes (attn_pallas.py:_fit_block)"""
    top = min(pref, s)
    top -= top % 256
    for d in range(top, 255, -256):
        if s % d == 0:
            return d
    return min(s, 256)


def _fused_bq(what: str, s: int, bq) -> int:
    """the Q block of the fused backward: the caller's, or the JAX
    package's default; it must be whole tiles and divide S"""
    bq = _fit_block(s, 1024) if bq is None else min(int(bq), s)
    if bq <= 0 or bq % TILE or s % bq:
        raise ValueError(f"{what}: bq must be a multiple of {TILE} that "
                         f"divides S, got S={s} bq={bq}")
    return bq


def flash_attention_bwd_fused_parts_ref(q, k, v, o, lse, do, bq=None,
                                        causal: bool = False,
                                        hybrid: bool = False, dlse=None):
    """plain PyTorch version of the fused backward kernel: (dq [B,S,dh],
    dk_parts, dv_parts [B, n_q, S, dh]).  flash_attention_bwd_ref's
    arithmetic, one Q block of bq rows at a time against the keys that the
    block sees; under the causal mask the keys after the block are never
    visited and their rows of the block's partials stay zero."""
    b, s, dh = q.shape
    bq = _fused_bq("flash_attention_bwd_fused_parts_ref", s, bq)
    n_q = s // bq
    q2, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                hybrid, dlse)
    q2 = q2.float() * qscale
    k, v, do = k.float(), v.float(), do.float()
    lse2 = lse * LOG2E

    def rnd(x):
        return x.to(torch.bfloat16).float() if hybrid else x

    dq = torch.empty_like(q2)
    dkp = torch.zeros((b, n_q, s, dh), dtype=torch.float32, device=q.device)
    dvp = torch.zeros_like(dkp)
    for qi in range(n_q):
        rows = slice(qi * bq, (qi + 1) * bq)
        n_k = (qi + 1) * bq if causal else s
        kb, vb = k[:, :n_k], v[:, :n_k]
        s2 = torch.einsum("nqd,nkd->nqk", q2[:, rows], kb)
        if causal:
            keep = (torch.arange(n_k, device=q.device)[None, :]
                    <= torch.arange(qi * bq, (qi + 1) * bq,
                                    device=q.device)[:, None])
            s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
        p = torch.exp2(s2 - lse2[:, rows, None])
        dp = torch.einsum("nqd,nkd->nqk", do[:, rows], vb)
        ds = rnd(p * (dp - delta[:, rows, None]))
        dq[:, rows] = torch.einsum("nqk,nkd->nqd", ds, kb) / math.sqrt(dh)
        dvp[:, qi, :n_k] = torch.einsum("nqk,nqd->nkd", rnd(p), do[:, rows])
        dkp[:, qi, :n_k] = torch.einsum("nqk,nqd->nkd", ds,
                                        q2[:, rows]) * LN2
    return dq, dkp, dvp


def flash_attention_bwd_fused_ref(q, k, v, o, lse, do, bq=None,
                                  causal: bool = False, hybrid: bool = False,
                                  dlse=None):
    """plain PyTorch version of flash_attention_bwd_fused: (dq, dk, dv)"""
    dq, dkp, dvp = flash_attention_bwd_fused_parts_ref(
        q, k, v, o, lse, do, bq, causal, hybrid, dlse)
    return dq, dkp.sum(dim=1), dvp.sum(dim=1)


def flash_attention_bwd_fused_parts(q, k, v, o, lse, do, bq=None,
                                    causal: bool = False,
                                    hybrid: bool = False, dlse=None):
    """the fused backward before its sum: (dq [B*h, S, dh], dk_parts,
    dv_parts [B*h, n_q, S, dh]) f32, n_q = S / bq.  CUDA tensors launch
    the one kernel; CPU tensors take the plain version; anything else
    raises."""
    what = "flash_attention_bwd_fused"
    _check_shape(what, (q, k, v, o, do))
    bq = _fused_bq(what, q.shape[1], bq)
    extra = (lse,) if dlse is None else (lse, dlse)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do) + extra):
        return flash_attention_bwd_fused_parts_ref(q, k, v, o, lse, do, bq,
                                                   causal, hybrid, dlse)
    _check_cuda(what, (q, k, v, o, do))
    _check_rows(what, q, extra)
    b, s, dh = q.shape
    q2, kk, vv, dd, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                  hybrid, dlse)
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = _lib("flash_bwd_fused")
    dq = torch.empty((b, s, dh), dtype=torch.float32, device=q.device)
    dkp = torch.empty((b, s // bq, s, dh), dtype=torch.float32,
                      device=q.device)
    dvp = torch.empty_like(dkp)
    ptrs = [t.data_ptr() for t in (q2, kk, vv, dd, lse, delta, dq, dkp, dvp)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_flash_bwd_fused(*ptrs, b, s, dh, bq, int(causal),
                                     int(hybrid), qscale,
                                     1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_fused kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd_fused.launches += 1
    return dq, dkp, dvp


def flash_attention_bwd_fused(q, k, v, o, lse, do, bq=None,
                              causal: bool = False, hybrid: bool = False,
                              dlse=None):
    """flash_attention_bwd's inputs and (dq, dk, dv), through the
    single-kernel backward: one launch, then one sum over the n_q = S / bq
    partials of dK and of dV.  bq, the rows of a Q block, defaults to the
    JAX package's _fit_block(S, 1024); it fixes n_q and with it the
    partial traffic and the number of blocks in the grid.  The kernel's
    KV tile is its own and is no parameter."""
    dq, dkp, dvp = flash_attention_bwd_fused_parts(q, k, v, o, lse, do, bq,
                                                   causal, hybrid, dlse)
    return dq, dkp.sum(dim=1), dvp.sum(dim=1)


flash_attention_bwd_fused.launches = 0   # kernel launches since the reset


# ===========================================================================
# the dots-only probe
# ===========================================================================
def attn_dots_ref(q, k, v):
    """plain PyTorch version of the probe kernel: f32 products of the bf16
    values, the scores rounded to bf16 before the second product, the sum
    over the keys taken one TILE of keys after another, as the kernel
    takes it"""
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros_like(qf)
    for k0 in range(0, k.shape[1], TILE):
        s2 = torch.einsum("nqd,nkd->nqk", qf, kf[:, k0:k0 + TILE])
        o += torch.einsum("nqk,nkd->nqd", s2.to(torch.bfloat16).float(),
                          vf[:, k0:k0 + TILE])
    return o


def attn_dots(q, k, v):
    """q, k, v [B*h, S, dh] bf16 -> o [B*h, S, dh] f32 = bf16(q k^T) v: the
    forward's two products with no scale, no mask and no softmax.  CUDA
    tensors launch the kernel; CPU tensors take the plain version;
    anything else raises."""
    _check_shape("attn_dots", (q, k, v))
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"attn_dots: tensors must be bfloat16, got "
                         f"{[t.dtype for t in (q, k, v)]}")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attn_dots_ref(q, k, v)
    _check_cuda("attn_dots", (q, k, v), torch.bfloat16)
    b, s, dh = q.shape
    lib = _lib("attn_dots")
    o = torch.empty((b, s, dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_attn_dots(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), b, s, dh, stream)
    if err != 0:
        raise RuntimeError(f"attn_dots kernel launch failed: cudaError {err}")
    attn_dots.launches += 1
    return o


attn_dots.launches = 0   # kernel launches since the last reset


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
