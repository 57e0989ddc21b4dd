"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions.

The forward kernel, ``csrc/flash_fwd.cu``, replaces the Pallas TPU kernel
tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (launched by that
module's ``flash_attention``).  It computes o = softmax(q k^T/sqrt(dh)) v
and the per-row log-sum-exp in nats over [B*h, S, dh], causal or not,
with the S x S scores kept on chip.  On this card it is bound by
operations, and both its products run on bf16 ``wgmma`` fed by TMA: in
the f32 class as six products of a three-part split (q*scale*log2e, k and
v split by one launch of the same source, ``_split_qkv``; p in registers),
in the hybrid class as one product of the wrapper's casts.  Its tile plan
is ``fwd_plan``.  lse is stored [B*h, S]; the Pallas kernel's 128-lane
copy was a TPU layout artefact.

The two backward kernels, ``csrc/flash_bwd.cu``, replace
attn_pallas.py:_flash_bwd_dkv_kernel and :_flash_bwd_dq_kernel (launched
by that module's ``flash_attention_bwd``): dK/dV with the KV rows
stationary and dQ with the Q rows stationary, each recomputing its
probability tile from the saved log-sum-exp.  They too are bound by
operations (4 and 3 products per visited tile pair), and run on bf16
``wgmma`` fed by TMA: in the f32 class as six products of a three-part
split (q*scale*log2e, k, v and do split by one launch of the same source,
``_split_bwd``; p and ds in registers), in the hybrid class as one
product of the wrapper's casts.  dh 256 in the f32 class keeps
strict-f32 FMA kernels (three parts of its tiles do not fit an SM).
Their plan is ``bwd_plan``.  ``flash_attention_lse`` pairs forward and
backward as a ``torch.autograd.Function`` that returns (o, lse),
differentiable in both (attn_pallas.py:flash_attention_lse).

The fused backward kernel, ``csrc/flash_bwd_fused.cu``, replaces
attn_pallas.py:_flash_bwd_fused_kernel (launched by that module's
``flash_attention_bwd_fused``): dQ, dK and dV in one launch with five
products per tile pair where the split has seven, dK and dV leaving as
per-Q-block partials [B*h, n_q, S, dh] that one ``sum(dim=1)`` reduces.
Its grid is planned here (``fused_plan``): a CTA owns a (head, Q block,
KV chunk) item, so the grid fills the card whatever bq is, and dq leaves
as one partial per KV chunk that the wrapper sums.  Hybrid mode runs on
bf16 ``wgmma``, f32 on the CUDA cores.  It is a measurement path
(``attn_bench``): ``flash_attention_lse`` keeps the two-kernel backward,
as in the JAX package.

The dots-only probe, ``csrc/attn_dots.cu``, replaces the Pallas kernel
inside bench.py:_attn_dots_probe: the forward kernel's two products with
the softmax taken out, on bf16 operands.

Every wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors; anything else raises.  There is no
fallback on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .gemm import SM90_ALIGN, _split3_ref

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


def flash_attention_split_ref(q, k, v, causal: bool = False,
                              parts: int = 3):
    """the f32 class's arithmetic with its products taken exactly, in f64:
    q*scale*log2e (an f32 product), k and v split into the first `parts`
    of the three-part split (gemm._split3_ref), s2 = the products of
    parts (i, j) with i + j < parts (six for 3 parts: the kernel's; three
    for 2: K5a 3pass's count) summed in f64, p = exp2(s2 - the row max)
    rounded to f32 and split the same way, o = the products of p's and
    v's parts over the row sum.  What it leaves out of the kernel: the
    tensor cores' truncating sums, ex2.approx, the running max.  Returns
    (o, lse in nats), f64."""
    s, dh = q.shape[1], q.shape[2]
    pairs = [(i, j) for i in range(parts) for j in range(parts)
             if i + j < parts]

    def prod(x, y, eq):
        xs = [t.double() for t in _split3_ref(x)[:parts]]
        ys = [t.double() for t in _split3_ref(y)[:parts]]
        return sum(torch.einsum(eq, xs[i], ys[j]) for i, j in pairs)

    s2 = prod(q * (LOG2E / math.sqrt(dh)), k, "nqd,nkd->nqk")
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m).float()
    l = p.double().sum(dim=-1, keepdim=True)
    o = prod(p, v, "nqk,nkd->nqd") / l
    return o, ((m + torch.log2(l)) * LN2)[..., 0]


# --- the forward kernel's tile plan -----------------------------------------
FWD_TILES = {128: (128, 64), 256: (64, 32)}   # dh -> (query rows, KV rows)
FWD_STAGES = {3: 1, 1: 2}        # parts -> stages of K and of V each


class FwdPlan(NamedTuple):
    """the forward kernel's plan for one shape (csrc/flash_fwd.cu: Fwd):
    a CTA of two warpgroups per (head, `bq` query rows); K and V in tiles
    of `bkv` rows, `stages` of each in flight; every operand in `parts`
    bf16 parts (3: the f32 class's split; 1: the hybrid casts)"""
    parts: int
    bq: int
    bkv: int
    stages: int
    smem: int           # dynamic shared memory, bytes
    ctas: int


def fwd_plan(bh: int, s: int, dh: int, hybrid: bool) -> FwdPlan:
    """the plan t4_flash_fwd launches (it refuses any other): Q's parts
    [bq, dh] stay for the CTA, K's and V's [bkv, dh] stream in `stages`
    each, 1024 bytes of alignment slack, an 8-byte barrier for Q and for
    each stage of K and of V"""
    parts = 1 if hybrid else 3
    bq, bkv = FWD_TILES[dh]
    stages = FWD_STAGES[parts]
    smem = (SM90_ALIGN + parts * bq * dh * 2 + 2 * stages * parts * bkv * dh
            * 2 + (1 + 2 * stages) * 8)
    return FwdPlan(parts, bq, bkv, stages, smem, bh * -(-s // bq))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {   # library -> exported function -> ctypes signature
    "flash_fwd": {"t4_flash_fwd": [_P] * 5 + [_I] * 9 + [_F, _P],
                  "t4_split_qkv": [_P] * 4 + [_I] * 2 + [_F, _P]},
    "flash_bwd": {"t4_flash_bwd_dkv": [_P] * 8 + [_I] * 9 + [_F, _P],
                  "t4_flash_bwd_dq": [_P] * 7 + [_I] * 9 + [_F, _F, _P],
                  "t4_split_bwd": [_P] * 5 + [_I] * 2 + [_F, _P]},
    "flash_bwd_fused": {"t4_flash_bwd_fused": [_P] * 10 + [_I] * 9
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


def _split_qkv(q, k, v, qscale: float):
    """the f32 class's operands: one launch writes [3 (q, k, v), 3 (hi,
    mid, lo), B*h, S, dh] bf16 from q*qscale, k and v (contiguous f32 on
    one CUDA device): q's, k's and v's parts"""
    b, s, dh = q.shape
    lib = _lib("flash_fwd")
    out = torch.empty((3, 3, b, s, dh), dtype=torch.bfloat16,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_split_qkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b * s, dh, qscale, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd split launch failed: cudaError {err}")
    flash_attention.split_launches += 1
    return out[0], out[1], out[2]


def _launch_fwd(q, k, v, causal: bool, hybrid: bool, qscale: float = 1.0):
    """launch the forward kernel on prepared operands: bf16 [B*h, S, dh]
    when hybrid, else bf16 parts [3, B*h, S, dh] (_split_qkv); the scores
    are qscale * (q k^T) (the wrappers fold the scale into q): (o, lse)"""
    b, s, dh = q.shape[-3:]
    plan = fwd_plan(b, s, dh, hybrid)
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.shape[-3:] != q.shape[-3:]
           or (t.dim() == 4) != (plan.parts == 3) for t in (q, k, v)):
        raise ValueError("flash_fwd: operands must be contiguous bf16 "
                         "[B*h, S, dh], or [3, B*h, S, dh] parts in the f32 "
                         "class")
    lib = _lib("flash_fwd")
    o = torch.empty((b, s, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), b, s, dh,
                               int(causal), plan.parts, plan.bq, plan.bkv,
                               plan.stages, plan.smem, qscale, stream)
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
        # does outside its kernel
        q, k, v = ((q * scale).to(torch.bfloat16), k.to(torch.bfloat16),
                   v.to(torch.bfloat16))
    else:
        q, k, v = _split_qkv(q, k, v, scale)
    return _launch_fwd(q, k, v, causal, hybrid)


flash_attention.launches = 0   # kernel launches since the last reset
flash_attention.split_launches = 0   # the f32 class's split launches


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


def flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal: bool = False,
                                  parts: int = 3, dlse=None):
    """the f32 class's backward arithmetic with its products taken exactly,
    in f64: delta and q*scale*log2e as _bwd_operands forms them (f32),
    q2, k, v and do split into the first `parts` of the three-part split
    (gemm._split3_ref), each product the sum of the products of parts
    (i, j) with i + j < parts (six for 3 parts: the kernels'; three for 2)
    in f64; s2 and dp rounded to f32 as the accumulators hold them, p =
    exp2(s2 - lse*log2e) and ds = p (dp - delta) in f32 and split the same
    way.  What it leaves out of the kernels: the tensor cores' truncating
    sums and ex2.approx.  Returns (dq, dk, dv), f64."""
    s, dh = q.shape[1], q.shape[2]
    q, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do, False,
                                               dlse)
    pairs = [(i, j) for i in range(parts) for j in range(parts)
             if i + j < parts]

    def prod(x, y, eq):
        xs = [t.double() for t in _split3_ref(x)[:parts]]
        ys = [t.double() for t in _split3_ref(y)[:parts]]
        return sum(torch.einsum(eq, xs[i], ys[j]) for i, j in pairs)

    q2 = q * qscale
    s2 = prod(q2, k, "nqd,nkd->nqk").float()
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    ds = p * (prod(do, v, "nqd,nkd->nqk").float() - delta[..., None])
    dv = prod(p, do, "nqk,nqd->nkd")
    dk = prod(ds, q2, "nqk,nqd->nkd") * LN2
    dq = prod(ds, k, "nqk,nkd->nqd") / math.sqrt(dh)
    return dq, dk, dv


# --- the backward kernels' plan ----------------------------------------------
BWD_ROWS = 64                    # stationary rows of a CTA (wgmma route)
BWD_TILES = {128: 64, 256: 32}   # dh -> rows of a streamed tile
BWD_STAGES = {3: 1, 1: 2}        # parts -> stages of each streamed operand
# the FMA route (dh 256, f32 class): 64-row Q tiles, 32-row KV tiles
# (csrc/flash_bwd_tile.cuh: BQ; csrc/flash_bwd.cu: FMA_BK)
FMA_Q, FMA_KV = 64, 32


class BwdTiles(NamedTuple):
    """one backward kernel's plan: a CTA holds `rows` stationary rows of
    one head (dK/dV: key rows; dQ: query rows) and streams the other side
    in tiles of `tile` rows, `stages` of each streamed operand in flight"""
    rows: int
    tile: int
    stages: int
    smem: int           # dynamic shared memory, bytes
    ctas: int


class BwdPlan(NamedTuple):
    """the two backward kernels' plan for one shape (csrc/flash_bwd.cu):
    on bf16 wgmma every operand in `parts` bf16 parts (3: the f32 class's
    split; 1: the hybrid casts); parts 0 is the FMA route (dh 256 in the
    f32 class: f32 operands)"""
    parts: int
    dkv: BwdTiles
    dq: BwdTiles


def _fma_smem(dh: int, bk: int, with_p: bool) -> int:
    """csrc/flash_bwd_tile.cuh: bwd_smem_floats, in bytes: K, V, Q and dO
    tiles with rows padded by 4 floats, the ds tile (and p's), the Q
    tile's lse and delta"""
    return 4 * ((2 * bk + 2 * FMA_Q) * (dh + 4)
                + (2 if with_p else 1) * FMA_Q * (bk + 4) + 2 * FMA_Q)


def bwd_plan(bh: int, s: int, dh: int, hybrid: bool) -> BwdPlan:
    """the plan t4_flash_bwd_dkv and t4_flash_bwd_dq launch (they refuse
    any other).  wgmma: both stationary operands' parts [rows, dh] stay
    for the CTA, both streamed operands' [tile, dh] come in `stages` each,
    1024 bytes of alignment slack, an 8-byte barrier for the stationary
    operands and for each stage of each streamed one; dK/dV also holds
    its streamed rows' lse and delta.  The route is picked by dh and the
    class alone: dh 256 in the f32 class takes the FMA kernels."""
    if dh == 256 and not hybrid:
        return BwdPlan(0,
                       BwdTiles(FMA_KV, FMA_Q, 1, _fma_smem(dh, FMA_KV, True),
                                bh * (s // FMA_KV)),
                       BwdTiles(FMA_Q, FMA_KV, 1,
                                _fma_smem(dh, FMA_KV, False),
                                bh * (s // FMA_Q)))
    parts = 1 if hybrid else 3
    tile, stages = BWD_TILES[dh], BWD_STAGES[parts]
    smem = (SM90_ALIGN + 2 * parts * BWD_ROWS * dh * 2
            + 2 * stages * parts * tile * dh * 2 + (1 + 2 * stages) * 8)
    dq = BwdTiles(BWD_ROWS, tile, stages, smem, bh * (s // BWD_ROWS))
    return BwdPlan(parts, dq._replace(smem=smem + 2 * stages * tile * 4), dq)


def _split_bwd(q, k, v, do, qscale: float):
    """the f32 class's backward operands: one launch writes [4 (q, k, v,
    do), 3 (hi, mid, lo), B*h, S, dh] bf16 from q*qscale, k, v and do
    (contiguous f32 on one CUDA device)"""
    b, s, dh = q.shape
    lib = _lib("flash_bwd")
    out = torch.empty((4, 3, b, s, dh), dtype=torch.bfloat16,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t4_split_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), out.data_ptr(), b * s, dh,
                               qscale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd split launch failed: cudaError {err}")
    flash_attention_bwd.split_launches += 1
    return tuple(out)


def _launch_bwd(which: str, ops, lse, delta, qscale, causal, plan: BwdPlan):
    """launch one backward kernel on prepared operands (q, k, v, do: bf16
    parts [3, B*h, S, dh] from _split_bwd when plan.parts is 3, bf16
    [B*h, S, dh] when 1, f32 [B*h, S, dh] when 0; q times qscale in the
    kernel): "dkv" -> (dk, dv), "dq" -> (dq,)"""
    b, s, dh = ops[0].shape[-3:]
    dtype = torch.float32 if plan.parts == 0 else torch.bfloat16
    if any(t.dtype != dtype or not t.is_contiguous()
           or t.shape[-3:] != ops[0].shape[-3:]
           or (t.dim() == 4) != (plan.parts == 3)
           or (t.dim() == 4 and t.shape[0] != 3) for t in ops):
        raise ValueError(f"flash_bwd_{which}: operands must be contiguous "
                         f"{dtype} [B*h, S, dh], [3, B*h, S, dh] parts in "
                         "the f32 class")
    tiles = plan.dkv if which == "dkv" else plan.dq
    lib = _lib("flash_bwd")
    outs = tuple(torch.empty((b, s, dh), dtype=torch.float32,
                             device=lse.device)
                 for _ in range(2 if which == "dkv" else 1))
    ptrs = [t.data_ptr() for t in (*ops, lse, delta) + outs]
    cfg = (b, s, dh, int(causal), plan.parts, tiles.rows, tiles.tile,
           tiles.stages, tiles.smem, qscale)
    with torch.cuda.device(lse.device):
        stream = torch.cuda.current_stream(lse.device).cuda_stream
        if which == "dkv":
            err = lib.t4_flash_bwd_dkv(*ptrs, *cfg, stream)
        else:
            err = lib.t4_flash_bwd_dq(*ptrs, *cfg, 1.0 / math.sqrt(dh),
                                      stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_{which} kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd.launches[which] += 1
    return outs


def _prepare_bwd(q, k, v, o, lse, do, causal, hybrid, dlse):
    """what both backward kernels take, from CUDA tensors: (ops, lse,
    delta, qscale, causal, plan), with the f32 class's split launched"""
    plan = bwd_plan(*q.shape, hybrid)
    *ops, delta, qscale = _bwd_operands(q, k, v, o, lse, do, hybrid, dlse)
    if plan.parts == 3:
        ops, qscale = _split_bwd(*ops, qscale), 1.0
    return ops, lse.contiguous(), delta.contiguous(), qscale, causal, plan


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        hybrid: bool = False, dlse=None, only=None):
    """(dq, dk, dv) [B*h, S, dh] f32 from q, k, v, the forward's o and
    lse [B*h, S] (nats), the output cotangent do and, optionally, the lse
    cotangent dlse [B*h, S], which folds into delta.  CUDA tensors launch
    the f32 class's split (once), then the dK/dV kernel and the dQ kernel;
    CPU tensors take the plain version; anything else raises.  only="dkv"
    or "dq" launches that one kernel alone after the split and returns its
    outputs (for timing each by itself)."""
    extra = (lse,) if dlse is None else (lse, dlse)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do) + extra):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, hybrid,
                                       dlse)
    _check_cuda("flash_attention_bwd", (q, k, v, o, do))
    _check_rows("flash_attention_bwd", q, extra)
    args = _prepare_bwd(q, k, v, o, lse, do, causal, hybrid, dlse)
    if only is not None:
        return _launch_bwd(only, *args)
    dk, dv = _launch_bwd("dkv", *args)
    dq, = _launch_bwd("dq", *args)
    return dq, dk, dv


# launches of each kernel since the last reset, and of the f32 class's split
flash_attention_bwd.launches = {"dkv": 0, "dq": 0}
flash_attention_bwd.split_launches = 0


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


# --- the fused kernel's grid ------------------------------------------------
N_SM = 132   # SMs of an H100 SXM: what a plan is made for off the card
# KV tile rows of the kernel by (hybrid, dh): the wgmma kernel's and the
# FMA kernel's (csrc/flash_bwd_fused.cu: kv_tile)
FUSED_KV_TILE = {(True, 128): 128, (True, 256): 64,
                 (False, 128): 64, (False, 256): 32}


class FusedPlan(NamedTuple):
    """the fused kernel's grid for one shape: a CTA per (head, item), an
    item = (Q block, KV chunk) of `chunk` KV tiles of `kv_tile` rows,
    listed heaviest first; `work` = the (Q tile, KV tile) pairs of each
    item; dq leaves as `n_slots` partials, one per KV chunk"""
    kv_tile: int
    chunk: int
    n_slots: int
    items: tuple
    work: tuple
    ctas: int


def _q_tiles_seeing(qi: int, j: int, bq: int, kv_tile: int, s: int,
                    causal: bool) -> int:
    """the 64-row Q tiles of Q block qi that see KV tile j: under the
    causal mask, tile q0 sees key kv0 when kv0 <= q0 + 63"""
    kv0 = j * kv_tile
    if kv0 >= s:
        return 0
    if not causal:
        return bq // TILE
    first = max(qi * bq, kv0 // TILE * TILE)
    return max(0, ((qi + 1) * bq - first) // TILE)


def _chunk_works(s: int, bq: int, causal: bool, kv_tile: int,
                 chunk: int) -> dict:
    """{(Q block, KV chunk): the (Q tile, KV tile) pairs it computes} for
    chunks of `chunk` KV tiles"""
    n_kv = -(-s // kv_tile)
    return {(qi, c): sum(_q_tiles_seeing(qi, j, bq, kv_tile, s, causal)
                         for j in range(c * chunk, min((c + 1) * chunk, n_kv)))
            for qi in range(s // bq) for c in range(-(-n_kv // chunk))}


@functools.lru_cache(maxsize=256)
def fused_plan(bh: int, s: int, bq: int, causal: bool, hybrid: bool,
               dh: int, sms: int = N_SM) -> FusedPlan:
    """the fused kernel's grid.  The chunk is the largest power of two of
    KV tiles that still gives every SM a CTA with work (one tile if none
    does): a longer chunk means fewer dq partials to write and sum, a
    shorter one more CTAs to even out the causal load (PERF.md, section
    6).  Items with no work (KV chunks that a causal Q block never sees)
    stay in the grid: their CTAs write the zeros of those rows.  Plans are
    kept: a shape's plan is made once."""
    kv_tile = FUSED_KV_TILE[(bool(hybrid), dh)]
    n_kv = -(-s // kv_tile)
    chunk = 1
    while chunk * 2 <= n_kv:
        w = _chunk_works(s, bq, causal, kv_tile, chunk * 2)
        if bh * sum(1 for x in w.values() if x) < sms:
            break
        chunk *= 2
    w = _chunk_works(s, bq, causal, kv_tile, chunk)
    items = sorted(w, key=lambda it: (-w[it], -it[0], it[1]))
    return FusedPlan(kv_tile, chunk, -(-n_kv // chunk), tuple(items),
                     tuple(w[it] for it in items), len(items) * bh)


@functools.lru_cache(maxsize=256)
def _items_on(items: tuple, device: str):
    """a plan's items as the kernel reads them, int32 [n_items, 2] on
    `device`, made once"""
    return torch.tensor(items, dtype=torch.int32, device=device)


def sm_count(device) -> int:
    """SMs of the CUDA device `device`; N_SM for any other"""
    device = torch.device(device)
    if device.type != "cuda":
        return N_SM
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_bwd_fused_slots_ref(q, k, v, o, lse, do, bq=None,
                                        causal: bool = False,
                                        hybrid: bool = False, dlse=None,
                                        sms: int = N_SM):
    """plain PyTorch model of the fused kernel's decomposition: (dq_slots
    [n_slots, B, S, dh], dk_parts, dv_parts [B, n_q, S, dh]).  Item by item
    of fused_plan, as the CTAs compute them: each (Q block, KV chunk) item
    gives its chunk's rows of the block's partials and its block's rows of
    the chunk's dq slot; rows that no item computes are zeros.  dq is
    dq_slots summed over the slots, in order."""
    b, s, dh = q.shape
    bq = _fused_bq("flash_attention_bwd_fused_slots_ref", s, bq)
    plan = fused_plan(b, s, bq, causal, hybrid, dh, sms)
    q2, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                hybrid, dlse)
    q2 = q2.float() * qscale
    k, v, do = k.float(), v.float(), do.float()
    lse2 = lse * LOG2E

    def rnd(x):
        return x.to(torch.bfloat16).float() if hybrid else x

    n_q, rows = s // bq, plan.chunk * plan.kv_tile
    slots = torch.zeros((plan.n_slots, b, s, dh), dtype=torch.float32,
                        device=q.device)
    dkp = torch.zeros((b, n_q, s, dh), dtype=torch.float32, device=q.device)
    dvp = torch.zeros_like(dkp)
    for (qi, c), work in zip(plan.items, plan.work):
        if not work:
            continue
        qr = slice(qi * bq, (qi + 1) * bq)
        kr = slice(c * rows, min((c + 1) * rows, s))
        s2 = torch.einsum("nqd,nkd->nqk", q2[:, qr], k[:, kr])
        if causal:
            keep = (torch.arange(kr.start, kr.stop, device=q.device)[None, :]
                    <= torch.arange(qr.start, qr.stop,
                                    device=q.device)[:, None])
            s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
        p = torch.exp2(s2 - lse2[:, qr, None])
        dp = torch.einsum("nqd,nkd->nqk", do[:, qr], v[:, kr])
        ds = rnd(p * (dp - delta[:, qr, None]))
        slots[c, :, qr] = torch.einsum("nqk,nkd->nqd", ds,
                                       k[:, kr]) / math.sqrt(dh)
        dvp[:, qi, kr] = torch.einsum("nqk,nqd->nkd", rnd(p), do[:, qr])
        dkp[:, qi, kr] = torch.einsum("nqk,nqd->nkd", ds, q2[:, qr]) * LN2
    return slots, dkp, dvp


def flash_attention_bwd_fused_ref(q, k, v, o, lse, do, bq=None,
                                  causal: bool = False, hybrid: bool = False,
                                  dlse=None):
    """plain PyTorch version of flash_attention_bwd_fused: (dq, dk, dv)"""
    dq, dkp, dvp = flash_attention_bwd_fused_parts_ref(
        q, k, v, o, lse, do, bq, causal, hybrid, dlse)
    return dq, dkp.sum(dim=1), dvp.sum(dim=1)


def _launch_fused(q2, k, v, do, lse, delta, bq: int, causal: bool,
                  hybrid: bool, qscale: float):
    """launch the fused kernel on _bwd_operands' prepared operands (lse
    and delta contiguous): (dq partials [n_slots, B*h, S, dh], dk_parts,
    dv_parts [B*h, S / bq, S, dh]), f32"""
    b, s, dh = q2.shape
    plan = fused_plan(b, s, bq, causal, hybrid, dh, sm_count(q2.device))
    items = _items_on(plan.items, str(q2.device))
    lib = _lib("flash_bwd_fused")
    slots = torch.empty((plan.n_slots, b, s, dh), dtype=torch.float32,
                        device=q2.device)
    dkp = torch.empty((b, s // bq, s, dh), dtype=torch.float32,
                      device=q2.device)
    dvp = torch.empty_like(dkp)
    ptrs = [t.data_ptr() for t in (q2, k, v, do, lse, delta, slots, dkp,
                                   dvp, items)]
    with torch.cuda.device(q2.device):
        stream = torch.cuda.current_stream(q2.device).cuda_stream
        err = lib.t4_flash_bwd_fused(*ptrs, len(plan.items), b, s, dh, bq,
                                     plan.kv_tile, plan.chunk, int(causal),
                                     int(hybrid), qscale,
                                     1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_fused kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_bwd_fused.launches += 1
    return slots, dkp, dvp


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
    q2, kk, vv, dd, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                  hybrid, dlse)
    slots, dkp, dvp = _launch_fused(q2, kk, vv, dd, lse.contiguous(),
                                    delta.contiguous(), bq, causal, hybrid,
                                    qscale)
    # the dq partials, summed in one fixed order
    dq = slots[0] if len(slots) == 1 else slots.sum(dim=0)
    return dq, dkp, dvp


def flash_attention_bwd_fused(q, k, v, o, lse, do, bq=None,
                              causal: bool = False, hybrid: bool = False,
                              dlse=None):
    """flash_attention_bwd's inputs and (dq, dk, dv), through the
    single-kernel backward: one launch, then one sum over the n_q = S / bq
    partials of dK and of dV.  bq, the rows of a Q block, defaults to the
    JAX package's _fit_block(S, 1024); it fixes n_q and with it the
    partial traffic.  The kernel's KV tile is its own and is no
    parameter; fused_plan sizes the grid to the card."""
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
