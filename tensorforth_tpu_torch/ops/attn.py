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
in the hybrid class as one product of the wrapper's casts.  At dh 384 to
1024 the f32 class runs on a cluster of dh / 128 CTAs (3 to 8) that
splits dh: each holds the dh-128 tiles over its 128 columns, and the CTAs
add their partial scores through distributed shared memory, each quad's
owner in the order of a fixed tree of pairs (``cluster_sum``; the
exchange's model is ``xrs_*``), so that each runs the same softmax on the
same bits.  The hybrid class there takes the wide route: the
warpgroups of one CTA split dh (128 columns each, ``wide_blocks``; a pair
of CTAs past dh 512), their partial scores added in the CTA's shared
memory in ``cluster_sum``'s order, so its scores are the cluster route's
bits.  Its tile plan is ``fwd_plan``.  lse is stored [B*h, S]; the Pallas
kernel's 128-lane copy was a TPU layout artefact.

The two backward kernels, ``csrc/flash_bwd.cu``, replace
attn_pallas.py:_flash_bwd_dkv_kernel and :_flash_bwd_dq_kernel (launched
by that module's ``flash_attention_bwd``): dK/dV with the KV rows
stationary and dQ with the Q rows stationary, each recomputing its
probability tile from the saved log-sum-exp.  They too are bound by
operations (4 and 3 products per visited tile pair), and run on bf16
``wgmma`` fed by TMA: in the f32 class as six products of a three-part
split (q*scale*log2e, k, v and do split by one launch of the same source,
``_split_bwd``; p and ds in registers), in the hybrid class as one
product of the wrapper's casts.  At dh 256 in the f32 class three parts
of their tiles do not fit a CTA: there a cluster of two CTAs splits dh,
each holding the dh-128 tiles over its half of the columns, and the two
add their partial s2 and dp through distributed shared memory; at dh 384
to 1024, in both classes, clusters of dh / 128 CTAs (3 to 8) do the same,
their partials added in ``cluster_sum``'s order.  Their plan is
``bwd_plan``.  ``flash_attention_lse`` pairs forward and
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
bf16 ``wgmma``; the f32 class too, as six products of the backward's
three-part split (``_split_bwd``, counted as the fused path's own).  The
f32 class at dh 256 to 1024 and the hybrid class at dh 384 to 1024 run on
clusters of dh / 128 CTAs that split dh, as the two-kernel backward's
routes there do, their partial scores added in ``cluster_sum``'s order.
It is a measurement path
(``attn_bench``): ``flash_attention_lse`` keeps the two-kernel backward,
as in the JAX package.

The dots-only probe, ``csrc/attn_dots.cu``, replaces the Pallas kernel
inside bench.py:_attn_dots_probe: the forward kernel's own body at the
hybrid plan (``csrc/flash_fwd.cuh``) with the softmax compiled out, on
bf16 operands; at dh 384 to 1024 on the hybrid forward's wide route.

Every wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors; anything else raises.  There is no
fallback on the card.  Every kernel takes dh 128 to 1024 (KERNEL_DH); dh
1152 and wider are refused (a deliberate deviation: a cluster of 9 or more
CTAs is past the 8 of a portable cluster).
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
# head dims the kernels are built for: a cluster holds at most 8 CTAs of
# 128 columns
KERNEL_DH = tuple(range(128, 1025, 128))
TILE = 64                  # S must be a multiple of the kernel's tile
N_SM = 132   # SMs of an H100 SXM: what a plan is made for off the card


def flash_attention_ref(q, k, v, causal: bool = False, hybrid: bool = False,
                        cluster: int = 1):
    """plain PyTorch version: (o [B,S,dh], lse [B,S] in nats).

    f32: the exact einsum attention (nn/funcs.py _sdpa_ref) plus its
    log-sum-exp.  hybrid: the kernel's bf16 treatment — q*scale*log2(e),
    k and v rounded to bf16, base-2 softmax in f32, P rounded to bf16
    before the PV product, f32 sums; with `cluster` 3 to 8 the scores as
    the dh-384 to dh-1024 routes form them (the cluster route's CTAs, the
    wide route's warpgroups), an f32 sum per 128 columns, added in
    cluster_sum's order.  o is one f32 sum over all the keys after the
    row max (the kernels rescale o by the running max a tile at a time,
    and the wide route accumulates it on the tensor cores)."""
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
    s2 = _cluster_scores(_einsum, q2, k.to(bf).float(), cluster)
    if causal:
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nqk,nkd->nqd", p.to(bf).float(), v.to(bf).float()) / l
    return o, ((m + torch.log2(l)) * LN2)[..., 0]


def _einsum(x, y, eq):
    return torch.einsum(eq, x, y)


def cluster_sum(parts, rank: int = 0):
    """the sum of a cluster's partials (one tensor per CTA, in rank order)
    in the order every cluster route keeps (csrc/sm90_gemm.cuh: Xch's
    pair, Xrs's owners): a tree of pairs, as CTA `rank` would form it.
    Round k (h = 2^(k-1)) adds to the sum over the CTA's block of h ranks
    the sum over the block beside it (ranks (rank ^ h) & ~(h - 1) on, those
    below the cluster's size), as that block formed it; a block with no
    CTA adds nothing.  An f32 sum of two terms is the same in either order,
    so every rank gets x0 + x1, (x0 + x1) + x2, (x0 + x1) + (x2 + x3),
    ((x0 + x1) + (x2 + x3)) + x4, ..., ((x0 + x1) + (x2 + x3)) + ((x4 +
    x5) + (x6 + x7)), the same bits."""
    cl = len(parts)

    def block(b, h):
        """the sum over ranks b .. b + h - 1 (those below cl), as formed"""
        if h == 1:
            return parts[b]
        lo = block(b, h // 2)
        return lo + block(b + h // 2, h // 2) if b + h // 2 < cl else lo

    mine, h = parts[rank], 1
    while h < cl:
        b = (rank ^ h) & ~(h - 1)
        if b < cl:
            mine = mine + block(b, h)
        h *= 2
    return mine


def _cluster_scores(prod, x, y, cluster: int):
    """x y^T as a cluster of `cluster` CTAs that split dh forms it: each
    CTA's sum over its columns (prod, exact) rounded to f32, the partials
    added in cluster_sum's order"""
    w = x.shape[-1] // cluster
    return cluster_sum([prod(x[..., c * w:(c + 1) * w],
                             y[..., c * w:(c + 1) * w],
                             "nqd,nkd->nqk").float() for c in range(cluster)])


def flash_attention_split_ref(q, k, v, causal: bool = False,
                              parts: int = 3, cluster: int = 1):
    """the f32 class's arithmetic with its products taken exactly, in f64:
    q*scale*log2e (an f32 product), k and v split into the first `parts`
    of the three-part split (gemm._split3_ref), s2 = the products of
    parts (i, j) with i + j < parts (six for 3 parts: the kernel's; three
    for 2: K5a 3pass's count) summed in f64 (with `cluster` 3 to 8, as the
    dh-384 to dh-1024 kernels form it: each CTA's sum over its 128 columns
    rounded to f32, the partials added in f32 in cluster_sum's order), p =
    exp2(s2 - the row max) rounded to f32 and split the same way, o = the
    products of p's and v's parts over the row sum.  What it leaves out of
    the kernel: the tensor cores' truncating sums, ex2.approx, the running
    max.  Returns (o, lse in nats), f64."""
    s, dh = q.shape[1], q.shape[2]
    pairs = [(i, j) for i in range(parts) for j in range(parts)
             if i + j < parts]

    def prod(x, y, eq):
        xs = [t.double() for t in _split3_ref(x)[:parts]]
        ys = [t.double() for t in _split3_ref(y)[:parts]]
        return sum(torch.einsum(eq, xs[i], ys[j]) for i, j in pairs)

    q2 = q * (LOG2E / math.sqrt(dh))
    s2 = (prod(q2, k, "nqd,nkd->nqk") if cluster == 1
          else _cluster_scores(prod, q2, k, cluster).double())
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m).float()
    l = p.double().sum(dim=-1, keepdim=True)
    o = prod(p, v, "nqk,nkd->nqd") / l
    return o, ((m + torch.log2(l)) * LN2)[..., 0]


# --- the clusters' balanced exchange (csrc/sm90_gemm.cuh: Xrs) -------------
# K1 (the f32 class), K2a, K2b and K3 at 3 to 8 CTAs add a tile's partial
# scores in two rounds, a reduce-scatter and an all-gather.  A thread's 32
# floats are 8 quads (s2's 4, then dp's 4; K1's s2's 8); quad q belongs
# to CTA q mod cluster where the
# cluster divides 8, else quad q of the threads of warp w of a warpgroup
# to CTA (q + w) mod cluster.  Round 1 sends each quad to its
# owner's pool: the slot read as warp-planes (a quad for each of a warp's
# 32 lanes, 512 bytes; 64 of them in 32 KB), warp w's block holding its
# owned quads' partials by source rank, warpgroup 1's blocks after
# warpgroup 0's.  Round 2 sends each owner's sums to every peer at the
# quad's own place (plane q of the thread: 256 threads' quads, 4 KB).
XRS_QUADS, XRS_WARPS, XRS_POOL = 8, 4, 64


def xrs_owner(cluster: int, w: int, q: int) -> int:
    """the CTA that owns quad q of the threads of warp w of a warpgroup:
    q mod cluster where the cluster divides the 8 quads, else staggered
    by warp"""
    return (q + (0 if XRS_QUADS % cluster == 0 else w)) % cluster


def xrs_owns(cluster: int, j: int, w: int, q: int = XRS_QUADS) -> int:
    """the quads before q (all 8 by default) of warp w's threads that
    CTA j owns"""
    return sum(xrs_owner(cluster, w, p) == j for p in range(q))


def xrs_span(cluster: int, j: int) -> int:
    """the warp-planes of a warpgroup's blocks in CTA j's pool"""
    return sum((cluster - 1) * xrs_owns(cluster, j, w)
               for w in range(XRS_WARPS))


def xrs_wplane(cluster: int, j: int, g: int, w: int, q: int,
               s: int) -> int:
    """the warp-plane of CTA j's pool that takes source s's partial of
    quad q (which j owns) of warp w of warpgroup g"""
    first = sum((cluster - 1) * xrs_owns(cluster, j, v) for v in range(w))
    return (g * xrs_span(cluster, j) + first
            + xrs_owns(cluster, j, w, q) * (cluster - 1)
            + (s if s < j else s - 1))


def xrs_messages(cluster: int, rank: int, g: int, w: int, rnd: int) -> list:
    """the 16-byte stores of a thread of warp w of warpgroup g of CTA
    `rank` in round `rnd`, as (target, quad, place): round 1 each quad it
    does not own to its owner's pool (place: the warp-plane), round 2
    each quad it owns to every peer (place: the quad's plane)"""
    out = []
    for q in range(XRS_QUADS):
        j = xrs_owner(cluster, w, q)
        if rnd == 1 and j != rank:
            out.append((j, q, xrs_wplane(cluster, j, g, w, q, rank)))
        elif rnd == 2 and j == rank:
            out += [(r, q, q) for r in range(cluster) if r != rank]
    return out


def xrs_sum(parts):
    """an owner's sum of a quad's partials (one a rank, rank order):
    cluster_sum's tree, ((x0 + x1) + (x2 + x3)) + ((x4 + x5) + (x6 + x7)),
    a block with no rank dropped: cluster_sum's bits"""
    cl = len(parts)

    def block(b, h):
        if h == 1:
            return parts[b]
        lo = block(b, h // 2)
        return lo + block(b + h // 2, h // 2) if b + h // 2 < cl else lo

    return block(0, 8)


def xrs_slots(hybrid: bool) -> int:
    """a CTA's exchange slots: two in the hybrid class (one a round: no
    sender waits), one in the f32 class (no room for a second)"""
    return 2 if hybrid else 1


def xrs_barriers(slots: int) -> int:
    """Xrs's barriers: a round's receipt each, and with one slot a round's
    reads each"""
    return 4 if slots == 1 else 2


def exchange_barriers(cluster: int, slots: int = 1) -> int:
    """a route's exchange barriers: none on one CTA, Xch's `full` and
    `empty` on a pair (dh 256), Xrs's (xrs_barriers) on 3 to 8 CTAs"""
    return 0 if cluster == 1 else 2 if cluster == 2 else xrs_barriers(slots)



# a CTA's columns of dh -> (query rows, KV rows)
FWD_TILES = {128: (128, 64), 256: (64, 32)}
FWD_STAGES = {3: 1, 1: 2}        # parts -> stages of K and of V each
# a cluster's exchange slot (csrc/flash_fwd.cuh: Fwd::XCH): each of a CTA's
# 256 threads' partial s2, 32 f32
FWD_EXCHANGE = 256 * 32 * 4
# the hybrid class's wide route at dh 384 to 1024 (csrc/flash_fwd.cuh:
# Wide): (query rows, KV rows) of a CTA, and a warpgroup's slot of partial
# s2 (128 threads' 16 f32), which is also the size of a pair's message
WIDE_TILES = (64, 32)
WIDE_SLOT = 128 * 16 * 4


def fwd_cluster(dh: int) -> int:
    """the CTAs of a cluster of the f32 class's forward route (and the
    backward's), from dh alone: dh / 128 at dh 384 to 1024 (one CTA holds
    neither the tiles nor, in a warpgroup's registers, 256 columns of o),
    else 1.  It is also the number of 128-column partial scores that every
    route at dh 384 to 1024 adds in cluster_sum's order"""
    return dh // 128 if dh > 256 else 1


def fwd_wide(dh: int, hybrid: bool) -> bool:
    """the forward takes the wide route: the bf16 class at dh 384 to 1024
    (K1 hybrid and K8), dh split between the warpgroups of one CTA"""
    return hybrid and dh > 256


def wide_blocks(dh: int):
    """the wide route's column layout at dh 384 to 1024: for each CTA (one
    to dh 512, a pair past it) the 128-column blocks of dh that its
    warpgroups hold, warpgroup w the w-th; rank 0 of a pair the first
    four, rank 1 the rest"""
    n = dh // 128
    return ((tuple(range(min(n, 4))),)
            + ((tuple(range(4, n)),) if n > 4 else ()))


class FwdPlan(NamedTuple):
    """the forward kernel's plan for one shape (csrc/flash_fwd.cuh: Fwd,
    Wide): a CTA of `warpgroups` warpgroups per (head, `bq` query rows,
    dh / `cluster` columns); K and V in tiles of `bkv` rows, `stages` of K
    and `v_stages` of V in flight; every operand in `parts` bf16 parts (3:
    the f32 class's split; 1: the hybrid casts); `cluster` CTAs (1, 2 on
    the wide route past dh 512, or 3 to 8 in the f32 class) share the rows
    and split dh; the scores are the sum of `blocks` partials over 128
    columns each (one at dh 128 and 256), added in cluster_sum's order"""
    parts: int
    bq: int
    bkv: int
    stages: int
    smem: int           # dynamic shared memory of a CTA, bytes
    ctas: int
    cluster: int
    warpgroups: int
    v_stages: int
    blocks: int


def fwd_plan(bh: int, s: int, dh: int, hybrid: bool) -> FwdPlan:
    """the plan t4_flash_fwd launches (it refuses any other): Q's parts
    [bq, dh / cluster] stay for the CTA, K's and V's [bkv, dh / cluster]
    stream in `stages` each, 1024 bytes of alignment slack, an 8-byte
    barrier for Q and for each stage of K and of V; on a cluster route the
    exchange slot and Xrs's four barriers (one slot).  The
    wide route (fwd_wide): Q [64, 128 w] for w warpgroups (dh / 128 to
    512, four a CTA of the pair past it), two stages of K [32, 128 w] and
    two of V (one in a pair), a slot of partial s2 a warpgroup, and in a
    pair the peer's message and two barriers (full, free)"""
    parts = 1 if hybrid else 3
    blocks = fwd_cluster(dh)
    if fwd_wide(dh, hybrid):
        cluster = 2 if blocks > 4 else 1
        wgs = min(blocks, 4)
        cols = 128 * wgs
        bq, bkv = WIDE_TILES
        stages, v_stages = 2, 1 if cluster == 2 else 2
        xch = WIDE_SLOT if cluster == 2 else 0
        smem = (SM90_ALIGN + bq * cols * 2 + (stages + v_stages) * bkv * cols
                * 2 + wgs * WIDE_SLOT + xch
                + (1 + stages + v_stages + (2 if cluster == 2 else 0)) * 8)
        return FwdPlan(parts, bq, bkv, stages, smem, cluster * bh * (s // bq),
                       cluster, wgs, v_stages, blocks)
    cluster = blocks
    cols = dh // cluster
    bq, bkv = FWD_TILES[cols]
    stages = FWD_STAGES[parts]
    smem = (SM90_ALIGN + parts * bq * cols * 2
            + 2 * stages * parts * bkv * cols * 2
            + (FWD_EXCHANGE if cluster > 1 else 0)
            + (1 + 2 * stages + exchange_barriers(cluster)) * 8)
    return FwdPlan(parts, bq, bkv, stages, smem,
                   cluster * bh * -(-s // bq), cluster, 2, stages, blocks)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {   # library -> exported function -> ctypes signature
    "flash_fwd": {"t4_flash_fwd": [_P] * 5 + [_I] * 10 + [_F, _P],
                  "t4_split_qkv": [_P] * 4 + [_I] * 2 + [_F, _P],
                  "t4_flash_fwd_clusters": [_I] * 2 + [_P]},
    "flash_bwd": {"t4_flash_bwd_dkv": [_P] * 8 + [_I] * 10 + [_P],
                  "t4_flash_bwd_dq": [_P] * 7 + [_I] * 10 + [_F, _P],
                  "t4_split_bwd": [_P] * 5 + [_I] * 2 + [_F, _P],
                  "t4_flash_bwd_clusters": [_I] * 3 + [_P]},
    "flash_bwd_fused": {"t4_flash_bwd_fused": [_P] * 10 + [_I] * 11
                        + [_F, _P],
                        "t4_flash_bwd_fused_clusters": [_I] * 2 + [_P]},
    "attn_dots": {"t4_attn_dots": [_P] * 4 + [_I] * 3 + [_P],
                  "t4_attn_dots_clusters": [_I, _P]},
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


def _check_shape(what: str, tensors, dims=KERNEL_DH):
    """the kernels' shapes: equal [B*h, S, dh], dh in `dims`, S % TILE ==
    0; a dh % 128 == 0 past 1024 names the deviation"""
    shape = tensors[0].shape
    if len(shape) != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         f", want equal [B*h, S, dh]")
    _, s, dh = shape
    if dh not in dims or s % TILE:
        wide = (" (dh 1152 and wider would need a cluster of 9 or more "
                "CTAs, past the 8 of a portable cluster: a deliberate "
                "deviation from the JAX package)"
                if dh % 128 == 0 and dh > max(dims) else "")
        raise ValueError(f"{what}: kernel takes dh in {dims} "
                         f"and S % {TILE} == 0, got S={s} dh={dh}{wide}")


def _check_cuda(what: str, tensors, dtype=torch.float32, dims=KERNEL_DH):
    """the kernels' contract: _check_shape, contiguous `dtype`, on one
    CUDA device"""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or not tensors[0].is_cuda:
        raise ValueError(f"{what}: tensors on {sorted(map(str, devs))}")
    _check_shape(what, tensors, dims)
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
                               plan.stages, plan.smem, plan.cluster, qscale,
                               stream)
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
                            hybrid: bool = False, dlse=None,
                            cluster: int = 1):
    """plain PyTorch version of the two backward kernels: (dq, dk, dv)
    from the forward's residuals, with the S x S tiles materialised.  The
    same arithmetic as the kernels: base-2 scores from q*scale*log2e,
    p = exp2(s2 - lse*log2e), ds = p*(dp - delta); hybrid rounds the same
    multiplicands to bf16 (p and ds before their products, ds formed from
    the unrounded p) and sums in f32.  `cluster` > 1: s2 and dp as a
    cluster route forms them, an f32 sum per CTA's columns, added in
    cluster_sum's order."""
    s, dh = q.shape[1], q.shape[2]
    q2, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do,
                                                hybrid, dlse)
    q2 = q2.float() * qscale
    k, v, do = k.float(), v.float(), do.float()

    def rnd(x):
        return x.to(torch.bfloat16).float() if hybrid else x

    s2 = _cluster_scores(_einsum, q2, k, cluster)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    dv = torch.einsum("nqk,nqd->nkd", rnd(p), do)
    dp = _cluster_scores(_einsum, do, v, cluster)
    ds = rnd(p * (dp - delta[..., None]))
    dk = torch.einsum("nqk,nqd->nkd", ds, q2) * LN2
    dq = torch.einsum("nqk,nkd->nqd", ds, k) / math.sqrt(dh)
    return dq, dk, dv


def flash_attention_bwd_split_ref(q, k, v, o, lse, do, causal: bool = False,
                                  parts: int = 3, dlse=None,
                                  cluster: int = 1):
    """the f32 class's backward arithmetic with its products taken exactly,
    in f64: delta and q*scale*log2e as _bwd_operands forms them (f32),
    q2, k, v and do split into the first `parts` of the three-part split
    (gemm._split3_ref), each product the sum of the products of parts
    (i, j) with i + j < parts (six for 3 parts: the kernels'; three for 2)
    in f64; s2 and dp rounded to f32 as the accumulators hold them (with
    `cluster` 2 to 8, as the dh-256 to dh-1024 kernels form
    them: each CTA's sum over its 128 columns rounded to f32, the partials
    added in f32 in cluster_sum's order, which Xrs's owners keep at 3 to
    8 CTAs: xrs_sum), p = exp2(s2 -
    lse*log2e) and ds = p (dp - delta) in f32 and split the same way.  What
    it leaves out of the kernels: the tensor cores' truncating sums and
    ex2.approx.  Returns (dq, dk, dv), f64."""
    s, dh = q.shape[1], q.shape[2]
    q, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do, False,
                                               dlse)
    pairs = [(i, j) for i in range(parts) for j in range(parts)
             if i + j < parts]

    def prod(x, y, eq):
        xs = [t.double() for t in _split3_ref(x)[:parts]]
        ys = [t.double() for t in _split3_ref(y)[:parts]]
        return sum(torch.einsum(eq, xs[i], ys[j]) for i, j in pairs)

    def scores(x, y):
        return _cluster_scores(prod, x, y, cluster)

    q2 = q * qscale
    s2 = scores(q2, k)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    ds = p * (scores(do, v) - delta[..., None])
    dv = prod(p, do, "nqk,nqd->nkd")
    dk = prod(ds, q2, "nqk,nqd->nkd") * LN2
    dq = prod(ds, k, "nqk,nkd->nqd") / math.sqrt(dh)
    return dq, dk, dv


def flash_attention_bwd_fused_split_ref(q, k, v, o, lse, do, bq=None,
                                        causal: bool = False, dlse=None,
                                        sms: int = N_SM):
    """a model of the fused kernel's f32 class (six products of the
    three-part split): (dq [B, S, dh], dk_parts, dv_parts [B, n_q, S, dh]),
    f32.  s2, p, dp and ds as flash_attention_bwd_split_ref forms them (the
    products of parts exact in f64, rounded to f32; at dh 256 to 1024 with
    the plan's `cluster` of dh / 128, each CTA's 128 columns rounded to f32
    and the partials added in f32 in cluster_sum's order; p and ds split in
    turn); then the gradients as the kernel sums
    them, each column on its own: each warpgroup's 32 queries of a (Q tile,
    KV tile) pair give one exact product for the tile's 64 keys (dv = p^T
    do, dk = ds^T q2), rounded to f32 and added in f32 one Q tile after
    another, the two warpgroups' sums added at the KV tile's end, dk times
    ln2; dq one exact product per pair over the tile's 64 keys, rounded to
    f32 and added in f32 one KV tile after another within a chunk of
    fused_plan, times 1/sqrt(dh), the chunks' slots added in f32 in order.
    What it leaves out: the tensor cores' truncating sums and ex2.approx."""
    what = "flash_attention_bwd_fused_split_ref"
    _check_shape(what, (q, k, v, o, do))
    b, s, dh = q.shape
    bq = _fused_bq(what, s, bq)
    plan = fused_plan(b, s, bq, causal, False, dh, sms)
    q, k, v, do, delta, qscale = _bwd_operands(q, k, v, o, lse, do, False,
                                               dlse)
    bkv, n_q, n_kv = plan.kv_tile, s // bq, s // plan.kv_tile
    pairs = [(i, j) for i in range(3) for j in range(3) if i + j < 3]

    def split(x):
        return [t.double() for t in _split3_ref(x)]

    def prod(xs, ys, eq):
        return sum(torch.einsum(eq, xs[i], ys[j]) for i, j in pairs).float()

    def scores(xs, ys):
        """x y^T, one f32 sum per CTA's columns, added in cluster_sum's
        order"""
        w = dh // plan.cluster
        return cluster_sum([prod([x[..., c * w:(c + 1) * w] for x in xs],
                                 [y[..., c * w:(c + 1) * w] for y in ys],
                                 "nqd,nkd->nqk")
                            for c in range(plan.cluster)])

    q2 = q * qscale
    qs, ks, vs, dos = split(q2), split(k), split(v), split(do)
    s2 = scores(qs, ks)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
    p = torch.exp2(s2 - (lse * LOG2E)[..., None])
    ds = p * (scores(dos, vs) - delta[..., None])

    # [B, Q block, Q tile, warpgroup, 32 queries, KV tile, 64 keys]
    grid = (b, n_q, bq // TILE, 2, TILE // 2, n_kv, bkv)

    def partials(a, x):
        """the warpgroups' f32 sums of a^T x over a Q block's tiles"""
        prods = prod([t.view(grid) for t in split(a)],
                     [t.view(grid[:5] + (dh,)) for t in split(x)],
                     "nbtwqjk,nbtwqd->nbtwjkd")
        acc = torch.zeros_like(prods[:, :, 0])
        for t in range(grid[2]):
            acc += prods[:, :, t]
        return (acc[:, :, 0] + acc[:, :, 1]).reshape(b, n_q, s, dh)

    dvp = partials(p, do)
    dkp = partials(ds, q2) * LN2
    fresh = prod([t.view(b, s, n_kv, bkv) for t in split(ds)],
                 [t.view(b, n_kv, bkv, dh) for t in split(k)],
                 "nqjk,njkd->nqjd")
    dq = torch.zeros((b, s, dh), dtype=torch.float32, device=q.device)
    for c in range(plan.n_slots):
        slot = torch.zeros_like(dq)
        for j in range(c * plan.chunk, min((c + 1) * plan.chunk, n_kv)):
            slot += fresh[:, :, j]
        dq += slot * (1.0 / math.sqrt(dh))
    return dq, dkp, dvp


# --- the backward kernels' plan ----------------------------------------------
BWD_ROWS = 64                    # stationary rows of a CTA
BWD_TILES = {128: 64, 256: 32}   # a CTA's columns of dh -> streamed rows
BWD_STAGES = {3: 1, 1: 2}        # parts -> stages of each streamed operand
# a cluster's exchange slots (csrc/flash_bwd.cu: Bwd::XCH): each of a
# CTA's 256 threads' partial s2 and dp, 32 f32
BWD_EXCHANGE = 256 * 32 * 4


def bwd_cluster(dh: int, hybrid: bool) -> int:
    """the CTAs of a cluster of the backward kernels' route, from dh and
    the class alone: 2 at dh 256 in the f32 class (its three parts do not
    fit one CTA), dh / 128 at dh 384 to 1024 in both classes (as the
    forward's), else 1"""
    return 2 if dh == 256 and not hybrid else fwd_cluster(dh)


class BwdTiles(NamedTuple):
    """one backward kernel's plan: a CTA holds `rows` stationary rows of
    one head (dK/dV: key rows; dQ: query rows) over dh / `cluster` of its
    columns and streams the other side in tiles of `tile` rows, `stages`
    of each streamed operand in flight; `cluster` CTAs (1 to 8) share the
    rows and split dh"""
    rows: int
    tile: int
    stages: int
    smem: int           # dynamic shared memory of a CTA, bytes
    ctas: int
    cluster: int


class BwdPlan(NamedTuple):
    """the two backward kernels' plan for one shape (csrc/flash_bwd.cu):
    on bf16 wgmma every operand in `parts` bf16 parts (3: the f32 class's
    split; 1: the hybrid casts)"""
    parts: int
    dkv: BwdTiles
    dq: BwdTiles


def bwd_plan(bh: int, s: int, dh: int, hybrid: bool) -> BwdPlan:
    """the plan t4_flash_bwd_dkv and t4_flash_bwd_dq launch (they refuse
    any other).  A CTA holds both stationary operands' parts [rows, dh /
    cluster] for its life and takes both streamed operands' [tile, dh /
    cluster] in `stages` each, with 1024 bytes of alignment slack, an
    8-byte barrier for the stationary operands and for each stage of each
    streamed one; dK/dV also holds its streamed rows' lse and delta.  The
    route is picked by dh and the class alone (bwd_cluster): on a cluster
    route the CTAs split dh, each with the dh-128 tiles of the class, an
    exchange slot that receives a peer's partial scores and the slot's
    barriers: a pair (dh 256) sums in Xch's one message (`full` and
    `empty`); 3 to 8 CTAs sum in Xrs's two balanced rounds, with one
    slot and four barriers in the f32 class, two slots and two barriers in
    the hybrid class."""
    parts = 1 if hybrid else 3
    cluster = bwd_cluster(dh, hybrid)
    cols = dh // cluster
    tile, stages = BWD_TILES[cols], BWD_STAGES[parts]
    slots = xrs_slots(hybrid) if cluster > 2 else 1
    xbar = exchange_barriers(cluster, slots)
    smem = (SM90_ALIGN + 2 * parts * BWD_ROWS * cols * 2
            + 2 * stages * parts * tile * cols * 2
            + (slots * BWD_EXCHANGE if cluster > 1 else 0)
            + (1 + 2 * stages + xbar) * 8)
    dq = BwdTiles(BWD_ROWS, tile, stages, smem,
                  cluster * bh * (s // BWD_ROWS), cluster)
    return BwdPlan(parts, dq._replace(smem=smem + 2 * stages * tile * 4), dq)


def _split_bwd(q, k, v, do, qscale: float, owner):
    """the f32 class's backward operands: one launch writes [4 (q, k, v,
    do), 3 (hi, mid, lo), B*h, S, dh] bf16 from q*qscale, k, v and do
    (contiguous f32 on one CUDA device); counted in the split_launches of
    `owner`, the wrapper that takes the parts (flash_attention_bwd or
    flash_attention_bwd_fused)"""
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
    owner.split_launches += 1
    return tuple(out)


def _launch_bwd(which: str, ops, lse, delta, causal, plan: BwdPlan):
    """launch one backward kernel on prepared operands (q*scale*log2e, k,
    v, do: bf16 parts [3, B*h, S, dh] from _split_bwd when plan.parts is
    3, bf16 [B*h, S, dh] when 1): "dkv" -> (dk, dv), "dq" -> (dq,)"""
    b, s, dh = ops[0].shape[-3:]
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.shape[-3:] != ops[0].shape[-3:]
           or (t.dim() == 4) != (plan.parts == 3)
           or (t.dim() == 4 and t.shape[0] != 3) for t in ops):
        raise ValueError(f"flash_bwd_{which}: operands must be contiguous "
                         "bf16 [B*h, S, dh], [3, B*h, S, dh] parts in the "
                         "f32 class")
    tiles = plan.dkv if which == "dkv" else plan.dq
    lib = _lib("flash_bwd")
    outs = tuple(torch.empty((b, s, dh), dtype=torch.float32,
                             device=lse.device)
                 for _ in range(2 if which == "dkv" else 1))
    ptrs = [t.data_ptr() for t in (*ops, lse, delta) + outs]
    cfg = (b, s, dh, int(causal), plan.parts, tiles.rows, tiles.tile,
           tiles.stages, tiles.smem, tiles.cluster)
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
    delta, causal, plan), with the f32 class's split launched"""
    plan = bwd_plan(*q.shape, hybrid)
    *ops, delta, qscale = _bwd_operands(q, k, v, o, lse, do, hybrid, dlse)
    if plan.parts == 3:
        ops = _split_bwd(*ops, qscale, flash_attention_bwd)
    return ops, lse.contiguous(), delta.contiguous(), causal, plan


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
                                        hybrid: bool = False, dlse=None,
                                        cluster: int = 1):
    """plain PyTorch version of the fused backward kernel: (dq [B,S,dh],
    dk_parts, dv_parts [B, n_q, S, dh]).  flash_attention_bwd_ref's
    arithmetic, one Q block of bq rows at a time against the keys that the
    block sees; under the causal mask the keys after the block are never
    visited and their rows of the block's partials stay zero.  `cluster` >
    1 (fused_cluster): s2 and dp as a cluster route forms them, an f32 sum
    per CTA's 128 columns, added in cluster_sum's order."""
    b, s, dh = q.shape
    _check_shape("flash_attention_bwd_fused_parts_ref", (q, k, v, o, do))
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
        s2 = _cluster_scores(_einsum, q2[:, rows], kb, cluster)
        if causal:
            keep = (torch.arange(n_k, device=q.device)[None, :]
                    <= torch.arange(qi * bq, (qi + 1) * bq,
                                    device=q.device)[:, None])
            s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
        p = torch.exp2(s2 - lse2[:, rows, None])
        dp = _cluster_scores(_einsum, do[:, rows], vb, cluster)
        ds = rnd(p * (dp - delta[:, rows, None]))
        dq[:, rows] = torch.einsum("nqk,nkd->nqd", ds, kb) / math.sqrt(dh)
        dvp[:, qi, :n_k] = torch.einsum("nqk,nqd->nkd", rnd(p), do[:, rows])
        dkp[:, qi, :n_k] = torch.einsum("nqk,nqd->nkd", ds,
                                        q2[:, rows]) * LN2
    return dq, dkp, dvp


# --- the fused kernel's grid ------------------------------------------------
# KV tile rows of the kernel by (hybrid, dh) (csrc/flash_bwd_fused.cu:
# route): hybrid's one-CTA wgmma kernel at dh 128 and 256 (Hy), and the
# split body (F6: the f32 class's six products at every dh, the hybrid
# class's one product at dh 384 to 1024, on clusters of dh / 128 CTAs from
# dh 256 in the f32 class and 384 in the hybrid class)
FUSED_KV_TILE = {(hy, dh): 128 if hy and dh == 128 else 64
                 for hy in (True, False) for dh in KERNEL_DH}
# a cluster's exchange slot (csrc/flash_bwd_fused.cu: F6::XCH): each of a
# CTA's 256 threads' partial s2 and dp, 32 f32; with one slot ds^T's parts
# live in it
FUSED_EXCHANGE = 256 * 32 * 4
# warpgroup 1's dk and dv [64, 128] f32 pass to warpgroup 0 through K's and
# V's space in the split body (F6::RED), which is at least their size
FUSED_REDUCTION = 2 * 64 * 128 * 4


def fused_parts(dh: int, hybrid: bool) -> int:
    """the parts of each bf16 operand of the fused kernel, from the class:
    1 (the hybrid casts) or 3 (the f32 class's split)"""
    return 1 if hybrid else 3


def fused_cluster(dh: int, hybrid: bool) -> int:
    """the CTAs of a cluster of the fused kernel's route, from dh and the
    class alone, as the two-kernel backward's (bwd_cluster): 2 for the f32
    class at dh 256, whose three parts do not fit one CTA, dh / 128 at dh
    384 to 1024 in both classes, else 1"""
    return bwd_cluster(dh, hybrid)


def fused_smem(dh: int, parts: int) -> int:
    """dynamic shared memory of a CTA of the fused kernel of (dh, parts),
    bytes (csrc/flash_bwd_fused.cu: Hy, F6).  hybrid at dh 128 and 256
    (Hy): K and V of a KV tile, two ds^T tiles, a ring of Q-side stages
    (Q, dO, then lse and delta in 1024 aligned bytes) and a barrier per
    stage and one for K and V.  The split body (F6; the f32 class, and the
    hybrid class at dh 384 to 1024): the parts of K and V (at least the
    FUSED_REDUCTION bytes that pass through their space), Q and dO (64 rows
    of the CTA's 128 columns each), of ds^T [64, 64], lse and delta of a Q
    tile, three barriers; on a cluster the exchange's slots and barriers
    (exchange_barriers): in the f32 class one slot, in which ds^T's parts
    live once its last round is read, in the hybrid class at 3 to 8 CTAs
    two slots (xrs_slots) and ds^T's part beside them."""
    cluster = fused_cluster(dh, parts == 1)
    if parts == 3 or cluster > 1:
        tile = parts * TILE * 128 * 2
        slots = xrs_slots(parts == 1) if cluster > 2 else 1
        ds = parts * TILE * TILE * 2
        exchange = slots * FUSED_EXCHANGE if cluster > 1 else 0
        return (SM90_ALIGN + max(2 * tile, FUSED_REDUCTION) + 2 * tile
                + (exchange if slots == 1 and cluster > 1 else exchange + ds)
                + 2 * TILE * 4
                + (3 + exchange_barriers(cluster, slots)) * 8)
    bkv, stages = FUSED_KV_TILE[(True, dh)], (3 if dh == 128 else 2)
    return (SM90_ALIGN + 2 * bkv * dh * 2 + 2 * bkv * TILE * 2
            + stages * (2 * TILE * dh * 2 + SM90_ALIGN) + (stages + 1) * 8)


class FusedPlan(NamedTuple):
    """the fused kernel's grid for one shape: `cluster` CTAs per (head,
    item), an item = (Q block, KV chunk) of `chunk` KV tiles of `kv_tile`
    rows, listed heaviest first; `work` = the (Q tile, KV tile) pairs of
    each item; dq leaves as `n_slots` partials, one per KV chunk; `ctas`
    counts every CTA of the grid.  The kernel: `parts` (fused_parts), its
    `smem` bytes a CTA (fused_smem) and `cluster` (fused_cluster)."""
    kv_tile: int
    chunk: int
    n_slots: int
    items: tuple
    work: tuple
    ctas: int
    parts: int
    smem: int
    cluster: int


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
               dh: int, sms: int = N_SM, clusters=None) -> FusedPlan:
    """the fused kernel's grid on a card of `sms` SMs.  The chunk is the
    largest power of two of KV tiles that still gives every slot an item
    with work (one tile if none does): a slot is an SM, or on a cluster
    route a cluster of its CTAs' SMs (at most `clusters`, the clusters the
    card runs at once, which fused_plan_on asks the card for).  A longer
    chunk means fewer dq partials to write and sum, a shorter one more
    items to even out the causal load (PERF.md, section 6).  Items with no
    work (KV chunks that a causal Q block never sees) stay in the grid:
    their CTAs write the zeros of those rows.  Plans are kept: a shape's
    plan is made once."""
    kv_tile = FUSED_KV_TILE[(bool(hybrid), dh)]
    cluster = fused_cluster(dh, hybrid)
    slots = sms if cluster == 1 else max(1, min(sms // cluster,
                                                clusters or sms // cluster))
    n_kv = -(-s // kv_tile)
    chunk = 1
    while chunk * 2 <= n_kv:
        w = _chunk_works(s, bq, causal, kv_tile, chunk * 2)
        if bh * sum(1 for x in w.values() if x) < slots:
            break
        chunk *= 2
    w = _chunk_works(s, bq, causal, kv_tile, chunk)
    items = sorted(w, key=lambda it: (-w[it], -it[0], it[1]))
    parts = fused_parts(dh, hybrid)
    return FusedPlan(kv_tile, chunk, -(-n_kv // chunk), tuple(items),
                     tuple(w[it] for it in items),
                     len(items) * bh * cluster, parts, fused_smem(dh, parts),
                     cluster)


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


@functools.lru_cache(maxsize=32)
def _active_clusters(index: int, dh: int, hybrid: bool) -> int:
    """the most clusters of the fused kernel's route at dh in the class
    that CUDA device `index` runs at once (t4_flash_bwd_fused_clusters)"""
    lib = _lib("flash_bwd_fused")
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.t4_flash_bwd_fused_clusters(
            dh, fused_parts(dh, hybrid), ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"flash_bwd_fused occupancy query failed: "
                           f"cudaError {err}")
    return n.value


@functools.lru_cache(maxsize=32)
def flash_clusters(kernel: str, dh: int, hybrid: bool, index: int) -> int:
    """the most clusters of K1's ("fwd"), K2a's ("dkv"), K2b's ("dq") or
    the probe's ("dots", bf16 only) route at dh in the class that CUDA
    device `index` runs at once (cudaOccupancyMaxActiveClusters; a
    cluster of one CTA off the cluster routes): times the route's cluster,
    the SMs its grid keeps busy"""
    parts = 1 if hybrid else 3
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        if kernel == "dots":
            err = _lib("attn_dots").t4_attn_dots_clusters(
                dh, ctypes.addressof(n))
        elif kernel == "fwd":
            err = _lib("flash_fwd").t4_flash_fwd_clusters(
                dh, parts, ctypes.addressof(n))
        else:
            err = _lib("flash_bwd").t4_flash_bwd_clusters(
                dh, parts, int(kernel == "dkv"), ctypes.addressof(n))
    if err != 0:
        raise RuntimeError(f"flash_{kernel} occupancy query failed: "
                           f"cudaError {err}")
    return n.value


def fused_plan_on(device, bh: int, s: int, bq: int, causal: bool,
                  hybrid: bool, dh: int) -> FusedPlan:
    """fused_plan for the card the tensors lie on: its SMs and, on the
    cluster route, the clusters it runs at once"""
    device = torch.device(device)
    clusters = (_active_clusters(device.index if device.index is not None
                                 else torch.cuda.current_device(), dh,
                                 bool(hybrid))
                if device.type == "cuda" and fused_cluster(dh, hybrid) > 1
                else None)
    return fused_plan(bh, s, bq, causal, hybrid, dh, sm_count(device),
                      clusters)


def flash_attention_bwd_fused_slots_ref(q, k, v, o, lse, do, bq=None,
                                        causal: bool = False,
                                        hybrid: bool = False, dlse=None,
                                        sms: int = N_SM, cluster: int = 1):
    """plain PyTorch model of the fused kernel's decomposition: (dq_slots
    [n_slots, B, S, dh], dk_parts, dv_parts [B, n_q, S, dh]).  Item by item
    of fused_plan, as the CTAs compute them: each (Q block, KV chunk) item
    gives its chunk's rows of the block's partials and its block's rows of
    the chunk's dq slot; rows that no item computes are zeros.  dq is
    dq_slots summed over the slots, in order.  `cluster` as in
    flash_attention_bwd_fused_parts_ref."""
    b, s, dh = q.shape
    _check_shape("flash_attention_bwd_fused_slots_ref", (q, k, v, o, do))
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
        s2 = _cluster_scores(_einsum, q2[:, qr], k[:, kr], cluster)
        if causal:
            keep = (torch.arange(kr.start, kr.stop, device=q.device)[None, :]
                    <= torch.arange(qr.start, qr.stop,
                                    device=q.device)[:, None])
            s2 = torch.where(keep, s2, torch.full_like(s2, NEG_INF))
        p = torch.exp2(s2 - lse2[:, qr, None])
        dp = _cluster_scores(_einsum, do[:, qr], v[:, kr], cluster)
        ds = rnd(p * (dp - delta[:, qr, None]))
        slots[c, :, qr] = torch.einsum("nqk,nkd->nqd", ds,
                                       k[:, kr]) / math.sqrt(dh)
        dvp[:, qi, kr] = torch.einsum("nqk,nqd->nkd", rnd(p), do[:, qr])
        dkp[:, qi, kr] = torch.einsum("nqk,nqd->nkd", ds, q2[:, qr]) * LN2
    return slots, dkp, dvp


def flash_attention_bwd_fused_ref(q, k, v, o, lse, do, bq=None,
                                  causal: bool = False, hybrid: bool = False,
                                  dlse=None, cluster: int = 1):
    """plain PyTorch version of flash_attention_bwd_fused: (dq, dk, dv)"""
    dq, dkp, dvp = flash_attention_bwd_fused_parts_ref(
        q, k, v, o, lse, do, bq, causal, hybrid, dlse, cluster)
    return dq, dkp.sum(dim=1), dvp.sum(dim=1)


def _prepare_fused(q, k, v, o, lse, do, hybrid, dlse):
    """what the fused kernel takes, from CUDA tensors: (ops, lse, delta),
    q times scale*log2e: the hybrid class's casts, or the f32 class's
    parts after one split launch"""
    *ops, delta, qscale = _bwd_operands(q, k, v, o, lse, do, hybrid, dlse)
    if fused_parts(q.shape[-1], hybrid) == 3:
        ops = _split_bwd(*ops, qscale, flash_attention_bwd_fused)
    return ops, lse.contiguous(), delta.contiguous()


def _launch_fused(ops, lse, delta, bq: int, causal: bool, hybrid: bool):
    """launch the fused kernel on _prepare_fused's operands (q*scale*log2e,
    k, v, do: bf16 [B*h, S, dh] in the hybrid class, bf16 parts [3, B*h, S,
    dh] from _split_bwd in the f32 class): (dq partials [n_slots, B*h, S,
    dh], dk_parts, dv_parts [B*h, S / bq, S, dh]), f32"""
    b, s, dh = ops[0].shape[-3:]
    parts = fused_parts(dh, hybrid)
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.shape[-3:] != ops[0].shape[-3:]
           or (t.dim() == 4) != (parts == 3)
           or (t.dim() == 4 and t.shape[0] != 3) for t in ops):
        raise ValueError("flash_bwd_fused: operands must be contiguous "
                         "bf16 [B*h, S, dh], [3, B*h, S, dh] parts in the "
                         "f32 class")
    plan = fused_plan_on(lse.device, b, s, bq, causal, hybrid, dh)
    items = _items_on(plan.items, str(lse.device))
    lib = _lib("flash_bwd_fused")
    slots = torch.empty((plan.n_slots, b, s, dh), dtype=torch.float32,
                        device=lse.device)
    dkp = torch.empty((b, s // bq, s, dh), dtype=torch.float32,
                      device=lse.device)
    dvp = torch.empty_like(dkp)
    ptrs = [t.data_ptr() for t in (*ops, lse, delta, slots, dkp, dvp,
                                   items)]
    with torch.cuda.device(lse.device):
        stream = torch.cuda.current_stream(lse.device).cuda_stream
        err = lib.t4_flash_bwd_fused(*ptrs, len(plan.items), b, s, dh, bq,
                                     plan.kv_tile, plan.chunk, int(causal),
                                     plan.parts, plan.smem, plan.cluster,
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
    the one kernel (in the f32 class after one split launch of
    q*scale*log2e, k, v and do); CPU tensors take the plain version;
    anything else raises."""
    what = "flash_attention_bwd_fused"
    _check_shape(what, (q, k, v, o, do))
    bq = _fused_bq(what, q.shape[1], bq)
    extra = (lse,) if dlse is None else (lse, dlse)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do) + extra):
        return flash_attention_bwd_fused_parts_ref(q, k, v, o, lse, do, bq,
                                                   causal, hybrid, dlse)
    _check_cuda(what, (q, k, v, o, do))
    _check_rows(what, q, extra)
    slots, dkp, dvp = _launch_fused(
        *_prepare_fused(q, k, v, o, lse, do, hybrid, dlse), bq, causal,
        hybrid)
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
flash_attention_bwd_fused.split_launches = 0   # its f32 class's splits


# ===========================================================================
# the dots-only probe
# ===========================================================================
def attn_dots_ref(q, k, v):
    """plain PyTorch version of the probe kernel: f32 products of the bf16
    values, the scores rounded to bf16 before the second product.  At dh
    128 and 256 the sum over the keys is taken one key tile after another,
    as the kernel takes it: its tile is the hybrid forward plan's KV tile
    (fwd_plan(..., hybrid=True).bkv: 64 keys at dh 128, 32 at dh 256), each
    tile's product summed apart and added to o in f32.  At dh 384 to 1024
    (the wide route) the scores are an f32 sum per 128 columns, added in
    cluster_sum's order, and the tensor cores accumulate o over every key:
    one f32 sum over all keys"""
    b, s, dh = q.shape
    plan = fwd_plan(b, s, dh, True)
    qf, kf, vf = q.float(), k.float(), v.float()
    if plan.blocks > 1:
        s2 = _cluster_scores(_einsum, qf, kf, plan.blocks)
        return torch.einsum("nqk,nkd->nqd", s2.to(torch.bfloat16).float(), vf)
    o = torch.zeros_like(qf)
    bkv = plan.bkv
    for k0 in range(0, s, bkv):
        s2 = torch.einsum("nqd,nkd->nqk", qf, kf[:, k0:k0 + bkv])
        o += torch.einsum("nqk,nkd->nqd", s2.to(torch.bfloat16).float(),
                          vf[:, k0:k0 + bkv])
    return o


def _launch_dots(q, k, v):
    """launch the probe kernel on contiguous bf16 [B*h, S, dh] operands of
    one shape (S % TILE == 0, dh in KERNEL_DH): o [B*h, S, dh] f32"""
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.shape != q.shape for t in (q, k, v)):
        raise ValueError("attn_dots: operands must be contiguous bf16 of "
                         "one shape [B*h, S, dh]")
    _check_shape("attn_dots", (q, k, v))
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
    return _launch_dots(q, k, v)


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
