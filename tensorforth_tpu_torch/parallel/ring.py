"""Ring attention over the sequence-parallel ('sp') mesh axis (the port of
tensorforth_tpu/parallel/ring.py).

Each rank holds its [B, S/sp, dh] shards of q, k and v.  K and V travel
round the ring one hop a step (`mesh.ppermute`: a send to the next rank
and a receive from the one before, posted together); at each step a rank
attends its queries to the chunk it holds and merges the chunk-normalised
partial into its running output by their log-sum-exps, so it never holds
more than one K/V chunk (Liu et al. 2023).  Causal masking is exact
across chunks: the diagonal chunk runs causal, the chunks of later
positions get lse NEG_INF and drop out of the merge.

A chunk's partial goes through the flash kernels' differentiable (o, lse)
pair (`ops/attn.flash_attention_lse`: K1 forward, K2a/K2b backward with
the lse cotangent in delta) when the chunk is square and `funcs._flash_ok`
takes it (a CUDA tensor, S/sp >= 512, S/sp % 256 == 0, dh 128 to 1024),
and through the einsum branch otherwise.  The hop is an autograd Function
whose backward is the reverse hop, so autograd through the ring trains.
"""
from __future__ import annotations

import math

import torch

from ..nn import funcs
from ..ops import attn as _attn
from .mesh import Mesh, ppermute

NEG_INF = -1.0e30


def _chunk_attn(q, k, v, causal: bool):
    """chunk-normalised attention and its per-row lse: q [B, Sq, dh], k/v
    [B, Skv, dh] -> (o [B, Sq, dh], lse [B, Sq])"""
    b, sq, dh = q.shape
    skv = k.shape[1]
    if sq == skv and funcs._flash_ok(q):
        return _attn.flash_attention_lse(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal,
                                         funcs._attn_hybrid())
    sc = torch.einsum("nqd,nkd->nqk", q, k) / math.sqrt(dh)
    if causal:
        keep = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    lse = torch.logsumexp(sc, dim=-1)
    o = torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1), v)
    return o, lse


def _merge(o1, l1, o2, l2):
    """two chunk-normalised partials combined by their lse weights"""
    m = torch.maximum(l1, l2)
    m = torch.clamp_min(m, NEG_INF)        # both -inf: weights 0/0 guard
    w1 = torch.exp(l1 - m)[..., None]
    w2 = torch.exp(l2 - m)[..., None]
    den = torch.clamp_min(w1 + w2, 1e-38)
    o = (o1 * w1 + o2 * w2) / den
    return o, m + torch.log(torch.clamp_min(w1[..., 0] + w2[..., 0], 1e-38))


def ring_attention(q, k, v, mesh: Mesh, causal: bool = False,
                   axis: str = "sp"):
    """q, k, v: this rank's [B, S/n, dh] shards of a sequence split over
    `axis` (n ranks, rank i holding positions i*S/n ..) -> its [B, S/n, dh]
    part of the attention over the whole sequence.  B may be split over
    another axis of the mesh as well."""
    n = mesh.axis_size(axis)
    i = mesh.index(axis)
    o = torch.zeros_like(q)
    lse = torch.full(q.shape[:2], NEG_INF, dtype=torch.float32,
                     device=q.device)
    k_c, v_c = k, v
    for t in range(n):
        src = (i - t) % n                  # the rank whose K/V we hold
        if causal:
            po, pl = _chunk_attn(q, k_c, v_c, src == i)
            if src > i:                    # a later chunk: drops out
                pl = torch.full_like(pl, NEG_INF)
        else:
            po, pl = _chunk_attn(q, k_c, v_c, False)
        o, lse = _merge(o, lse, po, pl)
        if t < n - 1:
            k_c = ppermute(k_c, mesh, axis, tag=1)
            v_c = ppermute(v_c, mesh, axis, tag=2)
    return o
