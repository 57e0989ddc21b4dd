"""Flash-attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel, ``csrc/flash_fwd.cu``, replaces the Pallas TPU kernel
tensorforth_tpu/ops/attn_pallas.py:_flash_kernel (launched by that
module's ``flash_attention``).  It computes o = softmax(q k^T/sqrt(dh)) v
and the per-row log-sum-exp in nats over [B*h, S, dh], causal or not,
with the S x S scores kept on chip.  On this card it is bound by
operations: strict-f32 products run on the CUDA cores, so it keeps the
FMA units fed from shared-memory tiles with register blocking (the
source's header says how).  lse is stored [B*h, S]; the Pallas kernel's
128-lane copy was a TPU layout artefact.

``flash_attention`` launches the kernel for CUDA tensors and uses the
plain version only for CPU tensors; anything else raises.  There is no
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


def _lib():
    from . import _build
    lib = _build.load("flash_fwd")
    fn = lib.t4_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, causal: bool = False, hybrid: bool = False):
    """q, k, v [B*h, S, dh] f32 -> (o [B*h, S, dh] f32, lse [B*h, S] f32
    in nats).  CUDA tensors launch the kernel; CPU tensors take the plain
    version; anything else raises."""
    devs = {q.device, k.device, v.device}
    if devs == {torch.device("cpu")}:
        return flash_attention_ref(q, k, v, causal, hybrid)
    if len(devs) != 1 or not q.is_cuda:
        raise ValueError(f"flash_attention: q, k, v on {sorted(map(str, devs))}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} "
                         f"{v.shape}, want three equal [B*h, S, dh]")
    b, s, dh = q.shape
    if dh not in KERNEL_DH or s % TILE:
        raise ValueError(f"flash_attention: kernel takes dh in {KERNEL_DH} "
                         f"and S % {TILE} == 0, got S={s} dh={dh}")
    for t in (q, k, v):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("flash_attention: q, k, v must be contiguous "
                             f"f32, got {t.dtype} contiguous="
                             f"{t.is_contiguous()}")
    scale = LOG2E / math.sqrt(dh)
    if hybrid:
        # bf16 multiplicands: scale in f32, then round, as attn_pallas.py
        # does outside its kernel; the kernel then loads Q unscaled
        q = (q * scale).to(torch.bfloat16)
        k = k.to(torch.bfloat16)
        v = v.to(torch.bfloat16)
        scale = 1.0
    lib = _lib()
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
