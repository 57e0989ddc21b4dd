#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensorforth_tpu_torch) on one NVIDIA card
and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  build   compile every kernel of the four paths with nvcc for sm_90a
          into build/torch_kernels/ (one nvcc per source, all at once:
          flash_fwd, flash_bwd, flash_bwd_fused, attn_dots, gemm_sm90,
          gemm_sm90_f32); each wgmma kernel's registers, shared memory and
          spills from ptxas (every instance of the flash forward, the
          two-kernel and the fused backward and gemm_sm90, split passes
          included, must show no spill and no stack frame)
  kernel  each kernel (flash forward with its split, flash backward dK/dV
          and dQ with theirs, the fused single-kernel backward, the
          dots-only probe,
          and the GEMM kernels of the tensor tier: K5a on the wgmma kernel
          with its rounding pass in all three classes, K6 on the same
          kernel, K5b and K7 on f32 operands rounded inside their one
          launch) against its plain PyTorch version on the card, on inputs
          from a numpy seed; the f32 forward and backward and K5a highest
          also against f64 (the classes' own accuracy); the backward runs
          twice to the bit; the fused backward also against
          the two-kernel split, against f64 and against itself run twice,
          with its grid (CTAs, KV chunk, dq partials); the rounding pass
          and the forward's split bit for bit; K5b and K7 also against K5a
          class default and K6 at 4096^3 (bit-equality recorded); kernel,
          plain and library times (the bf16 library also with the two
          f32 -> bf16 casts; the library attention also through a 4-d
          call) and the card's least time for the same work (the bound)
  serve   tiny_lm at bench_prefill's full width (dim 1024, 8 heads,
          4 layers, vocab 2048, batch 8, 2048-token prompt, 64 new
          tokens) through generate(), f32 and int8 KV caches: kernel
          launches counted, greedy tokens held against a teacher-forced
          replay, prefill/decode timings
  train   the same tiny_lm, full width and depth, through the word path
          forward / loss(CE) / backprop / adam on 8 x 2048 tokens:
          kernel launches counted in one step, the step's weight
          gradients held against the same step taken through the plain
          attention path, the loss sequence, step timings and a profile
  tensor  the port's Forth REPL on the card, fed from strings:
          examples/t4_20a.4th whole (its verify lines, the inverse
          round trip, msec/cycle of its 1000-product loop), the larger
          1000-product loop with a profile, the words gemm..gemm4 at
          4096^3 and 2048^3 under both precision settings with exact
          launch counts, and inverse/plu/det/solve at 1024 x 1024
  attn_bench  the attention measurement path at full width (16 heads,
          S 2048, dh 128; the sweep at B x S = 16 x 2048, 4 x 4096,
          1 x 8192): bench_attention, bench_attention_bwd,
          bench_attention_oracle with its dots-only probe, and
          sweep_bwd_fused, with exact launch counts; prints the rates,
          the within-rep ratios fused / split and library / ours, the
          forward's time over the probe's, and each candidate's blocks
          and partial bytes.  Then, uncounted, the fused backward at
          every (shape, mask, Q block) the sweep launched it at, against
          its plain version and the split.  It asserts no speed.
Then the seconds each phase took (`phase_seconds`), one `kernels` JSON
line, the card's name and power limit as nvidia-smi reports them, and
last {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, when there is no CUDA
device; and non-zero when a kernel does not build, launch or agree, or
any check fails.  Nothing is caught and turned into a pass.
"""
from __future__ import annotations

import argparse
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12        # f32 on the CUDA cores (no tensor cores)
PEAK_BF16_FLOPS = 989e12      # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12          # HBM3
KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_fused", "attn_dots",
           "gemm_sm90", "gemm_sm90_f32")   # ops/csrc/<name>.cu
# sources whose every kernel instance must show no spill and no stack frame
NO_SPILL = ("flash_fwd", "flash_bwd", "flash_bwd_fused", "gemm_sm90")
LM = dict(batch=8, vocab=2048, dim=1024, heads=8, layers=4, rope=True)
N_PROMPT, N_NEW = 2048, 64
TOL_F32 = 1e-4     # f32 sums in another order than the plain version's
# the f32 forward against f64, absolute plus relative: the JAX package's
# own tolerance for its flash forward in f32 (tests/test_attention.py)
TOL_F32_F64 = 2e-5
TOL_HYBRID = 3e-2  # the JAX package's hybrid tolerance: P rounds to bf16
#                    against the running max in the kernel, the row max
#                    in the plain version
TOL_BWD_F32 = 2e-4     # dq, dk, dv: the JAX package's own tolerance
TOL_BWD_HYBRID = 0.05  # of the largest reference value (bf16 p and ds)
TOL_FUSED_SPLIT = 1e-5  # the fused backward against the two-kernel split,
#                    f32, absolute plus relative (the JAX package's own
#                    test): the same p and ds, dq and the partials summed in
#                    another order
TOL_FUSED_SPLIT_HYBRID = 2.0 ** -7  # hybrid, of each gradient's largest
#                    value in the split: the fused kernel forms s2 and dp on
#                    the tensor cores, in another order than the split, so
#                    a p or ds can round to the neighbouring bf16 value (a
#                    relative step of 2^-8); that is the spacing of one
#                    term, with room for two such flips
TOL_DOTS = 1e-4    # the probe against its plain version, of the largest
#                    value: two f32 sums of a score that differ in the last
#                    bit can round to neighbouring bf16 values (2^-8 apart)
TOL_GRAD = 1e-3    # train: dw, db against the plain attention path, of
#                    each tensor's largest value
MARGIN = 1e-4      # top-2 logit gap below which a replay flip is a tie
TRAIN_STEPS = 5    # timed steps after the counted one
TRAIN_LR = 1e-4    # Adam.  The reference's Adam has no bias correction,
#                    so its first steps move every weight by about 3 lr;
#                    at dim 1024 the small tests' 1e-2 and 1e-3 overshoot
FLASH_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
PROBE_NAMES = ("flash_bwd_fused", "attn_dots")   # the measurement path's own
BENCH = dict(nh=16, s=2048, dh=128)   # bench.py's attention shape
BENCH_ITERS, BENCH_REPS = 4, 7        # calls per chain, timed chains
GEMM_NAMES = ("mm_f32io", "mm_bf16", "mm_v8", "mm_db", "mm_round")
# GEMM tolerances, of the largest value of an f64 product of the same
# operands.  The bf16 classes against their plain version: only the order
# of the f32 sums differs.  3pass and highest against f64: the classes'
# own accuracy (tests/test_gemm_prec.py of the JAX package).
TOL_GEMM_BF16 = 1e-5
TOL_GEMM_3PASS = 2e-5
TOL_GEMM_HIGHEST = 5e-6
# a word of the bf16 class against the f32 `gemm` word: each multiplicand
# is rounded to 8 bits of mantissa (relative 2^-9), and `rand` operands
# are all positive, so the rounding errors of a sum do not cancel to
# nothing: 2 * 2^-9 bounds it
TOL_WORD_BF16 = 4e-3
# a gemm2..4 word against its kernel's plain version on the same `rand`
# operands.  The tensor cores add into their f32 accumulator without
# rounding to nearest; on all-positive sums that error has one sign and
# grows with K (1.5e-5 at K = 4096), where random signs (the kernel
# phase's operands) keep it under 1e-5.
TOL_WORD_PLAIN = 2e-5
# m, k, n.  (1030, 1000, 1290): m and n no tile multiples, k no multiple
# of the wgmma kernels' slabs (64 bf16, K7's 32 f32), n no multiple of 4
# (K7's wrapper pads B's rows); (1000, 1500, 700): k no multiple of either
GEMM_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (4096, 4096, 4096),
               (1024, 2048, 512), (1000, 1500, 700), (2, 3, 2),
               (1030, 1000, 1290))
GEMM_MAIN = (4096, 4096, 4096)   # the shape of the `kernels` line
TOL_LINALG = 1e-4  # the tensor phase: residuals at 1024 x 1024
WORD_REPS = 3      # runs of each gemm word: the median time is kept


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 15, warm: int = 2) -> float:
    """median of `reps` synchronized runs, each timed with CUDA events"""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def attn_work(b, s, dh, causal, hybrid):
    """(operations, bytes, split bytes) of the attention forward: 2
    products of 2*dh operations per visited (query, key) pair, causal
    visiting S(S+1)/2 pairs; f32 q, k, v read once, o and lse written
    once.  The f32 class's split pass reads q, k, v and writes three bf16
    parts of each (the split bytes, its own bound); hybrid's casts are the
    wrapper's"""
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * dh * b * pairs
    nbytes = 3 * b * s * dh * 4 + b * s * dh * 4 + b * s * 4
    split = 0 if hybrid else 3 * b * s * dh * (4 + 3 * 2)
    return ops, nbytes, split


def attn_bwd_work(which, b, s, dh, causal, parts):
    """(operations, bytes, split bytes) of one backward kernel.  dK/dV does
    4 products per visited pair (s2, dp, p^T do, ds^T q), dQ does 3 (s2,
    dp, ds k); each reads q, k, v and do (`parts` bf16 parts each, or f32
    on the FMA route, parts 0), lse and delta once and writes its outputs
    once.  The f32 class's split (parts 3) reads q, k, v and do and writes
    three bf16 parts of each (the split bytes, its own bound); hybrid's
    casts are the wrapper's"""
    pairs = s * (s + 1) // 2 if causal else s * s
    n_prod, n_out = (4, 2) if which == "dkv" else (3, 1)
    ops = n_prod * 2 * dh * b * pairs
    elem = 2 * parts if parts else 4
    nbytes = (4 * b * s * dh * elem + 2 * b * s * 4
              + n_out * b * s * dh * 4)
    split = 4 * b * s * dh * (4 + 3 * 2) if parts == 3 else 0
    return ops, nbytes, split


def attn_bwd_fused_work(b, s, dh, bq, causal, elem_bytes):
    """(operations, bytes) of the fused backward with its sums: 5 products
    per visited pair (s2, dp, ds k, p^T do, ds^T q); q, k, v, do, lse and
    delta read once, dq written once, the 2 * n_q partial slabs written by
    the kernel and read by the sums, dk and dv written once"""
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 5 * 2 * dh * b * pairs
    slab = b * s * dh * 4
    nbytes = (4 * b * s * dh * elem_bytes + 2 * b * s * 4 + slab
              + 2 * 2 * (s // bq) * slab + 2 * slab)
    return ops, nbytes


def attn_dots_work(b, s, dh):
    """(operations, bytes) of the dots-only probe: 2 products of 2*dh
    operations per (query, key) pair; bf16 q, k, v read once, f32 o
    written once"""
    return 4 * dh * b * s * s, 3 * b * s * dh * 2 + b * s * dh * 4


def fwd_peak(hybrid: bool) -> float:
    """the rate of the forward's route: one bf16 product on the tensor
    cores (hybrid), or six (the f32 class's split)"""
    return PEAK_BF16_FLOPS if hybrid else PEAK_BF16_FLOPS / 6


def bwd_peak(parts: int) -> float:
    """the rate of the backward's route (ops.attn.bwd_plan): one bf16
    product on the tensor cores (parts 1), six (parts 3), or f32 FMAs on
    the CUDA cores (parts 0: dh 256 in the f32 class)"""
    return {1: PEAK_BF16_FLOPS, 3: PEAK_BF16_FLOPS / 6,
            0: PEAK_F32_FLOPS}[parts]


BWD_ROUTES = {1: "bf16 wgmma, one product",
              3: "bf16 wgmma, six products of a three-part split",
              0: "f32 FMA on the CUDA cores"}


def bound_ms(ops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ptxas_by_kernel(log: str):
    """each entry function of an nvcc -Xptxas -v log: its name (template
    arguments kept), registers, static shared memory, stack frame and
    spill bytes"""
    out, cur = [], None
    for ln in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", ln)
        if hit:
            mangled = name = hit.group(1)
            # the last <length><identifier> ending in "kernel" is the
            # function's own name: an earlier one can agree with its
            # length by chance inside the namespace's hash
            for mt in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?kernel))", mangled):
                digits, ident = mt.groups()
                if any(int(digits[i:]) == len(ident)
                       for i in range(len(digits))):
                    name = ident
            args = re.findall(r"Li(\d+)E", mangled)
            cur = {"kernel": name + (f"<{','.join(args)}>" if args else "")}
            out.append(cur)
        elif cur is not None:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", ln)
            if sp:
                cur["spill_stores"], cur["spill_loads"] = map(int,
                                                               sp.groups())
            fr = re.search(r"(\d+) bytes stack frame", ln)
            if fr:
                cur["stack_frame"] = int(fr.group(1))
            rg = re.search(r"Used (\d+) registers", ln)
            if rg:
                cur["registers"] = int(rg.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def phase_build():
    from tensorforth_tpu_torch.ops import _build, attn, gemm
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = list(ex.map(_build.build, KERNELS))
    secs = time.perf_counter() - t0
    ptxas, by_source = [], {}
    for name, lib in zip(KERNELS, libs):
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(
            ".log").exists() else ""
        ptxas += [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        if name.startswith("gemm_sm90") or name in NO_SPILL:
            by_source[name] = ptxas_by_kernel(log)
    plans = {cls: gemm.sm90_plan(4096, 4096, nprod)._asdict()
             for cls, nprod in (("default and v8", 1), ("3pass", 3),
                                ("highest", 6))}
    fwd_plans = {f"dh{dh}_{'hybrid' if hy else 'f32'}": attn.fwd_plan(
        64, 2048, dh, hy)._asdict() for dh in attn.KERNEL_DH
        for hy in (False, True)}
    bwd_plans = {f"dh{dh}_{'hybrid' if hy else 'f32'}": {
        key: (val._asdict() if hasattr(val, "_asdict") else val)
        for key, val in attn.bwd_plan(64, 2048, dh, hy)._asdict().items()}
        for dh in attn.KERNEL_DH for hy in (False, True)}
    f32in = {kern: gemm.f32in_plan(kern, 4096, 4096, 4096)._asdict()
             for kern in ("mm_bf16", "mm_db")}
    emit({"phase": "build", "seconds": secs, "kernels": list(KERNELS),
          "ptxas": ptxas, "gemm_sm90_kernels": by_source["gemm_sm90"],
          "gemm_sm90_f32_kernels": by_source["gemm_sm90_f32"],
          "flash_bwd_fused_kernels": by_source["flash_bwd_fused"],
          "flash_fwd_kernels": by_source["flash_fwd"],
          "flash_bwd_kernels": by_source["flash_bwd"],
          "gemm_sm90_plans_at_4096": plans,
          "gemm_sm90_f32_plans_at_4096": f32in,
          "flash_fwd_plans_at_64x2048": fwd_plans,
          "flash_bwd_plans_at_64x2048": bwd_plans})
    for name, want in (("gemm_sm90", ("gemm_sm90_kernel<128,6,2>",
                                      "gemm_sm90_kernel<128,3,3>",
                                      "gemm_sm90_kernel<256,1,4>",
                                      "split_kernel<3>", "split_kernel<2>",
                                      "split_kernel<1>")),
                       ("gemm_sm90_f32", ("mm_bf16_kernel", "mm_db_kernel")),
                       ("flash_bwd_fused", ("fused_sm90_kernel",
                                            "fused_f32_kernel")),
                       ("flash_fwd", ("flash_fwd_kernel<128,3>",
                                      "flash_fwd_kernel<128,1>",
                                      "flash_fwd_kernel<256,3>",
                                      "flash_fwd_kernel<256,1>",
                                      "split_kernel<3>")),
                       ("flash_bwd", ("flash_bwd_dkv_sm90_kernel<128,3>",
                                      "flash_bwd_dq_sm90_kernel<128,3>",
                                      "flash_bwd_dkv_sm90_kernel<128,1>",
                                      "flash_bwd_dq_sm90_kernel<128,1>",
                                      "flash_bwd_dkv_sm90_kernel<256,1>",
                                      "flash_bwd_dq_sm90_kernel<256,1>",
                                      "flash_bwd_dkv_kernel<256,32>",
                                      "flash_bwd_dq_kernel<256,32>",
                                      "split_kernel<3>"))):
        for kern in want:
            if not any(kern in k["kernel"] for k in by_source[name]):
                raise RuntimeError(f"{name}: no ptxas record of {kern}")
    spilled = [dict(k, source=name) for name in NO_SPILL
               for k in by_source[name]
               if k.get("spill_stores") or k.get("spill_loads")
               or k.get("stack_frame")]
    if spilled:
        raise RuntimeError(f"spills or stack frames: {spilled}")


def sdpa_grads(q, k, v, do, causal):
    """the library yardstick of the backward: torch.autograd.grad through
    scaled_dot_product_attention.  Returns a function that runs the
    backward alone (the graph is kept)."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)


def f64_grads(q, k, v, do, dlse, causal, heads=8):
    """dq, dk, dv in f64 by PyTorch's autograd through the exact (o, lse)
    attention, `heads` heads at a time (dlse may be None): a reference
    that shares no arithmetic with the kernels or their plain version"""
    import torch
    s, dh = q.shape[1], q.shape[2]
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = [[], [], []]
    for i in range(0, q.shape[0], heads):
        leaves = [t[i:i + heads].double().requires_grad_(True)
                  for t in (q, k, v)]
        sc = torch.einsum("nqd,nkd->nqk", leaves[0],
                          leaves[1]) / math.sqrt(dh)
        if causal:
            sc = sc.masked_fill(~keep, -1.0e30)
        outs = [torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1),
                             leaves[2])]
        cots = [do[i:i + heads].double()]
        if dlse is not None:
            outs.append(torch.logsumexp(sc, dim=-1))
            cots.append(dlse[i:i + heads].double())
        for acc, g in zip(out, torch.autograd.grad(outs, leaves, cots)):
            acc.append(g)
        del leaves, sc, outs
    return tuple(torch.cat(g) for g in out)


def f64_attention(q, k, v, causal, heads=8):
    """(o, lse) of the exact attention in f64, `heads` heads at a time: a
    reference that shares no arithmetic with the kernel"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    outs = [attn.flash_attention_ref(*(x[i:i + heads].double()
                                       for x in (q, k, v)), causal)
            for i in range(0, q.shape[0], heads)]
    return (torch.cat([o for o, _ in outs]),
            torch.cat([lse for _, lse in outs]))


def f64_ratio(got, want, tol=TOL_F32_F64) -> float:
    """the largest |got - want| over tol + tol |want|: at most 1 holds"""
    return ((got.double() - want).abs() / (tol + tol * want.abs())).max(
    ).item()


def fused_equals_split(got, want, hybrid: bool) -> bool:
    """(dq, dk, dv) of the fused backward against the two-kernel split's:
    f32 within TOL_FUSED_SPLIT, absolute plus relative; hybrid within
    TOL_FUSED_SPLIT_HYBRID of each gradient's largest value"""
    if hybrid:
        return all(bool(((g - w).abs() <= TOL_FUSED_SPLIT_HYBRID
                         * w.abs().max()).all()) for g, w in zip(got, want))
    return all(bool(((g - w).abs() <= TOL_FUSED_SPLIT
                     + TOL_FUSED_SPLIT * w.abs()).all())
               for g, w in zip(got, want))


def fused_case(args, split, bq, f64, sdpa_bwd, timed=True):
    """the fused backward kernel on one case's operands (q, k, v, o, lse,
    do, causal, hybrid, dlse): against its plain version (dq and both
    partials, the never-visited blocks included), against the two-kernel
    split's (dq, dk, dv), against f64 where given, and against itself run
    again; its grid; its times unless `timed` is false, and the library
    backward's where given (for hybrid cases also on bf16 operands)"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    q, k, v, o, lse, do, causal, hybrid, dlse = args
    b, s, dh = q.shape
    call = (q, k, v, o, lse, do, bq, causal, hybrid, dlse)
    dq, dkp, dvp = attn.flash_attention_bwd_fused_parts(*call)
    if q.is_cuda:
        torch.cuda.synchronize()
    want = attn.flash_attention_bwd_fused_parts_ref(*call)
    names = ("dq", "dk_parts", "dv_parts")
    errs = {nm: (g - w).abs().max().item()
            for nm, g, w in zip(names, (dq, dkp, dvp), want)}
    tops = {nm: w.abs().max().item() for nm, w in zip(names, want)}
    ok = all(bool(torch.isfinite(g).all()) and (
        errs[nm] <= TOL_BWD_HYBRID * tops[nm] if hybrid
        else errs[nm] <= TOL_BWD_F32)
        for nm, g in zip(names, (dq, dkp, dvp)))
    del want
    n_q = s // bq
    never = [part[:, qi, (qi + 1) * bq:] for part in (dkp, dvp)
             for qi in range(n_q - 1)] if causal else []
    zeros_ok = (tuple(dkp.shape) == tuple(dvp.shape) == (b, n_q, s, dh)
                and all(not bool(x.any()) for x in never))
    got = (dq, dkp.sum(dim=1), dvp.sum(dim=1))
    vs_split = {nm: (g - w).abs().max().item()
                for nm, g, w in zip(("dq", "dk", "dv"), got, split)}
    split_tops = {nm: w.abs().max().item()
                  for nm, w in zip(("dq", "dk", "dv"), split)}
    split_ok = fused_equals_split(got, split, hybrid)
    again = attn.flash_attention_bwd_fused(*call)
    repeats = all(torch.equal(g, a) for g, a in zip(got, again))
    plan = attn.fused_plan(b, s, bq, causal, hybrid, dh,
                           attn.sm_count(q.device))
    row = {"bq": bq, "n_q": n_q, "blocks": plan.ctas,
           "grid": {"ctas": plan.ctas, "ctas_with_work": b * sum(
               1 for x in plan.work if x), "kv_tile_rows": plan.kv_tile,
               "kv_tiles_per_cta": plan.chunk, "dq_partials": plan.n_slots,
               "most_pairs_of_a_cta": plan.work[0],
               "route": "bf16 wgmma" if hybrid else "f32 FMA"},
           "max_abs_err": errs, "largest_reference_value": tops,
           "partials_shape_and_zero_blocks_ok": zeros_ok,
           "never_visited_blocks": len(never) // 2,
           "max_abs_err_vs_split": vs_split,
           "largest_split_value": split_tops, "tol_vs_split":
           (f"{TOL_FUSED_SPLIT_HYBRID} of the largest split value" if hybrid
            else f"{TOL_FUSED_SPLIT} absolute plus {TOL_FUSED_SPLIT} "
                 "relative"),
           "fused_equals_split": split_ok, "two_runs_bit_equal": repeats}
    if f64 is not None:
        row["max_abs_err_vs_f64"] = max(
            (g.double() - w).abs().max().item() for g, w in zip(got, f64))
        ok = ok and row["max_abs_err_vs_f64"] <= TOL_BWD_F32
    del got, again, dq, dkp, dvp
    row["ok"] = ok and zeros_ok and split_ok and repeats
    if not timed:
        return row
    row["ms"] = time_ms(lambda: attn.flash_attention_bwd_fused(*call))
    row["ms_before_the_sums"] = time_ms(
        lambda: attn.flash_attention_bwd_fused_parts(*call))
    # the kernel alone, on the wrapper's prepared operands: the rest of
    # `ms` is the wrapper's (casts and delta, the dq partials' sum, then
    # the dK/dV sums)
    q2, kk, vv, dd, delta, qscale = attn._bwd_operands(q, k, v, o, lse, do,
                                                       hybrid, dlse)
    row["kernel_ms"] = time_ms(lambda: attn._launch_fused(
        q2, kk, vv, dd, lse.contiguous(), delta.contiguous(), bq, causal,
        hybrid, qscale))
    del q2, kk, vv, dd, delta
    ops, nbytes = attn_bwd_fused_work(b, s, dh, bq, causal,
                                      2 if hybrid else 4)
    # the rate of the class's route: bf16 wgmma, or f32 on the CUDA cores
    row["bound_ms"], row["bound_by"] = bound_ms(
        ops, nbytes, PEAK_BF16_FLOPS if hybrid else PEAK_F32_FLOPS)
    row.update(gflop=ops / 1e9, mbytes=nbytes / 1e6,
               tflops=ops / row["ms"] / 1e9)
    if sdpa_bwd is not None:
        row["plain_ms"] = time_ms(
            lambda: attn.flash_attention_bwd_fused_ref(*call), reps=10)
        row["library_ms"] = time_ms(sdpa_bwd)
        if hybrid:
            # the library on the operands' bf16 class, as [1, B*h, S, dh]:
            # a 3-d call keeps the library off its bf16 flash kernel
            bf = torch.bfloat16
            row["library_bf16_ms"] = time_ms(sdpa_grads(
                *(x.to(bf)[None] for x in (q, k, v, do)), causal))
            row["library_ms_4d"] = time_ms(sdpa_grads(
                *(x[None] for x in (q, k, v, do)), causal))
        # what bq trades: blocks in the grid against partial traffic
        row["ms_by_bq"] = {str(x): time_ms(
            lambda: attn.flash_attention_bwd_fused(
                q, k, v, o, lse, do, x, causal, hybrid, dlse))
            for x in (128, 256, 512, 1024, 2048)}
    return row


def phase_kernel_dots(seed: int):
    """the dots-only probe against its plain version; returns its record
    at the bench shape"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    rows, main = [], None
    for i, (b, s, dh) in enumerate(((BENCH["nh"], BENCH["s"], BENCH["dh"]),
                                    (64, 2048, 128), (8, 1024, 256))):
        rs = np.random.RandomState(seed + 200 + i)
        q, k, v = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda().to(torch.bfloat16) for _ in range(3))
        o = attn.attn_dots(q, k, v)
        torch.cuda.synchronize()
        want = attn.attn_dots_ref(q, k, v)
        err, top = (o - want).abs().max().item(), want.abs().max().item()
        ops, nbytes = attn_dots_work(b, s, dh)
        bms, by = bound_ms(ops, nbytes)
        ms = time_ms(lambda: attn.attn_dots(q, k, v))
        # the forward kernel alone on the same bf16 operands, q scaled as
        # it is loaded: what the softmax adds to the two products
        fwd_ms = time_ms(lambda: attn._launch_fwd(
            q, k, v, False, True, attn.LOG2E / math.sqrt(dh)))
        rows.append({
            "flash_fwd_ms_on_the_same_operands": fwd_ms,
            "flash_fwd_over_attn_dots": fwd_ms / ms,
            "shape": [b, s, dh], "max_abs_err": err,
            "largest_reference_value": top, "tol": TOL_DOTS,
            "ok": (err <= TOL_DOTS * top and bool(torch.isfinite(o).all())
                   and tuple(o.shape) == (b, s, dh)
                   and o.dtype == torch.float32),
            "ms": ms, "plain_ms": time_ms(
                lambda: attn.attn_dots_ref(q, k, v), reps=5),
            "library_ms": None, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
            "tflops": ops / ms / 1e9, "bound_ms": bms, "bound_by": by,
            "bound_ms_on_the_bf16_tensor_cores": bound_ms(
                ops, nbytes, PEAK_BF16_FLOPS)[0]})
        main = main or rows[-1]
        del q, k, v, o, want
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "attn_dots", "cases": rows,
          "tol": f"{TOL_DOTS} of the largest reference value",
          "library": "no one PyTorch call computes bf16(q k^T) v"})
    if not all(r["ok"] for r in rows):
        raise RuntimeError("attn_dots disagrees with its plain version")
    return main


def phase_kernel(seed: int):
    """the four flash kernels against their plain versions; returns each
    one's record by kernel name: at the serving and training slices' shape
    for the forward and the two-kernel backward, at the measurement path's
    for the fused backward"""
    import torch
    import torch.nn.functional as F
    from tensorforth_tpu_torch.ops import attn
    cases = [  # name, B*h, S, dh, causal, hybrid, with a non-zero dlse,
        #        rows of a Q block of the fused backward
        ("slice_causal", 64, 2048, 128, True, False, False, 1024),
        ("slice_noncausal", 64, 2048, 128, False, False, False, 512),
        ("odd_s_causal", 16, 1536, 128, True, False, False, 768),
        ("slice_causal_hybrid", 64, 2048, 128, True, True, False, 1024),
        ("dh256_causal", 8, 1024, 256, True, False, False, 512),
        ("odd_s_causal_dlse", 16, 1536, 128, True, False, True, 192),
        ("s2560_hybrid_dlse", 4, 2560, 128, False, True, True, 640),
        ("bench_causal_hybrid", BENCH["nh"], BENCH["s"], BENCH["dh"], True,
         True, False, 1024),
        ("dh256_causal_hybrid", 8, 1024, 256, True, True, False, 512),
        # S % 128 == 64: the forward's last 128-row Q tile is half past S
        ("s576_causal", 8, 576, 128, True, False, False, 192),
    ]
    rows, bwd_rows, failed, main = [], [], [], {}
    for i, (name, b, s, dh, causal, hybrid, with_dlse,
            bq) in enumerate(cases):
        rs = np.random.RandomState(seed + i)
        q, k, v, do = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda() for _ in range(4))
        dlse = (torch.from_numpy(rs.randn(b, s).astype(np.float32)).cuda()
                if with_dlse else None)
        # --- forward
        o, lse = attn.flash_attention(q, k, v, causal=causal, hybrid=hybrid)
        torch.cuda.synchronize()
        o_r, lse_r = attn.flash_attention_ref(q, k, v, causal, hybrid)
        err_o = (o - o_r).abs().max().item()
        err_l = (lse - lse_r).abs().max().item()
        tol = TOL_HYBRID if hybrid else TOL_F32
        ok = (err_o <= tol and err_l <= tol
              and bool(torch.isfinite(o).all()))
        del o_r, lse_r
        ms = time_ms(lambda: attn.flash_attention(q, k, v, causal=causal,
                                                  hybrid=hybrid))
        ops, nbytes, split_bytes = attn_work(b, s, dh, causal, hybrid)
        # the rate of the class's route: one bf16 product, or six
        bms, by = bound_ms(ops, nbytes, fwd_peak(hybrid))
        row = {"case": name, "shape": [b, s, dh], "causal": causal,
               "hybrid": hybrid, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_l, "tol": tol, "ms": ms,
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": ops / ms / 1e9, "bound_ms": bms, "bound_by": by,
               "route": "bf16 wgmma, one product" if hybrid else
                        "bf16 wgmma, six products of a three-part split"}
        if not hybrid:
            # the class's own accuracy: against f64, 2e-5 + 2e-5 |x|
            o64, l64 = f64_attention(q, k, v, causal)
            row["f64_ratio_o"] = f64_ratio(o, o64)
            row["f64_ratio_lse"] = f64_ratio(lse, l64)
            row["tol_vs_f64"] = (f"{TOL_F32_F64} absolute plus "
                                 f"{TOL_F32_F64} relative")
            ok = ok and max(row["f64_ratio_o"], row["f64_ratio_lse"]) <= 1
            row["split_bound_ms"] = split_bytes / PEAK_BYTES * 1e3
            del o64, l64
        row["ok"] = ok
        # --- backward, from the forward kernel's o and lse
        plan = attn.bwd_plan(b, s, dh, hybrid)
        call = (q, k, v, o, lse, do, causal, hybrid)
        dq, dk, dv = attn.flash_attention_bwd(*call, dlse=dlse)
        torch.cuda.synchronize()
        want = attn.flash_attention_bwd_ref(*call, dlse=dlse)
        errs = {nm: (g - w).abs().max().item()
                for nm, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        tops = {nm: w.abs().max().item()
                for nm, w in zip(("dq", "dk", "dv"), want)}
        again = attn.flash_attention_bwd(*call, dlse=dlse)
        repeats = all(torch.equal(g, a) for g, a in zip((dq, dk, dv), again))
        del again
        bok = repeats and all(bool(torch.isfinite(g).all()) and (
            errs[nm] <= TOL_BWD_HYBRID * tops[nm] if hybrid
            else errs[nm] <= TOL_BWD_F32)
            for nm, g in zip(("dq", "dk", "dv"), (dq, dk, dv)))
        brow = {"case": name, "shape": [b, s, dh], "causal": causal,
                "hybrid": hybrid, "dlse": with_dlse,
                "route": BWD_ROUTES[plan.parts], "max_abs_err": errs,
                "largest_reference_value": tops, "two_runs_bit_equal":
                repeats, "ok": bok,
                "tol": (f"{TOL_BWD_HYBRID} of the largest reference value"
                        if hybrid else TOL_BWD_F32)}
        w64 = None
        if not hybrid:
            # the class's own accuracy: the kernels (and, for the record,
            # their plain version) against f64, within TOL_BWD_F32
            w64 = f64_grads(q, k, v, do, dlse, causal)
            for who, gs in (("kernel", (dq, dk, dv)), ("plain", want)):
                brow[f"max_abs_err_{who}_vs_f64"] = max(
                    (g.double() - w).abs().max().item()
                    for g, w in zip(gs, w64))
                brow[f"f64_ratio_{who}"] = max(
                    f64_ratio(g, w, TOL_BWD_F32) for g, w in zip(gs, w64))
            brow["tol_vs_f64"] = (f"{TOL_BWD_F32} absolute; the ratios "
                                  f"are of {TOL_BWD_F32} absolute plus "
                                  "relative")
            if brow["max_abs_err_kernel_vs_f64"] > TOL_BWD_F32:
                brow["ok"] = bok = False
        del want
        timed = name in ("slice_causal", "bench_causal_hybrid")
        brow["fused"] = fused_case(
            (q, k, v, o, lse, do, causal, hybrid, dlse), (dq, dk, dv), bq,
            w64 if with_dlse else None,
            sdpa_grads(q, k, v, do, causal) if timed else None)
        del w64, dq, dk, dv
        for which in ("dkv", "dq"):
            kms = time_ms(lambda: attn.flash_attention_bwd(
                *call, dlse=dlse, only=which))
            kops, kbytes, split_bytes = attn_bwd_work(which, b, s, dh,
                                                      causal, plan.parts)
            # the rate of the class's route
            kb, kby = bound_ms(kops, kbytes, bwd_peak(plan.parts))
            brow[which] = {"ms": kms, "gflop": kops / 1e9,
                           "mbytes": kbytes / 1e6,
                           "tflops": kops / kms / 1e9, "bound_ms": kb,
                           "bound_by": kby}
        if timed:
            # the backward's launches apart: each kernel alone on prepared
            # operands, the f32 class's split, and the whole call (delta,
            # the split or the casts, both kernels)
            args = attn._prepare_bwd(q, k, v, o, lse, do, causal, hybrid,
                                     dlse)
            for which in ("dkv", "dq"):
                brow[which]["kernel_ms"] = time_ms(
                    lambda: attn._launch_bwd(which, *args))
            del args
            brow["ms"] = time_ms(lambda: attn.flash_attention_bwd(
                *call, dlse=dlse))
            if plan.parts == 3:
                qscale = attn.LOG2E / math.sqrt(dh)
                brow["split_ms"] = time_ms(lambda: attn._split_bwd(
                    q, k, v, do, qscale))
                brow["split_bound_ms"] = split_bytes / PEAK_BYTES * 1e3
            brow["kernels_and_split_ms"] = (brow["dkv"]["kernel_ms"]
                                            + brow["dq"]["kernel_ms"]
                                            + brow.get("split_ms", 0.0))
        if name == "slice_causal":
            row["plain_ms"] = time_ms(
                lambda: attn.flash_attention_ref(q, k, v, causal), reps=10)
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            # the library through a 4-d [1, B*h, S, dh] call, forward and
            # f32 backward (the 3-d call may take another kernel)
            row["library_ms_4d"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
            brow["library_ms_4d"] = time_ms(sdpa_grads(
                q[None], k[None], v[None], do[None], causal))
            # the forward's two launches apart: the split, then the kernel
            # on its parts
            qscale = attn.LOG2E / math.sqrt(dh)
            row["split_ms"] = time_ms(lambda: attn._split_qkv(q, k, v,
                                                              qscale))
            parts = attn._split_qkv(q, k, v, qscale)
            row["kernel_ms"] = time_ms(lambda: attn._launch_fwd(
                *parts, causal, False))
            del parts
            # the plain backward and the library backward each give dq,
            # dk and dv in one pass: their times cover both kernels' work
            brow["plain_ms"] = time_ms(
                lambda: attn.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     causal), reps=10)
            brow["library_ms"] = time_ms(sdpa_grads(q, k, v, do, causal))
            main["flash_fwd"] = dict(
                row, max_abs_err=max(err_o, err_l))
            common_bwd = {key: brow[key] for key in (
                "plain_ms", "library_ms", "library_ms_4d", "shape", "route",
                "split_ms", "split_bound_ms", "f64_ratio_kernel",
                "kernels_and_split_ms")}
            common_bwd["ms_whole_backward"] = brow["ms"]
            main["flash_bwd_dkv"] = dict(
                brow["dkv"], max_abs_err=max(errs["dk"], errs["dv"]),
                **common_bwd)
            main["flash_bwd_dq"] = dict(
                brow["dq"], max_abs_err=errs["dq"], **common_bwd)
        if name == "bench_causal_hybrid":
            # the hybrid forward's kernel alone, on the wrapper's casts,
            # and the library on bf16 operands through a 4-d call
            bf = torch.bfloat16
            qh, kh, vh = ((q * (attn.LOG2E / math.sqrt(dh))).to(bf),
                          k.to(bf), v.to(bf))
            row["kernel_ms"] = time_ms(lambda: attn._launch_fwd(
                qh, kh, vh, causal, True))
            row["library_bf16_ms_4d"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    *(x.to(bf)[None] for x in (q, k, v)), is_causal=causal))
            del qh, kh, vh
            main["flash_fwd_hybrid"] = {key: row[key] for key in (
                "shape", "ms", "kernel_ms", "bound_ms", "bound_by",
                "library_bf16_ms_4d", "max_abs_err_o", "max_abs_err_lse")}
            main["flash_bwd_fused"] = dict(
                brow["fused"], shape=[b, s, dh],
                max_abs_err=max(brow["fused"]["max_abs_err"].values()))
            # the hybrid backward beside the library's bf16 backward
            # through a 4-d call (timed by the fused case)
            main["flash_bwd_hybrid"] = {
                which: dict(brow[which], shape=[b, s, dh],
                            ms_whole_backward=brow["ms"],
                            library_bf16_ms_4d=brow["fused"][
                                "library_bf16_ms"])
                for which in ("dkv", "dq")}
        rows.append(row)
        bwd_rows.append(brow)
        if not ok:
            failed.append("flash_fwd " + name)
        if not bok:
            failed.append("flash_bwd " + name)
        if not brow["fused"]["ok"]:
            failed.append("flash_bwd_fused " + name)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    # the gate: a head dim the kernels are not compiled for takes the
    # einsum path on the card and launches nothing
    from tensorforth_tpu_torch.nn import funcs
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 512, 384).astype(np.float32)).cuda()
    before = flash_counts()
    gate_ok = (torch.equal(funcs.sdpa(x, x, x, True),
                           funcs._sdpa_ref(x, x, x, True))
               and flash_counts() == before)
    if not gate_ok:
        failed.append("sdpa gate at dh=384")
    common = {"phase": "kernel", "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
              "peak_tb_s": PEAK_BYTES / 1e12}
    emit(dict(common, kernel="flash_fwd", cases=rows,
              peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
              precision="bf16 wgmma, f32 sums: f32 class six products of a "
                        "three-part split (bound at a sixth of the bf16 "
                        "rate), hybrid one product",
              dh384_takes_the_einsum_path=gate_ok))
    emit(dict(common, kernel="flash_bwd (dkv, dq) and flash_bwd_fused",
              cases=bwd_rows, peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
              precision="dkv, dq: bf16 wgmma, f32 sums: f32 class six "
                        "products of a three-part split (bound at a sixth "
                        "of the bf16 rate), hybrid one product; dh 256 in "
                        "the f32 class f32 FMA on the CUDA cores",
              fused_precision="hybrid: bf16 wgmma, f32 sums (bound at the "
                              "bf16 rate); f32: f32 FMA on CUDA cores",
              plain_and_library_ms="one pass that gives dq, dk and dv: "
                                   "both kernels' work, and the fused "
                                   "kernel's with its sums"))
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    return main


def gemm_cases(m, k, n):
    """(case, kernel name, wrapper call, plain call, held against f64?,
    tolerance, peak rate, operand bytes per element) for one shape"""
    from tensorforth_tpu_torch.ops import gemm
    scale = 1.0 / max(m, k, n)
    return [
        ("default", "mm_f32io", lambda a, b: gemm._mm(a, b, prec="default"),
         lambda a, b: gemm._mm_ref(a, b, prec="default"), False,
         TOL_GEMM_BF16, PEAK_BF16_FLOPS, 4),
        ("3pass", "mm_f32io", lambda a, b: gemm._mm(a, b, prec="3pass"),
         lambda a, b: gemm._mm_ref(a, b, prec="3pass"), True,
         TOL_GEMM_3PASS, PEAK_BF16_FLOPS / 3, 4),
        ("highest", "mm_f32io", lambda a, b: gemm._mm(a, b, prec="highest"),
         lambda a, b: gemm._mm_ref(a, b, prec="highest"), True,
         TOL_GEMM_HIGHEST, PEAK_BF16_FLOPS / 6, 4),
        ("bf16", "mm_bf16", lambda a, b: gemm._mm(a, b, bf16=True),
         lambda a, b: gemm._mm_ref(a, b, bf16=True), False,
         TOL_GEMM_BF16, PEAK_BF16_FLOPS, 4),
        ("v8", "mm_v8", lambda a, b: gemm._mm_v8(a, b, scale),
         lambda a, b: gemm._mm_v8_ref(a, b, scale), False,
         TOL_GEMM_BF16, PEAK_BF16_FLOPS, 2),
        ("db", "mm_db", gemm._mm_db, gemm._mm_db_ref, False,
         TOL_GEMM_BF16, PEAK_BF16_FLOPS, 4),
    ]


def bf16_library():
    """the one PyTorch call that multiplies bf16 operands: with an f32
    result where this PyTorch has it, else with a bf16 result"""
    import torch
    x = torch.ones(16, 16, dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return "torch.matmul (bf16 result)", torch.matmul
    return ("torch.mm(out_dtype=float32)",
            lambda a, b: torch.mm(a, b, out_dtype=torch.float32))


def round_case(a, b, parts: int, timed: bool):
    """K5a's rounding pass against its plain version, bit for bit (the
    same rounding to nearest even of the same f32 values, the same exact
    or flushing subtractions, zeros in the padding): 1 part, 2 (3pass) or
    3 (highest); with its times when `timed`"""
    import torch
    from tensorforth_tpu_torch.ops import gemm
    got = gemm._round(a, b, parts=parts)
    torch.cuda.synchronize()
    want = gemm._round_ref(a, b, parts=parts)
    same = all(g.shape == w.shape and torch.equal(
        g.view(torch.int16), w.view(torch.int16)) for g, w in zip(got, want))
    err = max(torch.where(g.view(torch.int16) == w.view(torch.int16), 0.0,
                          (g.float() - w.float()).abs()).max().item()
              for g, w in zip(got, want) if g.shape == w.shape)
    (m, k), n = a.shape, b.shape[1]
    nbytes = (m * k + k * n) * 4 + sum(g.numel() for g in got) * 2
    row = {"parts": parts, "shape": [m, k, n], "bit_equal": same,
           "max_abs_err": err, "mbytes": nbytes / 1e6}
    if timed:
        row["ms"] = time_ms(lambda: gemm._round(a, b, parts=parts))
        row["plain_ms"] = time_ms(
            lambda: gemm._round_ref(a, b, parts=parts), reps=10)
        row["bound_ms"], row["bound_by"] = bound_ms(0, nbytes)
        row["library_ms"] = None
    return row


ROUNDING_CORNERS = ("ties", "signed_zeros", "subnormals", "large", "random")


def rounding_corners(kind: str, shape, seed: int = 0) -> np.ndarray:
    """f32 values at one family of corners of rounding to bf16 (the tests
    of the rounding pass's plain version take them too): exact ties of
    either parity, signed zeros, f32 subnormals, values up to f32's
    largest (some round to inf), every exponent f32 has; or "mixed", all
    of them"""
    rs = np.random.RandomState(seed)
    size = int(np.prod(shape))
    sign = np.where(rs.rand(size) < 0.5, -1.0, 1.0).astype(np.float32)
    if kind == "mixed":
        every = [rounding_corners(k, (size,), seed + i)
                 for i, k in enumerate(ROUNDING_CORNERS)]
        return np.choose(rs.randint(0, len(every), size),
                         every).reshape(shape)
    if kind == "ties":
        top = rs.randint(0x0080, 0x7F00, size).astype(np.uint32)
        x = ((top << 16) | 0x8000).view(np.float32) * sign
    elif kind == "signed_zeros":
        x = np.where(rs.rand(size) < 0.5, -0.0, 0.0).astype(np.float32)
        x[::3] = 1.0
    elif kind == "subnormals":       # and the smallest normals
        bits = rs.randint(1, 0x00800000, size).astype(np.uint32)
        x = bits.view(np.float32) * sign
        x[::4] = np.float32(1.1754944e-38) * sign[::4]
    elif kind == "large":
        big = np.finfo(np.float32).max
        x = (big * rs.uniform(0.9, 1.0, size)).astype(np.float32) * sign
    elif kind == "random":
        x = (rs.standard_normal(size) * 10.0 ** rs.uniform(-37, 37, size)
             ).astype(np.float32)
    else:
        raise ValueError(kind)
    return x.astype(np.float32).reshape(shape)


def phase_kernel_gemm(seed: int):
    """the GEMM kernels (K5a in its three classes, with its rounding pass)
    against their plain versions at the words' shapes, and K5b and K7
    against K5a class default and K6 at 4096^3; returns each kernel's
    record at 4096^3 (K5a: class default, its time with its rounding
    pass)"""
    import torch
    from tensorforth_tpu_torch.ops import gemm
    lib_name, lib_bf16 = bf16_library()
    gemm.reset_launches()
    rows, rounds, failed, main = [], [], [], {}
    same_fn = {}        # class default, K6 (scale undone), K5b, K7 at 4096^3
    highest = {}        # class highest's record at 4096^3
    for i, (m, k, n) in enumerate(GEMM_SHAPES):
        rs = np.random.RandomState(seed + 100 + i)
        a = torch.from_numpy(rs.standard_normal((m, k)).astype(
            np.float32)).cuda()
        b = torch.from_numpy(rs.standard_normal((k, n)).astype(
            np.float32)).cuda()
        ref64 = a.double() @ b.double()
        top = ref64.abs().max().item()
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        lib_ms = {4: time_ms(lambda: torch.matmul(a, b)),
                  2: time_ms(lambda: lib_bf16(a16, b16))}
        # the same function from the f32 operands: the two casts and the
        # bf16 product
        lib_cast_ms = time_ms(lambda: lib_bf16(a.to(torch.bfloat16),
                                               b.to(torch.bfloat16)))
        for (case, name, run, plain, vs_f64, tol, peak,
             elem) in gemm_cases(m, k, n):
            got = run(a, b)
            torch.cuda.synchronize()
            want = plain(a, b)
            err_plain = (got - want).abs().max().item()
            scale = 1.0 / max(m, k, n) if case == "v8" else 1.0
            err_f64 = (got.double() - ref64 * scale).abs().max().item()
            held = err_f64 / scale if vs_f64 else err_plain / scale
            ok = (held <= tol * top and bool(torch.isfinite(got).all())
                  and tuple(got.shape) == (m, n))
            ms = time_ms(lambda: run(a, b))
            ops = 2 * m * n * k
            nbytes = (m * k + k * n) * elem + m * n * 4
            bms, by = bound_ms(ops, nbytes, peak)
            row = {"kernel": name, "case": case, "shape": [m, k, n],
                   "max_abs_err": err_plain, "max_abs_err_vs_f64": err_f64,
                   "largest_f64_value": top, "tol": tol,
                   "held_against": "f64" if vs_f64 else "plain version",
                   "ok": ok, "ms": ms, "plain_ms": time_ms(
                       lambda: plain(a, b), reps=10),
                   "library_ms": lib_ms[2 if case in ("bf16", "v8", "db",
                                                      "default") else 4],
                   "tflops": ops / ms / 1e9, "bound_ms": bms,
                   "bound_by": by}
            if elem == 4 and case in ("default", "bf16", "db"):
                row["library_ms_with_casts"] = lib_cast_ms
            rows.append(row)
            if not ok:
                failed.append(f"{name} {case} {m}x{k}x{n}")
            if (m, k, n) == GEMM_MAIN and case not in ("3pass", "highest"):
                main[name] = dict(row)
            if (m, k, n) == GEMM_MAIN and case == "highest":
                highest = dict(row)
            if (m, k, n) == GEMM_MAIN and case in ("default", "v8", "bf16",
                                                   "db"):
                same_fn[case] = got / scale
            del got
        for parts in (1, 2, 3):
            rounds.append(round_case(a, b, parts, (m, k, n) == GEMM_MAIN))
            if not rounds[-1]["bit_equal"]:
                failed.append(f"mm_round parts={parts} {m}x{k}x{n}")
        if (m, k, n) == GEMM_MAIN:
            # K5b and K7 round inside one launch what K5a class default
            # rounds in its pass and K6's wrapper casts: the same bf16
            # values through wgmma in the same k order, so the same sums
            for case in ("bf16", "db"):
                for other in ("default", "v8"):
                    diff = same_fn[case] - same_fn[other]
                    err = diff.abs().max().item()
                    rec = {"max_abs_err": err, "tol": TOL_GEMM_BF16,
                           "largest_f64_value": top,
                           "bit_equal": bool(torch.equal(same_fn[case],
                                                         same_fn[other])),
                           "elements_that_differ": int((diff != 0).sum()),
                           "ok": err <= TOL_GEMM_BF16 * top}
                    same_fn[f"{case}_vs_{other}"] = rec
                    if not rec["ok"]:
                        failed.append(f"{case} against {other} at 4096^3")
            for case in ("default", "v8", "bf16", "db"):
                del same_fn[case]
            r0, r1, r2 = rounds[-3:]
            main["mm_round"] = dict(r0, split_ms=r1["ms"],
                                    split3_ms=r2["ms"],
                                    split3_bound_ms=r2["bound_ms"])
            main["mm_f32io"]["rounding_pass_ms"] = r0["ms"]
            highest["split3_pass_ms"] = r2["ms"]
            main["mm_f32io"]["ms_includes_rounding_pass"] = True
            for name in ("mm_bf16", "mm_db"):    # the placement they replace
                main[name]["k5a_default_with_pass_ms"] = main["mm_f32io"][
                    "ms"]
        del a, b, a16, b16, ref64
        torch.cuda.empty_cache()
    # the rounding pass on the corners of rounding, bit for bit
    a, b = (torch.from_numpy(rounding_corners("mixed", sh, seed + i)).cuda()
            for i, sh in enumerate(((300, 260), (260, 203))))
    for parts in (1, 2, 3):
        rounds.append(dict(round_case(a, b, parts, False), corners=True))
        if not rounds[-1]["bit_equal"]:
            failed.append(f"mm_round parts={parts} on rounding corners")
    # class highest on the words' all-positive `rand` operands at K 4096,
    # against f64 (on same-sign sums the tensor cores' truncation has one
    # sign), and the launches of one call: its pass and its kernel
    rs = np.random.RandomState(seed + 98)
    a, b = (torch.from_numpy(rs.rand(*GEMM_MAIN[:2]).astype(
        np.float32)).cuda() for _ in range(2))
    before = dict(gemm.launches)
    got = gemm._mm(a, b, prec="highest")
    torch.cuda.synchronize()
    one_call = {nm: gemm.launches[nm] - before[nm] for nm in GEMM_NAMES}
    ref64 = a.double() @ b.double()
    top = ref64.abs().max().item()
    err = (got.double() - ref64).abs().max().item()
    highest["rand_operands"] = {
        "shape": list(GEMM_MAIN), "max_abs_err_vs_f64": err,
        "largest_f64_value": top, "tol": TOL_GEMM_HIGHEST,
        "ok": err <= TOL_GEMM_HIGHEST * top, "launches_of_one_call": one_call}
    if not highest["rand_operands"]["ok"]:
        failed.append("highest on all-positive rand at 4096^3")
    if one_call != dict(dict.fromkeys(GEMM_NAMES, 0), mm_f32io=1,
                        mm_round=1):
        failed.append(f"highest launches {one_call}")
    del a, b, got, ref64
    main["mm_f32io"]["highest"] = {key: highest[key] for key in (
        "ms", "split3_pass_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "tflops", "max_abs_err_vs_f64", "largest_f64_value",
        "rand_operands")}
    # transposed operands (the words' ta / tb) and the alpha/beta epilogue
    rs = np.random.RandomState(seed + 99)
    at, bt, c = (torch.from_numpy(rs.standard_normal(sh).astype(
        np.float32)).cuda() for sh in ((300, 200), (260, 300), (200, 260)))
    for variant in (2, 3, 4):
        got = gemm.gemm(at, bt, c, 0.5, 2.0, ta=True, tb=True,
                        variant=variant)
        want = 0.5 * gemm._mm_ref(at.T, bt.T) + 2.0 * c
        if (got - want).abs().max().item() > TOL_GEMM_BF16 * \
                want.abs().max().item():
            failed.append(f"gemm variant {variant} with ta, tb")
    emit({"phase": "kernel", "kernel": "gemm (mm_f32io, mm_bf16, mm_v8, "
          "mm_db, mm_round)", "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
          "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
          "peak_tb_s": PEAK_BYTES / 1e12,
          "bound": "2mnk over the dense bf16 tensor-core rate (3pass: "
                   "three products; highest: six), or the bytes over the "
                   "memory rate",
          "library": {"f32 classes": "torch.matmul, TF32 off",
                      "bf16 classes": lib_name,
                      "with_casts": "the same call after x.to(bfloat16) of "
                                    "both f32 operands (f32-operand cases)"},
          "cases": rows, "rounding_pass": rounds,
          "k5b_and_k7_against_k5a_default_and_k6_at_4096": same_fn,
          "launches": dict(gemm.launches)})
    if failed:
        raise RuntimeError(f"GEMM kernels disagree: {failed}")
    return main


def repl(device=None, seed=0):
    """a fresh REPL of the port writing to a buffer: (instance, run)"""
    from tensorforth_tpu_torch.cli import TensorForth
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device=device)
    inst.sys.seed(seed)

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    return inst, run


def matrices_after(out: str, marker: str):
    """rows of numbers of the first matrix printed after `marker`"""
    body = out[out.index(marker) + len(marker):]
    body = body[body.index("] = {") + 5:]
    body = body[:body.index("} }")]
    return [[float(x) for x in re.findall(r"[-+]\d+\.\d+", ln)]
            for ln in body.strip().splitlines()]


def phase_tensor(seed: int, device=None, big=(4096, 2048), n_linalg=1024,
                 cycles=999, script_dir="examples"):
    """the tensor tier through the REPL: returns the GEMM kernels'
    launches on this path"""
    import torch
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.ops import gemm
    on_card = device is None or torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    checks, transcripts = {}, []
    gemm.reset_launches()        # every count to 0 just before the path

    # --- (a) examples/t4_20a.4th, whole
    inst, run = repl(device, seed)
    with open(os.path.join(script_dir, "t4_20a.4th")) as f:
        lines = [ln.rstrip("\n").replace("999 mx", f"{cycles} mx")
                 for ln in f]
    out = []
    for ln in lines:
        out.append(run(ln))
        if not inst.more_job():
            break
    out = "".join(out)
    transcripts.append(out)
    checks["t4_20a_ran_to_bye"] = not inst.more_job()
    checks["t4_20a_verify_lines"] = all(
        matrices_after(out, marker) == want for marker, want in (
            ("verify { { 6 6 } { 15 15 } }", [[6.0, 6.0], [15.0, 15.0]]),
            ("= {{2 3 4}{5 6 7}}", [[2.0, 3.0, 4.0], [5.0, 6.0, 7.0]]),
            ("= {{0 1 2}{3 4 5}}", [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]),
            ("verify = { { 6 6 } { 9 9 } }", [[6.0, 6.0], [9.0, 9.0]]),
            ("verify = { { 3 3 } { 4.5 4.5 } }", [[3.0, 3.0], [4.5, 4.5]])))
    checks["t4_20a_inverse_round_trip_prints_identity"] = (
        matrices_after(out, "### verify M*M^-1 = I")
        == [[float(i == j) for j in range(4)] for i in range(4)])
    mx_ms = float(re.search(r"=> (\S+)  msec/cycle", out).group(1))
    inst.teardown()

    # --- (b) the larger word loop, 1000 x [1024,2048] @ [2048,512], and
    #     t4_20a's own loop once more after a warm-up (its first run pays
    #     for the allocator's first 1000 results)
    inst, run = repl(device, seed)
    transcripts.append(run(
        "0 trace\n"
        ': mxl dup >r clock >r for @ drop next clock r> - r> 1+ / '
        '." => " . ."  msec/cycle" cr ;'))
    loops = {}
    for name, operands in (
            ("mx_warm", "512 1024 matrix rand 1024 256 matrix ones"),
            ("mxl", "1024 2048 matrix rand 2048 512 matrix ones")):
        transcripts.append(run(f"{operands}\n99 mxl"))
        loops[name] = []
        for _ in range(3):
            out = run(f"{cycles} mxl")
            transcripts.append(out)
            loops[name].append(float(re.search(r"=> (\S+) ", out).group(1)))
        if name != "mxl":
            transcripts.append(run("drop drop"))
    samples = loops["mxl"]
    mxl_ms = statistics.median(samples)
    prof = profile_run(lambda: run("99 mxl"), "cuda" if on_card else "cpu",
                       mxl_ms * 100)
    inst.teardown()

    # --- (c) gemm .. gemm4 at 4096^3 and 2048^3, fast and strict
    words, wrappers = [], []
    expect = {name: 0 for name in GEMM_NAMES}
    keep_precision = Config.PRECISION
    for size in big:
        inst, run = repl(device, seed)
        transcripts.append(run(
            f"1.0 0.0 {size} {size} matrix rand {size} {size} matrix rand "
            f"{size} {size} matrix zeros"))
        A, B = (inst.sys.mu.du2obj(inst.vm.ss[i]).ensure_data()
                for i in (-2, -1))
        for precision in ("fast", "strict"):
            Config.PRECISION = precision
            base = None
            for variant in range(5):
                word = "gemm" + (str(variant) if variant else "")
                before = dict(gemm.launches)
                times = []
                for _ in range(WORD_REPS):
                    sync()
                    t0 = time.perf_counter()
                    transcripts.append(run(word))
                    sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                    got = inst.vm.TTOS().ensure_data().clone()
                    transcripts.append(run("drop"))
                ms = statistics.median(times)
                delta = {nm: gemm.launches[nm] - before[nm]
                         for nm in GEMM_NAMES}
                want_delta = {nm: 0 for nm in GEMM_NAMES}
                if variant in (2, 3) and on_card:    # the CPU launches none
                    want_delta["mm_f32io"] = WORD_REPS  # and its rounding
                    want_delta["mm_round"] = WORD_REPS  # pass, each time
                elif variant == 4 and on_card:
                    want_delta["mm_v8"] = WORD_REPS
                for nm in GEMM_NAMES:
                    expect[nm] += want_delta[nm]
                if variant == 0:
                    base, top = got, got.abs().max().item()
                    err, tol, err_plain = 0.0, 0.0, None
                else:
                    err = (got - base).abs().max().item() / top
                    bf16_class = variant == 4 or (variant >= 2
                                                  and precision == "fast")
                    tol = (TOL_WORD_BF16 if bf16_class else
                           TOL_GEMM_3PASS if variant >= 2 else 1e-6)
                    err_plain = None
                    if variant >= 2:     # and against its plain version
                        plain = (gemm._mm_v8_ref(A, B, 1.0) if variant == 4
                                 else gemm._mm_ref(A, B, prec=gemm.prec_class()))
                        err_plain = (got - plain).abs().max().item() / top
                        del plain
                ok = (delta == want_delta and err <= tol and (
                    err_plain is None or err_plain <= TOL_WORD_PLAIN))
                words.append({"word": word, "size": size,
                              "precision": precision, "ms": ms,
                              "ms_samples": times,
                              "launches": delta,
                              "rel_err_vs_gemm": err, "tol": tol,
                              "rel_err_vs_plain_version": err_plain,
                              "tol_vs_plain_version": TOL_WORD_PLAIN,
                              "ok": ok})
                del got
            del base
        Config.PRECISION = keep_precision
        # K5b and K7 through their wrappers, on the words' operands: no
        # word reaches them in either package
        base = gemm._mm_ref(A, B)
        top = base.abs().max().item()
        for nm, call in (("mm_bf16", lambda: gemm._mm(A, B, bf16=True)),
                         ("mm_db", lambda: gemm._mm_db(A, B))):
            before = gemm.launches[nm]
            sync()
            t0 = time.perf_counter()
            got = call()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            err = (got - base).abs().max().item() / top
            n_launched = gemm.launches[nm] - before
            expect[nm] += 1 if on_card else 0
            wrappers.append({"wrapper": nm, "size": size, "ms": ms,
                             "launches": n_launched,
                             "rel_err_vs_plain_version": err,
                             "tol": TOL_WORD_PLAIN,
                             "ok": err <= TOL_WORD_PLAIN and n_launched == (
                                 1 if on_card else 0)})
            del got
        del A, B, base
        inst.teardown()
        if on_card:
            torch.cuda.empty_cache()
    checks["gemm_words"] = all(w["ok"] for w in words)
    checks["gemm_wrappers_no_word_reaches"] = all(w["ok"] for w in wrappers)

    # --- (d) inverse, plu, det, solve on a well-conditioned matrix
    n = n_linalg
    inst, run = repl(device, seed)
    transcripts.append(run(
        f"{n} {n} matrix randn 0.001 *= {n} {n} matrix eye +="))
    A = inst.vm.TTOS().ensure_data().clone()
    eye = torch.eye(n, device=A.device)
    transcripts.append(run("inverse"))                 # ( A A' )
    inv = inst.vm.TTOS().ensure_data().clone()
    transcripts.append(run("@"))                       # ( A A' A@A' )
    inv_err = (inst.vm.TTOS().ensure_data() - eye).abs().max().item()
    transcripts.append(run("drop drop plu"))           # ( A P LU )
    lu = inst.vm.TTOS().ensure_data().clone()
    P = inst.vm.TNOS().ensure_data().clone()
    plu_err = (P @ (torch.tril(lu, -1) + eye) @ torch.triu(lu)
               - A).abs().max().item()
    out = run("drop drop det .")
    transcripts.append(out)
    det = float(out.split()[0])
    sign, logdet = torch.linalg.slogdet(A.double())
    det64 = (sign * torch.exp(logdet)).item()
    transcripts.append(run(f"{n} vector rand swap solve"))   # ( B A X )
    X = inst.vm.TTOS().ensure_data()
    Bv = inst.sys.mu.du2obj(inst.vm.ss[-2]).ensure_data()
    solve_err = (A @ X - Bv).abs().max().item()
    checks["inverse_residual"] = inv_err <= TOL_LINALG
    checks["plu_reconstructs"] = plu_err <= TOL_LINALG
    checks["det_matches_f64"] = abs(det - det64) <= 1e-3 * abs(det64)
    checks["solve_residual"] = solve_err <= TOL_LINALG
    del inv
    inst.teardown()

    launches = dict(gemm.launches)   # read just after the path
    checks["launch_counts_exact"] = launches == expect
    noisy = [ln for t in transcripts for ln in t.splitlines()
             if "ERROR" in ln or "WARN" in ln]
    checks["no_ERROR_or_WARN_in_a_transcript"] = not noisy
    emit({"phase": "tensor", "sizes": {"gemm_words": list(big),
                                       "linalg": n, "cycles": cycles + 1},
          "mx_msec_per_cycle": mx_ms,
          "mx_warm_msec_per_cycle": statistics.median(loops["mx_warm"]),
          "mx_warm_samples": loops["mx_warm"],
          "mxl_msec_per_cycle": mxl_ms, "mxl_samples": samples,
          "mxl_profile_100_cycles": prof, "words": words,
          "wrappers_no_word_reaches": wrappers,
          "linalg": {"inverse_max_abs_residual": inv_err,
                     "plu_max_abs_residual": plu_err, "det": det,
                     "det_f64": det64, "solve_max_abs_residual": solve_err,
                     "tol": TOL_LINALG},
          "launches": launches, "expected_launches": expect,
          "noisy_lines": noisy[:5], "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"tensor checks failed: {bad}")
    return launches


def replay_check(m, out, device, lm, n_prompt):
    """teacher-forced replay: the argmax of the full forward over the
    generated sequence at each decoded position must be the token that
    followed it.  Returns (checked, flips above MARGIN, ties below it)."""
    import torch
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.weights import load_jax_params
    n, s = out.shape
    m2 = tiny_lm(seq=s, device=device, **lm)   # _program() carries S
    load_jax_params(m2, m._params())
    x = torch.as_tensor(out, dtype=torch.float32,
                        device=device).reshape(n, s, 1, 1)
    outs, _ = funcs.forward_pure(m2._program(), x, m2._params())
    logits = outs[-2].reshape(n, s, -1)[:, n_prompt - 1:s - 1]
    top2 = torch.topk(logits, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    want = torch.argmax(logits, dim=-1).cpu().numpy()
    got = out[:, n_prompt:]
    flip = want != got
    return (int(flip.size), int((flip & (margin >= MARGIN)).sum()),
            int((margin < MARGIN).sum()))


def profile_run(fn, device, wall_ms):
    """one fn() under torch.profiler: the device's busy time by kernel
    (the top 8, the flash kernels' and the device-to-device copies'), and
    the idle share of `wall_ms`, the same call's median time without the
    profiler"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        fn()
        if on_card:
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():      # kernels only, not the host ops
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            by_name[e.key] = by_name.get(e.key, 0) + (
                e.self_device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_idle_share": (1 - busy_ms / wall_ms
                                 if busy_ms > 0 else None),
           "kernel_launches": sum(e.count for e in prof.key_averages()
                                  if e.device_type == DeviceType.CUDA)}
    for nm in FLASH_NAMES + ("Memcpy DtoD",):
        out[nm.replace(" ", "_").lower() + "_ms"] = sum(
            v for k, v in by_name.items() if nm in k)
    out["top_kernels_ms"] = [[k[:80], v] for k, v in top]
    return out


def profile_generate(m, prompt, n_new, device, wall_ms):
    from tensorforth_tpu_torch.nn.serve import generate
    return profile_run(lambda: generate(m, prompt, n_new, temp=0.0), device,
                       wall_ms)


def phase_serve(seed: int, device="cuda", lm=LM, n_prompt=N_PROMPT,
                n_new=N_NEW, expect_launches=None):
    """the main path: returns the flash forward's launches in it, and its
    split's (the f32 class splits before each launch)"""
    import torch
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.ops import attn
    from tensorforth_tpu_torch.system import System

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    System.get_sys().seed(seed)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    m = tiny_lm(seq=n_prompt, device=device, **lm)
    n = lm["batch"]
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (n, n_prompt))
    # --- the main path, counted: every count to 0 just before, read after
    reset_flash_counts()
    t0 = time.perf_counter()
    out = generate(m, prompt, n_new, temp=0.0)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    l_f32 = attn.flash_attention.launches
    out8 = generate(m, prompt, n_new, temp=0.0, kv_dtype="int8")
    sync()
    launches = attn.flash_attention.launches
    split = attn.flash_attention.split_launches
    l_int8 = launches - l_f32

    checks = {}
    for nm, o in (("f32", out), ("int8", out8)):
        checks[f"{nm}_shape"] = o.shape == (n, n_prompt + n_new)
        checks[f"{nm}_prompt_kept"] = bool((o[:, :n_prompt] == prompt).all())
        checks[f"{nm}_ids_in_vocab"] = bool(((o >= 0) & (o < lm["vocab"]))
                                            .all())
    if expect_launches is not None:
        checks["launches_per_generate"] = (l_f32 == expect_launches
                                           and l_int8 == expect_launches)
    checks["split_before_each_launch"] = split == launches
    checked, flips, ties = replay_check(m, out, device, lm, n_prompt)
    checks["replay_tokens"] = flips == 0
    int8_agree = float((out8[:, n_prompt:] == out[:, n_prompt:]).mean())

    # --- timings (after the counted run)
    pre, tot = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        generate(m, prompt, 0, temp=0.0)
        sync()
        pre.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        generate(m, prompt, n_new, temp=0.0)
        sync()
        tot.append((time.perf_counter() - t0) * 1e3)
    prefill_ms, total_ms = statistics.median(pre), statistics.median(tot)
    decode_s = (total_ms - prefill_ms) / 1e3
    prof = {"prefill": profile_generate(m, prompt, 0, device, prefill_ms),
            "generate": profile_generate(m, prompt, n_new, device,
                                         total_ms)}
    emit({"phase": "serve", "model": dict(lm, n_prompt=n_prompt,
                                          n_new=n_new),
          "launches_f32": l_f32, "launches_int8": l_int8,
          "split_launches": split,
          "replay_checked": checked, "replay_flips": flips,
          "replay_ties_below_margin": ties, "margin": MARGIN,
          "int8_token_agreement": int8_agree,
          "first_generate_ms": first_ms, "prefill_ms": prefill_ms,
          "total_ms_per_generate": total_ms,
          "decode_tokens_per_s": (n * n_new / decode_s if decode_s > 0
                                  else None),
          "timing_samples": {"prefill_ms": pre, "total_ms": tot},
          "profile": prof, "peak_mem_gb": (
              torch.cuda.max_memory_allocated() / 1e9
              if torch.device(device).type == "cuda" else None),
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"serve checks failed: {bad}")
    return {"flash_fwd": launches, "flash_fwd_split": split}


def flash_counts():
    from tensorforth_tpu_torch.ops import attn
    return {"flash_fwd": attn.flash_attention.launches,
            "flash_bwd_dkv": attn.flash_attention_bwd.launches["dkv"],
            "flash_bwd_dq": attn.flash_attention_bwd.launches["dq"]}


def probe_counts():
    from tensorforth_tpu_torch.ops import attn
    return {"flash_bwd_fused": attn.flash_attention_bwd_fused.launches,
            "attn_dots": attn.attn_dots.launches}


def reset_flash_counts():
    from tensorforth_tpu_torch.ops import attn
    attn.flash_attention.launches = 0
    attn.flash_attention.split_launches = 0
    attn.flash_attention_bwd.launches = {"dkv": 0, "dq": 0}
    attn.flash_attention_bwd.split_launches = 0
    attn.flash_attention_bwd_fused.launches = 0
    attn.attn_dots.launches = 0


def phase_train(seed: int, device="cuda", lm=LM, seq=N_PROMPT,
                steps=TRAIN_STEPS, expect_launches=None):
    """the training path: returns the flash kernels' launches in one
    step"""
    import torch
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.ntypes import Loss
    from tensorforth_tpu_torch.ops import attn
    from tensorforth_tpu_torch.system import System
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    System.get_sys().seed(seed)
    m = tiny_lm(seq=seq, device=device, **lm)
    n, vocab = lm["batch"], lm["vocab"]
    ids = np.random.RandomState(seed + 1).randint(0, vocab, (n, seq))
    mmu = MMU.get_mmu()
    inp = mmu.tensor(n, seq, 1, 1, device=device).set_numpy(
        ids.reshape(n, seq, 1, 1))
    hot = mmu.tensor(n, seq, vocab, 1, device=device).replace_data(
        funcs.onehot_fn(torch.from_numpy(np.roll(ids, -1, axis=1)).to(device),
                        vocab))

    def grads():
        return [(e["dw"]) for e in weights.dump_state(m)]

    # --- the step through the plain attention path: what the counted
    #     step's gradients are held against (its launches are not counted)
    m.forward(inp).backprop(hot, flash=False)
    want = grads()
    m.grad_zero()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # --- the main path, counted: every count to 0 just before, read after
    reset_flash_counts()
    t0 = time.perf_counter()
    m.forward(inp)
    losses = [m.loss(Loss.CE, hot)]
    m.backprop(hot)
    got = grads()
    m.adam(TRAIN_LR)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(flash_counts(),
                    flash_fwd_split=attn.flash_attention.split_launches,
                    flash_bwd_split=attn.flash_attention_bwd.split_launches)

    rel = [float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
           for g, w in zip(got, want)]
    checks = {"grads_match_plain_attention": max(rel) <= TOL_GRAD,
              "grads_nonzero": all(bool(w.any()) for w in want)}
    if expect_launches is not None:
        checks["launches_per_step"] = launches == expect_launches
    del got, want

    # --- timed steps, the host clock with a sync after each word
    def step(split=None):
        words = (("forward", lambda: m.forward(inp)),
                 ("loss", lambda: losses.append(m.loss(Loss.CE, hot))),
                 ("backprop", lambda: m.backprop(hot)),
                 ("optimizer", lambda: m.adam(TRAIN_LR)))
        for name, word in words:
            t0 = time.perf_counter()
            word()
            if split is not None:
                sync()
                split.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)

    split = {}
    for _ in range(steps):
        step(split)
    step_ms = [sum(ts) for ts in zip(*split.values())]
    med = statistics.median(step_ms)
    checks["losses_finite"] = all(math.isfinite(x) for x in losses)
    checks["loss_fell"] = losses[-1] < losses[0]
    n_timed = len(losses)
    prof = profile_run(step, device, med)
    del losses[n_timed:]               # the profiled step's loss
    emit({"phase": "train", "model": dict(lm, seq=seq),
          "optimizer": f"adam({TRAIN_LR})", "launches_per_step": launches,
          "max_rel_grad_err_vs_plain_attention": max(rel),
          "grad_tol": TOL_GRAD, "losses": losses,
          "first_step_ms": first_ms, "ms_per_step": med,
          "split_ms": {k: statistics.median(v) for k, v in split.items()},
          "trained_tokens_per_s": n * seq / med * 1e3,
          "timing_samples": dict(split, step_ms=step_ms),
          "profile": prof,
          "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None),
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"train checks failed: {bad}")
    return launches


def phase_attn_bench(seed: int, device=None, n_iter=BENCH_ITERS,
                     reps=BENCH_REPS, shapes=None, **size):
    """the attention measurement path through its four entry points;
    returns the five attention kernels' launches on it"""
    import torch
    from tensorforth_tpu_torch import attn_bench as ab
    from tensorforth_tpu_torch.ops import attn
    size = size or BENCH
    shapes = ab.SWEEP_SHAPES if shapes is None else shapes
    on_card = device is None or torch.device(device).type == "cuda"
    depth = dict(n_iter=n_iter, reps=reps, device=device)

    # --- the main path, counted: every count to 0 just before, read after
    reset_flash_counts()
    fwd = ab.bench_attention(**size, **depth)
    bwd = ab.bench_attention_bwd(**size, **depth)
    oracle = ab.bench_attention_oracle(**size, **depth)
    sweeps = ab.sweep_bwd_fused("all", shapes=shapes, dh=size["dh"], **depth)
    launches = dict(flash_counts(), **probe_counts())

    # a chain is n_iter calls; each candidate runs one warm chain and
    # `reps` timed ones.  bench_attention: K1 in two chains.
    # bench_attention_bwd: K1 once for (o, lse), then one split chain.
    # The oracle: a forward chain and a forward-plus-backward chain,
    # causal and not, then the probe's chain beside one more K1 chain.
    # The sweep, per record: K1 once, one split chain, one fused chain per
    # candidate.
    runs = (reps + 1) * n_iter
    n_fused = sum(len(r["blocks"]) for r in sweeps)
    expect = {"flash_fwd": 7 * runs + 1 + len(sweeps),
              "flash_bwd_dkv": (3 + len(sweeps)) * runs,
              "flash_bwd_dq": (3 + len(sweeps)) * runs,
              "flash_bwd_fused": n_fused * runs, "attn_dots": runs}
    if not on_card:
        expect = dict.fromkeys(expect, 0)     # the CPU launches none
    rates = ([x for d in (fwd, bwd) for xs in d.values() for x in xs]
             + [x for xs in oracle.values() for x in xs]
             + [x for r in sweeps for part in ("tflops", "vs_control")
                for xs in r[part].values() for x in xs])
    # every backward there is hybrid: no backward split
    bwd_splits = attn.flash_attention_bwd.split_launches
    checks = {"launch_counts_exact": launches == expect,
              "no_backward_split": bwd_splits == 0,
              "rates_finite_and_positive": all(
                  math.isfinite(x) and x > 0 for x in rates),
              "sweep_records": len(sweeps) == 2 * len(shapes)}

    # --- not counted: the fused kernel at every (shape, causal, bq) that
    #     the sweep launched it at, against its plain version (dq, both
    #     partials, the never-visited blocks), the split and itself again
    held = []
    for r in sweeps:
        b, s, causal = r["b"], r["s"], r["causal"]
        rs = np.random.RandomState(seed + s + causal)
        q, k, v, do = (torch.from_numpy(rs.randn(b, s, size["dh"]).astype(
            np.float32)).to(device or "cuda") for _ in range(4))
        o, lse = attn.flash_attention(q, k, v, causal=causal, hybrid=True)
        split = attn.flash_attention_bwd(q, k, v, o, lse, do, causal, True)
        for tag in r["blocks"]:
            row = fused_case((q, k, v, o, lse, do, causal, True, None), split,
                             int(tag.rsplit("=", 1)[1]), None, None,
                             timed=on_card)
            held.append(dict(row, b=b, s=s, causal=causal))
        del q, k, v, do, o, lse, split
    checks["fused_equals_plain_and_split_at_every_sweep_case"] = (
        len(held) == n_fused and all(h["ok"] for h in held))

    def med(d):
        return {k: statistics.median(v) for k, v in d.items()}

    emit({"phase": "attn_bench", "size": dict(size, n_iter=n_iter,
                                               reps=reps),
          "bench_attention_tflops": fwd, "bench_attention_bwd_tflops": bwd,
          "bench_attention_oracle": oracle,
          "sweep_bwd_fused": sweeps,
          "medians": {
              "bench_attention_tflops": med(fwd),
              "bench_attention_bwd_tflops": med(bwd),
              "library_over_ours_time": med(
                  {k: v for k, v in oracle.items()
                   if k.startswith(("fwd", "bwd"))}),
              "dots_only_tflops": statistics.median(
                  oracle["dots_only_tflops"]),
              "full_vs_dots_time_ratio": statistics.median(
                  oracle["full_vs_dots_time_ratio"]),
              "sweep": [{"b": r["b"], "s": r["s"], "causal": r["causal"],
                         "tflops": med(r["tflops"]),
                         "fused_over_split_rate": med(r["vs_control"]),
                         "blocks": r["blocks"],
                         "partial_bytes_written_and_read":
                             r["partial_bytes_written_and_read"]}
                        for r in sweeps]},
          "fused_vs_plain_and_split": held,
          "tol_fused_vs_plain": f"{TOL_BWD_HYBRID} of the largest reference "
                                "value",
          "launches": launches, "expected_launches": expect,
          "backward_split_launches": bwd_splits, "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"attn_bench checks failed: {bad}")
    return launches


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import tensorforth_tpu_torch  # noqa: F401  (TF32 off)
    seconds = {}

    def timed(phase, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        seconds[phase] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    rec = timed("kernel_flash", phase_kernel, args.seed)
    rec["attn_dots"] = timed("kernel_dots", phase_kernel_dots, args.seed)
    gemm_rec = timed("kernel_gemm", phase_kernel_gemm, args.seed)
    layers = LM["layers"]
    ran = dict(timed("serve", phase_serve, args.seed,
                     expect_launches=layers))
    # a step launches the forward kernel twice per attention layer (the
    # layer backward runs the layer forward again), each after its split
    # (the f32 class), and each backward kernel once, both after one split
    per_step = timed("train", phase_train, args.seed, expect_launches={
        "flash_fwd": 2 * layers, "flash_fwd_split": 2 * layers,
        "flash_bwd_dkv": layers, "flash_bwd_dq": layers,
        "flash_bwd_split": layers})
    for name, n in per_step.items():
        ran[name] = ran.get(name, 0) + n
    on_tensor_path = timed("tensor", phase_tensor, args.seed)
    for name, n in timed("attn_bench", phase_attn_bench, args.seed).items():
        ran[name] = ran.get(name, 0) + n
    emit({"phase_seconds": seconds})
    # no word of either package reaches K5b or K7: the tensor phase calls
    # their wrappers on the words' operands
    launched_by = {"flash_fwd": "generate, the train step and attn_bench "
                                "(in the f32 class after its split, "
                                "split_launches on generate and the train "
                                "step)",
                   "flash_bwd_dkv": "the train step and attn_bench (in "
                                    "the f32 class after the backward's "
                                    "split, split_launches on the train "
                                    "step)",
                   "flash_bwd_dq": "the train step and attn_bench (after "
                                   "the same split)",
                   "flash_bwd_fused": "attn_bench.sweep_bwd_fused",
                   "attn_dots": "attn_bench.bench_attention_oracle (its "
                                "dots-only probe)",
                   "mm_f32io": "the gemm2 and gemm3 words (classes default "
                               "and 3pass; highest, which no word reaches, "
                               "in the kernel phase)",
                   "mm_round": "the gemm2 and gemm3 words (K5a's rounding "
                               "pass, once before each K5a launch)",
                   "mm_v8": "the gemm4 word",
                   "mm_bf16": "its wrapper only: no word reaches this "
                              "kernel in either package",
                   "mm_db": "its wrapper only: no word reaches this "
                            "kernel in either package"}
    ran.update(on_tensor_path)
    names = FLASH_NAMES + PROBE_NAMES + GEMM_NAMES
    never = [name for name in names + ("flash_fwd_split", "flash_bwd_split")
             if not ran.get(name)]
    if never:
        raise RuntimeError(f"no path launched {never}")
    rec.update(gemm_rec)
    ops_dir = "tensorforth_tpu/ops/"
    replaces = {"flash_fwd": ("flash_fwd.cu", ops_dir + "attn_pallas.py:74"),
                "flash_bwd_dkv": ("flash_bwd.cu",
                                  ops_dir + "attn_pallas.py:172"),
                "flash_bwd_dq": ("flash_bwd.cu",
                                 ops_dir + "attn_pallas.py:226"),
                "flash_bwd_fused": ("flash_bwd_fused.cu",
                                    ops_dir + "attn_pallas.py:475"),
                "attn_dots": ("attn_dots.cu", "bench.py:692"),
                "mm_f32io": ("gemm_sm90.cu", ops_dir + "gemm_pallas.py:94"),
                "mm_bf16": ("gemm_sm90_f32.cu",
                            ops_dir + "gemm_pallas.py:106"),
                "mm_v8": ("gemm_sm90.cu", ops_dir + "gemm_pallas.py:249"),
                "mm_db": ("gemm_sm90_f32.cu", ops_dir + "gemm_pallas.py:161"),
                # the operand rounding that _mm_kernel's dot does in its
                # body (_kdot, its 3pass split at 80-83)
                "mm_round": ("gemm_sm90.cu",
                             ops_dir + "gemm_pallas.py:76")}
    rec["flash_fwd"]["split_launches"] = ran["flash_fwd_split"]
    rec["flash_fwd"]["hybrid"] = rec.pop("flash_fwd_hybrid")
    for which, hy in rec.pop("flash_bwd_hybrid").items():
        rec[f"flash_bwd_{which}"].update(
            hybrid=hy, split_launches=ran["flash_bwd_split"])
    extra = {"flash_fwd": ("kernel_ms", "split_ms", "split_bound_ms",
                           "split_launches", "library_ms_4d", "route",
                           "f64_ratio_o", "f64_ratio_lse", "hybrid"),
             "flash_bwd_dkv": ("kernel_ms", "split_ms", "split_bound_ms",
                               "split_launches", "kernels_and_split_ms",
                               "ms_whole_backward", "library_ms_4d", "route",
                               "f64_ratio_kernel", "hybrid"),
             "flash_bwd_dq": ("kernel_ms", "split_ms", "split_bound_ms",
                              "split_launches", "kernels_and_split_ms",
                              "ms_whole_backward", "library_ms_4d", "route",
                              "f64_ratio_kernel", "hybrid"),
             "flash_bwd_fused": ("kernel_ms", "ms_before_the_sums",
                                 "library_bf16_ms", "library_ms_4d",
                                 "blocks", "grid"),
             "mm_f32io": ("rounding_pass_ms", "ms_includes_rounding_pass",
                          "library_ms_with_casts", "highest"),
             "mm_bf16": ("k5a_default_with_pass_ms", "library_ms_with_casts"),
             "mm_db": ("k5a_default_with_pass_ms", "library_ms_with_casts"),
             "mm_round": ("split_ms", "split3_ms", "split3_bound_ms")}
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"tensorforth_tpu_torch/ops/csrc/{replaces[name][0]}",
        "replaces": replaces[name][1],
        "launches": ran[name],
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": rec[name]["library_ms"],
        "launched_by": launched_by[name], "shape": rec[name]["shape"],
        # a kernel's own design goes by another name than the contract's
        # "route" (cuda or triton)
        **{("design" if key == "route" else key): rec[name][key]
           for key in extra.get(name, ())}}
        for name in names]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
