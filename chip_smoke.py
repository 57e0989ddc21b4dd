#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensorforth_tpu_torch) on one NVIDIA card
and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  build   compile every kernel of the four paths with nvcc for sm_90a
          into build/torch_kernels/ (one nvcc per source, all at once:
          flash_fwd, flash_bwd, flash_bwd_fused, attn_dots, gemm)
  kernel  each kernel (flash forward, flash backward dK/dV and dQ, the
          fused single-kernel backward, the dots-only probe, and the four
          GEMM kernels of the tensor tier) against its plain PyTorch
          version on the card, on inputs from a numpy seed; the fused
          backward also against the two-kernel split, against f64 and
          against itself run twice; kernel, plain and library times and
          the card's least time for the same work (the bound)
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
Then one `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.

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
           "gemm")            # ops/csrc/<name>.cu
LM = dict(batch=8, vocab=2048, dim=1024, heads=8, layers=4, rope=True)
N_PROMPT, N_NEW = 2048, 64
TOL_F32 = 1e-4     # f32 sums in another order than the plain version's
TOL_HYBRID = 3e-2  # the JAX package's hybrid tolerance: P rounds to bf16
#                    against the running max in the kernel, the row max
#                    in the plain version
TOL_BWD_F32 = 2e-4     # dq, dk, dv: the JAX package's own tolerance
TOL_BWD_HYBRID = 0.05  # of the largest reference value (bf16 p and ds)
TOL_FUSED_SPLIT = 1e-5  # the fused backward against the two-kernel split,
#                    absolute plus relative (the JAX package's own test):
#                    the same p and ds, dq and the partials summed in
#                    another order
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
GEMM_NAMES = ("mm_f32io", "mm_bf16", "mm_v8", "mm_db")
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
GEMM_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (4096, 4096, 4096),
               (1024, 2048, 512), (1000, 1500, 700), (2, 3, 2))   # m, k, n
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


def attn_work(b, s, dh, causal, elem_bytes):
    """(operations, bytes) the attention forward needs: 2 products of
    2*dh operations per visited (query, key) pair, causal visiting
    S(S+1)/2 pairs; q, k, v read once, o and lse written once"""
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * dh * b * pairs
    nbytes = 3 * b * s * dh * elem_bytes + b * s * dh * 4 + b * s * 4
    return ops, nbytes


def attn_bwd_work(which, b, s, dh, causal, elem_bytes):
    """(operations, bytes) of one backward kernel.  dK/dV does 4 products
    per visited pair (s2, dp, p^T do, ds^T q), dQ does 3 (s2, dp, ds k);
    each reads q, k, v, do, lse and delta once and writes its outputs
    once"""
    pairs = s * (s + 1) // 2 if causal else s * s
    n_prod, n_out = (4, 2) if which == "dkv" else (3, 1)
    ops = n_prod * 2 * dh * b * pairs
    nbytes = (4 * b * s * dh * elem_bytes + 2 * b * s * 4
              + n_out * b * s * dh * 4)
    return ops, nbytes


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


def bound_ms(ops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops, t_bytes = ops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_build():
    from tensorforth_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = list(ex.map(_build.build, KERNELS))
    secs = time.perf_counter() - t0
    ptxas = []
    for lib in libs:
        log = lib.with_suffix(".log").read_text() if lib.with_suffix(
            ".log").exists() else ""
        ptxas += [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "kernels": list(KERNELS),
          "ptxas": ptxas})


def sdpa_grads(q, k, v, do, causal):
    """the library yardstick of the backward: torch.autograd.grad through
    scaled_dot_product_attention.  Returns a function that runs the
    backward alone (the graph is kept)."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    return lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)


def f64_grads(q, k, v, do, dlse, causal):
    """dq, dk, dv in f64 by PyTorch's autograd through the exact (o, lse)
    attention: a reference that shares no arithmetic with the kernels or
    their plain version"""
    import torch
    s, dh = q.shape[1], q.shape[2]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    sc = torch.einsum("nqd,nkd->nqk", leaves[0], leaves[1]) / math.sqrt(dh)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, -1.0e30)
    o = torch.einsum("nqk,nkd->nqd", torch.softmax(sc, dim=-1), leaves[2])
    return torch.autograd.grad((o, torch.logsumexp(sc, dim=-1)), leaves,
                               (do.double(), dlse.double()))


def fused_equals_split(got, want) -> bool:
    """(dq, dk, dv) of the fused backward within TOL_FUSED_SPLIT, absolute
    plus relative, of the two-kernel split's"""
    return all(bool(((g - w).abs() <= TOL_FUSED_SPLIT
                     + TOL_FUSED_SPLIT * w.abs()).all())
               for g, w in zip(got, want))


def fused_case(args, split, bq, f64, sdpa_bwd, timed=True):
    """the fused backward kernel on one case's operands (q, k, v, o, lse,
    do, causal, hybrid, dlse): against its plain version (dq and both
    partials, the never-visited blocks included), against the two-kernel
    split's (dq, dk, dv), against f64 where given, and against itself run
    again; its times unless `timed` is false, and the library backward's
    where given"""
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
    split_ok = fused_equals_split(got, split)
    again = attn.flash_attention_bwd_fused(*call)
    repeats = all(torch.equal(g, a) for g, a in zip(got, again))
    row = {"bq": bq, "n_q": n_q, "blocks": b * n_q, "max_abs_err": errs,
           "largest_reference_value": tops,
           "partials_shape_and_zero_blocks_ok": zeros_ok,
           "never_visited_blocks": len(never) // 2,
           "max_abs_err_vs_split": vs_split, "tol_vs_split":
           f"{TOL_FUSED_SPLIT} absolute plus {TOL_FUSED_SPLIT} relative",
           "two_runs_bit_equal": repeats}
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
    ops, nbytes = attn_bwd_fused_work(b, s, dh, bq, causal,
                                      2 if hybrid else 4)
    row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes)
    row.update(gflop=ops / 1e9, mbytes=nbytes / 1e6,
               tflops=ops / row["ms"] / 1e9)
    if sdpa_bwd is not None:
        row["plain_ms"] = time_ms(
            lambda: attn.flash_attention_bwd_fused_ref(*call), reps=10)
        row["library_ms"] = time_ms(sdpa_bwd)
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
    ]
    rows, bwd_rows, failed, main = [], [], [], {}
    for i, (name, b, s, dh, causal, hybrid, with_dlse,
            bq) in enumerate(cases):
        rs = np.random.RandomState(seed + i)
        q, k, v, do = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda() for _ in range(4))
        dlse = (torch.from_numpy(rs.randn(b, s).astype(np.float32)).cuda()
                if with_dlse else None)
        eb = 2 if hybrid else 4
        # --- forward
        o, lse = attn.flash_attention(q, k, v, causal=causal, hybrid=hybrid)
        torch.cuda.synchronize()
        o_r, lse_r = attn.flash_attention_ref(q, k, v, causal, hybrid)
        err_o = (o - o_r).abs().max().item()
        err_l = (lse - lse_r).abs().max().item()
        tol = TOL_HYBRID if hybrid else TOL_F32
        ok = (err_o <= tol and err_l <= tol
              and bool(torch.isfinite(o).all()))
        ms = time_ms(lambda: attn.flash_attention(q, k, v, causal=causal,
                                                  hybrid=hybrid))
        ops, nbytes = attn_work(b, s, dh, causal, eb)
        bms, by = bound_ms(ops, nbytes)
        row = {"case": name, "shape": [b, s, dh], "causal": causal,
               "hybrid": hybrid, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_l, "tol": tol, "ok": ok, "ms": ms,
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": ops / ms / 1e9, "bound_ms": bms, "bound_by": by}
        del o_r, lse_r
        # --- backward, from the forward kernel's o and lse
        dq, dk, dv = attn.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                              hybrid, dlse=dlse)
        torch.cuda.synchronize()
        want = attn.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                            hybrid, dlse=dlse)
        errs = {nm: (g - w).abs().max().item()
                for nm, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
        tops = {nm: w.abs().max().item()
                for nm, w in zip(("dq", "dk", "dv"), want)}
        bok = all(bool(torch.isfinite(g).all()) and (
            errs[nm] <= TOL_BWD_HYBRID * tops[nm] if hybrid
            else errs[nm] <= TOL_BWD_F32)
            for nm, g in zip(("dq", "dk", "dv"), (dq, dk, dv)))
        brow = {"case": name, "shape": [b, s, dh], "causal": causal,
                "hybrid": hybrid, "dlse": with_dlse, "max_abs_err": errs,
                "largest_reference_value": tops, "ok": bok,
                "tol": (f"{TOL_BWD_HYBRID} of the largest reference value"
                        if hybrid else TOL_BWD_F32)}
        w64 = None
        if with_dlse and not hybrid:
            # the kernels and their plain version sum in the same order
            # (one FMA chain per output, as the library's f32 GEMM), so
            # they can agree to the bit: hold both against f64 as well
            w64 = f64_grads(q, k, v, do, dlse, causal)
            for who, gs in (("kernel", (dq, dk, dv)), ("plain", want)):
                brow[f"max_abs_err_{who}_vs_f64"] = max(
                    (g.double() - w).abs().max().item()
                    for g, w in zip(gs, w64))
            if brow["max_abs_err_kernel_vs_f64"] > TOL_BWD_F32:
                brow["ok"] = bok = False
        del want
        timed = name in ("slice_causal", "bench_causal_hybrid")
        brow["fused"] = fused_case(
            (q, k, v, o, lse, do, causal, hybrid, dlse), (dq, dk, dv), bq,
            w64, sdpa_grads(q, k, v, do, causal) if timed else None)
        del w64, dq, dk, dv
        for which in ("dkv", "dq"):
            kms = time_ms(lambda: attn.flash_attention_bwd(
                q, k, v, o, lse, do, causal, hybrid, dlse=dlse, only=which))
            kops, kbytes = attn_bwd_work(which, b, s, dh, causal, eb)
            kb, kby = bound_ms(kops, kbytes)
            brow[which] = {"ms": kms, "gflop": kops / 1e9,
                           "mbytes": kbytes / 1e6,
                           "tflops": kops / kms / 1e9, "bound_ms": kb,
                           "bound_by": kby}
        if name == "slice_causal":
            row["plain_ms"] = time_ms(
                lambda: attn.flash_attention_ref(q, k, v, causal), reps=10)
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            # the plain backward and the library backward each give dq,
            # dk and dv in one pass: their times cover both kernels' work
            brow["plain_ms"] = time_ms(
                lambda: attn.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     causal), reps=10)
            brow["library_ms"] = time_ms(sdpa_grads(q, k, v, do, causal))
            main["flash_fwd"] = dict(
                row, max_abs_err=max(err_o, err_l))
            main["flash_bwd_dkv"] = dict(
                brow["dkv"], max_abs_err=max(errs["dk"], errs["dv"]),
                plain_ms=brow["plain_ms"], library_ms=brow["library_ms"],
                shape=[b, s, dh])
            main["flash_bwd_dq"] = dict(
                brow["dq"], max_abs_err=errs["dq"],
                plain_ms=brow["plain_ms"], library_ms=brow["library_ms"],
                shape=[b, s, dh])
        if name == "bench_causal_hybrid":
            main["flash_bwd_fused"] = dict(
                brow["fused"], shape=[b, s, dh],
                max_abs_err=max(brow["fused"]["max_abs_err"].values()))
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
              "peak_tb_s": PEAK_BYTES / 1e12,
              "precision": "f32 FMA on CUDA cores (hybrid: bf16 loads, "
                           "f32 FMA)"}
    emit(dict(common, kernel="flash_fwd", cases=rows,
              dh384_takes_the_einsum_path=gate_ok))
    emit(dict(common, kernel="flash_bwd (dkv, dq) and flash_bwd_fused",
              cases=bwd_rows,
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
         TOL_GEMM_HIGHEST, PEAK_F32_FLOPS, 4),
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


def phase_kernel_gemm(seed: int):
    """the four GEMM kernels (K5a in its three classes) against their
    plain versions at the words' shapes; returns each kernel's record at
    4096^3 (K5a: class default)"""
    import torch
    from tensorforth_tpu_torch.ops import gemm
    lib_name, lib_bf16 = bf16_library()
    gemm.reset_launches()
    rows, failed, main = [], [], {}
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
            rows.append(row)
            if not ok:
                failed.append(f"{name} {case} {m}x{k}x{n}")
            if (m, k, n) == GEMM_MAIN and case not in ("3pass", "highest"):
                main[name] = dict(row)
        del a, b, a16, b16, ref64
        torch.cuda.empty_cache()
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
          "mm_db)", "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
          "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
          "peak_tb_s": PEAK_BYTES / 1e12,
          "bound": "2mnk over the dense bf16 tensor-core rate (3pass: "
                   "three products; highest: the f32 CUDA-core rate), or "
                   "the bytes over the memory rate",
          "library": {"f32 classes": "torch.matmul, TF32 off",
                      "bf16 classes": lib_name},
          "cases": rows, "launches": dict(gemm.launches)})
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
                    want_delta["mm_f32io"] = WORD_REPS
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
    """the main path: returns the flash kernel's launches in it"""
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
    return launches


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
    attn.flash_attention_bwd.launches = {"dkv": 0, "dq": 0}
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
    launches = flash_counts()

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
    checks = {"launch_counts_exact": launches == expect,
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
          "checks": checks})
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
    phase_build()
    rec = phase_kernel(args.seed)
    rec["attn_dots"] = phase_kernel_dots(args.seed)
    gemm_rec = phase_kernel_gemm(args.seed)
    layers = LM["layers"]
    ran = {"flash_fwd": phase_serve(args.seed, expect_launches=layers)}
    # a step launches the forward kernel twice per attention layer (the
    # layer backward runs the layer forward again) and each backward
    # kernel once
    per_step = phase_train(args.seed, expect_launches={
        "flash_fwd": 2 * layers, "flash_bwd_dkv": layers,
        "flash_bwd_dq": layers})
    for name, n in per_step.items():
        ran[name] = ran.get(name, 0) + n
    on_tensor_path = phase_tensor(args.seed)
    for name, n in phase_attn_bench(args.seed).items():
        ran[name] = ran.get(name, 0) + n
    # no word of either package reaches K5b or K7: the tensor phase calls
    # their wrappers on the words' operands
    launched_by = {"flash_fwd": "generate, the train step and attn_bench",
                   "flash_bwd_dkv": "the train step and attn_bench",
                   "flash_bwd_dq": "the train step and attn_bench",
                   "flash_bwd_fused": "attn_bench.sweep_bwd_fused",
                   "attn_dots": "attn_bench.bench_attention_oracle (its "
                                "dots-only probe)",
                   "mm_f32io": "the gemm2 and gemm3 words",
                   "mm_v8": "the gemm4 word",
                   "mm_bf16": "its wrapper only: no word reaches this "
                              "kernel in either package",
                   "mm_db": "its wrapper only: no word reaches this "
                            "kernel in either package"}
    ran.update(on_tensor_path)
    names = FLASH_NAMES + PROBE_NAMES + GEMM_NAMES
    never = [name for name in names if not ran.get(name)]
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
                "mm_f32io": ("gemm.cu", ops_dir + "gemm_pallas.py:94"),
                "mm_bf16": ("gemm.cu", ops_dir + "gemm_pallas.py:106"),
                "mm_v8": ("gemm.cu", ops_dir + "gemm_pallas.py:249"),
                "mm_db": ("gemm.cu", ops_dir + "gemm_pallas.py:161")}
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
        "launched_by": launched_by[name], "shape": rec[name]["shape"]}
        for name in names]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
