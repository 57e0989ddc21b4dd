#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensorforth_tpu_torch) on one NVIDIA card
and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  build   compile every kernel of the two paths with nvcc for sm_90a
          into build/torch_kernels/ (one nvcc per source, all at once)
  kernel  each kernel (flash forward, flash backward dK/dV and dQ)
          against its plain PyTorch version on the card, on inputs from
          a numpy seed; kernel, plain and library times and the card's
          least time for the same work (the bound)
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
Then one `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, when there is no CUDA
device; and non-zero when a kernel does not build, launch or agree, or
any check fails.  Nothing is caught and turned into a pass.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12        # f32 on the CUDA cores (no tensor cores)
PEAK_BYTES = 3.35e12          # HBM3
KERNELS = ("flash_fwd", "flash_bwd")   # ops/csrc/<name>.cu, both paths
LM = dict(batch=8, vocab=2048, dim=1024, heads=8, layers=4, rope=True)
N_PROMPT, N_NEW = 2048, 64
TOL_F32 = 1e-4     # f32 sums in another order than the plain version's
TOL_HYBRID = 3e-2  # the JAX package's hybrid tolerance: P rounds to bf16
#                    against the running max in the kernel, the row max
#                    in the plain version
TOL_BWD_F32 = 2e-4     # dq, dk, dv: the JAX package's own tolerance
TOL_BWD_HYBRID = 0.05  # of the largest reference value (bf16 p and ds)
TOL_GRAD = 1e-3    # train: dw, db against the plain attention path, of
#                    each tensor's largest value
MARGIN = 1e-4      # top-2 logit gap below which a replay flip is a tie
TRAIN_STEPS = 5    # timed steps after the counted one
TRAIN_LR = 1e-4    # Adam.  The reference's Adam has no bias correction,
#                    so its first steps move every weight by about 3 lr;
#                    at dim 1024 the small tests' 1e-2 and 1e-3 overshoot
FLASH_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


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


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
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


def phase_kernel(seed: int):
    """the three flash kernels against their plain versions; returns the
    slice shape's record of each, by kernel name"""
    import torch
    import torch.nn.functional as F
    from tensorforth_tpu_torch.ops import attn
    cases = [  # name, B*h, S, dh, causal, hybrid, with a non-zero dlse
        ("slice_causal", 64, 2048, 128, True, False, False),
        ("slice_noncausal", 64, 2048, 128, False, False, False),
        ("odd_s_causal", 16, 1536, 128, True, False, False),
        ("slice_causal_hybrid", 64, 2048, 128, True, True, False),
        ("dh256_causal", 8, 1024, 256, True, False, False),
        ("odd_s_causal_dlse", 16, 1536, 128, True, False, True),
    ]
    rows, bwd_rows, failed, main = [], [], [], {}
    for i, (name, b, s, dh, causal, hybrid, with_dlse) in enumerate(cases):
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
        if with_dlse:
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
            del w64
        del want, dq, dk, dv
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
                plain_ms=brow["plain_ms"], library_ms=brow["library_ms"])
            main["flash_bwd_dq"] = dict(
                brow["dq"], max_abs_err=errs["dq"],
                plain_ms=brow["plain_ms"], library_ms=brow["library_ms"])
        rows.append(row)
        bwd_rows.append(brow)
        if not ok:
            failed.append("flash_fwd " + name)
        if not bok:
            failed.append("flash_bwd " + name)
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
    emit(dict(common, kernel="flash_bwd (dkv, dq)", cases=bwd_rows,
              plain_and_library_ms="one pass that gives dq, dk and dv: "
                                   "both kernels' work"))
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    return main


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


def reset_flash_counts():
    from tensorforth_tpu_torch.ops import attn
    attn.flash_attention.launches = 0
    attn.flash_attention_bwd.launches = {"dkv": 0, "dq": 0}


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
    never = [name for name in FLASH_NAMES if not ran.get(name)]
    if never:
        raise RuntimeError(f"no path launched {never}")
    replaces = {"flash_fwd": ("flash_fwd.cu", 74),
                "flash_bwd_dkv": ("flash_bwd.cu", 172),
                "flash_bwd_dq": ("flash_bwd.cu", 226)}
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"tensorforth_tpu_torch/ops/csrc/{replaces[name][0]}",
        "replaces": f"tensorforth_tpu/ops/attn_pallas.py:{replaces[name][1]}",
        "launches": ran[name],
        "max_abs_err": rec[name]["max_abs_err"],
        "ms": rec[name]["ms"], "plain_ms": rec[name]["plain_ms"],
        "bound_ms": rec[name]["bound_ms"],
        "bound_by": rec[name]["bound_by"],
        "library_ms": rec[name]["library_ms"]} for name in FLASH_NAMES]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
