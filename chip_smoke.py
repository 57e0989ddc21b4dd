#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tensorforth_tpu_torch) on one NVIDIA card
and check it.  Run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each:
  build   compile every kernel of the serving path with nvcc for sm_90a
          into build/torch_kernels/ (one nvcc per source, all at once)
  kernel  each kernel against its plain PyTorch version on the card, on
          inputs from a numpy seed; kernel, plain and library times and
          the card's least time for the same work (the bound)
  serve   tiny_lm at bench_prefill's full width (dim 1024, 8 heads,
          4 layers, vocab 2048, batch 8, 2048-token prompt, 64 new
          tokens) through generate(), f32 and int8 KV caches: kernel
          launches counted, greedy tokens held against a teacher-forced
          replay, prefill/decode timings
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
KERNELS = ("flash_fwd",)      # ops/csrc/<name>.cu on the serving path
LM = dict(batch=8, vocab=2048, dim=1024, heads=8, layers=4, rope=True)
N_PROMPT, N_NEW = 2048, 64
TOL_F32 = 1e-4     # f32 sums in another order than the plain version's
TOL_HYBRID = 3e-2  # the JAX package's hybrid tolerance: P rounds to bf16
#                    against the running max in the kernel, the row max
#                    in the plain version
MARGIN = 1e-4      # top-2 logit gap below which a replay flip is a tie


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


def phase_kernel(seed: int):
    """K1 against its plain version; returns the slice shape's record"""
    import torch
    import torch.nn.functional as F
    from tensorforth_tpu_torch.ops import attn
    cases = [  # name, B*h, S, dh, causal, hybrid
        ("slice_causal", 64, 2048, 128, True, False),
        ("slice_noncausal", 64, 2048, 128, False, False),
        ("odd_s_causal", 16, 1536, 128, True, False),
        ("slice_causal_hybrid", 64, 2048, 128, True, True),
        ("dh256_causal", 8, 1024, 256, True, False),
    ]
    rows, failed, main = [], [], None
    for i, (name, b, s, dh, causal, hybrid) in enumerate(cases):
        rs = np.random.RandomState(seed + i)
        q, k, v = (torch.from_numpy(rs.randn(b, s, dh).astype(np.float32))
                   .cuda() for _ in range(3))
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
        ops, nbytes = attn_work(b, s, dh, causal, 2 if hybrid else 4)
        bms, by = bound_ms(ops, nbytes)
        row = {"case": name, "shape": [b, s, dh], "causal": causal,
               "hybrid": hybrid, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_l, "tol": tol, "ok": ok, "ms": ms,
               "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": ops / ms / 1e9, "bound_ms": bms, "bound_by": by}
        if name == "slice_causal":
            row["plain_ms"] = time_ms(
                lambda: attn.flash_attention_ref(q, k, v, causal), reps=10)
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
            main = row
        rows.append(row)
        if not ok:
            failed.append(name)
        del q, k, v, o, lse, o_r, lse_r
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "flash_fwd",
          "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
          "peak_tb_s": PEAK_BYTES / 1e12,
          "precision": "f32 FMA on CUDA cores (hybrid: bf16 loads, "
                       "f32 FMA)", "cases": rows})
    if failed:
        raise RuntimeError(f"flash_fwd disagrees with its plain version: "
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


def profile_generate(m, prompt, n_new, device, wall_ms):
    """one generate() under torch.profiler: the device's busy time by
    kernel (the top 8 and the flash kernel's), and the idle share of
    `wall_ms`, the same call's median time without the profiler"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tensorforth_tpu_torch.nn.serve import generate
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        generate(m, prompt, n_new, temp=0.0)
        if on_card:
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():      # kernels only, not the host ops
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            by_name[e.key] = by_name.get(e.key, 0) + (
                e.self_device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_busy_ms": busy_ms if busy_ms > 0 else None,
            "device_idle_share": (1 - busy_ms / wall_ms
                                  if busy_ms > 0 else None),
            "kernel_launches": sum(e.count for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA),
            "flash_fwd_ms": sum(v for k, v in by_name.items()
                                if "flash_fwd" in k),
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


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
    attn.flash_attention.launches = 0
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
    k1 = phase_kernel(args.seed)
    launches = phase_serve(args.seed, expect_launches=LM["layers"])
    if launches == 0:
        raise RuntimeError("the serving path never launched flash_fwd")
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tensorforth_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tensorforth_tpu/ops/attn_pallas.py:74",
        "launches": launches,
        "max_abs_err": max(k1["max_abs_err_o"], k1["max_abs_err_lse"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
