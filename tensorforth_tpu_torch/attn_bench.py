"""The attention measurement path: the port's counterpart of the JAX
package's bench.py:bench_attention, bench_attention_bwd,
bench_attention_oracle (with its dots-only probe) and of the sweep
scripts/sweep_bwd_fused_r5.py over scripts/sweep_attn_r4b.py:sweep.

    python -m tensorforth_tpu_torch.attn_bench [fwd|bwd|oracle|sweep|all]
        [--device cpu] [--tiny] [--dh DH]

prints one JSON line per function.  Without --device it runs on the CUDA
card and raises where there is none.  --tiny runs every function at the
size of TINY (for a CPU), not at its full width.  --dh picks the head dim
(128, the default, to 1024 in steps of 128; at 384 and wider the kernels
run on clusters of dh / 128 CTAs).

Every function makes its inputs from a numpy seed, runs each candidate as
a chain of `n_iter` dependent calls (the output feeds the next call's
input, as the JAX versions' scans do), times a chain with CUDA events (the
host clock on the CPU), interleaves the candidates within a rep so that a
ratio is taken inside one rep, and returns what it measured.  A kernel
that fails raises; nothing is caught.  Rates are TFLOP/s over the
conventional operation counts: 4*NH*S^2*dh forward, 10*B*S^2*dh backward
(half when causal), whatever a kernel really computes.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time

import numpy as np
import torch

from .config import resolve_device
from .nn.funcs import _sdpa_ref
from .ops import attn

SWEEP_SHAPES = {"2048": (16, 2048), "4096": (4, 4096), "8192": (1, 8192)}
# rows of a Q block of the fused backward: the JAX sweep's three candidates
SWEEP_BQ = (2048, 1024, 512)
# a candidate of the port's own, beyond the JAX sweep.  The port's grid
# (attn.fused_plan: one CTA per head, Q block and KV chunk) fills the card
# at any bq, so bq trades the dK/dV partials' traffic, which doubles each
# time bq halves, against the length of a CTA's work; 256 rows is the
# small end of that trade
EXTRA_BQ = (256,)
# --tiny: one small shape, one call a chain, one timed chain
TINY = dict(nh=2, s=128, n_iter=1, reps=1)
TINY_SWEEP = dict(shapes={"128": (2, 128)}, n_iter=1, reps=1)

def _randn(seed: int, n: int, shape, device, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype) for _ in range(n)]


def _elapsed_s(fn, device) -> float:
    """seconds one fn() takes, the device's work included"""
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _chain(step, x0, n_iter: int):
    """fn() that runs x = step(x) n_iter times from x0"""
    def run():
        x = x0
        for _ in range(n_iter):
            x = step(x)
        return x
    return run


def _interleaved(runs: dict, reps: int, device) -> dict:
    """{name: [seconds per rep]}: one warm chain each, then `reps` rounds
    with every chain timed once per round, in the dict's order"""
    for run in runs.values():
        run()
    times = {name: [] for name in runs}
    for _ in range(reps):
        for name, run in runs.items():
            times[name].append(_elapsed_s(run, device))
    return times


def bench_attention(nh: int = 16, s: int = 2048, dh: int = 128,
                    n_iter: int = 64, reps: int = 9, device=None,
                    seed: int = 3) -> dict:
    """the flash forward against the einsum path at a serving shape:
    TFLOP/s samples for `hybrid` (bf16 multiplicands), `f32stream` (strict
    f32) and `plain` (bench.py:bench_attention, whose third is `xla`)"""
    device = resolve_device(device)
    q, k, v = _randn(seed, 3, (nh, s, dh), device)
    flops = 4.0 * nh * s * s * dh * n_iter
    times = _interleaved({
        "hybrid": _chain(lambda x: attn.flash_attention(
            x, k, v, hybrid=True)[0], q, n_iter),
        "f32stream": _chain(lambda x: attn.flash_attention(x, k, v)[0], q,
                            n_iter),
        "plain": _chain(lambda x: _sdpa_ref(x, k, v, False, "f32"), q,
                        n_iter),
    }, reps, device)
    return {name: [flops / t / 1e12 for t in ts]
            for name, ts in times.items()}


def _plain_bwd(q, k, v, causal: bool):
    """bwd(do) -> (dq, dk, dv) by autograd through the einsum attention
    (the JAX benches' `xla_attn`); the graph is built once and kept"""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = _sdpa_ref(*leaves, causal, "f32")
    return lambda do: torch.autograd.grad(o, leaves, do, retain_graph=True)


def bench_attention_bwd(nh: int = 16, s: int = 2048, dh: int = 128,
                        n_iter: int = 24, reps: int = 9, device=None,
                        seed: int = 4) -> dict:
    """the two-kernel flash backward (`hybrid`) against autograd through
    the einsum path (`plain`): TFLOP/s samples; dq feeds back as the next
    output cotangent (bench.py:bench_attention_bwd)"""
    device = resolve_device(device)
    q, k, v, do0 = _randn(seed, 4, (nh, s, dh), device)
    o, lse = attn.flash_attention(q, k, v, hybrid=True)
    flops = 10.0 * nh * s * s * dh * n_iter
    plain = _plain_bwd(q, k, v, False)
    times = _interleaved({
        "hybrid": _chain(lambda do: attn.flash_attention_bwd(
            q, k, v, o, lse, do, hybrid=True)[0], do0, n_iter),
        "plain": _chain(lambda do: plain(do)[0], do0, n_iter),
    }, reps, device)
    return {name: [flops / t / 1e12 for t in ts]
            for name, ts in times.items()}


def _grad_step(f, k, v):
    """q -> d sum(f(q, k, v)^2) / dq: forward and backward in one step"""
    def step(q):
        q = q.detach().requires_grad_(True)
        return torch.autograd.grad((f(q, k, v) ** 2).sum(), q)[0]
    return step


def attn_dots_probe(nh: int = 16, s: int = 2048, dh: int = 128,
                    n_iter: int = 32, reps: int = 7, device=None,
                    seed: int = 6):
    """the dots-only probe interleaved with the real forward on the same
    bf16 values: (TFLOP/s samples of the probe, per-rep time ratios
    forward / probe).  A ratio of 1 would mean the softmax costs nothing
    beside the two products (bench.py:_attn_dots_probe).  On the card both
    chains are one kernel launch and one cast of the output back to bf16
    per call: the forward kernel takes the probe's own bf16 operands and
    scales q as it loads it, so the ratio holds none of the hybrid
    wrapper's casts.  The probe's unscaled outputs feed back as q, so a
    long chain's values grow past the bf16 range, as the JAX scan's do;
    the kernels' time does not depend on the values."""
    device = resolve_device(device)
    q, k, v = _randn(seed, 3, (nh, s, dh), device, torch.bfloat16)
    if device.type == "cuda":
        qscale = attn.LOG2E / math.sqrt(dh)

        def full(x):
            return attn._launch_fwd(x, k, v, False, True, qscale)[0]
    else:
        kf, vf = k.float(), v.float()

        def full(x):
            return attn.flash_attention(x.float(), kf, vf, hybrid=True)[0]
    times = _interleaved({
        "dots": _chain(lambda x: attn.attn_dots(x, k, v).to(torch.bfloat16),
                       q, n_iter),
        "full": _chain(lambda x: full(x).to(torch.bfloat16), q, n_iter),
    }, reps, device)
    flops = 4.0 * nh * s * s * dh * n_iter
    return ([flops / t / 1e12 for t in times["dots"]],
            [tf / td for tf, td in zip(times["full"], times["dots"])])


def bench_attention_oracle(nh: int = 16, s: int = 2048, dh: int = 128,
                           n_iter: int = 32, reps: int = 7, device=None,
                           seed: int = 5) -> dict:
    """the flash kernels against the library's attention on the same
    inputs, interleaved: per-rep time ratios library / ours (above 1 the
    port's kernels are faster) for `fwd`, `fwd_causal`, `bwd` and
    `bwd_causal` (forward plus backward, through each side's own
    autograd), then `dots_only_tflops` and `full_vs_dots_time_ratio` from
    attn_dots_probe (bench.py:bench_attention_oracle, whose stock kernel is
    jaxlib's).  scaled_dot_product_attention is a yardstick here and
    stands on no path of the port."""
    device = resolve_device(device)
    q, k, v = _randn(seed, 3, (nh, s, dh), device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for causal in (False, True):
        tag = "_causal" if causal else ""
        stock = functools.partial(sdpa, is_causal=causal)
        pairs = {
            f"fwd{tag}": (lambda x, c=causal: attn.flash_attention(
                x, k, v, causal=c, hybrid=True)[0],
                lambda x, f=stock: f(x, k, v)),
            # autograd needs the Function that pairs the kernels
            f"bwd{tag}": (_grad_step(lambda *a, c=causal:
                                     attn.flash_attention_lse(*a, c, True)[0],
                                     k, v),
                          _grad_step(stock, k, v)),
        }
        for name, (mine, lib) in pairs.items():
            times = _interleaved({"ours": _chain(mine, q, n_iter),
                                  "library": _chain(lib, q, n_iter)},
                                 reps, device)
            out[name] = [tl / to for tl, to in zip(times["library"],
                                                   times["ours"])]
    dots, full_vs_dots = attn_dots_probe(nh, s, dh, n_iter, reps, device)
    out["dots_only_tflops"] = dots
    out["full_vs_dots_time_ratio"] = full_vs_dots
    return out


def sweep(tag_fns, b: int, s: int, dh: int, causal: bool, n_iter: int = 24,
          reps: int = 9, device=None, seed: int = 5) -> dict:
    """tag_fns: [(tag, bwd(q, k, v, o, lse, do) -> (dq, dk, dv))], the
    first the control.  Each is chained by feeding dq back as the next do
    and timed once per rep; returns {"tflops": {tag: samples}, "vs_control":
    {tag: per-rep rate ratios to the control}} over the conventional
    backward operations (scripts/sweep_attn_r4b.py:sweep)."""
    device = resolve_device(device)
    q, k, v, do0 = _randn(seed, 4, (b, s, dh), device)
    o, lse = attn.flash_attention(q, k, v, causal=causal, hybrid=True)
    tflop = (5 if causal else 10) * b * s * s * dh * n_iter / 1e12
    times = _interleaved({
        tag: _chain(lambda do, f=f: f(q, k, v, o, lse, do)[0], do0, n_iter)
        for tag, f in tag_fns}, reps, device)
    control = tag_fns[0][0]
    return {"tflops": {tag: [tflop / t for t in ts]
                       for tag, ts in times.items()},
            "vs_control": {tag: [tc / t for tc, t in zip(times[control], ts)]
                           for tag, ts in times.items() if tag != control}}


def sweep_bwd_fused(which: str = "all", n_iter: int = 24, reps: int = 9,
                    device=None, shapes=None, bqs=SWEEP_BQ + EXTRA_BQ,
                    dh: int = 128):
    """the single-kernel backward against the two-kernel split, hybrid,
    causal and not, over `shapes` ({key: (B, S)}, default SWEEP_SHAPES;
    `which` picks one key or "all"): one record per (shape, causal) with
    the sweep's rates and ratios and each candidate's partial traffic
    (scripts/sweep_bwd_fused_r5.py).  The candidates differ in bq alone:
    the port's kernel has no bkv to vary, its KV tile is fixed.  The
    default candidates are the JAX sweep's SWEEP_BQ and the port's own
    EXTRA_BQ."""
    shapes = SWEEP_SHAPES if shapes is None else shapes
    out = []
    for key, (b, s) in shapes.items():
        if which not in (key, "all"):
            continue
        cand = sorted({min(bq, s) for bq in bqs}, reverse=True)
        for causal in (False, True):
            tag_fns = [("split", functools.partial(
                attn.flash_attention_bwd, causal=causal, hybrid=True))]
            tag_fns += [(f"fused bq={bq}", functools.partial(
                attn.flash_attention_bwd_fused, bq=bq, causal=causal,
                hybrid=True)) for bq in cand]
            rec = sweep(tag_fns, b, s, dh, causal, n_iter, reps, device)
            rec.update(b=b, s=s, dh=dh, causal=causal, blocks={
                f"fused bq={bq}": attn.fused_plan_on(
                    resolve_device(device), b, s, bq, causal, True, dh).ctas
                for bq in cand},
                partial_bytes_written_and_read={
                    f"fused bq={bq}": 2 * 2 * (s // bq) * b * s * dh * 4
                    for bq in cand})
            out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", nargs="?", default="all",
                    choices=("fwd", "bwd", "oracle", "sweep", "all"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="the size of TINY, not the full width")
    ap.add_argument("--dh", type=int, default=128,
                    help="head dim, 128 to 1024 in steps of 128")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = dict(TINY if args.tiny else {}, device=device, dh=args.dh)
    if args.what in ("fwd", "all"):
        print(json.dumps({"bench_attention": bench_attention(**size)}),
              flush=True)
    if args.what in ("bwd", "all"):
        print(json.dumps({"bench_attention_bwd":
                          bench_attention_bwd(**size)}), flush=True)
    if args.what in ("oracle", "all"):
        print(json.dumps({"bench_attention_oracle":
                          bench_attention_oracle(**size)}), flush=True)
    if args.what in ("sweep", "all"):
        print(json.dumps({"sweep_bwd_fused": sweep_bwd_fused(
            device=device, dh=args.dh, **(TINY_SWEEP if args.tiny else {}))}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
