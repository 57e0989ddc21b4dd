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
          and dQ with theirs, the fused single-kernel backward (its f32
          class after its split, at dh 256 on a cluster of two CTAs,
          with the launches of a call counted), the dots-only probe
          (the forward's body with the softmax compiled out, beside two
          cuBLAS calls),
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
  kernel_wide  K1, K2a and K2b at dh 384 to 1024 ([16, 2048, dh]: the
          dh-512 train slice's cores, and the dh-1024 slice's at twice its
          B*h), both classes, causal (dh 640 to 1024 also not, with an
          lse cotangent), on clusters of dh / 128 CTAs that split
          dh (K1's hybrid class on its wide route: a warpgroup per 128
          columns, one CTA to dh 512, a pair past it): against their
          plain versions in the cluster's sum order, the
          f32 class also against f64, each backward twice to the bit; the
          causal cases timed, each kernel alone and with its split, beside
          its bound, SDPA's 4-d call, the clusters the card runs at once,
          the SMs they leave idle, the forward's registers and spills and
          its output's SHA-1.  Then K3 (both classes) and K8 (non-causal,
          on K1 hybrid's wide route) at
          every dh 384 to 1024 on [2, 512, dh] (K3 causal and not, bq
          256): against their plain versions in the cluster's order, K3
          also against K2a + K2b (TOL_FUSED_SPLIT; hybrid
          TOL_FUSED_SPLIT_HYBRID), f64 (f32 class) and itself run again;
          and causal [16, 2048, dh] at dh 512 and 1024 timed beside their
          bounds, SDPA's backward (K3) and two cuBLAS bmm (K8); the
          SHA-1s of K8's and K1's outputs at dh 128 and 256 (`sha1`:
          equal in a tree whose routes there kept their bits)
  serve   tiny_lm at bench_prefill's full width (dim 1024, 8 heads,
          4 layers, vocab 2048, batch 8, 2048-token prompt, 64 new
          tokens) through generate(), f32 and int8 KV caches: kernel
          launches counted, the decode's graph captures and replays (one
          replay a token after the prefill), its tokens against the
          uncaptured step on the card (greedy and sampled), a strict
          generate against its teacher-forced replay, prefill/decode
          timings of the graphs and of the uncaptured step with profiles;
          then an MoE LM (tiny_lm's widths at 2 layers, an MoE block
          after each attention block) whose graph tokens are held against
          its eager ones, on the route moe_select picks and dispatched
  train   the same tiny_lm, full width and depth, through the word path
          forward / loss(CE) / backprop / adam on 8 x 2048 tokens:
          kernel launches counted in one step, the step's weight
          gradients held against the same step taken through the plain
          attention path, the loss sequence, step timings and a profile;
          again with 4 heads (train_dh256, K2 on two-CTA clusters)
  serve_dh512, train_dh512  the same model with 2 heads (dh 512) at 2
          layers: a generate (one K1 launch a layer on four-CTA
          clusters, by the host counter and the profiler; tokens against
          the uncaptured step and the strict replay; the prefill beside
          the einsum path's) and six train steps (4 K1, 2 K2a and 2 K2b
          a step, by both counts; gradients against the plain attention
          path; the same step on the einsum path timed beside it)
  serve_dh1024, train_dh1024  the same with 1 head at the full 4 layers
          (dh 1024, K1, K2a and K2b on clusters of eight CTAs: 4 K1 a
          generate, 8 K1 and 4 K2a and K2b a step)
  tensor  the port's Forth REPL on the card, fed from strings:
          examples/t4_20a.4th whole (its verify lines, the inverse
          round trip, msec/cycle of its 1000-product loop), the larger
          1000-product loop with a profile, the words gemm..gemm4 at
          4096^3 and 2048^3 under both precision settings with exact
          launch counts, and inverse/plu/det/solve at 1024 x 1024
  nn      the NN tier's main path, mnist_cnn at t4_30e's full width
          (batch 100 of 28 x 28 x 1, conv 10@3x3, maxpool 2, linear 100,
          linear 10, softmax) on seeded numpy images, under both
          precision classes: one forward / loss(CE) / backprop / adam
          step on the card against a CPU copy of the port model with the
          same weights (outputs, loss, every dw and db, the weights after
          the step), the conv and linear dots against f64 of the class's
          bf16 parts, 100 training steps (no NaN, the loss falls), ms per
          step with the words' split and the device's busy share; then a
          net of the other layer kinds (NN_COVERAGE) and gan_mnist's D at
          batch 256, card against CPU
  net     the system's own main path, examples/t4_30e.4th, through the
          port's REPL on the card on its per-word path (T4_NO_FUSE=1
          T4_NO_MACRO=1), the control of net_fused: nn_c at batch 100
          with Adam at 0.001 for NET_CONTROL_EPOCHS of the script's 20
          epochs over the synthetic mnist_train of 60,000, then bench.py's
          held-out loop over mnist_test, the saved model loaded into a
          CPU model of the port (its weights the card's bit for bit, its
          logits within TOL_NN, its classes the card's on at least
          NET_SAME_CLASS of a held-out batch), ms per batch, images/s,
          launches per batch and the device's busy share over a profiled
          slice
  net_fused  t4_30e whole at the defaults, as a user of the JAX package
          runs it: fused cycles and trace chunks of 100 batches, each
          chunk K replays of one captured CUDA graph; its first epochs'
          acc= and loss= lines equal the control's, the held-out gate
          0.98, the net phase's other checks; fused cycles, chunks,
          graph replays and macro-served batches a batch
  net_rollback  the fused path's exits against their controls from the
          same weights, on a window with a chunk in flight: a weight read
          inside the loop (every cycle rolls the chunk back), the
          canonical body without `hint` (the macro serve runs), each
          against the per-word path, and the exploding SGD of
          test_nan_guard.py detected lazily and eagerly (the faulting
          batch and weights against the per-word path traced, the hits
          against the per-batch fused cycles): all equal; then a failed
          capture (a body that reads back) raises through the words
  net_train  `nn.train`: examples/t4_50_tpu.4th whole (5 epochs, each a
          captured batch step replayed once a batch) with bench.py's
          held-out loop; train_epochs over tiny_transformer at
          bench_prefill's widths (dim 1024, 8 heads, seq 2048, batch 8,
          2 layers) on a seeded stub corpus of 4 batches against the
          per-word loop (TOL_NET_TRAIN), with the flash kernels inside
          its graph counted through the profiler
  net_gen an LM built by words at bench_prefill's width, `64 nn.gen`
          on a seeded [8, 2048] prompt: tokens against generate(), the
          uncaptured step's and (under strict) the teacher-forced
          replay, the decode's captures and replays, a generate's kernel
          launches by the profiler, the flash forward launched once per
          layer; then one word-path step `forward loss.ce backprop
          nn.adam` with the train phase's launch counts
  moe     the MoE layer: examples/t4_52_moe.4th's MoE parts through the
          REPL on the card against a CPU run of the port (TOL_NN), its
          nn.pipe part trained over two pipeline ranks; the zoo's tiny_moe
          one step card against CPU under fast and strict, soft and
          under T4_MOE_DISPATCH=1; train_epochs over tiny_moe on a
          seeded stub corpus against the word loop; the REPL's fused
          cycles and chunks over tiny_moe's layers against its per-word
          path, bit for bit, both routes
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
  attn_bench_dh512  the same four entry points at dh 512 (4 heads, S
          2048, one sweep shape 4 x 2048, 2 calls a chain, 2 timed
          chains): K3's hybrid class on clusters of four CTAs and K8 on
          the wide route (one CTA of four warpgroups),
          counted from 0 as the phase before, the fused backward held as
          there.
  host    the host tier: examples/t4_40a.4th whole through ten4_torch's
          main() with -t (and once without, and once more with): 21
          epochs at batch 256 on the fused path, its event file read
          back (every record's CRCs; each epoch's train/acc, loss, lr,
          time and test/acc, four histograms, the two tiles, the graph),
          the logged values against the printed ones, bench.py's
          held-out loop on the trained model (gate 0.98), seconds an
          epoch with and without -t, the deferred queue's backlog, and
          mstat's TLSF lines at bye against the live tensors; the native
          inner interpreter against the Python loop (t4_20a whole, `see
          mx` as the JAX package prints it, msec/cycle of the mx and mxl
          loops in turns); two tasks (a gemm4 loop, a send/recv `@`
          loop) at T4_VM_COUNT=4 while VM 0 captures and replays a fused
          chunk: their results and VM 0's weights against the same words
          in turn and a single-VM run, bit for bit; prof.start/prof.stop
          around gemm4 and gemm, the trace naming K6 and cuBLAS's GEMM
  arena   the device arena (T4_ARENA=1): t4_20a whole with the payloads
          in the one pool and without it (transcripts equal but for the
          clock and mstat's Ostore lines), mx's msec/cycle both ways,
          mstat's `Ostore(TLSF:owner)` and its owner line against the
          live tensors' bytes; t4_30e's nn_c trained 2 epochs on the
          per-word path both ways, the printed acc=/loss= and bench.py's
          held-out accuracy equal
  mesh    the dp/tp mesh, its ranks gloo processes on the one card (NCCL
          refuses two ranks on one GPU): a ShardedTrainer gradient of
          tiny_lm at bench_prefill's width under dp2 against one rank
          (TOL_NN of each tensor's largest value), K1, K2a and K2b
          launched inside the ranks; t4_30e's word loop under dp2 and
          dp2,tp2 against one rank (test_word_mesh's bounds, uncaptured);
          generate at bench_prefill's width under dp2,tp2 (the KV caches
          [4, 4, S, 128] a rank) against the one-rank tokens, prefill ms
          and decode tok/s beside the one-rank numbers; the ranks'
          count, the backend and rank 0's collectives; each word-loop
          rank's peak allocated bytes and collectives a step beside one
          rank's (C10: a rank holds its shards)
  parallel  the parallel modules, every rank a gloo process on the card:
          ring attention over sp4 on [64, 2048, 128] f32, causal and
          not (4 K1 launches a rank a call, 4 K2a and 4 K2b a backward),
          outputs and dq, dk, dv of sum(o^2) against single-rank K4 over
          the whole sequence within TOL_F32_F64, the K/V hops and bytes;
          nn.pipe's engine over pp4 on tiny_transformer at
          bench_prefill's width with 4 layers (a stage a layer, 8
          microbatches of [1, 2048, 1024]), 2 batches, its weights
          against the word path's steps on one rank under strict, each
          stage's K1/K2a/K2b launches and seconds a step; nn.train over
          tiny_moe under T4_MESH=ep4 against the unsharded run (a rank's
          expert bytes a quarter; the worst element, its gradients and
          each forward's smallest top-2 route margin printed); the sp
          forward over make_mesh3(dp1, sp2, tp2) at bench_prefill's
          widths against one rank (K1 once an attention layer a rank,
          on the input gathered over sp); two processes started by
          T4_COORD/T4_NPROC/T4_RANK training on dp2 against one
Then the seconds each phase took (`phase_seconds`), one `kernels` JSON
line, the card's name and power limit as nvidia-smi reports them, and
last {"ok": true, "device": {...}}.

Exits non-zero, before printing any result, when there is no CUDA
device; and non-zero when a kernel does not build, launch or agree, or
any check fails.  Nothing is caught and turned into a pass.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
NO_SPILL = ("flash_fwd", "flash_bwd", "flash_bwd_fused", "attn_dots",
            "gemm_sm90")
LM = dict(batch=8, vocab=2048, dim=1024, heads=8, layers=4, rope=True)
N_PROMPT, N_NEW = 2048, 64
MOE_LM = dict(LM, layers=2)      # the MoE LM's depth, cut from 4
LM_DH512 = dict(LM, heads=2, layers=2)   # tiny_lm with dh 512: K1, K2a,
#                        K2b on clusters of four CTAs; depth cut from 4
LM_DH1024 = dict(LM, heads=1)    # ... with dh 1024: on clusters of eight
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
TOL_DOTS = 2.0 ** -6  # the probe against its plain version, of the largest
#                    term |bf16(s2) v| (the largest |s2| times the largest
#                    |v|).  The kernel's scores are the tensor cores' f32
#                    sums, whose adds truncate; the plain version's round to
#                    nearest (on bf16 values nearly always exactly).  Where
#                    the two straddle a bf16 rounding point, the rounded
#                    score moves by one bf16 step, at most 2^-7 of it, and
#                    the output by at most 2^-7 of one term.  That is the
#                    spacing of one term, with room for two such flips.
#                    (Until the probe ran on the tensor cores it was held to
#                    1e-4 of the largest output; one step of the largest
#                    term is 6 to 7 times that on randn at the phase's
#                    shapes, so any flip there broke it, and cuBLAS's bf16
#                    GEMM misses it by as much as the kernel.)
TOL_GRAD = 1e-3    # train: dw, db against the plain attention path, of
#                    each tensor's largest value
MARGIN = 1e-4      # top-2 logit gap below which a replay flip is a tie
# the class of the dots around a kernel when its path is held against
# the plain one: a decode against its teacher-forced replay (under fast
# the prompt's attention core is K1's f32 class in the decode and a bf16
# einsum in the replay, which is not flash-eligible at 2112 tokens), and
# the train step's gradients against the plain attention path's (under
# fast the bf16 rounding of the dots' operands turns the two cores'
# ~1e-6 difference into whole bf16 steps where an operand straddles a
# rounding point).  strict holds the dots near f32 (three bf16 products,
# 2^-16 of each term)
CHECK_CLASS = "strict"
SAMPLE_SEED, SAMPLE_TOP_K = 7, 50   # the sampled decode's draw
# the MoE LM of the serve phase: tiny_lm's widths (LM) at 2 layers, an
# MoE block (4 experts, hidden 1024, top-2) after each attention block
MOE_BLOCK = dict(experts=4, hidden=1024, top_k=2)
TRAIN_STEPS = 5    # timed steps after the counted one
TRAIN_LR = 1e-4    # Adam.  The reference's Adam has no bias correction,
#                    so its first steps move every weight by about 3 lr;
#                    at dim 1024 the small tests' 1e-2 and 1e-3 overshoot
FLASH_NAMES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the dh-384 to dh-1024 routes (clusters of 3 to 8 CTAs that split dh),
# both classes: the build's instances, whose registers the build records
WIDE_DH = (384, 512, 640, 768, 896, 1024)
FWD_CLUSTER_KERNELS = tuple(f"flash_fwd_kernel<{dh},3,{dh // 128}>"
                            for dh in WIDE_DH)
# the bf16 class's forward there (K1 hybrid, K8): the wide route, a
# warpgroup per 128 columns of dh, one CTA to dh 512, a pair past it
FWD_WIDE_KERNELS = tuple(f"flash_fwd_wide_kernel<{dh}>" for dh in WIDE_DH)
BWD_CLUSTER_KERNELS = tuple(
    f"flash_bwd_{w}_sm90_kernel<{dh},{np_},{dh // 128}>"
    for w in ("dkv", "dq") for dh in WIDE_DH for np_ in (3, 1))
# K3 on the same clusters: the fused backward's split body in both
# classes; K8 on the forward's wide route
FUSED_CLUSTER_KERNELS = tuple(f"fused_{cls}_sm90_kernel<{dh // 128}>"
                              for cls in ("f32", "hybrid") for dh in WIDE_DH)
DOTS_WIDE_KERNELS = tuple(f"attn_dots_wide_kernel<{dh}>" for dh in WIDE_DH)
PROBE_NAMES = ("flash_bwd_fused", "attn_dots")   # the measurement path's own
BENCH = dict(nh=16, s=2048, dh=128)   # bench.py's attention shape
BENCH_ITERS, BENCH_REPS = 4, 7        # calls per chain, timed chains
# the measurement path again at dh 512 (K3 on clusters of four CTAs, K8
# on the wide route): 4
# heads, one sweep shape, 2 calls a chain, 2 timed chains
ATTN_BENCH_WIDE = dict(nh=4, s=2048, dh=512, n_iter=2, reps=2,
                       shapes={"2048": (4, 2048)})
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

# the nn phase: mnist_cnn at t4_30e's width (batch 100, 28 x 28 x 1,
# conv 10@3x3, maxpool 2, linear 100, linear 10, softmax)
NN_BATCH = 100
NN_BATCHES = 5     # fixed batches the training steps cycle over
NN_STEPS = 100     # training steps: no NaN, and the loss falls
NN_TIMED = 20      # timed steps after them (median)
NN_LR = 1e-3       # Adam: its first step moves each weight by ~3.16 lr
# The card against the CPU port (exact f32), of each tensor's largest
# value.  fast rounds both operands of every conv and linear product to
# bf16 (8 significant bits, unit roundoff u = 2^-8), so a product is off
# by at most 2u of |a||b|; a weight gradient comes out of at most three
# dots in a row, and a sum may cancel to a few times below its terms:
# 2u * 8 = 2^-4.  strict keeps hi + lo of each operand (off by at most
# u^2 = 2^-16) and drops only lo * lo: three products, 2 * 2^-16 each,
# with the same factor 8 and 3 is under 2^-11.
TOL_NN = {"fast": 2.0 ** -4, "strict": 2.0 ** -11}
# a conv or linear dot on the card against f64 of its class's bf16 parts:
# the products are exact, only the f32 sums round (K <= 1960 terms)
TOL_NN_CLASS = 1e-5
# the layers mnist_cnn does not run, in one net on [8, 12, 12, 2]
# (kind, n, bias, opt), as Model.add takes them
NN_COVERAGE = ((1, 4, 0.5, [3, 2, 0, 1]),    # conv2d stride 2 -> 6 x 6 x 4
               (16, 0, 0.0, None),           # batchnorm
               (7, 0, 0.0, None),            # selu
               (18, 3, 0.5, [4, 2, 1, 1]),   # dconv2d -> 12 x 12 x 3
               (9, 0, 1.0, None),            # elu
               (13, 3, 0.0, None),           # avgpool 3 -> 4 x 4
               (17, 2, 0.0, None),           # upsample 2 -> 8 x 8
               (15, 2, 0.0, None),           # minpool 2 -> 4 x 4
               (8, 0, 0.1, None),            # leakyrelu
               (10, 0, 0.2, None),           # dropout 0.2
               (3, 0, 0.0, None),            # flatten -> 48
               (2, 10, 1.0, None),           # linear 10
               (12, 0, 0.0, None))           # logsmax
NN_COVERAGE_IN = (8, 12, 12, 2)

# the net phase: examples/t4_30e.4th through the REPL, batch 100, nn_c,
# Adam at 0.001 (decayed 0.9 an epoch by the script), on the synthetic
# mnist_train of 60,000, then bench.py's held-out loop over mnist_test
NET_EPOCHS = 20    # the script's own count
NET_GATE = 0.98    # BASELINE.md's held-out accuracy gate at 20 epochs
NET_SEED = 42      # bench.py's gate seed (io/loader.py Synthetic: the
#                    synthetic task has an init-dependent failure mode
#                    that a fixed seed keeps out of a regression gate)
NET_PROFILE_BATCHES = 50   # the profiled epoch slice
# The saved model loaded into a CPU model of the port: its weights are
# the card's bit for bit, and its logits (the softmax's input) on a
# held-out batch are within TOL_NN of the card's: they come out of three
# dots in a row (conv 3x3, linear 100, linear 10), each off by at most 2u
# of |a||b| under fast, with sums that cancel to a few times below their
# terms, TOL_NN's own budget.  The predicted classes of the two agree on
# at least NET_SAME_CLASS of the batch: a class flips only where its
# top-two margin is under twice the logits' gap (1.0 read at seed 42 on
# an H100 80GB HBM3 at 700 W, chip_smoke.py's net phase).
NET_SAME_CLASS = 0.99
# the net_gen phase: an LM built by words at bench_prefill's width
NET_GEN_WORDS = ("8 2048 1 1 nn.model 1024 2048 nn.embed\n"
                 + "layernorm 3 8 nn.attn tanh\n" * 4
                 + "layernorm 2048 nn.proj softmax constant lm")
NET_GEN_LR = 1e-4  # the word-path step's Adam rate (TRAIN_LR)
NET_CONTROL_EPOCHS = 2   # the per-word control's depth, cut from 20: the
#                          fused run's first epochs are held against it
PER_WORD = {"T4_NO_FUSE": "1", "T4_NO_MACRO": "1"}   # the control's path
# net_rollback: t4_30e's nn_c on a window of ROLLBACK_BATCHES batches in
# chunks of ROLLBACK_CHUNK, so that every epoch has a chunk in flight
ROLLBACK_BATCHES = 10
ROLLBACK_CHUNK = 4
NN_C = ("100 28 28 1 nn.model\n"
        "0.5 10 conv2d 2 maxpool relu flatten 100 linear relu "
        "10 linear softmax\nconstant {v}\n"
        "{v} batchsize dataset mnist_train constant {v}d drop")
# test_nan_guard.py's fault: SGD at 3e3 on a purely linear model
NAN_MODEL = ("8 28 28 1 nn.model\nflatten 16 linear 10 linear softmax\n"
             "constant {v}\n{v} batchsize dataset mnist_train constant "
             "{v}d drop")
NAN_LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
            ": {v}ep for forward loss.ce {probe}{v}l ! nn.hit {v}h +! "
            "backprop 3.0e3 nn.sgd next ;")
# net_train: nn.train over the zoo's tiny_transformer at bench_prefill's
# widths, on a seeded in-memory corpus of NET_TRAIN_BATCHES batches
NET_TRAIN_LM = dict(batch=8, seq=2048, dim=1024, heads=8, classes=10,
                    layers=2)
NET_TRAIN_BATCHES = 4
# the moe phase: nn.train over the zoo's tiny_moe on a stub corpus of
# MOE_BATCHES batches; the REPL's fused paths over tiny_moe's layers at
# mnist_train's shape on a window of MOE_FUSED_BATCHES batches in chunks
# of MOE_FUSED_CHUNK
MOE_BATCHES = 4
MOE_FUSED_BATCHES = 7
MOE_FUSED_CHUNK = 3
MOE_FUSED_NET = ("8 28 28 1 nn.model\n"
                 "4 nn.attn 2 32 4 nn.moe tanh flatten 10 linear softmax\n"
                 "constant {v}\n"
                 "{v} batchsize dataset mnist_train constant {v}d drop")
MOE_FUSED_LOOP = ("variable {v}h 0 {v}h ! variable {v}l\n"
                  ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
                  "backprop 0.001 nn.adam next ;")
# its weights after one epoch against the per-word loop's from the same
# start, of the largest weight: the two run the same kernels in the same
# order (the graph replays what the words launch), so they agree to the
# bit unless a kernel is not deterministic
TOL_NET_TRAIN = 1e-6


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
    dp, ds k); each reads q, k, v and do (`parts` bf16 parts each), lse
    and delta once and writes its outputs once.  The f32 class's split
    (parts 3) reads q, k, v and do and writes three bf16 parts of each (the
    split bytes, its own bound); hybrid's casts are the wrapper's"""
    pairs = s * (s + 1) // 2 if causal else s * s
    n_prod, n_out = (4, 2) if which == "dkv" else (3, 1)
    ops = n_prod * 2 * dh * b * pairs
    nbytes = (4 * b * s * dh * 2 * parts + 2 * b * s * 4
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
    """the rate of a backward route (ops.attn.bwd_plan, fused_parts): one
    bf16 product on the tensor cores (parts 1), or six (parts 3)"""
    return {1: PEAK_BF16_FLOPS, 3: PEAK_BF16_FLOPS / 6}[parts]


CTAS = {2: "two", 3: "three", 4: "four", 5: "five", 6: "six", 7: "seven",
        8: "eight"}   # a cluster's CTAs, in words
BWD_ROUTES = {1: "bf16 wgmma, one product",
              3: "bf16 wgmma, six products of a three-part split"}


def fwd_route(dh: int, hybrid: bool) -> str:
    """the forward's route (K1; K8 takes the hybrid one), from its plan"""
    from tensorforth_tpu_torch.ops import attn
    plan = attn.fwd_plan(1, 64, dh, hybrid)
    if not attn.fwd_wide(dh, hybrid):
        return bwd_route(plan.parts, plan.cluster)
    wgs = " and ".join(str(len(b)) for b in attn.wide_blocks(dh))
    return (BWD_ROUTES[1] + f", dh over warpgroups ({wgs}) of "
            + ("one CTA" if plan.cluster == 1 else "a pair of CTAs")
            + ", the partial scores summed in shared memory")


def fwd_kernel(dh: int, hybrid: bool, dots: bool = False) -> str:
    """the name of the forward's (or K8's) kernel instance at dh"""
    from tensorforth_tpu_torch.ops import attn
    plan = attn.fwd_plan(1, 64, dh, hybrid or dots)
    if attn.fwd_wide(dh, hybrid or dots):
        return f"{'attn_dots' if dots else 'flash_fwd'}_wide_kernel<{dh}>"
    if dots:
        return f"attn_dots_kernel<{dh}>"
    return f"flash_fwd_kernel<{dh},{plan.parts},{plan.cluster}>"


def ptxas_record(source: str, kernel: str) -> dict:
    """the build's ptxas record of one kernel instance of csrc/<source>.cu
    (registers, stack frame, spill bytes), or {} if it has none"""
    from tensorforth_tpu_torch.ops import _build
    log = _build.library_path(source).with_suffix(".log")
    recs = [k for k in ptxas_by_kernel(log.read_text() if log.exists()
                                       else "") if k["kernel"] == kernel]
    return recs[0] if recs else {}


def bwd_route(parts: int, cluster: int) -> str:
    """a backward route, from its plan's parts and cluster"""
    return BWD_ROUTES[parts] + (
        f", dh split over a cluster of {CTAS[cluster]} CTAs" if cluster > 1
        else "")


def kernel_names(fn, top=3):
    """the names of the `top` CUDA kernels that take most device time in
    one fn() under torch.profiler (a library call's backend)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return [key[:120] for _, key in sorted(rows, reverse=True)[:top]]


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
    fused_routes = {f"dh{dh}_{'hybrid' if hy else 'f32'}": {
        "parts": attn.fused_parts(dh, hy), "kv_tile": attn.FUSED_KV_TILE[(
            hy, dh)], "smem": attn.fused_smem(dh, attn.fused_parts(dh, hy)),
        "cluster": attn.fused_cluster(dh, hy)}
        for dh in attn.KERNEL_DH for hy in (False, True)}
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
          "attn_dots_kernels": by_source["attn_dots"],
          "flash_bwd_fused_routes": fused_routes,
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
                       ("flash_bwd_fused", ("fused_sm90_kernel<128>",
                                            "fused_sm90_kernel<256>",
                                            "fused_f32_sm90_kernel<1>",
                                            "fused_f32_sm90_kernel<2>",
                                            *FUSED_CLUSTER_KERNELS)),
                       ("attn_dots", ("attn_dots_kernel<128>",
                                      "attn_dots_kernel<256>",
                                      *DOTS_WIDE_KERNELS)),
                       ("flash_fwd", ("flash_fwd_kernel<128,3,1>",
                                      "flash_fwd_kernel<128,1,1>",
                                      "flash_fwd_kernel<256,3,1>",
                                      "flash_fwd_kernel<256,1,1>",
                                      *FWD_CLUSTER_KERNELS,
                                      *FWD_WIDE_KERNELS,
                                      "split_kernel<3>")),
                       ("flash_bwd", ("flash_bwd_dkv_sm90_kernel<128,3,1>",
                                      "flash_bwd_dq_sm90_kernel<128,3,1>",
                                      "flash_bwd_dkv_sm90_kernel<128,1,1>",
                                      "flash_bwd_dq_sm90_kernel<128,1,1>",
                                      "flash_bwd_dkv_sm90_kernel<256,1,1>",
                                      "flash_bwd_dq_sm90_kernel<256,1,1>",
                                      "flash_bwd_dkv_sm90_kernel<256,3,2>",
                                      "flash_bwd_dq_sm90_kernel<256,3,2>",
                                      *BWD_CLUSTER_KERNELS,
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


def fused_counts():
    from tensorforth_tpu_torch.ops import attn
    return {"kernel": attn.flash_attention_bwd_fused.launches,
            "split": attn.flash_attention_bwd_fused.split_launches}


def fused_case(args, split, bq, f64, sdpa_bwd, timed=True):
    """the fused backward kernel on one case's operands (q, k, v, o, lse,
    do, causal, hybrid, dlse): against its plain version (dq and both
    partials, the never-visited blocks included), against the two-kernel
    split's (dq, dk, dv), against f64 where given, and against itself run
    again; its grid and the launches of one call (the kernel, and the f32
    class's split); its times unless `timed` is false, and the
    library backward's where given (for hybrid cases also on bf16
    operands)"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    q, k, v, o, lse, do, causal, hybrid, dlse = args
    b, s, dh = q.shape
    parts = attn.fused_parts(dh, hybrid)
    call = (q, k, v, o, lse, do, bq, causal, hybrid, dlse)
    before = fused_counts()
    dq, dkp, dvp = attn.flash_attention_bwd_fused_parts(*call)
    one_call = {key: n - before[key] for key, n in fused_counts().items()}
    on_card = q.is_cuda
    calls_ok = one_call == ({"kernel": 1, "split": int(parts == 3)}
                            if on_card else {"kernel": 0, "split": 0})
    if q.is_cuda:
        torch.cuda.synchronize()
    # the plain version with the scores in the kernel's cluster order
    want = attn.flash_attention_bwd_fused_parts_ref(
        *call, cluster=attn.fused_cluster(dh, hybrid))
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
    plan = attn.fused_plan_on(q.device, b, s, bq, causal, hybrid, dh)
    row = {"bq": bq, "n_q": n_q, "blocks": plan.ctas,
           "grid": {"ctas": plan.ctas, "ctas_with_work": plan.cluster * b
                    * sum(1 for x in plan.work if x),
                    "kv_tile_rows": plan.kv_tile,
                    "kv_tiles_per_cta": plan.chunk,
                    "dq_partials": plan.n_slots,
                    "most_pairs_of_a_cta": plan.work[0], "smem": plan.smem,
                    "cluster": plan.cluster,
                    "route": bwd_route(parts, plan.cluster)},
           "launches_of_one_call": one_call,
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
        row["f64_ratio"] = max(f64_ratio(g, w, TOL_BWD_F32)
                               for g, w in zip(got, f64))
        ok = ok and row["max_abs_err_vs_f64"] <= TOL_BWD_F32
    del got, again, dq, dkp, dvp
    row["ok"] = ok and zeros_ok and split_ok and repeats and calls_ok
    if not timed:
        return row
    row["ms"] = time_ms(lambda: attn.flash_attention_bwd_fused(*call))
    row["ms_before_the_sums"] = time_ms(
        lambda: attn.flash_attention_bwd_fused_parts(*call))
    # the kernel alone, on the wrapper's prepared operands: the rest of
    # `ms` is the wrapper's (casts or the f32 class's split, delta, the dq
    # partials' sum, then the dK/dV sums)
    prep = attn._prepare_fused(q, k, v, o, lse, do, hybrid, dlse)
    row["kernel_ms"] = time_ms(lambda: attn._launch_fused(
        *prep, bq, causal, hybrid))
    del prep
    ops, nbytes = attn_bwd_fused_work(b, s, dh, bq, causal, 2 * parts)
    # the rate of the class's route (bwd_peak: one bf16 product, or six)
    row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes, bwd_peak(parts))
    row.update(gflop=ops / 1e9, mbytes=nbytes / 1e6,
               tflops=ops / row["ms"] / 1e9)
    if parts == 3:
        # the f32 class's split of q*scale*log2e, k, v and do alone (its
        # bytes bound it)
        qscale = attn.LOG2E / math.sqrt(dh)
        row["split_ms"] = time_ms(lambda: attn._split_bwd(
            q, k, v, do, qscale, attn.flash_attention_bwd_fused))
        row["split_bound_ms"] = 4 * b * s * dh * (4 + 3 * 2) / PEAK_BYTES \
            * 1e3
    if sdpa_bwd is not None:
        row["plain_ms"] = time_ms(
            lambda: attn.flash_attention_bwd_fused_ref(*call), reps=10)
        row["library_ms"] = time_ms(sdpa_bwd)
        # the library through a 4-d [1, B*h, S, dh] call, and in the
        # hybrid class on the operands' bf16 values: a 3-d call keeps the
        # library off its flash kernels
        row["library_ms_4d"] = time_ms(sdpa_grads(
            *(x[None] for x in (q, k, v, do)), causal))
        if hybrid:
            bf = torch.bfloat16
            row["library_bf16_ms"] = time_ms(sdpa_grads(
                *(x.to(bf)[None] for x in (q, k, v, do)), causal))
        # what bq trades: blocks in the grid against partial traffic; at
        # each bq (each its own KV chunk and dq partials) fused = split
        # holds as at the case's own
        by_bq = (128, 256, 512, 1024, 2048)
        row["equals_split_by_bq"] = {str(x): fused_equals_split(
            attn.flash_attention_bwd_fused(q, k, v, o, lse, do, x, causal,
                                           hybrid, dlse), split, hybrid)
            for x in by_bq}
        row["ok"] = row["ok"] and all(row["equals_split_by_bq"].values())
        row["ms_by_bq"] = {str(x): time_ms(
            lambda: attn.flash_attention_bwd_fused(
                q, k, v, o, lse, do, x, causal, hybrid, dlse))
            for x in by_bq}
    return row


def dots_library(q, k, v):
    """the probe's function in two cuBLAS calls, a yardstick that the port
    never calls: bf16(q k^T) with f32 sums, then its product with v in f32
    sums (over all keys at once, where the kernel adds one key tile's
    product after another)"""
    import torch
    s2 = torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(s2.to(torch.bfloat16), v, out_dtype=torch.float32)


def dots_case(q, k, v, timed=True):
    """the probe on one case's bf16 operands against its plain version
    (TOL_DOTS of the largest term), with its times, bound and the
    library's when `timed`"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    b, s, dh = q.shape
    plan = attn.fwd_plan(b, s, dh, True)
    kern = fwd_kernel(dh, True, dots=True)
    clusters = attn.flash_clusters("dots", dh, True, q.device.index or 0)
    before = attn.attn_dots.launches
    o = attn.attn_dots(q, k, v)
    torch.cuda.synchronize()
    launched = attn.attn_dots.launches - before
    want = attn.attn_dots_ref(q, k, v)
    err, top = (o - want).abs().max().item(), want.abs().max().item()
    # the largest term |s2| |v|, eight heads at a time
    term = max(torch.einsum("nqd,nkd->nqk", q[i:i + 8].float(),
                            k[i:i + 8].float()).abs().max().item()
               for i in range(0, b, 8)) * v.float().abs().max().item()
    row = {"shape": [b, s, dh], "max_abs_err": err,
           "largest_reference_value": top, "largest_term": term,
           "err_over_largest_value": err / top,
           "err_over_largest_term": err / term, "tol": TOL_DOTS,
           "launches_of_one_call": launched,
           "cluster": plan.cluster, "warpgroups": plan.warpgroups,
           "clusters_at_once": clusters,
           "idle_sms": torch.cuda.get_device_properties(
               q.device).multi_processor_count - clusters * plan.cluster,
           "ptxas": dict(ptxas_record("attn_dots", kern), kernel=kern),
           "ok": (err <= TOL_DOTS * term and bool(torch.isfinite(o).all())
                  and tuple(o.shape) == (b, s, dh)
                  and o.dtype == torch.float32 and launched == 1),
           "route": "the hybrid forward's body, softmax compiled out: "
                    + fwd_route(dh, True)}
    del o, want
    if not timed:
        return row
    # the yardstick on the same operands, for the record
    lib_err = (dots_library(q, k, v) - attn.attn_dots_ref(q, k, v)).abs(
    ).max().item()
    ops, nbytes = attn_dots_work(b, s, dh)
    bms, by = bound_ms(ops, nbytes, PEAK_BF16_FLOPS)
    ms = time_ms(lambda: attn.attn_dots(q, k, v))
    # the forward kernel alone on the same bf16 operands, q scaled as it
    # is loaded: what the softmax adds to the two products
    fwd_ms = time_ms(lambda: attn._launch_fwd(
        q, k, v, False, True, attn.LOG2E / math.sqrt(dh)))
    row.update({
        "flash_fwd_ms_on_the_same_operands": fwd_ms,
        "flash_fwd_over_attn_dots": fwd_ms / ms,
        "ms": ms, "plain_ms": time_ms(
            lambda: attn.attn_dots_ref(q, k, v), reps=5),
        "library_ms": time_ms(lambda: dots_library(q, k, v)),
        "library_max_abs_err": lib_err,
        "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
        "tflops": ops / ms / 1e9, "bound_ms": bms, "bound_by": by})
    return row


def phase_kernel_dots(seed: int):
    """the dots-only probe (the forward's wgmma body with the softmax
    compiled out) against its plain version; returns its record at the
    bench shape"""
    import torch
    rows, main = [], None
    for i, (b, s, dh) in enumerate(((BENCH["nh"], BENCH["s"], BENCH["dh"]),
                                    (64, 2048, 128), (8, 1024, 256))):
        rs = np.random.RandomState(seed + 200 + i)
        q, k, v = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda().to(torch.bfloat16) for _ in range(3))
        rows.append(dots_case(q, k, v))
        main = main or rows[-1]
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "attn_dots", "cases": rows,
          "tol": f"{TOL_DOTS} of the largest term |s2| |v|",
          "library": DOTS_LIBRARY})
    if not all(r["ok"] for r in rows):
        raise RuntimeError("attn_dots disagrees with its plain version")
    return main


DOTS_LIBRARY = ("two cuBLAS calls: torch.bmm(q, k^T, out_dtype=f32), "
                ".to(bf16), torch.bmm(., v, out_dtype=f32)")


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
        # the dh-256 train slice's shape: tiny_lm at bench_prefill's
        # widths with 4 heads
        ("dh256_slice_causal", 32, 2048, 256, True, False, False, 1024),
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
                "route": bwd_route(plan.parts, plan.dq.cluster), "plan": {
                    key: (val._asdict() if hasattr(val, "_asdict") else val)
                    for key, val in plan._asdict().items()},
                "max_abs_err": errs,
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
        timed = name in ("slice_causal", "bench_causal_hybrid",
                         "dh256_causal", "dh256_slice_causal")
        brow["fused"] = fused_case(
            (q, k, v, o, lse, do, causal, hybrid, dlse), (dq, dk, dv), bq,
            w64, sdpa_grads(q, k, v, do, causal) if timed else None)
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
                    q, k, v, do, qscale, attn.flash_attention_bwd))
                brow["split_bound_ms"] = split_bytes / PEAK_BYTES * 1e3
            brow["kernels_and_split_ms"] = (brow["dkv"]["kernel_ms"]
                                            + brow["dq"]["kernel_ms"]
                                            + brow.get("split_ms", 0.0))
        if name.startswith("dh256") and not hybrid:
            # K1's <256,3> route (the dh-256 train step's): the kernel
            # alone on its split's parts, the split, and SDPA's f32
            # forward through a 4-d call on the same operands
            qscale = attn.LOG2E / math.sqrt(dh)
            row["split_ms"] = time_ms(lambda: attn._split_qkv(q, k, v,
                                                              qscale))
            parts = attn._split_qkv(q, k, v, qscale)
            row["kernel_ms"] = time_ms(lambda: attn._launch_fwd(
                *parts, causal, False))
            del parts
            row["library_ms_4d"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
            main.setdefault("flash_fwd_dh256", {})[name] = {
                key: row[key] for key in (
                    "shape", "route", "ms", "kernel_ms", "split_ms",
                    "split_bound_ms", "bound_ms", "bound_by",
                    "library_ms_4d", "max_abs_err_o", "max_abs_err_lse",
                    "f64_ratio_o", "f64_ratio_lse")}
            # the f32 class at dh 256 (the cluster routes) beside the
            # library's f32 backward on the same operands (timed by the
            # fused case; the 4-d call's kernels named), the plain version,
            # and K3's f32 class at dh 256
            fused = brow["fused"]
            brow.update(
                library_ms=fused["library_ms"],
                library_ms_4d=fused["library_ms_4d"],
                library_4d_kernels=kernel_names(sdpa_grads(
                    *(x[None] for x in (q, k, v, do)), causal)),
                plain_ms=time_ms(lambda: attn.flash_attention_bwd_ref(
                    *call, dlse=dlse), reps=5))
            common = {key: brow[key] for key in (
                "shape", "route", "plan", "ms", "split_ms",
                "split_bound_ms", "kernels_and_split_ms", "plain_ms",
                "library_ms", "library_ms_4d", "library_4d_kernels",
                "f64_ratio_kernel", "two_runs_bit_equal")}
            for which, errs_of in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
                main.setdefault(f"flash_bwd_{which}_dh256", {})[name] = dict(
                    brow[which], max_abs_err=max(errs[e] for e in errs_of),
                    **common)
            main.setdefault("flash_bwd_fused_f32_dh256", {})[name] = {
                key: fused[key] for key in (
                    "kernel_ms", "ms", "ms_before_the_sums", "split_ms",
                    "bound_ms", "bound_by", "plain_ms", "library_ms",
                    "library_ms_4d", "grid", "bq", "launches_of_one_call",
                    "max_abs_err", "max_abs_err_vs_split",
                    "fused_equals_split", "max_abs_err_vs_f64", "f64_ratio",
                    "two_runs_bit_equal")}
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
            # K3's f32 class at dh 128 (six products after its split),
            # beside the split's kernels and the library's f32 backward
            fused = brow["fused"]
            main["flash_bwd_fused_f32"] = dict(
                {key: fused[key] for key in (
                    "ms", "ms_before_the_sums", "kernel_ms", "split_ms",
                    "split_bound_ms", "bound_ms", "bound_by", "plain_ms",
                    "library_ms", "library_ms_4d", "launches_of_one_call",
                    "grid", "bq", "max_abs_err", "max_abs_err_vs_split",
                    "max_abs_err_vs_f64", "equals_split_by_bq",
                    "ms_by_bq") if key in fused},
                shape=[b, s, dh], causal=causal,
                split_kernels_and_split_ms=brow["kernels_and_split_ms"])
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
    # the gate: a head dim the kernels are not built for (dh 1152) takes
    # the einsum path on the card and launches nothing; the wrapper and
    # both C entries refuse it, given the widest route's plan
    from tensorforth_tpu_torch.nn import funcs
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 512, 1152).astype(np.float32)).cuda()
    before = flash_counts()
    gate_ok = (torch.equal(funcs.sdpa(x, x, x, True),
                           funcs._sdpa_ref(x, x, x, True))
               and flash_counts() == before)
    try:
        attn.flash_attention(x, x, x, True)
        gate_ok = False
    except ValueError:
        pass
    pw = attn.fwd_plan(2, 512, 1024, False)
    bw = attn.bwd_plan(2, 512, 1024, False).dq
    xp = x.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        gate_ok = gate_ok and attn._lib("flash_fwd").t4_flash_fwd(
            xp, xp, xp, xp, xp, 2, 512, 1152, 1, 3, pw.bq, pw.bkv,
            pw.stages, pw.smem, pw.cluster, 1.0, stream) != 0
        gate_ok = gate_ok and attn._lib("flash_bwd").t4_flash_bwd_dq(
            xp, xp, xp, xp, xp, xp, xp, 2, 512, 1152, 1, 3, bw.rows,
            bw.tile, bw.stages, bw.smem, bw.cluster, 1.0,
            stream) != 0
    torch.cuda.synchronize()
    if not gate_ok:
        failed.append("sdpa gate and launch at dh=1152")
    common = {"phase": "kernel", "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
              "peak_tb_s": PEAK_BYTES / 1e12}
    emit(dict(common, kernel="flash_fwd", cases=rows,
              peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
              precision="bf16 wgmma, f32 sums: f32 class six products of a "
                        "three-part split (bound at a sixth of the bf16 "
                        "rate), hybrid one product",
              dh1152_takes_the_einsum_path_and_is_refused=gate_ok))
    emit(dict(common, kernel="flash_bwd (dkv, dq) and flash_bwd_fused",
              cases=bwd_rows, peak_bf16_tflops=PEAK_BF16_FLOPS / 1e12,
              precision="dkv, dq: bf16 wgmma, f32 sums: f32 class six "
                        "products of a three-part split (bound at a sixth "
                        "of the bf16 rate; at dh 256 over a cluster of two "
                        "CTAs that split dh), hybrid one product",
              fused_precision="hybrid: bf16 wgmma, f32 sums (bound at the "
                              "bf16 rate); f32: six products of a "
                              "three-part split after one split launch "
                              "(bound at a sixth of the bf16 rate; at dh "
                              "256 over a cluster of two CTAs that split "
                              "dh)",
              plain_and_library_ms="one pass that gives dq, dk and dv: "
                                   "both kernels' work, and the fused "
                                   "kernel's with its sums"))
    if failed:
        raise RuntimeError(f"kernels disagree with their plain versions: "
                           f"{failed}")
    return main


# the wide head dims' cases (K1, K2a, K2b on clusters of dh / 128 CTAs):
# [16, 2048, 512] (tiny_lm at bench_prefill's widths with 2 heads: the
# cores of its full depth), and dh 384 and 640 to 1024 at the same B*h and
# S (the dh-1024 slice's cores are [8, 2048, 1024]); every route causal
# and not (each cluster size is an exchange of its own)
WIDE_CASES = tuple((dh, causal, hybrid) for dh in WIDE_DH
                   for hybrid in (False, True) for causal in (True, False))
WIDE_BH, WIDE_S = 16, 2048
WIDE_REPS = 7      # timed runs a kernel_wide time is the median of


def phase_kernel_wide(seed: int, bh=WIDE_BH, s=WIDE_S, cases=WIDE_CASES):
    """K1, K2a and K2b at dh 384 to 1024, both classes, causal and not,
    against their plain versions (the class's
    tolerance; the f32 class also against f64, and each backward twice,
    bit for bit), with an lse cotangent in the non-causal cases; the
    causal f32 and hybrid cases
    timed: each kernel alone and with its split, beside its bound and
    SDPA's f32 forward and backward through a 4-d call on the same
    operands.  Returns the `kernels` line's entries by kernel name"""
    import torch
    import torch.nn.functional as F
    from tensorforth_tpu_torch.ops import attn
    rows, failed, entries = [], [], {}

    wide_ms = functools.partial(time_ms, reps=WIDE_REPS)

    for i, (dh, causal, hybrid) in enumerate(cases):
        t0 = time.perf_counter()
        # numpy's float32 normal generator: the inputs at dh 1024 are 134 M
        # values, which RandomState.randn makes in seconds
        rs = np.random.default_rng(seed + 100 + i)
        q, k, v, do = (torch.from_numpy(rs.standard_normal(
            (bh, s, dh), dtype=np.float32)).cuda() for _ in range(4))
        dlse = (None if causal else torch.from_numpy(rs.standard_normal(
            (bh, s), dtype=np.float32)).cuda())
        cl = attn.fwd_cluster(dh)
        fplan = attn.fwd_plan(bh, s, dh, hybrid)
        bplan = attn.bwd_plan(bh, s, dh, hybrid)
        name = f"dh{dh}_{'causal' if causal else 'noncausal'}_" + (
            "hybrid" if hybrid else "f32")
        kern = fwd_kernel(dh, hybrid)
        row = {"case": name, "shape": [bh, s, dh], "causal": causal,
               "hybrid": hybrid, "dlse": dlse is not None,
               "route": bwd_route(fplan.parts, cl),
               "fwd_route": fwd_route(dh, hybrid),
               "fwd_ptxas": dict(ptxas_record("flash_fwd", kern),
                                 kernel=kern),
               "fwd_plan": fplan._asdict(),
               "bwd_plan": {key: (val._asdict() if hasattr(val, "_asdict")
                                  else val)
                            for key, val in bplan._asdict().items()},
               "clusters_at_once": {
                   kern: attn.flash_clusters(kern, dh, hybrid,
                                             q.device.index or 0)
                   for kern in ("fwd", "dkv", "dq")}}
        # the SMs that many clusters of the route leave without a CTA
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        row["idle_sms"] = {kern: sms - n * (fplan.cluster if kern == "fwd"
                                            else bplan.dq.cluster)
                           for kern, n in row["clusters_at_once"].items()}
        # --- forward, against the plain version in the kernel's sum order
        o, lse = attn.flash_attention(q, k, v, causal=causal, hybrid=hybrid)
        torch.cuda.synchronize()
        # the output's bits, for holding two trees against each other
        row["fwd_sha1"] = sha1_of(o, lse)
        o_r, lse_r = attn.flash_attention_ref(q, k, v, causal, hybrid,
                                              cl if hybrid else 1)
        tol = TOL_HYBRID if hybrid else TOL_F32
        row["fwd_max_abs_err"] = [(o - o_r).abs().max().item(),
                                  (lse - lse_r).abs().max().item()]
        ok = (max(row["fwd_max_abs_err"]) <= tol
              and bool(torch.isfinite(o).all()))
        del o_r, lse_r
        if not hybrid:
            o64, l64 = f64_attention(q, k, v, causal)
            row["fwd_f64_ratio"] = max(f64_ratio(o, o64), f64_ratio(lse, l64))
            ok = ok and row["fwd_f64_ratio"] <= 1
            del o64, l64
        # --- backward, from the forward kernel's o and lse
        call = (q, k, v, o, lse, do, causal, hybrid)
        got = attn.flash_attention_bwd(*call, dlse=dlse)
        again = attn.flash_attention_bwd(*call, dlse=dlse)
        torch.cuda.synchronize()
        row["bwd_two_runs_bit_equal"] = all(
            torch.equal(g, a) for g, a in zip(got, again))
        del again
        # the exchange of the partial scores, each kernel's registers and
        # spills, and the gradients' bits (two trees held against each
        # other: the same SHA-1s where the kernels kept their bits)
        row["bwd_exchange"] = exchange("k2", bplan.dq.cluster, hybrid)
        row["fwd_exchange"] = exchange("k1", fplan.cluster, hybrid)
        row["bwd_ptxas"] = {
            w: dict(ptxas_record("flash_bwd", kern), kernel=kern)
            for w, kern in ((w, f"flash_bwd_{w}_sm90_kernel<{dh},"
                                f"{bplan.parts},{bplan.dq.cluster}>")
                            for w in ("dkv", "dq"))}
        row["bwd_sha1"] = {nm: sha1_of(g)
                           for nm, g in zip(("dq", "dk", "dv"), got)}
        want = attn.flash_attention_bwd_ref(*call, dlse=dlse,
                                            cluster=cl if hybrid else 1)
        names = ("dq", "dk", "dv")
        row["bwd_max_abs_err"] = {nm: (g - w).abs().max().item()
                                  for nm, g, w in zip(names, got, want)}
        row["bwd_largest_reference_value"] = {
            nm: w.abs().max().item() for nm, w in zip(names, want)}
        del want
        spilled = [r["kernel"] for r in row["bwd_ptxas"].values()
                   if r.get("spill_stores", 1) or r.get("spill_loads", 1)
                   or r.get("stack_frame", 1)]
        bok = not spilled and row["bwd_two_runs_bit_equal"] and all(
            bool(torch.isfinite(g).all()) and row["bwd_max_abs_err"][nm] <= (
                TOL_BWD_HYBRID * row["bwd_largest_reference_value"][nm]
                if hybrid else TOL_BWD_F32) for nm, g in zip(names, got))
        if not hybrid:
            w64 = f64_grads(q, k, v, do, dlse, causal)
            row["bwd_max_abs_err_vs_f64"] = max(
                (g.double() - w).abs().max().item() for g, w in zip(got, w64))
            row["bwd_f64_ratio"] = max(f64_ratio(g, w, TOL_BWD_F32)
                                       for g, w in zip(got, w64))
            bok = bok and row["bwd_max_abs_err_vs_f64"] <= TOL_BWD_F32
            del w64
        row["tol"] = {"fwd": tol, "bwd": (
            f"{TOL_BWD_HYBRID} of the largest reference value" if hybrid
            else TOL_BWD_F32)}
        row["ok"] = ok and bok
        del got
        if causal:
            # --- the times the kernel table keeps
            qscale = attn.LOG2E / math.sqrt(dh)
            ops, nbytes, split_bytes = attn_work(bh, s, dh, causal, hybrid)
            fb, fby = bound_ms(ops, nbytes, fwd_peak(hybrid))
            fwd = {"ms": wide_ms(lambda: attn.flash_attention(
                q, k, v, causal=causal, hybrid=hybrid)),
                "bound_ms": fb, "bound_by": fby, "gflop": ops / 1e9}
            if hybrid:
                bf = torch.bfloat16
                ops3 = ((q * qscale).to(bf), k.to(bf), v.to(bf))
            else:
                fwd["split_ms"] = wide_ms(lambda: attn._split_qkv(
                    q, k, v, qscale))
                fwd["split_bound_ms"] = split_bytes / PEAK_BYTES * 1e3
                ops3 = attn._split_qkv(q, k, v, qscale)
            fwd["kernel_ms"] = wide_ms(lambda: attn._launch_fwd(
                *ops3, causal, hybrid))
            del ops3
            fwd["plain_ms"] = wide_ms(lambda: attn.flash_attention_ref(
                q, k, v, causal, hybrid), reps=5)
            cast = (lambda x: x.to(torch.bfloat16)) if hybrid else (
                lambda x: x)
            fwd["library_ms_4d"] = wide_ms(
                lambda: F.scaled_dot_product_attention(
                    *(cast(x)[None] for x in (q, k, v)), is_causal=causal))
            args = attn._prepare_bwd(q, k, v, o, lse, do, causal, hybrid,
                                     dlse)
            bwd = {}
            for which in ("dkv", "dq"):
                kops, kbytes, bsplit = attn_bwd_work(which, bh, s, dh, causal,
                                                     bplan.parts)
                kb, kby = bound_ms(kops, kbytes, bwd_peak(bplan.parts))
                bwd[which] = {
                    "kernel_ms": wide_ms(lambda: attn._launch_bwd(
                        which, *args)),
                    "ms": wide_ms(lambda: attn.flash_attention_bwd(
                        *call, dlse=dlse, only=which)),
                    "bound_ms": kb, "bound_by": kby, "gflop": kops / 1e9}
            del args
            common = {"ms_whole_backward": wide_ms(
                lambda: attn.flash_attention_bwd(*call, dlse=dlse)),
                "plain_ms": wide_ms(lambda: attn.flash_attention_bwd_ref(
                    *call, dlse=dlse), reps=5),
                "library_ms_4d": wide_ms(sdpa_grads(
                    *(cast(x)[None] for x in (q, k, v, do)), causal))}
            if not hybrid:
                common["split_ms"] = wide_ms(lambda: attn._split_bwd(
                    q, k, v, do, qscale, attn.flash_attention_bwd))
                common["split_bound_ms"] = bsplit / PEAK_BYTES * 1e3
            row["timed"] = {"fwd": fwd, "bwd": dict(bwd, **common)}
            tag = f"{'hybrid' if hybrid else 'f32'}_dh{dh}"
            keep = {"shape": [bh, s, dh], "causal": causal,
                    "route": row["route"],
                    "clusters_at_once": row["clusters_at_once"],
                    "idle_sms": row["idle_sms"]}
            entries.setdefault("flash_fwd", {})[tag] = dict(
                fwd, max_abs_err=max(row["fwd_max_abs_err"]),
                f64_ratio=row.get("fwd_f64_ratio"), plan=row["fwd_plan"],
                **dict(keep, route=row["fwd_route"]),
                ptxas=row["fwd_ptxas"])
            for which, errs_of in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
                entries.setdefault(f"flash_bwd_{which}", {})[tag] = dict(
                    bwd[which], **common, plan=row["bwd_plan"][which],
                    max_abs_err=max(row["bwd_max_abs_err"][e]
                                    for e in errs_of),
                    f64_ratio=row.get("bwd_f64_ratio"), **keep)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        if not row["ok"]:
            failed.append(name)
        del q, k, v, do, o, lse, dlse
        torch.cuda.empty_cache()
    probe_rows, probe_entries = wide_probes(seed)
    entries.update(probe_entries)
    bits = route_sha1s(seed)
    failed += [f"{r['kernel']} {r['shape']} causal={r.get('causal')} "
               f"hybrid={r.get('hybrid')}" for r in probe_rows if not r["ok"]]
    emit({"phase": "kernel_wide", "cases": rows,
          "fused_and_dots_cases": probe_rows,
          "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
          "precision": "bf16 wgmma, f32 sums: f32 class six products of a "
                       "three-part split (bound at a sixth of the bf16 "
                       "rate), hybrid one product; dh over a cluster of "
                       "dh / 128 CTAs",
          "tol_fused_vs_split": f"f32 {TOL_FUSED_SPLIT} absolute plus "
                                f"{TOL_FUSED_SPLIT} relative; hybrid "
                                f"{TOL_FUSED_SPLIT_HYBRID} of the largest "
                                "split value",
          "tol_dots": f"{TOL_DOTS} of the largest term |s2| |v|",
          "dots_library": DOTS_LIBRARY, "sha1": bits})
    if failed:
        raise RuntimeError(f"the wide head dims' kernels disagree: {failed}")
    return entries


def exchange(kernel: str, cluster: int, hybrid: bool) -> dict:
    """how a route's CTAs add their partial scores (kernel "k1", "k2" or
    "k3"): none (one CTA), Xch's one message (a pair), the wide route's
    warpgroups in the CTA's shared memory (K1's hybrid class), Xrs's
    reduce-scatter and all-gather at 3 to 8 CTAs, with the most 16-byte
    stores a thread makes in each round, its slots and (K3) where ds^T's
    parts live (ops.attn's model of the schedule)"""
    from tensorforth_tpu_torch.ops import attn
    if kernel == "k1" and hybrid:
        return {"kind": "wide", "rounds": 1 if cluster == 2 else 0}
    if cluster < 3:
        return {"kind": "xch" if cluster == 2 else "none",
                "rounds": cluster - 1}
    by_round = {k: max(len(attn.xrs_messages(cluster, r, 0, w, k))
                       for r in range(cluster)
                       for w in range(attn.XRS_WARPS)) for k in (1, 2)}
    slots = attn.xrs_slots(hybrid)
    out = {"kind": "xrs", "rounds": 2, "slots": slots,
           "barriers": attn.exchange_barriers(cluster, slots),
           "most_stores_a_thread_a_round": max(by_round.values()),
           "most_stores_a_thread_by_round": by_round}
    if kernel == "k3":
        out["ds_home"] = ("its own place after the two slots" if slots == 2
                          else "the slot, read() after the dq products")
    return out


def sha1_of(*tensors) -> str:
    """the SHA-1 of the tensors' bytes, one after another"""
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# the routes whose bits the wide bf16 forward left alone: K8 and K1 (both
# classes) at dh 128 and 256 on [4, 1024, dh]
ROUTE_BITS_SHAPE = (4, 1024)


def route_sha1s(seed: int, shape=ROUTE_BITS_SHAPE) -> dict:
    """SHA-1s of K8's and K1's outputs at dh 128 and 256 on inputs made
    from `seed`: equal in two trees where those routes kept their bits"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    out = {}
    for dh in (128, 256):
        rs = np.random.default_rng(seed + 500 + dh)
        q, k, v = (torch.from_numpy(rs.standard_normal(
            (*shape, dh), dtype=np.float32)).cuda() for _ in range(3))
        bf = torch.bfloat16
        out[f"attn_dots_dh{dh}"] = sha1_of(attn.attn_dots(
            q.to(bf), k.to(bf), v.to(bf)))
        for hybrid in (False, True):
            out[f"flash_fwd_{'hybrid' if hybrid else 'f32'}_dh{dh}"] = (
                sha1_of(*attn.flash_attention(q, k, v, causal=True,
                                              hybrid=hybrid)))
    return out


# K3 (both classes) and K8 at dh 384 to 1024, on clusters of dh / 128 CTAs:
# every dh held on a small shape (two Q blocks, so the never-visited
# partial blocks show), then causal [WIDE_BH, WIDE_S, dh] timed at
# WIDE_PROBE_TIMED beside the library's call
WIDE_PROBE_SMALL = (2, 512)      # (B*h, S) of the held cases
WIDE_PROBE_BQ = 256
WIDE_PROBE_TIMED = (512, 1024)


def wide_probes(seed: int, small=WIDE_PROBE_SMALL, timed_dh=WIDE_PROBE_TIMED,
                bh=WIDE_BH, s=WIDE_S):
    """K3 and K8 at dh 384 to 1024: K3 in both classes, causal and not
    (an lse cotangent in the non-causal cases), against its plain version
    in the cluster's sum order (dq and both partials, the never-visited
    blocks), against the two-kernel split K2a + K2b (TOL_FUSED_SPLIT; the
    hybrid class TOL_FUSED_SPLIT_HYBRID), the f32 class against f64, and
    against itself run again; K8 against its plain version (TOL_DOTS).
    Then the causal [bh, s, dh] cases at `timed_dh`: K3's and K8's times,
    bounds and library calls (SDPA's backward; two cuBLAS bmm), K3 beside
    the split's.  Returns (rows, the `kernels` line's entries)"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    rows, entries = [], {}
    b, sm = small
    index = torch.cuda.current_device()
    for i, dh in enumerate(WIDE_DH):
        t0 = time.perf_counter()
        rs = np.random.default_rng(seed + 300 + i)
        q, k, v, do = (torch.from_numpy(rs.standard_normal(
            (b, sm, dh), dtype=np.float32)).cuda() for _ in range(4))
        dlse = torch.from_numpy(rs.standard_normal(
            (b, sm), dtype=np.float32)).cuda()
        for hybrid in (False, True):
            for causal in (True, False):
                cot = None if causal else dlse
                o, lse = attn.flash_attention(q, k, v, causal=causal,
                                              hybrid=hybrid)
                split = attn.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                 hybrid, dlse=cot)
                f64 = None if hybrid else f64_grads(q, k, v, do, cot, causal)
                row = fused_case((q, k, v, o, lse, do, causal, hybrid, cot),
                                 split, WIDE_PROBE_BQ, f64, None,
                                 timed=False)
                rows.append(dict(
                    row, kernel="flash_bwd_fused", shape=[b, sm, dh],
                    causal=causal, hybrid=hybrid, dlse=cot is not None,
                    clusters_at_once=attn._active_clusters(index, dh,
                                                           hybrid)))
                del o, lse, split, f64
        bf = torch.bfloat16
        rows.append(dict(dots_case(q.to(bf), k.to(bf), v.to(bf),
                                   timed=False), kernel="attn_dots"))
        rows[-1]["seconds"] = time.perf_counter() - t0
        del q, k, v, do, dlse
    for i, dh in enumerate(timed_dh):
        rs = np.random.default_rng(seed + 400 + i)
        q, k, v, do = (torch.from_numpy(rs.standard_normal(
            (bh, s, dh), dtype=np.float32)).cuda() for _ in range(4))
        for hybrid in (False, True):
            t0 = time.perf_counter()
            o, lse = attn.flash_attention(q, k, v, causal=True,
                                          hybrid=hybrid)
            bq = attn._fused_bq("chip_smoke", s, None)
            plan = attn.fused_plan_on(q.device, bh, s, bq, True, hybrid, dh)
            call = (q, k, v, o, lse, do, bq, True, hybrid, None)
            got = attn.flash_attention_bwd_fused(*call)
            split = attn.flash_attention_bwd(q, k, v, o, lse, do, True,
                                             hybrid)
            want = attn.flash_attention_bwd_fused_ref(*call,
                                                      cluster=plan.cluster)
            names = ("dq", "dk", "dv")
            errs = {nm: (g - w).abs().max().item()
                    for nm, g, w in zip(names, got, want)}
            tops = {nm: w.abs().max().item() for nm, w in zip(names, want)}
            bits = sha1_of(*got)
            ok = fused_equals_split(got, split, hybrid) and all(
                bool(torch.isfinite(g).all()) and (
                    errs[nm] <= TOL_BWD_HYBRID * tops[nm] if hybrid
                    else errs[nm] <= TOL_BWD_F32)
                for nm, g in zip(names, got))
            del got, split, want
            parts = plan.parts
            ops, nbytes = attn_bwd_fused_work(bh, s, dh, bq, True, 2 * parts)
            bms, by = bound_ms(ops, nbytes, bwd_peak(parts))
            prep = attn._prepare_fused(q, k, v, o, lse, do, hybrid, None)
            cast = (lambda x: x.to(torch.bfloat16)) if hybrid else (
                lambda x: x)
            tag = f"{'hybrid' if hybrid else 'f32'}_dh{dh}"
            kern = (f"fused_{'hybrid' if hybrid else 'f32'}_sm90_kernel"
                    f"<{plan.cluster}>")
            ent = {
                "shape": [bh, s, dh], "causal": True, "bq": bq,
                "route": bwd_route(parts, plan.cluster),
                "exchange": exchange("k3", plan.cluster, hybrid),
                "ptxas": dict(ptxas_record("flash_bwd_fused", kern),
                              kernel=kern),
                "grid": {"ctas": plan.ctas, "kv_tiles_per_cta": plan.chunk,
                         "dq_partials": plan.n_slots, "smem": plan.smem,
                         "cluster": plan.cluster},
                "clusters_at_once": attn._active_clusters(index, dh, hybrid),
                "max_abs_err": max(errs.values()),
                "max_abs_err_by_output": errs,
                "largest_reference_value": tops,
                "fused_equals_split": ok, "sha1": bits,
                "ms": time_ms(lambda: attn.flash_attention_bwd_fused(*call),
                              reps=WIDE_REPS),
                "kernel_ms": time_ms(lambda: attn._launch_fused(
                    *prep, bq, True, hybrid), reps=WIDE_REPS),
                "split_k2a_k2b_ms": time_ms(lambda: attn.flash_attention_bwd(
                    q, k, v, o, lse, do, True, hybrid), reps=WIDE_REPS),
                "plain_ms": time_ms(lambda: attn.flash_attention_bwd_fused_ref(
                    *call, cluster=plan.cluster), reps=3),
                "library_ms": time_ms(sdpa_grads(
                    *(cast(x)[None] for x in (q, k, v, do)), True),
                    reps=WIDE_REPS),
                "library": "scaled_dot_product_attention's backward through "
                           "a 4-d call" + (" on bf16 operands" if hybrid
                                           else ""),
                "bound_ms": bms, "bound_by": by, "gflop": ops / 1e9,
                "mbytes": nbytes / 1e6, "ok": ok}
            del prep
            if parts == 3:
                ent["split_ms"] = time_ms(lambda: attn._split_bwd(
                    q, k, v, do, attn.LOG2E / math.sqrt(dh),
                    attn.flash_attention_bwd_fused), reps=WIDE_REPS)
            ent["seconds"] = time.perf_counter() - t0
            entries.setdefault("flash_bwd_fused", {})[tag] = ent
            rows.append(dict(ent, kernel="flash_bwd_fused", hybrid=hybrid))
            del o, lse
        bf = torch.bfloat16
        t0 = time.perf_counter()
        ent = dots_case(q.to(bf), k.to(bf), v.to(bf))
        ent["seconds"] = time.perf_counter() - t0
        entries.setdefault("attn_dots", {})[f"dh{dh}"] = ent
        rows.append(dict(ent, kernel="attn_dots"))
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows, entries


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
    followed it.  Returns (checked, flips above MARGIN, ties below it).
    The forward runs in Config.PRECISION's class, so a replay checks a
    decode of the same class (the serve and net_gen phases take both
    under strict, see CHECK_CLASS)"""
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


class precision_set:
    """Config.PRECISION set to `cls` inside the block, put back after"""

    def __init__(self, cls):
        self.cls = cls

    def __enter__(self):
        from tensorforth_tpu_torch.config import Config
        self.kept, Config.PRECISION = Config.PRECISION, self.cls

    def __exit__(self, *exc):
        from tensorforth_tpu_torch.config import Config
        Config.PRECISION = self.kept


def decode_checks(m, prompt, n_new, device, lm, out, checks, tag=""):
    """the captured decode against the uncaptured body on the same device
    (serve._generate_ids with graphs=False: the same step, run eagerly),
    greedy (`out`, the main path's tokens) and sampled with one seed, and
    a strict generate against its teacher-forced replay; returns what it
    measured"""
    from tensorforth_tpu_torch.nn import serve
    device = torch_device(device)
    on_card = device.type == "cuda"
    eager = serve._generate_ids(m, prompt, n_new, temp=0.0, graphs=False)
    checks[f"{tag}tokens_equal_eager_body"] = bool((eager == out).all())
    kw = dict(temp=1.0, seed=SAMPLE_SEED, top_k=SAMPLE_TOP_K)
    sampled = serve.generate(m, prompt, n_new, **kw)
    sampled_eager = serve._generate_ids(m, prompt, n_new, graphs=False, **kw)
    checks[f"{tag}sampled_tokens_equal_eager_body"] = bool(
        (sampled == sampled_eager).all())
    checks[f"{tag}sampled_tokens_differ_from_greedy"] = bool(
        (sampled != out).any())
    # the replay of a decode of the same class: under fast the prompt's
    # attention core is K1's f32 class while the replay's einsum core
    # rounds to bf16, so the strict class holds both to f32's order
    fast = replay_check(m, out, device, lm, prompt.shape[1])
    with precision_set(CHECK_CLASS):
        strict = serve.generate(m, prompt, n_new, temp=0.0)
        checked, flips, ties = replay_check(m, strict, device, lm,
                                            prompt.shape[1])
    checks[f"{tag}replay_tokens"] = flips == 0
    return {"eager_token_agreement": float((eager == out).mean()),
            "sampled": {"seed": SAMPLE_SEED, "top_k": SAMPLE_TOP_K,
                        "agreement_with_eager": float(
                            (sampled == sampled_eager).mean())},
            "replay_class": CHECK_CLASS, "replay_checked": checked,
            "replay_flips": flips, "replay_ties_below_margin": ties,
            "fast_replay_of_fast_decode": {
                "checked": fast[0], "flips_above_margin": fast[1],
                "ties": fast[2]},
            "strict_token_agreement_with_fast": float(
                (strict == out).mean()),
            "on_card": on_card}


def torch_device(device):
    import torch
    return torch.device("cuda" if device is None else device)


def moe_lm(seq, device, lm, moe=MOE_BLOCK):
    """tiny_lm's program with an MoE block after each attention layer's
    activation (test_lm.py:207-225's MoE LM at `lm`'s widths)"""
    from tensorforth_tpu_torch.models.zoo import _new_model
    from tensorforth_tpu_torch.nn.ntypes import Layer
    m = _new_model(lm["batch"], seq, 1, 1, device=device)
    m.add(Layer.EMBED, lm["vocab"], float(lm["dim"]))
    for _ in range(lm["layers"]):
        m.add(Layer.LNORM)
        m.add(Layer.ATTN, lm["heads"], 3.0 if lm.get("rope") else 1.0)
        m.add(Layer.TANH)
        m.add(Layer.MOE, moe["experts"], float(moe["hidden"]),
              [moe["top_k"]])
    m.add(Layer.LNORM)
    m.add(Layer.PROJ, lm["vocab"])
    m.add(Layer.SOFTMAX)
    return m


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
    # cuBLAS's GEMM kernels (the class's products and the f32 `@`s;
    # the port's own GEMM kernels are named t4_*)
    gemm_ms = sum(v for k, v in by_name.items()
                  if "gemm" in k.lower() and "t4_" not in k)
    out = {"device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_idle_share": (1 - busy_ms / wall_ms
                                 if busy_ms > 0 else None),
           "cublas_gemm_ms": gemm_ms,
           "cublas_gemm_share_of_busy": (gemm_ms / busy_ms
                                         if busy_ms > 0 else None),
           "kernel_launches": sum(e.count for e in prof.key_averages()
                                  if e.device_type == DeviceType.CUDA)}
    for nm in FLASH_NAMES + ("Memcpy DtoD",):
        out[nm.replace(" ", "_").lower() + "_ms"] = sum(
            v for k, v in by_name.items() if nm in k)
    for nm in FLASH_NAMES:       # counted on the device: graph replays too
        out[nm + "_launches"] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and nm in e.key)
    out["top_kernels_ms"] = [[k[:80], v] for k, v in top]
    return out


def profile_generate(m, prompt, n_new, device, wall_ms, graphs=True):
    from tensorforth_tpu_torch.nn import serve
    return profile_run(lambda: serve._generate_ids(
        m, prompt, n_new, temp=0.0, graphs=graphs), device, wall_ms)


def time_generate(m, prompt, n_new, sync, graphs=True, reps=3):
    """median ms of a prefill alone (0 new tokens) and of a whole
    generate, each synchronized, and their samples"""
    from tensorforth_tpu_torch.nn import serve
    pre, tot = [], []
    for _ in range(reps):
        for n_gen, acc in ((0, pre), (n_new, tot)):
            t0 = time.perf_counter()
            serve._generate_ids(m, prompt, n_gen, temp=0.0, graphs=graphs)
            sync()
            acc.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(pre), statistics.median(tot), pre, tot


def phase_serve(seed: int, device="cuda", lm=LM, n_prompt=N_PROMPT,
                n_new=N_NEW, expect_launches=None, moe_lm_cfg=MOE_LM):
    """the main path: returns the flash forward's launches in it, and its
    split's (the f32 class splits before each launch)"""
    import torch
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn import serve
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.ops import attn
    from tensorforth_tpu_torch.system import System
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    System.get_sys().seed(seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    m = tiny_lm(seq=n_prompt, device=device, **lm)
    n = lm["batch"]
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (n, n_prompt))
    # --- the main path, counted: every count to 0 just before, read after
    reset_flash_counts()
    serve.reset_counts()
    t0 = time.perf_counter()
    out = generate(m, prompt, n_new, temp=0.0)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    decode = dict(serve.COUNTS)
    l_f32 = attn.flash_attention.launches
    out8 = generate(m, prompt, n_new, temp=0.0, kv_dtype="int8")
    sync()
    launches = attn.flash_attention.launches
    split = attn.flash_attention.split_launches
    l_int8 = launches - l_f32
    segments = serve._segments(n_prompt, n_prompt + n_new,
                               serve.Config.DECODE_WIN)

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
    # a generate on the card: its captures, then one replay a token
    # after the prefill, and no eager step
    checks["decode_captures_and_replays"] = (
        decode == {"captures": len(segments), "replays": n_new - 1,
                   "steps": 0} if on_card else
        decode == {"captures": 0, "replays": 0, "steps": n_new - 1})
    agree = decode_checks(m, prompt, n_new, device, lm, out, checks)
    int8_agree = float((out8[:, n_prompt:] == out[:, n_prompt:]).mean())

    # --- timings (after the counted run): the captured decode and the
    #     uncaptured body on the same device, in turns
    t_graph = time_generate(m, prompt, n_new, sync, graphs=on_card)
    t_eager = time_generate(m, prompt, n_new, sync, graphs=False)
    prefill_ms, total_ms = t_graph[:2]
    decode_s = (total_ms - prefill_ms) / 1e3
    eager_decode_s = (t_eager[1] - t_eager[0]) / 1e3
    prof = {"prefill": profile_generate(m, prompt, 0, device, prefill_ms,
                                        graphs=on_card),
            "generate": profile_generate(m, prompt, n_new, device,
                                         total_ms, graphs=on_card),
            "generate_eager_body": profile_generate(
                m, prompt, n_new, device, t_eager[1], graphs=False)}
    moe = moe_lm_check(seed, device, moe_lm_cfg, n_prompt, n_new, sync,
                       checks)
    emit({"phase": "serve", "model": dict(lm, n_prompt=n_prompt,
                                          n_new=n_new),
          "launches_f32": l_f32, "launches_int8": l_int8,
          "split_launches": split, "decode_counts": decode,
          "segments": segments, **agree,
          "margin": MARGIN, "int8_token_agreement": int8_agree,
          "first_generate_ms": first_ms, "prefill_ms": prefill_ms,
          "total_ms_per_generate": total_ms,
          "decode_tokens_per_s": (n * n_new / decode_s if decode_s > 0
                                  else None),
          "eager_body": {"prefill_ms": t_eager[0],
                         "total_ms_per_generate": t_eager[1],
                         "decode_tokens_per_s": (
                             n * n_new / eager_decode_s
                             if eager_decode_s > 0 else None),
                         "timing_samples": {"prefill_ms": t_eager[2],
                                            "total_ms": t_eager[3]}},
          "timing_samples": {"prefill_ms": t_graph[2],
                             "total_ms": t_graph[3]},
          "profile": prof, "moe_lm": moe, "peak_mem_gb": (
              torch.cuda.max_memory_allocated() / 1e9 if on_card else None),
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"serve checks failed: {bad}")
    return {"flash_fwd": launches, "flash_fwd_split": split}


class flash_gate_closed:
    """funcs._flash_ok closed inside the block, put back after: every
    attention core takes the einsum path (the LM tier's class), as the
    JAX package's does off the TPU"""

    def __enter__(self):
        from tensorforth_tpu_torch.nn import funcs
        self.kept, funcs._flash_ok = funcs._flash_ok, lambda q: False

    def __exit__(self, *exc):
        from tensorforth_tpu_torch.nn import funcs
        funcs._flash_ok = self.kept


def phase_serve_wide(seed: int, device="cuda", lm=LM_DH512,
                     n_prompt=N_PROMPT, n_new=N_NEW):
    """generate at a wide head dim (dh 512 or 1024: tiny_lm at
    bench_prefill's widths with 2 heads or 1), greedy: the prefill's attention cores go through
    K1's cluster route, one launch a layer, counted by the host counter
    and by the profiler on the device; the tokens against the uncaptured
    step's and, under strict, against the teacher-forced replay; the
    prefill and the generate timed, and the prefill beside it on the
    einsum path.  Returns the launches of the counted generate"""
    import torch
    from tensorforth_tpu_torch.models import tiny_lm
    from tensorforth_tpu_torch.nn import serve
    from tensorforth_tpu_torch.ops import attn
    from tensorforth_tpu_torch.system import System
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    System.get_sys().seed(seed)
    m = tiny_lm(seq=n_prompt, device=device, **lm)
    n, layers = lm["batch"], lm["layers"]
    dh = lm["dim"] // lm["heads"]
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (n, n_prompt))
    # --- the main path, counted: every count to 0 just before, read after
    reset_flash_counts()
    t0 = time.perf_counter()
    out = serve.generate(m, prompt, n_new, temp=0.0)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(flash_counts(),
                    flash_fwd_split=attn.flash_attention.split_launches)
    checks = {"shape": out.shape == (n, n_prompt + n_new),
              "prompt_kept": bool((out[:, :n_prompt] == prompt).all()),
              # (a CPU run takes the plain attention and launches none)
              "launches_per_generate": launches == {
                  "flash_fwd": layers * on_card, "flash_bwd_dkv": 0,
                  "flash_bwd_dq": 0, "flash_fwd_split": layers * on_card}}
    eager = serve._generate_ids(m, prompt, n_new, temp=0.0, graphs=False)
    checks["tokens_equal_eager_body"] = bool((eager == out).all())
    with precision_set(CHECK_CLASS):
        strict = serve.generate(m, prompt, n_new, temp=0.0)
        checked, flips, ties = replay_check(m, strict, device, lm, n_prompt)
    checks["replay_tokens"] = flips == 0
    prefill_ms, total_ms, pre, tot = time_generate(m, prompt, n_new, sync,
                                                   graphs=on_card)
    prof = profile_generate(m, prompt, n_new, device, total_ms,
                            graphs=on_card)
    if on_card:
        checks["profiled_launches"] = (
            prof["flash_fwd_launches"] == layers
            and prof["flash_bwd_dkv_launches"] == 0
            and prof["flash_bwd_dq_launches"] == 0)
    with flash_gate_closed():
        reset_flash_counts()
        plain_prefill = time_generate(m, prompt, 0, sync, graphs=on_card)
        checks["einsum_prefill_launches_nothing"] = (
            attn.flash_attention.launches == 0)
    emit({"phase": "serve_wide", "model": dict(lm, n_prompt=n_prompt,
                                               n_new=n_new),
          "head_dim": dh, "cluster": attn.fwd_cluster(dh),
          "launches": launches, "first_generate_ms": first_ms,
          "prefill_ms": prefill_ms, "total_ms_per_generate": total_ms,
          "einsum_prefill_ms": plain_prefill[0],
          "timing_samples": {"prefill_ms": pre, "total_ms": tot,
                             "einsum_prefill_ms": plain_prefill[2]},
          "replay_class": CHECK_CLASS, "replay_checked": checked,
          "replay_flips": flips, "replay_ties_below_margin": ties,
          "eager_token_agreement": float((eager == out).mean()),
          "profile": prof, "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"serve_wide checks failed: {bad}")
    return launches


def moe_lm_check(seed, device, lm, n_prompt, n_new, sync, checks):
    """the MoE LM (moe_lm) served: its captured decode's tokens against
    the uncaptured body's, greedy, on the route moe_select picks (soft:
    8 tokens a step) and under T4_MOE_DISPATCH=1 (both the prefill and
    the steps dispatch)"""
    from tensorforth_tpu_torch.nn import serve
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(seed + 1)
    m = moe_lm(n_prompt, device, lm)
    prompt = np.random.RandomState(seed + 1).randint(0, lm["vocab"],
                                                     (lm["batch"], n_prompt))
    res = {"model": dict(lm, moe=MOE_BLOCK)}
    for route, env in (("auto", None), ("dispatch", "1")):
        with env_set(T4_MOE_DISPATCH=env):
            serve.reset_counts()
            t0 = time.perf_counter()
            g = serve.generate(m, prompt, n_new, temp=0.0)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            counts = dict(serve.COUNTS)
            e = serve._generate_ids(m, prompt, n_new, temp=0.0, graphs=False)
        checks[f"moe_lm_{route}_tokens_equal_eager_body"] = bool(
            (g == e).all())
        res[route] = {"first_generate_ms": ms, "decode_counts": counts,
                      "token_agreement": float((g == e).mean()),
                      "distinct_new_tokens": int(len(np.unique(
                          g[:, n_prompt:])))}
    return res


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
    attn.flash_attention_bwd_fused.split_launches = 0
    attn.attn_dots.launches = 0


def launches_per_step(layers: int) -> dict:
    """a train step launches the forward kernel twice per attention layer
    (the layer backward runs the layer forward again), each after its
    split (the f32 class), and each backward kernel once, both after one
    split"""
    return {"flash_fwd": 2 * layers, "flash_fwd_split": 2 * layers,
            "flash_bwd_dkv": layers, "flash_bwd_dq": layers,
            "flash_bwd_split": layers}


def phase_train(seed: int, device="cuda", lm=LM, seq=N_PROMPT,
                steps=TRAIN_STEPS, expect_launches=None, wide=False):
    """the training path: returns the flash kernels' launches in one
    step.  wide (the cluster routes of dh 384 to 1024): the profiled
    step's K1, K2a and
    K2b launches are checked on the device too, and the same step on the
    einsum attention path is timed beside it"""
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

    # --- the kernels' gradients against the plain attention path (their
    #     launches are not counted), like against like: the plain path's
    #     core is the flash kernels' plain version in their class
    #     (funcs._sdpa_plain: exact f32), and both steps take the other
    #     dots under CHECK_CLASS.  Under fast the bf16 rounding of those
    #     dots' operands turns the cores' ~1e-6 difference into whole
    #     bf16 steps wherever an operand straddles a rounding point (the
    #     fast pair is recorded beside, unchecked)
    with precision_set(CHECK_CLASS):
        m.forward(inp).backprop(hot, flash=False)
        want = grads()
        m.grad_zero()
        m.forward(inp).backprop(hot)
        got = grads()
        m.grad_zero()
    m.forward(inp).backprop(hot, flash=False)
    want_fast = grads()
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
    got_fast = grads()
    m.adam(TRAIN_LR)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(flash_counts(),
                    flash_fwd_split=attn.flash_attention.split_launches,
                    flash_bwd_split=attn.flash_attention_bwd.split_launches)

    def rel(gs, ws):
        return [float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
                for g, w in zip(gs, ws)]
    checked, fast = rel(got, want), rel(got_fast, want_fast)
    checks = {"grads_match_plain_attention": max(checked) <= TOL_GRAD,
              "grads_nonzero": all(bool(w.any()) for w in want)}
    if expect_launches is not None:
        checks["launches_per_step"] = launches == expect_launches
    del got, want, got_fast, want_fast

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
    plain = None
    if wide:
        if on_card:
            want = launches_per_step(lm["layers"])
            checks["profiled_launches"] = all(
                prof[name + "_launches"] == want[name]
                for name in FLASH_NAMES)
        # the same step with every attention core on the einsum path (its
        # S x S scores in device memory), after the counted and timed ones
        with flash_gate_closed():
            reset_flash_counts()
            by_word = {}
            for _ in range(2):
                step(by_word)
            plain = {"ms_per_step": statistics.median(
                sum(ts) for ts in zip(*by_word.values())),
                "split_ms": {k: statistics.median(v)
                             for k, v in by_word.items()},
                "launches": flash_counts()}
        checks["einsum_step_launches_nothing"] = not any(
            plain["launches"].values())
        del losses[n_timed:]
    dh = lm["dim"] // lm["heads"]
    bplan = (attn.bwd_plan(n * lm["heads"], seq, dh, False)
             if dh in attn.KERNEL_DH else None)
    emit({"phase": "train", "model": dict(lm, seq=seq), "head_dim": dh,
          "attention_backward_route": bwd_route(
              bplan.parts, bplan.dq.cluster) if bplan else None,
          "optimizer": f"adam({TRAIN_LR})", "launches_per_step": launches,
          "max_rel_grad_err_vs_plain_attention": max(checked),
          "grad_check_class": CHECK_CLASS,
          "rel_grad_err_vs_plain_attention_by_tensor": checked,
          "fast_pair_rel_grad_err_by_tensor": fast,
          "grad_tol": TOL_GRAD, "losses": losses,
          "first_step_ms": first_ms, "ms_per_step": med,
          "split_ms": {k: statistics.median(v) for k, v in split.items()},
          "trained_tokens_per_s": n * seq / med * 1e3,
          "timing_samples": dict(split, step_ms=step_ms),
          "profile": prof, "einsum_attention_step": plain,
          "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                          if on_card else None),
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"train checks failed: {bad}")
    return launches


def nn_data(seed: int, batches: int, batch: int, shape=(28, 28, 1),
            classes: int = 10):
    """seeded images that a net can learn: each is half its class's
    template and half noise; (images [B, N, *shape] f32, labels [B, N])"""
    rs = np.random.RandomState(seed)
    protos = rs.rand(classes, *shape)
    labels = rs.randint(0, classes, (batches, batch))
    x = 0.5 * protos[labels] + 0.5 * rs.rand(batches, batch, *shape)
    return x.astype(np.float32), labels


def build_net(shape, layers, device):
    """a port model on `shape` with `layers` (NN_COVERAGE's form)"""
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    m = mmu.model(device=device)
    m.npush(mmu.tensor(*shape, device=device))
    for kind, n, bias, opt in layers:
        m.add(kind, n, bias, opt)
    return m


def nn_cpu_copy(m, build):
    """a CPU model built by `build` with `m`'s weights"""
    from tensorforth_tpu_torch import weights
    c = build("cpu")
    weights.load_jax_params(c, [tuple(a.cpu() for a in lp)
                                for lp in m._params()])
    return c


def nn_step(m, x, hot, loss_op, key_seed):
    """forward -> loss -> backprop -> adam on `m`: (output, loss, the
    training state after backprop, the state after the step).  The
    System seed is set first, so a dropout layer draws the same mask on
    either device."""
    from tensorforth_tpu_torch import weights
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    mmu = MMU.get_mmu()
    inp = mmu.tensor(*x.shape, device=m.device).set_numpy(x)
    tgt = mmu.tensor(*m[-1].shape, device=m.device).set_numpy(hot)
    System.get_sys().seed(key_seed)
    m.forward(inp)
    out = m[-1].numpy()
    loss = m.loss(loss_op, tgt)
    m.backprop(tgt)
    grads = weights.dump_state(m)
    m.adam(NN_LR)
    return out, loss, grads, weights.dump_state(m)


def adam_ref(st, lr):
    """the port's Adam step (the reference's: no bias correction) in f32
    numpy on a state of dump_state's, before the step"""
    f = np.float32
    g = st["dw"]
    m = np.zeros_like(g) if st["m"] is None else st["m"]
    v = np.zeros_like(g) if st["v"] is None else st["v"]
    m = f(0.9) * m + (f(1) - f(0.9)) * g
    v = f(0.999) * v + (f(1) - f(0.999)) * g * g
    return st["w"] - f(lr) * (m / (np.sqrt(v) + f(1e-6)))


def nn_compare(card, cpu, tol, card_first=True):
    """the largest errors of one nn_step on the card against the CPU port:
    the output of its largest value, the loss of itself, every dw and db
    of the largest gradient in the net (a conv bias under a batchnorm
    gets a gradient of rounding noise alone).  The
    weights after the Adam step: on the card, the step of its own
    gradients to f32 rounding; against the CPU, within the largest move
    of a first step, 2 * 3.17 lr, wherever the gradients differ in sign"""
    if not card_first:            # the CPU copy was stepped first
        card, cpu = cpu, card

    def rel(g, w):
        return float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
    out = {"out": rel(card[0], cpu[0]),
           "loss": abs(card[1] - cpu[1]) / abs(cpu[1]),
           "dw": max(float(np.abs(g["dw"] - w["dw"]).max())
                     for g, w in zip(card[2], cpu[2]))
           / max(float(np.abs(w["dw"]).max()) for w in cpu[2])}
    own = max(float(np.abs(a["w"] - adam_ref(b, NN_LR)).max())
              for a, b in zip(card[3], card[2]))
    out["w_after_step_vs_own_grads"] = own / NN_LR
    out["w_after_step_vs_cpu"] = max(
        float(np.abs(a["w"] - b["w"]).max())
        for a, b in zip(card[3], cpu[3])) / NN_LR
    out["ok"] = (max(out["out"], out["loss"], out["dw"]) <= tol
                 and own <= 1e-3 * NN_LR
                 and out["w_after_step_vs_cpu"] <= 2 * 3.17)
    return out


def nn_class_check(m, x, cls):
    """the conv and linear dots of `m` (on the card) on one forward's
    operands, against f64 of the class's bf16 parts: the largest error of
    the largest value, and the distance to the exact f32 dot (the class's
    own rounding)"""
    import torch
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.ntypes import Layer

    def parts(a):
        hi = a.to(torch.bfloat16).to(torch.float32)
        if cls == "fast":
            return [hi.double()]
        return [hi.double(), (a - hi).to(torch.bfloat16).double()]

    inp = MMU.get_mmu().tensor(*x.shape, device=m.device).set_numpy(x)
    m.forward(inp)
    res = {}
    for j, ((kind, opts, _), p) in enumerate(zip(m._program(), m._params())):
        x_in = m[j].ensure_data()
        if kind == Layer.CONV:
            a = funcs._filter2d(p[0])
            b = funcs._patches(x_in, p[0].shape[1], *opts)
        elif kind == Layer.LINEAR:
            a, b = x_in.reshape(x_in.shape[0], -1), p[0].T
        else:
            continue
        got = funcs.class_dot(funcs._mm, a, b).double()
        pa, pb = parts(a), parts(b)
        pairs = [(0, 0)] if cls == "fast" else [(1, 0), (0, 1), (0, 0)]
        want = sum(pa[i] @ pb[k] for i, k in pairs)
        exact = a.double() @ b.double()
        top = want.abs().max()
        res[f"{Layer.NAMES[kind].strip()}{j}"] = {
            "err": float((got - want).abs().max() / top),
            "from_exact_f32": float((got - exact).abs().max() / top)}
    return res


def phase_nn(seed: int, device="cuda", batch=NN_BATCH, steps=NN_STEPS,
             timed=NN_TIMED, coverage_in=NN_COVERAGE_IN, gan_batch=256):
    """mnist_cnn, the main path of the NN tier, under both precision
    classes: one step on the card against the CPU port, the class of its
    dots against f64, 100 training steps, the step's times; then the
    coverage net and gan_mnist's D, card against CPU.  No hand-written
    kernel lies on the path (its dots are library calls, as they are
    XLA's in the JAX package): the counts stay at 0."""
    import torch
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.models import gan_mnist, mnist_cnn
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.nn.ntypes import Loss
    from tensorforth_tpu_torch.ops import gemm
    from tensorforth_tpu_torch.system import System
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    xs, labels = nn_data(seed, NN_BATCHES, batch)
    hots = np.eye(10, dtype=np.float32)[labels].reshape(
        NN_BATCHES, batch, 1, 10, 1)
    mmu = MMU.get_mmu()
    checks, rec = {}, {}
    kept = Config.PRECISION
    try:
        for cls in ("fast", "strict"):
            Config.PRECISION = cls
            System.get_sys().seed(seed)
            m = mnist_cnn(batch, device=device)
            cpu = nn_cpu_copy(m, lambda d: mnist_cnn(batch, device=d))
            cmp = nn_compare(nn_step(m, xs[0], hots[0], Loss.CE, seed),
                             nn_step(cpu, xs[0], hots[0], Loss.CE, seed),
                             TOL_NN[cls])
            checks[f"{cls}_card_vs_cpu"] = cmp.pop("ok")
            cls_rec = nn_class_check(m, xs[1], cls)
            if on_card:                # the CPU keeps exact f32 dots
                checks[f"{cls}_class_vs_f64"] = all(
                    v["err"] <= TOL_NN_CLASS for v in cls_rec.values())
            # --- the main path, counted: every count to 0 just before
            reset_flash_counts()
            gemm.reset_launches()
            inps = [mmu.tensor(*x.shape, device=device).set_numpy(x)
                    for x in xs]
            tgts = [mmu.tensor(batch, 1, 10, 1, device=device).set_numpy(h)
                    for h in hots]
            losses = []
            for i in range(steps):
                m.forward(inps[i % NN_BATCHES])
                losses.append(m.loss(Loss.CE, tgts[i % NN_BATCHES]))
                m.backprop(tgts[i % NN_BATCHES])
                m.adam(NN_LR)
            launches = dict(flash_counts(), **probe_counts(),
                            **gemm.launches)
            checks[f"{cls}_losses_finite"] = all(
                math.isfinite(v) for v in losses)
            checks[f"{cls}_loss_fell"] = (
                statistics.mean(losses[-NN_BATCHES:])
                < 0.5 * statistics.mean(losses[:NN_BATCHES]))

            split = {}

            def step(split=None):
                words = (("forward", lambda: m.forward(inps[0])),
                         ("loss", lambda: m.loss(Loss.CE, tgts[0])),
                         ("backprop", lambda: m.backprop(tgts[0])),
                         ("optimizer", lambda: m.adam(NN_LR)))
                for name, word in words:
                    t0 = time.perf_counter()
                    word()
                    if split is not None:
                        sync()
                        split.setdefault(name, []).append(
                            (time.perf_counter() - t0) * 1e3)

            for _ in range(timed):
                step(split)
            step_ms = [sum(ts) for ts in zip(*split.values())]
            med = statistics.median(step_ms)
            rec[cls] = {"card_vs_cpu": cmp, "tol": TOL_NN[cls],
                        "class_vs_f64": cls_rec,
                        "losses": losses,
                        "ms_per_step": med,
                        "split_ms": {k: statistics.median(v)
                                     for k, v in split.items()},
                        "images_per_s": batch / med * 1e3,
                        "timing_samples": len(step_ms),
                        "profile": profile_run(step, device, med),
                        "kernel_launches_on_path": launches}

            # --- the layers mnist_cnn does not run, and gan_mnist's D
            def cov(d):
                return build_net(coverage_in, NN_COVERAGE, d)

            System.get_sys().seed(seed + 1)
            m = cov(device)
            xc, lc = nn_data(seed + 1, 1, coverage_in[0], coverage_in[1:])
            hc = np.eye(10, dtype=np.float32)[lc[0]].reshape(
                coverage_in[0], 1, 10, 1)
            rec[cls]["coverage"] = nn_compare(
                nn_step(nn_cpu_copy(m, cov), xc[0], hc, Loss.NLL, seed),
                nn_step(m, xc[0], hc, Loss.NLL, seed), TOL_NN[cls],
                card_first=False)
            checks[f"{cls}_coverage"] = rec[cls]["coverage"].pop("ok")
            _, d = gan_mnist(gan_batch, device=device)
            xg, lg = nn_data(seed + 2, 1, gan_batch, classes=2)
            hg = lg[0].astype(np.float32).reshape(gan_batch, 1, 1, 1)
            rec[cls]["gan_d"] = nn_compare(
                nn_step(nn_cpu_copy(d, lambda dv: gan_mnist(
                    gan_batch, device=dv)[1]), xg[0], hg, Loss.BCE, seed),
                nn_step(d, xg[0], hg, Loss.BCE, seed), TOL_NN[cls],
                card_first=False)
            checks[f"{cls}_gan_d"] = rec[cls]["gan_d"].pop("ok")
            checks[f"{cls}_no_handwritten_kernel"] = not any(
                launches.values())
    finally:
        Config.PRECISION = kept
    emit({"phase": "nn", "model": "mnist_cnn", "batch": batch,
          "optimizer": f"adam({NN_LR})", "steps": steps,
          "class_tol": TOL_NN_CLASS, "card": card_line() if on_card else None,
          **rec, "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"nn checks failed: {bad}")


def _net_lines(path, epochs, save_dir):
    """t4_30e's lines up to its `bye`, with its epoch count set and the
    model saved under save_dir in place of /tmp"""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    lines = lines[:lines.index("bye")]
    return [ln.replace("20 cnn", f"{epochs} cnn")
            .replace("/tmp/", save_dir + "/") for ln in lines]


def transcript_faults(out: str, allowed=("\\ WARN: corpus files for ",)):
    """the ERROR and WARN lines of a transcript, less the allowed ones"""
    return [ln for ln in out.splitlines()
            if ("ERROR" in ln or "WARN" in ln)
            and not any(ln.lstrip().startswith(a) for a in allowed)]


class env_set:
    """os.environ with `values` set (None: removed) inside the block, put
    back after"""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_net(seed: int = NET_SEED, device=None, epochs=NET_EPOCHS,
              max_batch=None, profile_batches=NET_PROFILE_BATCHES,
              script_dir="examples"):
    """the system's own main path, `ten4 < examples/t4_30e.4th`, through
    the port's REPL on its per-word path (T4_NO_FUSE=1 T4_NO_MACRO=1):
    the flagship word loop over mnist_train, the held-out pass of
    bench.py's gate, the saved model loaded on the CPU.  Returns the
    epochs' (acc, loss) as printed: net_fused's control"""
    with tempfile.TemporaryDirectory(prefix="t4_net_") as save_dir, \
            env_set(**PER_WORD):
        return _net_run(seed, device, epochs, max_batch, profile_batches,
                        script_dir, save_dir)


def phase_net_fused(seed: int = NET_SEED, device=None, epochs=NET_EPOCHS,
                    max_batch=None, profile_batches=NET_PROFILE_BATCHES,
                    script_dir="examples", control=None):
    """t4_30e the way a user of the JAX package runs it, at the defaults:
    fused cycles, trace chunks (captured CUDA graphs replayed on the card)
    and the macro serve where the loop body allows it; its first epochs'
    printed acc= and loss= held against `control` (phase_net's)"""
    with tempfile.TemporaryDirectory(prefix="t4_net_") as save_dir, \
            env_set(T4_NO_FUSE=None, T4_NO_MACRO=None):
        return _net_run(seed, device, epochs, max_batch, profile_batches,
                        script_dir, save_dir, control=control)


def _net_run(seed, device, epochs, max_batch, profile_batches, script_dir,
             save_dir, control=None):
    """phase_net (control None) or phase_net_fused, with the script's
    model saved under save_dir"""
    import torch
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.io.nnio import _param_layers
    from tensorforth_tpu_torch.nn import cycle
    fused = control is not None
    phase = "net_fused" if fused else "net"
    on_card = device is None or torch.device(device).type == "cuda"
    cut = []
    if epochs != NET_EPOCHS:
        cut.append(f"{epochs} epochs of {NET_EPOCHS}")
    if max_batch:
        os.environ["T4_MAX_BATCH"] = str(max_batch)
        cut.append(f"T4_MAX_BATCH={max_batch}")
    if cut:
        print(f"{phase}: cut to {', '.join(cut)}", flush=True)
    checks = {}
    inst, run = repl(device, seed)
    vm = inst.vm
    vm._macro_count = 0
    stamps = []                  # the time of every dataset NEXT
    ds_next = vm._ds_next

    def timed_next(ioff):
        stamps.append(time.perf_counter())
        return ds_next(ioff)

    vm._ds_next = timed_next
    out = []
    t0 = time.perf_counter()
    for ln in _net_lines(os.path.join(script_dir, "t4_30e.4th"), epochs,
                         save_dir):
        if "cnn" in ln and ln.strip().startswith(f"{epochs} cnn"):
            cycle.reset_counts()
            t_train = time.perf_counter()
        out.append(run(ln))
        if "cnn" in ln and ln.strip().startswith(f"{epochs} cnn"):
            train_s = time.perf_counter() - t_train
            counts = dict(cycle.COUNTS, macro_served=vm._macro_count)
    script_s = time.perf_counter() - t0
    out = "".join(out)
    vm._ds_next = ds_next
    stats = [(int(b), float(acc), float(loss)) for b, acc, loss in
             re.findall(r"b=(\d+) t=\S+ acc=(\S+) loss=(\S+)", out)]
    printed = re.findall(r"acc=(\S+) loss=(\S+)", out)
    n_batches = len(stamps)

    # --- the held-out pass: bench.py's gep loop (bench.py:889-895)
    held = run("md0 batchsize dataset mnist_test constant gtd\n"
               "variable gh 0 gh ! variable gn 0 gn !\n"
               ": gep for forward nn.hit gh +! batchsize gn +! next ;\n"
               "md0 gtd gep drop\n"
               'gh @ gn @ / ." GATE= " . cr')
    acc = float(re.search(r"GATE= (\S+) ", held).group(1))

    # --- the card model's forward on a held-out batch (the weights the
    #     script saved); the file is loaded on the CPU below
    run("gtd rewind drop md0 gtd forward drop")
    run("md0")
    md = vm.mmu.du2obj(vm.tos)
    run("drop")
    x = md[0].ensure_data().cpu().numpy().copy()
    # the softmax's input: on a trained net the softmax is so sharp that
    # the class's rounding of the logits moves some outputs by more than
    # the logits move
    want = md[-2].ensure_data().cpu().numpy().copy()
    want_out = md[-1].ensure_data().cpu().numpy().copy()
    weights = [t_in.grad[k].numpy().copy()
               for t_in, slots in _param_layers(md) for k in range(len(slots))]
    # --- one profiled epoch slice (and its time without the profiler);
    #     it trains on, after the saved model was read back above.  The
    #     warm run arms the fused path again (the rate decayed after the
    #     last epoch), so the timed and profiled runs are one chunk each
    os.environ["T4_MAX_BATCH"] = str(profile_batches)
    slice_line = "ds0 rewind drop md0 ds0 epoch drop"
    run(slice_line)
    sync = (lambda: torch.cuda.synchronize()) if on_card else (lambda: None)
    sync()
    t1 = time.perf_counter()
    run(slice_line)
    sync()
    slice_ms = (time.perf_counter() - t1) * 1e3
    cycle.reset_counts()
    prof = profile_run(lambda: run(slice_line), "cuda" if on_card else "cpu",
                       slice_ms)
    prof["cycle_runs"] = cycle.COUNTS["runs"]
    if max_batch:
        os.environ["T4_MAX_BATCH"] = str(max_batch)
    else:
        os.environ.pop("T4_MAX_BATCH", None)

    precision = Config.PRECISION
    transcript = out + held
    inst.teardown()
    # the saved file loaded into a CPU model of the port: the same forward
    cpu, crun = repl("cpu", seed)
    saved = os.path.join(save_dir, "l30e_c.t4")
    loaded = crun(f'100 28 28 1 nn.model constant lm0 lm0 s" {saved}" '
                  "load drop")
    crun("lm0")
    m = cpu.vm.mmu.du2obj(cpu.vm.tos)
    inp = cpu.vm.mmu.tensor(*x.shape, device="cpu").set_numpy(x)
    m.forward(inp)
    got = m[-2].ensure_data().numpy()
    got_out = m[-1].ensure_data().numpy()
    loaded_w = [t_in.grad[k].numpy()
                for t_in, slots in _param_layers(m) for k in range(len(slots))]
    weights_equal = len(loaded_w) == len(weights) and all(
        np.array_equal(a, b) for a, b in zip(loaded_w, weights))
    cpu.teardown()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    rel_out = float(np.abs(got_out - want_out).max()
                    / np.abs(want_out).max())
    same_class = float((got_out.reshape(100, -1).argmax(1)
                        == want_out.reshape(100, -1).argmax(1)).mean())
    tol = TOL_NN[precision] if on_card else 1e-6   # see NET_SAME_CLASS

    iv = np.diff(stamps) * 1e3 if n_batches > 1 else np.array([float("nan")])
    ms_batch = float(np.median(iv))
    losses = [l for _, _, l in stats]
    checks["epochs_printed"] = len(stats) == epochs
    checks["no_error_or_warn"] = not transcript_faults(transcript + loaded)
    checks["losses_finite"] = all(math.isfinite(v) for v in losses)
    checks["loss_fell"] = len(losses) > 1 and losses[-1] < losses[0]
    if not cut:
        checks["held_out_accuracy"] = acc >= NET_GATE
    checks["saved_model_weights_equal"] = weights_equal
    checks["saved_model_forward_on_cpu"] = rel <= tol
    checks["saved_model_same_class"] = same_class >= NET_SAME_CLASS
    checks["network_printed"] = "NN Model[8/128]" in transcript
    rec = {}
    if fused:
        n_ctl = len(control)
        checks["first_epochs_equal_control"] = (
            n_ctl > 0 and printed[:n_ctl] == control)
        checks["fused_cycles_and_chunks_ran"] = (
            counts["fused"] > 0 and counts["chunks"] > 0)
        if on_card:
            checks["graphs_captured_and_replayed"] = (
                counts["captures"] >= 1 and counts["runs"] >= n_batches / 2)
        rec = {"control_epochs": n_ctl, "control": control,
               "per_batch": {k: v / max(n_batches, 1)
                             for k, v in counts.items()},
               "counts": counts}
    else:
        checks["per_word_path"] = counts["runs"] == 0
    emit({"phase": phase, "script": "examples/t4_30e.4th",
          "batch": 100, "epochs": epochs, "cut": cut or None,
          "path": ("defaults: fused cycle, trace chunks, macro serve"
                   if fused else "per-word (T4_NO_FUSE=1 T4_NO_MACRO=1)"),
          "precision": precision, "seed": seed,
          "batches_run": n_batches, "stat_lines": stats,
          "held_out_accuracy": acc, "gate": NET_GATE if not cut else None,
          "script_s": script_s, "train_s": train_s,
          "ms_per_batch_median": ms_batch,
          "ms_per_batch_mean": train_s * 1e3 / max(n_batches, 1),
          "images_per_s": 100 * 1e3 / ms_batch,
          "images_per_s_mean": 100 * n_batches / train_s,
          "launches_per_batch": prof["kernel_launches"] / profile_batches,
          "profiled_slice": {"batches": profile_batches,
                             "wall_ms": slice_ms, **prof},
          **rec,
          "saved_model_logits_rel_err_cpu": rel, "tol": tol,
          "saved_model_output_rel_err_cpu": rel_out,
          "saved_model_same_class_share_cpu": same_class,
          "same_class_min": NET_SAME_CLASS,
          "saved_model_weight_tensors": len(weights),
          "faults": transcript_faults(transcript + loaded),
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{phase} checks failed: {bad}")
    return printed


def _models(vm):
    return [o for o in vm.mmu._objs.values()
            if getattr(o, "is_model", lambda: False)()]


def _weights(m):
    return [w.detach().cpu().numpy().copy() for pl in m._params()
            for w in pl]


def _pin(m, weights):
    """m's parameters set to `weights` (another model's _weights)"""
    it = iter(weights)
    for j in range(m.numel - 1):
        for k in range(len(m._params()[j])):
            g = m[j].grad[k]
            g.replace_data(next(it).reshape(g.shape))


def _max_diff(wa, wb) -> float:
    return max((float(np.abs(a - b).max()) for a, b in zip(wa, wb)),
               default=0.0)


def phase_net_rollback(seed: int = NET_SEED, device=None,
                       batches=ROLLBACK_BATCHES, chunk=ROLLBACK_CHUNK):
    """the fused path's exits on the card, each against its control from
    the same weights: a weight read inside the loop body (test_chunk's
    introspection case: every cycle rolls the chunk back), the canonical
    body without `hint` (test_macro's: the macro serve runs), each
    against the per-word path; and test_nan_guard's exploding SGD,
    detected lazily and eagerly: the faulting batch and the weights
    against the per-word path traced (its forward's NaN check stops it
    there; it has no sentinel), the hit counts against the per-batch
    fused cycles.  Then a failed capture, in a process of its own"""
    from tensorforth_tpu_torch.nn import cycle
    inst, run = repl(device, seed)
    vm = inst.vm
    rec, checks = {}, {}

    def loop_run(name, env, model, loop, epochs, tag):
        with env_set(**env):
            run(model.format(v=name))
            m = _models(vm)[-1]
            if tag in base:
                _pin(m, base[tag])
            else:
                base[tag] = _weights(m)
            run(loop.format(v=name))
            vm._macro_count = 0
            cycle.reset_counts()
            outs = [run(f"{name}d rewind drop {name} {name}d {name}ep "
                        "drop") for _ in range(epochs)]
            counts = dict(cycle.COUNTS, macro_served=vm._macro_count)
            vals = [run(f"{name}{c} @ . cr").split()[0]
                    for c in ("h", "l")]
            return "".join(outs), vals, _weights(m), m, counts

    base = {}
    fused = dict(T4_NO_FUSE=None, T4_NO_MACRO=None,
                 T4_MAX_BATCH=batches, T4_CHUNK=chunk)
    control = dict(PER_WORD, T4_MAX_BATCH=batches)
    cases = {
        "probe": ("variable {v}h 0 {v}h ! variable {v}l variable {v}w\n"
                  ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
                  "backprop dup 0 nn.w sum {v}w ! drop 0.001 nn.adam "
                  "next ;"),
        "macro": ("variable {v}h 0 {v}h ! variable {v}l\n"
                  ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
                  "backprop 0.001 nn.adam next ;")}
    for tag, loop in cases.items():
        a = loop_run(f"{tag[0]}a", control, NN_C, loop, 2, tag)
        b = loop_run(f"{tag[0]}b", fused, NN_C, loop, 2, tag)
        va, vb = a[1], b[1]
        if tag == "probe":
            va.append(run(f"{tag[0]}aw @ . cr").split()[0])
            vb.append(run(f"{tag[0]}bw @ . cr").split()[0])
        diff = _max_diff(a[2], b[2])
        rec[tag] = {"control": va, "fused": vb, "weights_max_diff": diff,
                    "counts": b[4]}
        checks[f"{tag}_printed_equal"] = va == vb
        checks[f"{tag}_weights_equal"] = diff == 0.0
        checks[f"{tag}_chunks_ran"] = b[4]["chunks"] > 0
    checks["macro_served"] = rec["macro"]["counts"]["macro_served"] > 0

    at = re.compile(r"non-finite at corpus offset (\d+)")
    nan = {}
    for tag, chunk_k, probe, guard in (("control", 0, "dup . ", ""),
                                       ("lazy", 8, "dup . ", ""),
                                       ("eager", 3, "", "eager")):
        env = dict(T4_NO_FUSE=None, T4_NO_MACRO=None, T4_MAX_BATCH=9,
                   T4_CHUNK=chunk_k, T4_NAN_GUARD=guard or None)
        out, vals, w, m, counts = loop_run(
            f"n{tag[0]}", env, NAN_MODEL,
            NAN_LOOP.replace("{probe}", probe), 1, "nan")
        offs = at.findall(out)
        nan[tag] = {"offsets": offs, "err": m.err, "hits": vals[0],
                    "weights": w, "counts": counts,
                    "rolled_back": "rolled back to the faulting batch" in out}
        run("0 trace")
        m.err = 0
    # the per-word path has no sentinel; traced, its forward's NaN check
    # stops the loop at the faulting batch, before that batch's step:
    # the state the sentinel rolls back to
    with env_set(T4_MAX_BATCH=9, **PER_WORD):
        run(NAN_MODEL.format(v="nw"))
        m = _models(vm)[-1]
        _pin(m, base["nan"])
        run(NAN_LOOP.replace("{probe}", "").format(v="nw"))
        out = run("1 trace nwd rewind drop nw nwd nwep drop 0 trace")
        m.err = 0
    per_word = {"offset": str((out.count("Model::forward trace") - 1) * 8),
                "stopped": "ERROR: nn#forward NaN in" in out,
                "weights": _weights(m)}
    checks["nan_per_word_stopped"] = per_word["stopped"]
    ctl = nan["control"]
    for tag in ("control", "lazy", "eager"):
        r = nan[tag]
        diff = _max_diff(per_word["weights"], r["weights"])
        checks[f"nan_{tag}_same_batch"] = r["offsets"][:1] == [
            per_word["offset"]]
        checks[f"nan_{tag}_weights_equal"] = diff == 0.0
        r["weights_max_diff_vs_per_word"] = diff
        if tag != "control":
            checks[f"nan_{tag}_rolled_back"] = r["rolled_back"]
            checks[f"nan_{tag}_same_hits"] = r["hits"] == ctl["hits"]
    checks["nan_control_stopped"] = bool(ctl["offsets"]) and ctl["err"] == 1
    checks["nan_weights_finite"] = all(
        np.isfinite(w).all() for r in nan.values() for w in r["weights"])
    for r in nan.values():
        r.pop("weights")
    per_word.pop("weights")
    nan["per_word_traced"] = per_word
    inst.teardown()
    failed = None
    if device is None or str(device).startswith("cuda"):
        # a failed capture, in a process of its own (a capture left
        # broken must not touch the phases after this one)
        r = subprocess.run([sys.executable, "-c", "import chip_smoke as cs; "
                            "cs.capture_failure_child()"],
                           capture_output=True, text=True, timeout=600,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith('{"capture_failure"')]
        failed = json.loads(lines[-1])["capture_failure"] if lines else {
            "rc": r.returncode, "stderr": r.stderr[-2000:]}
        checks["failed_capture_raises"] = bool(failed.get("raised"))
        checks["failed_capture_no_eager_run"] = failed.get("runs") == 0
        checks["failed_capture_repl_alive"] = bool(failed.get("alive"))
    emit({"phase": "net_rollback", "window": batches, "chunk": chunk,
          "cases": rec, "nan_guard": nan, "capture_failure": failed,
          "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"net_rollback checks failed: {bad}")


def capture_failure_child(device=None):
    """run by phase_net_rollback in a process of its own: the fused
    cycle's body made to read its loss back to the host, which no CUDA
    graph capture allows.  The forward that captures it must raise
    through the words (`ERROR in 'forward'`: the native inner
    interpreter runs `cfep` and names the word that raised, as the JAX
    package's does), run no cycle eagerly in its place, and leave the
    REPL working"""
    from tensorforth_tpu_torch.nn import cycle, funcs
    body = funcs.fused_cycle_body

    def reads_back(*a, **kw):
        st = body(*a, **kw)
        float(st[4])
        return st

    funcs.fused_cycle_body = reads_back
    inst, run = repl(device, NET_SEED)
    cycle.reset_counts()
    with env_set(T4_NO_FUSE=None, T4_NO_MACRO=None, T4_MAX_BATCH=4,
                 T4_CHUNK=0):
        run(NN_C.replace("mnist_train", "mnist_test").format(v="cf"))
        run("variable cfh 0 cfh ! variable cfl\n"
            ": cfep for forward loss.ce cfl ! nn.hit cfh +! backprop "
            "0.001 nn.adam next ;")
        out = run("cfd rewind drop cf cfd cfep drop")
        alive = run("1 2 + . cr")
    print(json.dumps({"capture_failure": {
        "raised": "ERROR in 'forward'" in out,
        "error": [ln for ln in out.splitlines() if "ERROR" in ln][:2],
        "runs": cycle.COUNTS["runs"], "captures": cycle.COUNTS["captures"],
        "alive": alive.split()[:1] == ["3"]}}), flush=True)
    inst.teardown()


class _StubCorpus:
    """a corpus held in memory: what train_epochs reads"""

    def __init__(self, data, labels):
        self._data, self._labels = data, labels
        self.size = data.shape[0]

    def _read(self, start, n):
        return self._data[start:start + n], self._labels[start:start + n]


class _StubDataset:
    def __init__(self, data, labels, batch):
        self._corpus = _StubCorpus(data, labels)
        self.batch_sz, self._mean, self._scale = batch, 0.0, 1.0


def phase_net_train(seed: int = NET_SEED, device=None,
                    lm=NET_TRAIN_LM, n_batches=NET_TRAIN_BATCHES,
                    script_dir="examples", epochs=5, max_batch=None):
    """`nn.train`: examples/t4_50_tpu.4th whole (5 epochs over mnist_train,
    each a captured batch step replayed once a batch on the card), its
    seconds an epoch and bench.py's held-out loop; then train_epochs over
    tiny_transformer at bench_prefill's widths on a seeded stub corpus,
    its weights against the per-word loop's from the same start, and the
    flash kernels inside its graph counted through the profiler (host
    counters count the warm-up and capture, not replays).  Returns the
    profiled launches"""
    import torch
    from tensorforth_tpu_torch import models
    from tensorforth_tpu_torch.nn import cycle
    from tensorforth_tpu_torch.nn.train import train_epochs
    on_card = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda" if device is None else device)
    sync = (lambda: torch.cuda.synchronize()) if on_card else (lambda: None)
    checks = {}
    with tempfile.TemporaryDirectory(prefix="t4_train_") as save_dir, \
            env_set(T4_MAX_BATCH=max_batch):
        inst, run = repl(device, seed)
        with open(os.path.join(script_dir, "t4_50_tpu.4th")) as f:
            lines = [ln.rstrip("\n").replace("/tmp/", save_dir + "/")
                     .replace("0.001 5 nn.train", f"0.001 {epochs} nn.train")
                     for ln in f]
        lines = lines[:lines.index("bye")]
        out, train_s = [], None
        cycle.reset_counts()
        for ln in lines:
            t0 = time.perf_counter()
            out.append(run(ln))
            if "nn.train" in ln:
                sync()
                train_s = time.perf_counter() - t0
        runs = cycle.COUNTS["runs"]
        held = run("md0 batchsize dataset mnist_test constant gtd\n"
                   "variable gh 0 gh ! variable gn 0 gn !\n"
                   ": gep for forward nn.hit gh +! batchsize gn +! next ;\n"
                   "md0 gtd gep drop\n"
                   'gh @ gn @ / ." GATE= " . cr')
        inst.teardown()
    transcript = "".join(out) + held
    acc = float(re.search(r"GATE= (\S+) ", held).group(1))
    loss = re.search(r"nn.train \d+ epochs done, final loss=(\S+)",
                     transcript)
    checks["nn_train_ran"] = loss is not None and math.isfinite(
        float(loss.group(1)))
    checks["no_error_or_warn"] = not transcript_faults(transcript)
    checks["held_out_accuracy_finite"] = math.isfinite(acc)
    checks["one_run_a_batch"] = runs > 0 and runs % epochs == 0

    # --- tiny_transformer: nn.train against the per-word loop
    rs = np.random.RandomState(seed)
    b, s_, e = lm["batch"], lm["seq"], lm["dim"]
    data = rs.rand(n_batches * b, s_, e, 1).astype(np.float32)
    labels = rs.randint(0, lm["classes"], size=n_batches * b)
    ds = _StubDataset(data, labels, b)
    build = lambda: models.tiny_transformer(device=dev, **lm)  # noqa: E731
    mg, mw = build(), build()
    _pin(mw, _weights(mg))
    reset_flash_counts()
    t0 = time.perf_counter()
    train_epochs(mg, ds, lr=TRAIN_LR, epochs=1)
    sync()
    first_s = time.perf_counter() - t0
    host_counts = flash_counts()
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    inp = mmu.tensor(b, s_, e, 1, device=dev)
    hot = mmu.tensor(b, 1, lm["classes"], 1, device=dev)
    eye = np.eye(lm["classes"], dtype=np.float32)
    t0 = time.perf_counter()
    for i in range(n_batches):
        inp.set_numpy(data[i * b:(i + 1) * b])
        hot.set_numpy(eye[labels[i * b:(i + 1) * b]])
        mw.forward(inp)
        mw.backprop(hot)
        mw.adam(TRAIN_LR)
    sync()
    word_s = time.perf_counter() - t0
    wg, ww = _weights(mg), _weights(mw)
    diff = _max_diff(wg, ww) / max(float(np.abs(w).max()) for w in ww)
    checks["nn_train_equals_word_loop"] = diff <= TOL_NET_TRAIN
    t0 = time.perf_counter()
    train_epochs(mg, ds, lr=TRAIN_LR, epochs=1)
    sync()
    epoch_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_run(lambda: train_epochs(mg, ds, lr=TRAIN_LR, epochs=1),
                       "cuda" if on_card else "cpu", epoch_ms)
    launched = {nm: prof[nm + "_launches"] for nm in FLASH_NAMES}
    if on_card:
        # a step launches the forward twice per attention layer (the
        # layer backward runs it again) and each backward kernel once
        want = {"flash_fwd": 2, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
        checks["flash_kernels_in_graph"] = all(
            launched[nm] == k * lm["layers"] * n_batches
            for nm, k in want.items())
    emit({"phase": "net_train", "script": "examples/t4_50_tpu.4th",
          "epochs": epochs, "cut": ({"T4_MAX_BATCH": max_batch}
                                    if max_batch else None),
          "nn_train_s": train_s,
          "s_per_epoch": train_s / epochs if train_s else None,
          "held_out_accuracy": acc, "cycle_runs": runs,
          "model": dict(lm, n_batches=n_batches),
          "first_call_s_with_capture": first_s, "word_loop_s": word_s,
          "epoch_ms": epoch_ms, "ms_per_step": epoch_ms / n_batches,
          "weights_rel_diff_vs_word_loop": diff, "tol": TOL_NET_TRAIN,
          "host_counts_capture": host_counts,
          "profiled_launches": launched, "profiled_epoch": prof,
          "faults": transcript_faults(transcript), "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"net_train checks failed: {bad}")
    return launched


def phase_net_gen(seed: int, device=None, lm=LM, n_prompt=N_PROMPT,
                  n_new=N_NEW, words=NET_GEN_WORDS, expect_gen=None,
                  expect_step=None):
    """an LM built by words at bench_prefill's width: `nn.gen` against
    generate() and the teacher-forced replay, then one word-path training
    step; returns the flash kernels' launches in both"""
    import torch
    from tensorforth_tpu_torch.nn import funcs, serve
    from tensorforth_tpu_torch.nn.serve import generate
    from tensorforth_tpu_torch.ops import attn
    on_card = device is None or torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    checks = {}
    inst, run = repl(device, seed)
    vm = inst.vm
    out = [run("0 trace\nvariable lox\n" + words)]
    n = lm["batch"]
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (n, n_prompt))
    out.append(run(f"{n} {n_prompt} matrix"))
    vm.mmu.du2obj(vm.tos).set_numpy(prompt.astype(np.float32))
    out.append(run("constant pr"))
    run("lm")
    m = vm.mmu.du2obj(vm.tos)
    run("drop")

    # --- nn.gen, counted: every count to 0 just before, read after
    reset_flash_counts()
    serve.reset_counts()
    t0 = time.perf_counter()
    out.append(run(f"lm pr {n_new} nn.gen"))
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    gen = dict(flash_counts(),
               flash_fwd_split=attn.flash_attention.split_launches)
    decode = dict(serve.COUNTS)
    toks = vm.mmu.du2obj(vm.tos).numpy().astype(np.int64)
    out.append(run("drop drop"))
    want = generate(m, prompt, n_new, temp=0.0)
    checks["tokens_shape"] = toks.shape == (n, n_prompt + n_new)
    checks["tokens_equal_generate"] = bool((toks == want).all())
    segments = serve._segments(n_prompt, n_prompt + n_new,
                               serve.Config.DECODE_WIN)
    checks["decode_captures_and_replays"] = (
        decode == {"captures": len(segments), "replays": n_new - 1,
                   "steps": 0} if on_card else
        decode == {"captures": 0, "replays": 0, "steps": n_new - 1})
    agree = decode_checks(m, prompt, n_new, device, lm, toks, checks)
    if expect_gen is not None:
        checks["launches_per_nn_gen"] = gen == expect_gen

    # --- timings: nn.gen and its prefill alone (0 new tokens)
    pre, tot = [], []
    for _ in range(3):
        for n_gen, acc in ((0, pre), (n_new, tot)):
            t0 = time.perf_counter()
            run(f"lm pr {n_gen} nn.gen drop drop")
            sync()
            acc.append((time.perf_counter() - t0) * 1e3)
    prof = profile_generate(m, prompt, n_new, torch_device(device),
                            statistics.median(tot), graphs=on_card)

    # --- one word-path step: forward loss.ce backprop nn.adam, counted
    hot = vm.mmu.tensor(n, n_prompt, lm["vocab"], 1)
    hot.replace_data(funcs.onehot_fn(torch.from_numpy(
        np.roll(prompt, -1, axis=1)).to(hot.device), lm["vocab"]))
    reset_flash_counts()
    t0 = time.perf_counter()
    out.append(run("lm pr forward"))
    vm.PUSH_OBJ(hot)
    out.append(run(f"nn.onehot= loss.ce lox ! backprop {NET_GEN_LR} "
                   "nn.adam"))
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    step = dict(flash_counts(),
                flash_fwd_split=attn.flash_attention.split_launches,
                flash_bwd_split=attn.flash_attention_bwd.split_launches)
    loss = float(run("lox @ .").split()[0])
    out.append(run("drop"))
    transcript = "".join(out)
    inst.teardown()
    checks["loss_finite"] = math.isfinite(loss)
    checks["no_error_or_warn"] = not transcript_faults(transcript)
    if expect_step is not None:
        checks["launches_per_step"] = step == expect_step
    emit({"phase": "net_gen", "model": dict(lm, n_prompt=n_prompt,
                                            n_new=n_new),
          "words": words, "launches_per_nn_gen": gen,
          "launches_per_step": step, "decode_counts": decode,
          "segments": segments, **agree,
          "generate_kernel_launches": prof["kernel_launches"],
          "generate_profile": prof, "first_nn_gen_ms": first_ms,
          "nn_gen_ms": statistics.median(tot),
          "prefill_ms": statistics.median(pre),
          "timing_samples": {"nn_gen_ms": tot, "prefill_ms": pre},
          "step_ms_first": step_ms, "loss": loss,
          "faults": transcript_faults(transcript), "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"net_gen checks failed: {bad}")
    return {k: gen.get(k, 0) + step.get(k, 0)
            for k in set(gen) | set(step)}


def phase_moe(seed: int, device=None, cfg=None, n_batches=MOE_BATCHES,
              script_dir="examples", fused_batches=MOE_FUSED_BATCHES):
    """the MoE layer on the card (nothing of it is a TPU kernel: the JAX
    package's MoE is XLA's einsums, scatter and gather): t4_52_moe.4th's
    MoE parts through the REPL on the card against a CPU run of the port,
    its printed numbers within TOL_NN; the zoo's tiny_moe (its defaults)
    one step card against a CPU copy under fast and strict, soft and
    under T4_MOE_DISPATCH=1; train_epochs over tiny_moe on a seeded stub
    corpus, the graph's weights against the word loop's; the REPL's
    fused cycles and trace chunks over tiny_moe's layers at mnist_train's
    shape against the per-word path, bit for bit"""
    import torch
    from tensorforth_tpu_torch import models
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.nn.ntypes import Loss
    from tensorforth_tpu_torch.nn.train import train_epochs
    from tensorforth_tpu_torch.system import System
    dev = torch_device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize()) if on_card else (lambda: None)
    cfg = dict(cfg or {})
    checks, res = {}, {}

    # --- t4_52_moe.4th: the card against the CPU
    with open(os.path.join(script_dir, "t4_52_moe.4th")) as f:
        lines = [ln.rstrip("\n") for ln in f]
    cut = next(i for i, ln in enumerate(lines) if "pipeline-parallel" in ln)
    outs = {}
    for where in (device, "cpu"):
        inst, run = repl(where, seed)
        outs[str(where)] = "".join(run(ln) for ln in lines[:cut])
        if where is device:
            # its nn.pipe: two pipeline ranks on the card, cut to 3
            # batches an epoch (as test_scripts.py cuts the script)
            with env_set(T4_MAX_BATCH="3"):
                rest = "".join(run(ln) for ln in lines[cut:cut + 6])
        inst.teardown()
    card_out, cpu_out = outs[str(device)], outs["cpu"]
    num = re.compile(r"[-+]?\d+\.?\d*(?:e[-+]?\d+)?")
    tol = TOL_NN[Config.PRECISION]
    pairs = [(float(a), float(b)) for a, b in zip(num.findall(card_out),
                                                  num.findall(cpu_out))]
    worst = max((abs(a - b) / max(abs(a), abs(b)) for a, b in pairs
                 if a != b), default=0.0)
    checks["t4_52_moe_lines_match_cpu"] = (
        num.sub("#", card_out) == num.sub("#", cpu_out) and worst <= tol)
    checks["t4_52_moe_pipe_trains"] = (
        "nn.pipe 2 epochs over pp2 done" in rest)
    checks["t4_52_moe_no_error"] = not transcript_faults(card_out + rest)
    res["t4_52_moe"] = {"worst_rel_diff_vs_cpu": worst, "tol": tol,
                        "numbers": len(pairs), "precision": Config.PRECISION,
                        "losses": re.findall(r"loss \w+ += (\S+)",
                                             card_out)}

    # --- tiny_moe: one step on the card against a CPU copy
    build = lambda where: models.tiny_moe(device=where, **cfg)  # noqa: E731
    probe = build("cpu")
    b, s_, d = probe[0].N(), probe[0].H(), probe[0].W()
    classes = probe[-1].HWC()
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s_, d, 1).astype(np.float32)
    hot = np.eye(classes, dtype=np.float32)[rs.randint(0, classes, b)]
    hot = hot.reshape(b, 1, classes, 1)
    steps = {}
    for cls in ("fast", "strict"):
        for route, env in (("soft", "0"), ("dispatch", "1")):
            with precision_set(cls), env_set(T4_MOE_DISPATCH=env):
                System.get_sys().seed(seed)
                m = build(device)
                c = nn_cpu_copy(m, build)
                margin, top_cpu = moe_routing(c, x)
                _, top_card = moe_routing(m, x)
                card = nn_step(m, x, hot, Loss.CE, seed)
                cpu = nn_step(c, x, hot, Loss.CE, seed)
                cmp = nn_compare(card, cpu, TOL_NN[cls])
            # tokens whose experts differ between the card and the CPU: a
            # near tie of the gates that the class's rounding tips over
            cmp["gate_margin_cpu"] = margin
            cmp["tokens_routed_apart"] = int(
                (top_card != top_cpu).any(axis=1).sum())
            steps[f"{cls}_{route}"] = cmp
            checks[f"tiny_moe_step_{cls}_{route}"] = cmp["ok"]
    res["tiny_moe_step"] = steps

    # --- nn.train over tiny_moe against the word loop, both routes
    b = probe[0].N()
    data = rs.rand(n_batches * b, s_, d, 1).astype(np.float32)
    labels = rs.randint(0, classes, size=n_batches * b)
    ds = _StubDataset(data, labels, b)
    eye = np.eye(classes, dtype=np.float32)
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    trains = {}
    for route, env in (("soft", "0"), ("dispatch", "1")):
        with env_set(T4_MOE_DISPATCH=env):
            mg, mw = build(device), build(device)
            _pin(mw, _weights(mg))
            t0 = time.perf_counter()
            train_epochs(mg, ds, lr=TRAIN_LR, epochs=1)
            sync()
            first_s = time.perf_counter() - t0
            inp = mmu.tensor(b, s_, d, 1, device=dev)
            tgt = mmu.tensor(b, 1, classes, 1, device=dev)
            for i in range(n_batches):
                inp.set_numpy(data[i * b:(i + 1) * b])
                tgt.set_numpy(eye[labels[i * b:(i + 1) * b]])
                mw.forward(inp)
                mw.backprop(tgt)
                mw.adam(TRAIN_LR)
            sync()
            wg, ww = _weights(mg), _weights(mw)
            diff = _max_diff(wg, ww) / max(float(np.abs(w).max())
                                           for w in ww)
            t0 = time.perf_counter()
            train_epochs(mg, ds, lr=TRAIN_LR, epochs=1)
            sync()
            epoch_ms = (time.perf_counter() - t0) * 1e3
        trains[route] = {"weights_rel_diff_vs_word_loop": diff,
                         "first_call_s_with_capture": first_s,
                         "epoch_ms": epoch_ms}
        checks[f"nn_train_{route}_equals_word_loop"] = diff <= TOL_NET_TRAIN
    res["nn_train"] = dict(trains, n_batches=n_batches, tol=TOL_NET_TRAIN)

    # --- the REPL's fused cycles and chunks against its per-word path
    fused = {}
    for route, env in (("soft", "0"), ("dispatch", "1")):
        got = []
        for name, path in (("ma", PER_WORD), ("mb", {"T4_NO_FUSE": "0",
                                                    "T4_NO_MACRO": "0"})):
            with env_set(T4_MOE_DISPATCH=env, T4_MAX_BATCH=fused_batches,
                         T4_CHUNK=MOE_FUSED_CHUNK, **path):
                inst, run = repl(device, seed)
                run(MOE_FUSED_NET.format(v=name))
                m = _models(inst.vm)[-1]
                if got:
                    _pin(m, got[0][2])
                w0 = _weights(m)
                run(MOE_FUSED_LOOP.format(v=name))
                from tensorforth_tpu_torch.nn import cycle
                cycle.reset_counts()
                for _ in range(2):
                    run(f"{name}d rewind drop {name} {name}d {name}ep drop")
                hit = run(f"{name}h @ . cr").split()[0]
                loss = run(f"{name}l @ . cr").split()[0]
                got.append((hit, loss, w0 if not got else None,
                            _weights(m), dict(cycle.COUNTS)))
                inst.teardown()
        (ha, la, _, wa, _), (hb, lb, _, wb, counts) = got
        fused[route] = {"hit": hb, "loss": lb, "counts": counts,
                        "max_diff_vs_per_word": _max_diff(wa, wb)}
        checks[f"fused_{route}_equals_per_word"] = (
            ha == hb and la == lb and _max_diff(wa, wb) == 0.0
            and counts["chunks"] >= 1)
    res["fused"] = fused
    emit({"phase": "moe", "model": {"tiny_moe": cfg or "zoo defaults"},
          **res, "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"moe checks failed: {bad}")


def moe_routing(m, x):
    """the MoE layer of `m` (tiny_moe: layer 1) on the input x, from one
    forward: (the least gap between a token's k-th and (k+1)-th gate,
    each token's top-k experts as a sorted array)"""
    import torch
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.parallel import moe
    inp = MMU.get_mmu().tensor(*x.shape, device=m.device).set_numpy(x)
    m.forward(inp)
    w1 = m._params()[1][0]
    k = m[1].stride[0]
    g = moe._gates(m[1].ensure_data().reshape(-1, w1.shape[1]), w1[:, :, -1])
    o = torch.sort(g, dim=-1, descending=True, stable=True)
    top = np.sort(o.indices[:, :k].cpu().numpy(), axis=1)
    gv = o.values
    return (float((gv[:, k - 1] - gv[:, k]).min()) if k < g.shape[1]
            else 1.0), top


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
    # every backward there is hybrid: no backward split, neither the
    # split's nor the fused kernel's
    bwd_splits = (attn.flash_attention_bwd.split_launches
                  + attn.flash_attention_bwd_fused.split_launches)
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


# --- the host phase (the host tier: the native engine, the TLSF, the VM
# pool and task words, the TensorBoard writer and its deferred queue, the
# profiler words)
HOST_EPOCHS = 20          # t4_40a's own `20 cnn` (it runs epochs 0..20)
HOST_GATE = NET_GATE      # net_fused's held-out gate
HOST_TB_TAGS = ("train/acc", "train/loss", "train/lr", "train/time")
HOST_HISTOS = ("nn/conv0", "nn/relu2", "nn/lin4", "nn/lin6")
HOST_TILES = ("mnist/train", "mnist/test")
# bench.py's held-out loop (bench.py:889-895) over t4_40a's model, on the
# full batches of mnist_test only (39 of 256: 9,984 of its 10,000): the
# script's own test/acc divides the hits of 40 batches, the last padded
# with 240 zero images of label 0, by 10,000
HOST_HELD_BATCHES = 39
HOST_HELD_OUT = ("md0 batchsize dataset mnist_test constant gtd\n"
                 "variable gh 0 gh ! variable gn 0 gn !\n"
                 ": gep for forward nn.hit gh +! batchsize gn +! next ;\n"
                 "md0 gtd gep drop\n"
                 'gh @ gn @ / ." GATE= " . cr')
HOST_TASK_N = 512         # the task words' square operands
HOST_TASK_ITERS = 3000    # each task's gemm4 or @ loop: long enough to
#                           be running when VM 0 captures its chunk
HOST_CHUNK = 4            # VM 0's fused chunk while the tasks run ...
HOST_BATCHES = 10         # ... on a window of this many batches
# `see mx` as the JAX package prints it (its REPL on the CPU, from
# examples/t4_20a.4th): the dictionary indices of the words mx calls
SEE_MX = """: mx
  ( 0014 [  2] ) dup  
  ( 0018 [ 57] ) >r  
  ( 001c [ 83] ) clock  
  ( 0020 [ 57] ) >r  
  ( 0024 [  9] ) for  
  ( 0028 [ e4] ) @  
  ( 002c [  3] ) drop  
  ( 0030 [  1] ) next  \\ $0028
  ( 0034 [ 83] ) clock  
  ( 0038 [ 58] ) r>  
  ( 003c [ 10] ) -  
  ( 0040 [ 58] ) r>  
  ( 0044 [ 24] ) 1+  
  ( 0048 [ 12] ) /  
  ( 004c [  6] ) ." => "
  ( 0054 [ 3a] ) .  
  ( 0058 [  6] ) ."  msec/cycle"
  ( 0068 [ 39] ) cr  
  ( 006c [  0] ) ;
"""


class attr_set:
    """obj's attributes set to `values` inside the block, put back after"""

    def __init__(self, obj, **values):
        self.obj, self.values, self.saved = obj, values, {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = getattr(self.obj, k)
            setattr(self.obj, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.obj, k, v)


def native_libs() -> dict:
    """the native libraries the port built from csrc/ and loaded; raises
    when one did not load (no compiler, a failed build)"""
    from tensorforth_tpu_torch.runtime import native
    libs = {name: get() for name, get in (
        ("t4core", native.get_core), ("t4alloc", native.get_alloc),
        ("t4io", native.get_io), ("t4tb", native.get_tb))}
    print("host: native libraries " + ", ".join(
        f"{k}={getattr(v, '_name', None)}" for k, v in libs.items()),
        flush=True)
    missing = [k for k, v in libs.items() if v is None]
    if missing:
        raise RuntimeError(f"the native libraries {missing} did not load")
    return {k: v._name for k, v in libs.items()}


def _host_t4_40a(seed, device, tb_dir, epochs, max_batch):
    """examples/t4_40a.4th through ten4_torch's main() with its stdin and
    stdout redirected, with `-t tb_dir -r t4_40a` or, tb_dir None, without:
    (transcript, seconds of each epoch, the equeue's backlog at each
    line's end, mstat's lines and the MMU's live bytes at bye, the
    session's seconds up to bye)"""
    import contextlib
    from tensorforth_tpu_torch import cli
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    from tensorforth_tpu_torch.tb.summary import Summary
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()                   # main() as in a process of its own
    with open(os.path.join("examples", "t4_40a.4th")) as f:
        script = f.read().replace("20 cnn", f"{epochs} cnn")
    backlog, at_bye = [], {}
    flush, teardown = Summary.flush, cli.TensorForth.teardown

    def counted_flush(self):
        backlog.append(self.pending())
        flush(self)

    def reading_teardown(self):
        """at bye: mstat and the MMU's live bytes, then (with -t) the
        held-out loop on the trained model"""
        from tensorforth_tpu_torch.vm.vm import VMState
        at_bye["t"] = time.perf_counter()
        mmu = self.sys.mu
        buf = io.StringIO()
        with attr_set(self.sys, fout=buf):
            mmu.status()
        at_bye["mstat"] = buf.getvalue()
        live = [o.numel * 4 for o in mmu._objs.values()
                if not (o.is_model() or o.is_future())]
        at_bye["live_tensor_bytes"] = sum(live)
        at_bye["live_tlsf_bytes"] = sum((max(b, 4) + 7) // 8 * 8
                                        for b in live)
        at_bye["live_tensors"] = len(live)
        if tb_dir:                 # its GATE= line ends the transcript
            self.vm.state = VMState.QUERY
            with env_set(T4_MAX_BATCH=min(HOST_HELD_BATCHES, max_batch
                                          or HOST_HELD_BATCHES)):
                for ln in HOST_HELD_OUT.split("\n"):
                    self.run_line(ln)
        teardown(self)

    args = ["-r", "t4_40a", "-t", tb_dir] if tb_dir else []
    if device is not None:
        args += ["--device", str(device)]
    out = io.StringIO()
    env = dict(T4_SEED=seed, T4_MAX_BATCH=max_batch or None)
    t0 = time.perf_counter()
    with env_set(**env), attr_set(sys, stdin=io.StringIO(script)), \
            contextlib.redirect_stdout(out), \
            attr_set(Summary, flush=counted_flush), \
            attr_set(cli.TensorForth, teardown=reading_teardown):
        rc = cli.main(args)
    wall = at_bye.pop("t") - t0                # the session up to bye
    text = out.getvalue()
    if rc != 0:
        raise RuntimeError(f"ten4_torch exited {rc}")
    if tb_dir:
        at_bye["held_out"] = float(re.search(r"GATE= (\S+) ",
                                             text).group(1))
    secs = [float(x) for x in re.findall(r"epoch=\S+ (\S+) sec", text)]
    per_epoch = [b - a for a, b in zip([0.0] + secs, secs)]
    return text, per_epoch, backlog, at_bye, wall


def _host_tb_check(tb_dir, text, epochs, checks):
    """the event file of _host_t4_40a against what the script printed"""
    from tensorforth_tpu_torch.tb import reader
    run_dir = os.path.join(tb_dir, "t4_40a")
    files = [f for f in os.listdir(run_dir) if "tfevents" in f]
    path = os.path.join(run_dir, files[0])
    try:
        import tensorboard.backend.event_processing.event_file_loader \
            as tb_loader
        n_tb = len(list(tb_loader.RawEventFileLoader(path).Load()))
    except ImportError:
        n_tb = None
    recs = reader.records(path)           # raises on a bad CRC
    vals = reader.summaries(path)
    steps = list(range(epochs + 1))
    scal = {t: [(s, v) for s, tag, k, v in vals if tag == t]
            for t in HOST_TB_TAGS + ("test/acc",)}
    checks["tb_one_file"] = len(files) == 1
    checks["tb_crcs"] = len(recs) > 0
    checks["tb_reader_agrees"] = n_tb is None or n_tb == len(recs)
    for t in HOST_TB_TAGS + ("test/acc",):
        checks[f"tb_{t}_steps"] = [s for s, _ in scal[t]] == steps
    for t in HOST_HISTOS:
        checks[f"tb_{t}_steps"] = [s for s, tag, k, _ in vals
                                   if tag == t and k == "histo"] == steps
    checks["tb_tiles"] = sorted(tag for _, tag, k, v in vals
                                if k == "image"
                                and v[:8] == b"\x89PNG\r\n\x1a\n") == sorted(
        HOST_TILES)
    checks["tb_graph"] = len(reader.graphs(path)) == 1
    # the logged values against the printed ones, to the printed digit
    # (both print 6 significant digits, %g): hit= and test/acc= on
    # stdout (train/acc = hit / 60000 in f32), and the progress/text
    # record's acc= loss= learn_rate=
    hits = [int(h) for h in re.findall(r"hit=(\d+)", text)]
    test_acc = re.findall(r"test/acc=(\S+)", text)
    texts = [v[8][0].decode() for _, tag, k, v in vals
             if tag == "progress/text"]
    got = [re.search(r"acc=(\S+) loss=(\S+) learn_rate=(\S+)", t).groups()
           for t in texts]
    g6 = "{:g}".format
    checks["tb_acc_is_printed_hits"] = len(hits) == len(steps) and all(
        math.isclose(v, h / 60000, rel_tol=1e-6)
        for (_, v), h in zip(scal["train/acc"], hits))
    checks["tb_acc_loss_lr_are_the_texts"] = len(got) == len(steps) and all(
        (g6(a), g6(lo), g6(lr)) == t
        for (_, a), (_, lo), (_, lr), t in zip(
            scal["train/acc"], scal["train/loss"], scal["train/lr"], got))
    checks["tb_test_acc_is_printed"] = len(test_acc) == len(steps) and all(
        g6(v) == p for (_, v), p in zip(scal["test/acc"], test_acc))
    return {"records": len(recs), "tensorboard_reader_records": n_tb,
            "summaries": len(vals), "script_test_acc": float(test_acc[-1])
            if test_acc else None}


def _host_engines(seed, device, cycles):
    """t4_20a whole on the native engine and on the Python inner loop
    (the path T4_NO_NATIVE=1 takes), each in a REPL of its own; then, in
    one REPL, 3 warm runs each of t4_20a's `mx` loop and the larger
    `mxl` loop on either engine, the engines in turns (N P P N N P)"""
    from tensorforth_tpu_torch.runtime import native
    core = native.get_core
    gets = {"native": core, "python": lambda: None}
    res = {e: {} for e in gets}
    with open(os.path.join("examples", "t4_20a.4th")) as f:
        lines = [ln.rstrip("\n").replace("999 mx", f"{cycles} mx")
                 for ln in f if not ln.startswith("bye")]
    for engine, get in gets.items():
        with attr_set(native, get_core=get):
            inst, run = repl(device, seed)
            res[engine]["transcript"] = "".join(run(ln) for ln in lines)
            res[engine]["engine_used"] = inst.vm._engine is not None
            inst.teardown()
    inst, run = repl(device, seed)
    # t4_20a's word; mxl is the same loop over the larger operands
    run("0 trace\n: mx dup >r clock >r for @ drop next clock r> - r> 1+ "
        '/ ." => " . ."  msec/cycle" cr ;')
    for word, operands in (
            ("mx", "512 1024 matrix rand 1024 256 matrix ones"),
            ("mxl", "1024 2048 matrix rand 2048 512 matrix ones")):
        run(operands)
        run(f"{cycles} mx")        # warm: the allocator holds its results
        for engine in ("native", "python", "python", "native", "native",
                       "python"):
            with attr_set(native, get_core=gets[engine]):
                inst.vm._engine = None     # made again on the next line
                o = run(f"{cycles} mx")
                if (inst.vm._engine is not None) != (engine == "native"):
                    raise RuntimeError(f"{word} did not run on {engine}")
            res[engine].setdefault(word + "_samples", []).append(
                float(re.search(r"=> (\S+) ", o).group(1)))
        run("drop drop")
    inst.teardown()
    for r in res.values():
        for word in ("mx", "mxl"):
            r[word + "_ms"] = statistics.median(r[word + "_samples"])
    return res


def _host_tasks(seed, device, n, iters, batches, chunk):
    """at T4_VM_COUNT=4, two tasks run a gemm4 loop and a send/recv `@`
    loop on card tensors while VM 0 trains t4_30e's nn_c on the fused
    path (a captured chunk and its replays); then the same words on VM 0
    one after another, and VM 0's training again from the same weights in
    a single-VM REPL"""
    import torch
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.nn import cycle
    from tensorforth_tpu_torch.vm.multitask import TaskPool
    setup = (f"{n} {n} matrix rand constant TA\n"
             f"{n} {n} matrix rand constant TB\n"
             f"{n} {n} matrix rand constant TC\n"
             f"{n} {n} matrix rand constant TX\n"
             f": tg 1.0 0.0 TA TB TC {iters} for gemm4 drop next gemm4 ;\n"
             f": tms TB {iters} for @ drop next @ ;\n"
             ": tm recv tms ;")
    loop = ("variable {v}h 0 {v}h ! variable {v}l\n"
            ": {v}ep for forward loss.ce {v}l ! nn.hit {v}h +! "
            "backprop 0.001 nn.adam next ;")
    fused = dict(T4_NO_FUSE=None, T4_NO_MACRO=None, T4_MAX_BATCH=batches,
                 T4_CHUNK=chunk)
    alive_at_capture = []
    capture_fn = cycle._capture

    def watched(*a):
        alive_at_capture.append(sum(
            1 for t in TaskPool.get().tasks.values()
            if t.thread is not None and t.thread.is_alive()))
        return capture_fn(*a)

    with attr_set(Config, VM_COUNT=4), env_set(**fused), \
            attr_set(cycle, _capture=watched):
        inst, run = repl(device, seed)
        pool_size = len(inst.pool)
        run(setup)
        run(NN_C.format(v="ka"))
        base = _weights(_models(inst.vm)[-1])
        run(loop.format(v="ka"))
        cycle.reset_counts()
        run("' tg task constant T1\n' tm task constant T2")
        out = run("T1 start T2 start TX 1 T2 send "
                  "kad rewind drop ka kad kaep drop\n"
                  "kad rewind drop ka kad kaep drop")
        counts = dict(cycle.COUNTS)
        run("T1 join T2 join")
        pulled = []
        for t in ("T1", "T2"):
            run(f"1 {t} pull")
            pulled.append(inst.vm.TTOS().numpy())
            run("drop")
        w_tasks = _weights(_models(inst.vm)[-1])
        seq = []
        for word in ("tg", "TX tms"):
            run(f"abort {word}")
            seq.append(inst.vm.TTOS().numpy())
        run("abort")
        inst.teardown()
    with env_set(**fused):
        inst, run = repl(device, seed)
        run(NN_C.format(v="ka"))
        _pin(_models(inst.vm)[-1], base)
        run(loop.format(v="ka"))
        run("kad rewind drop ka kad kaep drop\n"
            "kad rewind drop ka kad kaep drop")
        w_single = _weights(_models(inst.vm)[-1])
        inst.teardown()
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    return {"pool": pool_size, "counts": counts,
            "tasks_alive_at_captures": alive_at_capture,
            "faults": transcript_faults(out),
            "task_results_equal": [bool(np.array_equal(a, b))
                                   for a, b in zip(pulled, seq)],
            "weights_max_diff": _max_diff(w_tasks, w_single)}


def _host_prof(seed, device, n):
    """_host_prof_child in a process of its own, as a user's session
    that profiles: on an H100 a process that had run this script's
    earlier phases (many profiler sessions, CUDA graphs) kept only the
    first kernel record of a later session, where a process's first
    sessions kept all of them"""
    r = subprocess.run([sys.executable, "-c", "import json, chip_smoke as "
                        f"cs; print(json.dumps({{'prof': cs._host_prof_child("
                        f"{seed!r}, {device!r}, {n!r})}}))"],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"prof"')]
    if r.returncode or not lines:
        raise RuntimeError(f"the profiler's child failed ({r.returncode}): "
                           f"{r.stderr[-2000:]}")
    return json.loads(lines[-1])["prof"]


def _host_prof_child(seed, device, n):
    """prof.start / prof.stop around one gemm4 and one gemm: the kernel
    names in the Chrome trace under ./t4_profile"""
    import glob
    with tempfile.TemporaryDirectory(prefix="t4_prof_") as d:
        cwd = os.getcwd()
        inst, run = repl(device, seed)
        try:
            run(f"1.0 0.0 {n} {n} matrix rand {n} {n} matrix rand "
                f"{n} {n} matrix zeros gemm4 drop gemm drop")
            os.chdir(d)
            out = run("prof.start\ngemm4 drop\ngemm drop\nprof.stop")
        finally:
            os.chdir(cwd)
            inst.teardown()
        paths = glob.glob(os.path.join(d, "t4_profile", "plugins", "profile",
                                       "*", "*.pt.trace.json"))
        names, cats = set(), {}
        for p in paths:
            with open(p) as f:
                events = json.load(f)["traceEvents"]
            for e in events:
                c = str(e.get("cat"))
                cats[c] = cats.get(c, 0) + 1
                if c.lower() == "kernel":
                    names.add(e.get("name", ""))
    ours = sorted(k for k in names if "gemm_sm90_kernel" in k)
    library = sorted(k for k in names
                     if "gemm" in k.lower() and "gemm_sm90" not in k)
    return {"printed": [ln for ln in out.splitlines() if "prof" in ln],
            "faults": transcript_faults(out), "traces": len(paths),
            "event_categories": cats,
            "kernels": sorted(k[:60] for k in names)[:12],
            "k6_kernels": [k[:120] for k in ours],
            "library_gemm_kernels": [k[:120] for k in library]}


def phase_host(seed: int = NET_SEED, device=None, epochs=HOST_EPOCHS,
               max_batch=None, cycles=999, task_n=HOST_TASK_N,
               task_iters=HOST_TASK_ITERS, batches=HOST_BATCHES,
               chunk=HOST_CHUNK):
    """the host tier on the card: (a) t4_40a through TensorBoard, uncut,
    with and without -t; (b) the native engine against the Python loop on
    t4_20a's loops; (c) tasks on the card while VM 0 captures; (d)
    prof.start/prof.stop; (e) mstat's TLSF lines after (a)"""
    import torch
    on_card = device is None or torch.device(device).type == "cuda"
    cut = []
    if epochs != HOST_EPOCHS:
        cut.append(f"{epochs} epochs of {HOST_EPOCHS}")
    if max_batch:
        cut.append(f"T4_MAX_BATCH={max_batch}")
    if cut:
        print(f"host: cut to {', '.join(cut)}", flush=True)
    libs = native_libs()
    checks, rec = {}, {"native_libraries": libs}

    # --- (a) t4_40a with -t, without it (the control of its cost), and
    #     with it again: the first run also makes the corpus
    runs = []
    for tb, sync_io in ((True, None), (False, None), (True, None),
                        (True, 1)):
        with tempfile.TemporaryDirectory(prefix="t4_tb_") as tb_dir, \
                env_set(T4_SYNC_IO=sync_io):
            r = _host_t4_40a(seed, device, tb_dir if tb else None, epochs,
                             max_batch)
            if not runs:
                rec["tb"] = _host_tb_check(tb_dir, r[0], epochs, checks)
        runs.append(r)
    text, per_epoch, backlog, at_bye, wall = runs[0]
    ctl_text, ctl_epoch, _, _, ctl_wall = runs[1]
    again_epoch, again_wall = runs[2][1], runs[2][4]
    sync_epoch, sync_wall = runs[3][1], runs[3][4]
    checks["t4_40a_epochs_printed"] = len(per_epoch) == epochs + 1
    checks["t4_40a_no_faults"] = not transcript_faults(text)
    # the same training with and without the writer: the same hits
    checks["t4_40a_same_hits_without_tb"] = re.findall(
        r"hit=(\d+)", text) == re.findall(r"hit=(\d+)", ctl_text)
    acc = at_bye["held_out"]
    if not cut:
        checks["held_out_accuracy"] = acc >= HOST_GATE
    rec["t4_40a"] = {
        "epochs_run": len(per_epoch), "wall_s_with_tb": wall,
        "wall_s_without_tb": ctl_wall, "wall_s_with_tb_again": again_wall,
        "s_per_epoch_with_tb": statistics.median(per_epoch[1:] or per_epoch),
        "s_per_epoch_without_tb": statistics.median(ctl_epoch[1:]
                                                    or ctl_epoch),
        "s_per_epoch_with_tb_again": statistics.median(again_epoch[1:]
                                                       or again_epoch),
        # the writes on VM 0's thread, no worker (T4_SYNC_IO=1)
        "s_per_epoch_with_tb_sync_io": statistics.median(sync_epoch[1:]
                                                         or sync_epoch),
        "wall_s_with_tb_sync_io": sync_wall,
        "epoch_s_with_tb_sync_io": sync_epoch,
        "first_epoch_s_with_tb": per_epoch[0],
        "first_epoch_s_without_tb": ctl_epoch[0],
        "epoch_s_with_tb": per_epoch, "epoch_s_without_tb": ctl_epoch,
        "equeue_backlog_at_line_ends_max": max(backlog),
        "equeue_backlog_at_bye": backlog[-1],
        "equeue_backlog_at_training_line_end": backlog[-2],
        "script_test_acc": rec["tb"]["script_test_acc"],
        "held_out_accuracy": acc, "held_out_samples":
            256 * min(HOST_HELD_BATCHES, max_batch or HOST_HELD_BATCHES),
        "gate": HOST_GATE if not cut else None}

    # --- (e) mstat after (a): the TLSF's used bytes are the live tensors'
    m = re.search(r"Ostore\(TLSF:accounting\) arena\[(\d+)\] used\[(\d+)\] "
                  r"peak\[(\d+)\] alloc#\[(\d+)\] free#\[(\d+)\]",
                  at_bye["mstat"])
    checks["mstat_tlsf_line"] = m is not None
    if m:
        used, peak = int(m.group(2)), int(m.group(3))
        checks["mstat_used_is_live_tensor_bytes"] = (
            used == at_bye["live_tlsf_bytes"])
        checks["mstat_peak_at_least_used"] = peak >= used
    rec["mstat"] = {"lines": at_bye["mstat"].splitlines(),
                    "live_tensors": at_bye["live_tensors"],
                    "live_tensor_bytes": at_bye["live_tensor_bytes"],
                    "live_tensor_bytes_8_aligned": at_bye["live_tlsf_bytes"]}

    # --- (b) the native engine against the Python loop
    eng = _host_engines(seed, device, cycles)
    mask = lambda t: re.sub(r"=> \S+  msec/cycle", "=> T  msec/cycle",
                            t)  # noqa: E731
    checks["native_engine_used"] = eng["native"]["engine_used"]
    checks["python_loop_used"] = not eng["python"]["engine_used"]
    checks["engines_print_the_same"] = (mask(eng["native"]["transcript"])
                                        == mask(eng["python"]["transcript"]))
    checks["see_mx_is_the_references"] = SEE_MX in eng["native"]["transcript"]
    checks["engines_no_faults"] = not transcript_faults(
        eng["native"]["transcript"])
    rec["engines"] = {k: {kk: vv for kk, vv in v.items()
                          if kk != "transcript"} for k, v in eng.items()}

    # --- (c) tasks on the card while VM 0 captures
    tasks = _host_tasks(seed, device, task_n, task_iters, batches, chunk)
    checks["tasks_pool_of_4"] = tasks["pool"] == 4
    checks["tasks_chunks_ran"] = tasks["counts"]["chunks"] > 0
    if on_card:
        checks["tasks_captured"] = tasks["counts"]["captures"] > 0
        checks["tasks_ran_during_a_capture"] = any(
            tasks["tasks_alive_at_captures"])
    checks["tasks_no_faults"] = not tasks["faults"]
    checks["task_results_equal_in_turn"] = all(tasks["task_results_equal"])
    checks["weights_equal_single_vm"] = tasks["weights_max_diff"] == 0.0
    rec["tasks"] = tasks

    # --- (d) the profiler words
    prof = _host_prof(seed, device, task_n)
    checks["prof_trace_written"] = prof["traces"] == 1
    checks["prof_no_faults"] = not prof["faults"]
    checks["prof_printed"] = any("profile -> t4_profile" in ln
                                 for ln in prof["printed"])
    if on_card:
        checks["prof_names_k6"] = bool(prof["k6_kernels"])
        checks["prof_names_library_gemm"] = bool(prof["library_gemm_kernels"])
    rec["prof"] = prof

    emit({"phase": "host", "card": card_line() if on_card else None,
          "cut": cut or None, **rec, "checks": checks})
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"host checks failed: {bad}")
    return rec



ARENA_EPOCHS = 2      # t4_30e under T4_ARENA=1 and without, cut from 20
# t4_20a's runs, in an order that puts the pool's runs between two runs
# without it: the first run of a process pays the first-run effect
ARENA_ORDER = (False, True, True, False)
# after t4_30e's word loop at the defaults, one epoch of nn.train
ARENA_NN_TRAIN = "ds0 rewind drop md0 ds0 0.001 1 nn.train drop"
ARENA_MASK = ((re.compile(r"=> \S+  msec/cycle"), "=> #  msec/cycle"),
              (re.compile(r"-0\.0000\b"), "+0.0000"),
              (re.compile(r"\\   (Ostore|payloads).*\n"), ""))


def _with_arena(on: bool, fn):
    """fn() with Config.ARENA set (a fresh REPL's MMU reads it)"""
    from tensorforth_tpu_torch.config import Config
    saved = Config.ARENA
    Config.ARENA = on
    try:
        return fn()
    finally:
        Config.ARENA = saved


def phase_arena(seed: int = NET_SEED, device=None, epochs=ARENA_EPOCHS,
                max_batch=None, script_dir="examples"):
    """the device arena (T4_ARENA=1, mu/arena.py): t4_20a whole and
    t4_30e's model trained `epochs` epochs on the per-word path and at the
    REPL's defaults (fused cycles, chunks and CUDA graphs, then an epoch
    of nn.train), each with the payloads in the one pool and without it;
    the transcripts equal (but for the clock and mstat's Ostore lines),
    mx's msec/cycle both ways (ARENA_ORDER), mstat's owner line against
    the live tensors' bytes, and the held-out accuracy equal"""
    from tensorforth_tpu_torch.nn import cycle
    with open(os.path.join(script_dir, "t4_20a.4th")) as f:
        t20 = [ln.rstrip("\n") for ln in f]
    runs, checks, mx = {}, {}, []
    for on in ARENA_ORDER:
        def go():
            inst, run = repl(device, seed)
            out = "".join(run(ln) for ln in t20)
            mst = run("256 256 matrix rand 3 vector{ 1 2 3 } 8 8 matrix ones "
                      "mstat")
            mmu = inst.sys.mu
            own, other = mmu.payloads()
            live = sum(o.numel * 4 for o in mmu._objs.values()
                       if not (o.is_model() or o.is_future()))
            return dict(out=out, mstat=mst, own=own, other=other, live=live,
                        ms=[float(v) for v in re.findall(
                            r"=> (\S+)  msec/cycle", out)],
                        pool=mmu.arena is not None)
        got = _with_arena(on, go)
        runs.setdefault(on, got)          # the first run of each kind
        mx.append({"arena": on, "ms": got["ms"]})
        checks["t4_20a_equal"] = checks.get("t4_20a_equal", True) and (
            _mask_all(got["out"], ARENA_MASK)
            == _mask_all(runs[ARENA_ORDER[0]]["out"], ARENA_MASK))
    a, b = runs[True], runs[False]
    checks["t4_20a_no_fault"] = not transcript_faults(a["out"])
    checks["pool_made"] = a["pool"] and not b["pool"]
    checks["mstat_owner"] = "Ostore(TLSF:owner)" in a["mstat"]
    owner = re.search(r"pool-owned\[(\d+)\]=(\d+)B torch-owned\[(\d+)\]"
                      r"=(\d+)B", a["mstat"])
    checks["owner_line_is_live_bytes"] = bool(owner) and (
        int(owner.group(2)) + int(owner.group(4)) == a["live"] > 0
        and int(owner.group(2)) == sum(a["own"]) > 0)
    t30 = {}
    for path, env in (("per_word", PER_WORD),
                      ("default", {k: None for k in PER_WORD})):
        held = {}
        with tempfile.TemporaryDirectory(prefix="t4_arena_") as save_dir, \
                env_set(T4_MAX_BATCH=max_batch, **env):
            lines = _net_lines(os.path.join(script_dir, "t4_30e.4th"),
                               epochs, save_dir)
            if path == "default":
                lines.append(ARENA_NN_TRAIN)
            for on in (False, True):
                def train():
                    inst, run = repl(device, seed)
                    cycle.reset_counts()
                    t0 = time.perf_counter()
                    out = "".join(run(ln) for ln in lines)
                    sec = time.perf_counter() - t0
                    counts = dict(cycle.COUNTS)
                    h = run(HOST_HELD_OUT)
                    return dict(printed=re.findall(r"acc=(\S+) loss=(\S+)",
                                                   out),
                                acc=float(re.search(r"GATE= (\S+) ",
                                                    h).group(1)),
                                seconds=sec, counts=counts,
                                pool=inst.sys.mu.arena is not None,
                                faults=transcript_faults(out))
                held[on] = _with_arena(on, train)
        t, f = held[True], held[False]
        checks[f"t4_30e_{path}_lines_equal"] = (
            t["printed"] == f["printed"] and len(t["printed"]) == epochs)
        checks[f"t4_30e_{path}_held_out_equal"] = t["acc"] == f["acc"]
        checks[f"t4_30e_{path}_no_fault"] = not (t["faults"] or f["faults"])
        checks[f"t4_30e_{path}_pool_made"] = t["pool"] and not f["pool"]
        if path == "default":
            # the fused cycles and nn.train's graph ran under the pool
            checks["t4_30e_default_fused"] = t["counts"]["fused"] > 0 and \
                t["counts"]["runs"] > 0
            checks["t4_30e_default_captured"] = (
                t["counts"]["captures"] > 0 or torch_device(device).type != "cuda")
        t30[path] = {"held_out_arena": t["acc"],
                     "held_out_no_arena": f["acc"],
                     "printed": t["printed"], "counts_arena": t["counts"],
                     "counts_no_arena": f["counts"],
                     "seconds_arena": t["seconds"],
                     "seconds_no_arena": f["seconds"]}
    emit({"phase": "arena", "card": card_line() if
          torch_device(device).type == "cuda" else None,
          "mx_msec_per_cycle": mx, "order": ARENA_ORDER,
          "mstat_owner": owner.group(0) if owner else None,
          "live_tensor_bytes": a["live"],
          "t4_30e": {"epochs": epochs, **t30}, "checks": checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"arena phase failed: {bad}")
    return checks


def _mask_all(text, pats):
    for pat, repl_ in pats:
        text = pat.sub(repl_, text)
    return text


MESH_LM = dict(LM)          # bench_prefill's tiny_lm width (LM), seq 2048
MESH_RANKS = 2              # dp2 on the one card, over gloo
MESH_SPECS = ("dp2", "dp2,tp2")   # the word loop's meshes
MESH_EPOCHS = 2             # t4_30e's word loop under each mesh
# batches an epoch, cut from 600: test_word_mesh's own depth (7), where
# the mesh is held to one rank within its bounds (equal hits, 5e-5 on the
# loss, 2e-4 on the weights), and 20 (40 steps), where the mesh is held
# bit for bit to one process that runs the ranks' arithmetic in turn
# (_emulated_mesh): a rank's products over its 50 rows (or its half of a
# layer's features) sum in another order than one rank's over 100, and
# Adam's steps carry that apart from one rank (PERF.md §6)
MESH_MAX_BATCH = 7
MESH_LONG_BATCH = 20
MESH_LOSS_TOL, MESH_W_ATOL = 5e-5, 2e-4
MESH_GEN_SPEC = "dp2,tp2"   # generate over 4 ranks: 4 prompts and 4 heads
MESH_N_NEW = 64             # each


class _EmuMesh:
    """the word mesh as one process sees it while it runs every rank's
    arithmetic in turn: dp x tp with no collective (the whole tensors are
    there already)"""
    axis_names = ("dp", "tp")

    def __init__(self, dp, tp):
        self.dp, self.tp, self.shape = dp, tp, (dp, tp)

    def axis_size(self, axis):
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def all_gather(self, t, dim, axis="tp"):
        return t

    def all_reduce(self, t, axis):
        return t


def _tp_part(t, axis, i, tp):
    return t.chunk(tp, dim=axis)[i].contiguous()


def _emu_forward(mesh, program, x, params, key):
    """funcs._forward_mesh's arithmetic for every dp rank in turn, each
    rank's layer over its rows and (for a split layer) each tp rank's
    shard of the parameters in turn; the collectives become
    concatenations"""
    import torch
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.ntypes import Layer
    from tensorforth_tpu_torch.ops import rng
    n = x.shape[0]
    k = n // mesh.dp
    per = []
    for d in range(mesh.dp):
        lo = d * k
        xl, outs, masks = x[lo:lo + k], [], []
        for j, (spec, p) in enumerate(zip(program, params)):
            ls = funcs._local_spec(spec, k)
            if spec[0] == Layer.DROPOUT:
                u = rng.uniform(funcs.layer_key(key, j),
                                (n,) + tuple(xl.shape[1:]), xl.device)
                m = (u > spec[1][0]).to(torch.float32)[lo:lo + k]
                y = xl * m
            elif spec[0] in funcs._TP_SPLIT and mesh.tp > 1:
                ax, wax, bax = funcs._TP_SPLIT[spec[0]]
                y = torch.cat([funcs._tp_layer(
                    mesh, ls, xl, (_tp_part(p[0], wax, t, mesh.tp),
                                   _tp_part(p[1], bax, t, mesh.tp)))
                    for t in range(mesh.tp)], dim=ax)
                m = None
            elif spec[0] in (Layer.BATCHNM, Layer.MOE):
                raise NotImplementedError("the emulation has no batchnorm")
            else:
                y, m = funcs._apply_layer(ls, xl, p, None)
            xl = y.reshape(ls[2])
            outs.append(xl)
            masks.append(m)
        per.append((outs, masks))
    rows = lambda ts: (torch.cat(ts, 0) if torch.is_tensor(ts[0])  # noqa
                       and ts[0].dim() and ts[0].shape[0] == k else ts[0])
    return tuple(tuple(rows([r[i][j] for r in per])
                       for j in range(len(program))) for i in (0, 1))


def _emu_split_grads(m, kind, x_in, w, dy, opts, out_shape):
    """funcs._split_grads for each tp rank in turn (its shard of w, its
    features of dy), dx summed over them (a sum of two is the one order
    gloo's all-reduce can take), dw and db concatenated"""
    import torch
    from tensorforth_tpu_torch.nn import funcs
    if m is None:
        return _EMU_SAVED["split"](None, kind, x_in, w, dy, opts, out_shape)
    assert m.tp == 2, "the emulation sums two tp ranks"
    ax, wax, bax = funcs._TP_SPLIT[kind]
    res = []
    for t in range(m.tp):
        one = type("TpRank", (), {
            "chunk": lambda self, v, dim, axis, t=t: v.chunk(m.tp, dim)[t],
            "all_reduce": lambda self, v, axis: v})()
        res.append(_EMU_SAVED["split"](one, kind, x_in,
                                       _tp_part(w, wax, t, m.tp), dy, opts,
                                       out_shape))
    (x0, w0, b0), (x1, w1, b1) = res
    return x0 + x1, torch.cat((w0, w1), wax), torch.cat((b0, b1), bax)


def _row_slice(t, lo, k, n):
    """rows lo.. lo + k of every tensor of n rows in t (a tuple of them)"""
    import torch
    if isinstance(t, (tuple, list)):
        return type(t)(_row_slice(v, lo, k, n) for v in t)
    if torch.is_tensor(t) and t.dim() and t.shape[0] == n:
        return t[lo:lo + k]
    return t


def _emu_backward(mesh, program, train, tgt, x0, outs, params, masks, dws,
                  dbs, flash):
    """funcs._backward_mesh's arithmetic for the dp2 ranks in turn: each
    rank's rows from zeroed accumulators, the two contributions summed (a
    sum of two is the one order gloo's all-reduce can take)"""
    import torch
    from tensorforth_tpu_torch.nn import funcs
    assert mesh.dp == 2, "the emulation sums two ranks"
    n = outs[-1].shape[0]
    k = n // mesh.dp
    res = []
    for d in range(mesh.dp):
        sl = lambda t, lo=d * k: _row_slice(t, lo, k, n)  # noqa: E731
        res.append(funcs._backward_body(
            tuple(funcs._local_spec(spec, k) for spec in program), train,
            sl(tgt.reshape(outs[-1].shape)), sl(x0), sl(tuple(outs)), params,
            sl(tuple(masks)), [None if w is None else torch.zeros_like(w)
                               for w in dws],
            [None if b is None else torch.zeros_like(b) for b in dbs],
            flash, mesh=(mesh, n)))
    (o0, x0s, w0, b0), (o1, x1s, w1, b1) = res
    acc = lambda a, c0, c1: None if c0 is None else funcs._acc(  # noqa
        a, c0.contiguous() + c1.contiguous())
    return (torch.cat((o0, o1)),
            type(x0s)(None if a is None else torch.cat((a, b))
                      for a, b in zip(x0s, x1s)),
            type(w0)(acc(a, c0, c1) for a, c0, c1 in zip(dws, w0, w1)),
            type(b0)(acc(a, c0, c1) for a, c0, c1 in zip(dbs, b0, b1)))


_EMU_SAVED = {}


class _emulated_mesh:
    """inside the block the word path runs a dp2[,tp2] mesh's arithmetic
    in this one process, with no collective and the model's tensors
    whole: the witness that a mesh run departs from one rank's by the
    ranks' shapes alone"""

    def __init__(self, spec):
        from tensorforth_tpu_torch.parallel.mesh import parse_spec
        p = parse_spec(spec)
        self.mesh = _EmuMesh(p.get("dp", 1), p.get("tp", 1))

    def __enter__(self):
        from tensorforth_tpu_torch.nn import funcs
        from tensorforth_tpu_torch.nn.model import Model
        self.saved = (funcs.word_mesh, Model._rows, Model._pspec,
                      funcs._forward_mesh, funcs._backward_mesh,
                      funcs._split_grads)
        _EMU_SAVED["split"] = funcs._split_grads
        funcs.word_mesh = lambda: self.mesh
        # the model's tensors stay whole: no rank's rows or shards
        Model._rows = staticmethod(lambda: None)
        Model._pspec = staticmethod(lambda t_in, k: None)
        funcs._forward_mesh, funcs._backward_mesh = _emu_forward, _emu_backward
        funcs._split_grads = _emu_split_grads
        return self

    def __exit__(self, *exc):
        from tensorforth_tpu_torch.nn import funcs
        from tensorforth_tpu_torch.nn.model import Model
        rows, pspec = self.saved[1:3]
        (funcs.word_mesh, _r, _p, funcs._forward_mesh,
         funcs._backward_mesh, funcs._split_grads) = self.saved
        Model._rows, Model._pspec = staticmethod(rows), staticmethod(pspec)


def _held_bytes(model) -> int:
    """the bytes of a model's tensors (layer outputs, parameters,
    gradients, moments, masks) that this process holds: a rank's part
    under the word mesh (C10), else the whole"""
    seen, n = set(), 0
    for t in model.data:
        for x in [t] + list(t.grad) + list(t.mtum):
            if x is None or id(x) in seen:
                continue
            seen.add(id(x))
            part = x._shard[0] if x._shard is not None else x.data
            n += 0 if part is None else part.numel() * 4
    return n


def _mesh_word_loop(device, epochs, max_batch, script_dir):
    """t4_30e's lines (its `epochs`), the model's weights after them and
    the printed acc=/loss= lines, through a fresh REPL; the bytes of the
    model this process held after its training loop (before `save` reads
    the model whole)"""
    with tempfile.TemporaryDirectory(prefix="t4_mesh_") as save_dir, \
            env_set(T4_MAX_BATCH=max_batch):
        lines = _net_lines(os.path.join(script_dir, "t4_30e.4th"), epochs,
                           save_dir)
        inst, run = repl(device, NET_SEED)
        t0 = time.perf_counter()
        out, held = [], None
        for ln in lines:
            if held is None and " save" in ln:
                held = _held_bytes(_models(inst.vm)[-1])
            out.append(run(ln))
        out = "".join(out)
        sec = time.perf_counter() - t0
        run("md0")
        md = inst.vm.mmu.du2obj(inst.vm.tos)
        run("drop")
        ws = [w.detach().cpu().numpy().copy() for pl in md._params()
              for w in pl]
    return dict(printed=re.findall(r"acc=(\S+) loss=(\S+)", out),
                weights=ws, seconds=sec, faults=transcript_faults(out),
                held_bytes=held)


def _peak_over(device, fn):
    """fn()'s result and the device memory its run allocated at its peak
    beyond what was allocated before it (None off the card)"""
    import torch
    if torch.device(device if device else "cuda").type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _mesh_word_rank(rank, world, device, spec, epochs, max_batch,
                    script_dir):
    import torch
    from tensorforth_tpu_torch.nn import cycle, funcs
    from tensorforth_tpu_torch.parallel import mesh as pm
    os.environ["T4_MESH"] = spec
    cycle.reset_counts()
    before = dict(pm.COUNTS)
    r, peak = _peak_over(device, lambda: _mesh_word_loop(
        device, epochs, max_batch, script_dir))
    steps = epochs * max_batch
    comm = {k: pm.COUNTS[k] - before[k] for k in before}
    r.update(mesh=funcs.word_mesh().shape, counts=dict(cycle.COUNTS),
             collectives=comm, peak_bytes_over_start=peak,
             collectives_per_step={k: comm[k] / steps
                                   for k in ("all_reduce", "all_gather")},
             backend=torch.distributed.get_backend())
    r["long"] = _mesh_word_loop(device, epochs, MESH_LONG_BATCH, script_dir)
    return r


def _mesh_gen_rank(rank, world, device, spec, lm, seq, n_new, seed):
    """generate under the mesh: (ids, prefill ms, whole ms, collectives)"""
    import torch
    from tensorforth_tpu_torch.nn import serve
    from tensorforth_tpu_torch.parallel import mesh as pm
    os.environ["T4_MESH"] = spec
    m = _gen_lm(device, lm, seq, seed)
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (lm["batch"], seq))
    sync = torch.cuda.synchronize if m.device.type == "cuda" else (
        lambda: None)
    before, launched = dict(pm.COUNTS), flash_counts()
    ids = serve.generate(m, prompt, n_new, temp=0.0)
    pre, tot, _p, _t = time_generate(m, prompt, n_new, sync, graphs=False)
    return dict(ids=ids, prefill_ms=pre, total_ms=tot,
                mesh=serve.serving_mesh(m._program(), lm["batch"]).shape,
                collectives={k: pm.COUNTS[k] - before[k] for k in before},
                launches={k: v - launched[k]
                          for k, v in flash_counts().items()})


def _mesh_ranks(rank, world, device, spec, lm, seq, epochs, max_batch,
                script_dir, n_new, seed):
    """one start of the mesh's ranks: the ShardedTrainer gradient under
    dp2, the word loop under `spec`, generate under MESH_GEN_SPEC"""
    out = {}
    if "tp" not in spec:
        out["trainer"] = _mesh_rank(rank, world, device, lm, seq, spec)
    out["word"] = _mesh_word_rank(rank, world, device, spec, epochs,
                                  max_batch, script_dir)
    if spec == MESH_GEN_SPEC:
        out["gen"] = _mesh_gen_rank(rank, world, device, spec, lm, seq,
                                    n_new, seed)
    return out


def _gen_lm(device, lm, seq, seed):
    from tensorforth_tpu_torch.models.zoo import tiny_lm
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(seed)
    return tiny_lm(seq=seq, device=device, **lm)


def _mesh_lm(device, lm, seq):
    from tensorforth_tpu_torch.models import zoo
    import torch
    torch.manual_seed(0)
    m = zoo.tiny_lm(batch=lm["batch"], seq=seq, vocab=lm["vocab"],
                    dim=lm["dim"], heads=lm["heads"], layers=lm["layers"],
                    rope=lm["rope"], device=device)
    rs = np.random.RandomState(0)
    for pl in m._params():          # the same weights on every rank
        for w in pl:
            v = rs.standard_normal(tuple(w.shape)).astype(np.float32)
            w.copy_(torch.from_numpy(0.02 * v).to(w.device))
    return m


def _mesh_batch(lm, seq, device):
    import torch
    rs = np.random.RandomState(1)
    ids = rs.randint(0, lm["vocab"], size=(lm["batch"], seq, 1, 1))
    nxt = rs.randint(0, lm["vocab"], size=(lm["batch"], seq))
    tgt = np.zeros((lm["batch"], seq, lm["vocab"], 1), np.float32)
    tgt[np.arange(lm["batch"])[:, None], np.arange(seq)[None, :], nxt, 0] = 1
    return (torch.from_numpy(ids.astype(np.float32)).to(device),
            torch.from_numpy(tgt).to(device))


def _mesh_rank(rank, world, device, lm, seq, spec):
    """a rank of the mesh: one ShardedTrainer gradient and step of the LM
    on its dp rows; rank 0 returns its numbers"""
    import torch
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    tr = ShardedTrainer(_mesh_lm(device, lm, seq), pm.mesh_from_spec(spec))
    x, y = _mesh_batch(lm, seq, device)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    tr.grads(x, y, rng.PRNGKey(0))          # warm: no build in the time
    before = flash_counts()
    sync()
    t0 = time.perf_counter()
    lval, grads = tr.grads(x, y, rng.PRNGKey(0))
    sync()
    ms = 1e3 * (time.perf_counter() - t0)
    after = flash_counts()
    tr.step(x, y)
    return dict(loss=float(lval), ms=ms,
                grads=[g.detach().cpu() for gl in grads for g in gl],
                launches={k: after[k] - before[k] for k in after},
                collectives=dict(pm.COUNTS), mesh=repr(tr.mesh),
                backend=torch.distributed.get_backend())


def phase_mesh(seed: int = 0, device=None, lm=MESH_LM, seq=N_PROMPT,
               ranks=MESH_RANKS, epochs=MESH_EPOCHS,
               max_batch=MESH_MAX_BATCH, n_new=MESH_N_NEW,
               script_dir="examples"):
    """the dp/tp mesh (parallel/mesh.py, trainer.py) on the one card: a
    ShardedTrainer gradient of tiny_lm at bench_prefill's width under dp2,
    its two ranks gloo processes on the one device (NCCL refuses two ranks
    on one GPU), against the one-rank gradient within TOL_NN of each
    tensor's largest value; each rank launches K1, K2a and K2b on its
    rows.  Then t4_30e's word loop at nn_c's width under dp2 and dp2,tp2
    against the one-rank run (test_word_mesh's bounds at its 14 steps),
    and generate at
    bench_prefill's width under dp2,tp2 (4 ranks: 4 prompts and 4 heads
    each, the KV caches [4, 4, S, 128]) against the one-rank tokens, with
    prefill ms and decode tok/s beside the one-rank numbers.  The word
    loop also runs 40 steps under each mesh, held bit for bit to one
    process that runs the ranks' arithmetic in turn (_emulated_mesh),
    with both runs' distance from one rank beside it"""
    import torch
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.ops import rng
    from tensorforth_tpu_torch.parallel import launch
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    dev = torch_device(device)
    t_part = time.perf_counter()
    one = ShardedTrainer(_mesh_lm(dev, lm, seq))
    x, y = _mesh_batch(lm, seq, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    one.grads(x, y, rng.PRNGKey(0))         # warm: no build in the time
    sync()
    t0 = time.perf_counter()
    l1, g1 = one.grads(x, y, rng.PRNGKey(0))
    sync()
    ms1 = 1e3 * (time.perf_counter() - t0)
    g1 = [g.detach().cpu() for gl in g1 for g in gl]
    del one, x, y
    # the one-rank references, then each mesh's ranks started once
    one_loop, one_peak = _peak_over(device, lambda: _mesh_word_loop(
        device, epochs, max_batch, script_dir))
    one_long = _mesh_word_loop(device, epochs, MESH_LONG_BATCH, script_dir)
    gm = _gen_lm(dev, lm, seq, seed)
    prompt = np.random.RandomState(seed).randint(0, lm["vocab"],
                                                 (lm["batch"], seq))
    from tensorforth_tpu_torch.nn import serve
    one_ids = serve.generate(gm, prompt, n_new, temp=0.0)
    one_pre, one_tot, _p, _t = time_generate(gm, prompt, n_new, sync,
                                             graphs=dev.type == "cuda")
    del gm
    runs, emus = {}, {}
    seconds = {"one_rank_references": time.perf_counter() - t_part}
    for spec in MESH_SPECS:
        t_part = time.perf_counter()
        with _emulated_mesh(spec):
            emus[spec] = _mesh_word_loop(device, epochs, MESH_LONG_BATCH,
                                         script_dir)
        seconds[f"emulation_{spec}"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        runs[spec] = launch.run(_mesh_ranks, 4 if "tp" in spec else ranks,
                                str(dev), spec, lm, seq, epochs, max_batch,
                                script_dir, n_new, seed)
        seconds[f"ranks_{spec}"] = time.perf_counter() - t_part
    r = runs[f"dp{ranks}"]["trainer"]
    tol = TOL_NN[Config.PRECISION]
    worst = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
                for a, b in zip(r["grads"], g1))
    checks = {"grads_within_tol_nn": worst <= tol,
              "loss_close": abs(r["loss"] - float(l1)) <= tol * abs(float(l1)),
              "k1_k2_launched_in_rank": all(
                  r["launches"][k] > 0 for k in
                  ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
              or dev.type != "cuda",
              "backend_gloo": r["backend"] == "gloo"}
    emit({"phase": "mesh", "ranks": ranks, "seconds": seconds,
          "backend": r["backend"], "mesh": r["mesh"],
          "collectives_rank0": r["collectives"],
          "launches_rank0": r["launches"], "lm": lm, "seq": seq,
          "precision": Config.PRECISION, "tol_nn": tol,
          "worst_grad_rel_err": worst, "loss_dp": r["loss"],
          "loss_one_rank": float(l1), "grad_ms_rank0": r["ms"],
          "grad_ms_one_rank": ms1, "checks": checks})
    # --- t4_30e's word loop under T4_MESH against one rank, and at 40
    # steps against the ranks' arithmetic run in one process
    loops = {}
    for spec in MESH_SPECS:
        emu = emus[spec]
        loops[spec] = lr = runs[spec]["word"]
        long_ = lr.pop("long")
        w_emu = max(float(np.abs(a - b).max())
                    for a, b in zip(long_["weights"], emu["weights"]))
        drift = lambda run: max(float(np.abs(a - b).max())  # noqa: E731
                                for a, b in zip(run["weights"],
                                                one_long["weights"]))
        checks[f"word_loop_{spec}_long_run_bit_equal_emulation"] = (
            w_emu == 0.0 and long_["printed"] == emu["printed"]
            and len(emu["printed"]) == epochs)
        checks[f"word_loop_{spec}_long_run_no_fault"] = not (
            long_["faults"] or emu["faults"])
        lr["long_run"] = {
            "printed": long_["printed"], "seconds": long_["seconds"],
            "emulation_printed": emu["printed"],
            "emulation_seconds": emu["seconds"],
            "max_weight_err_against_emulation": w_emu,
            "max_weight_err_against_one_rank": drift(long_),
            "emulation_max_weight_err_against_one_rank": drift(emu)}
        hits_equal = [a[0] for a in lr["printed"]] == [
            a[0] for a in one_loop["printed"]]
        loss_ok = all(abs(float(a[1]) - float(b[1])) < MESH_LOSS_TOL
                      for a, b in zip(lr["printed"], one_loop["printed"]))
        w_err = max(float(np.abs(a - b).max())
                    for a, b in zip(lr["weights"], one_loop["weights"]))
        checks[f"word_loop_{spec}_hits_equal"] = hits_equal and \
            len(lr["printed"]) == epochs
        checks[f"word_loop_{spec}_loss"] = loss_ok
        checks[f"word_loop_{spec}_weights"] = w_err <= MESH_W_ATOL
        checks[f"word_loop_{spec}_uncaptured"] = lr["counts"]["captures"] == 0
        checks[f"word_loop_{spec}_no_fault"] = not lr["faults"]
        lr["max_weight_err"] = w_err
        del lr["weights"]
    # --- generate under dp2,tp2 against one rank (graphs and eager alike)
    gen = runs[MESH_GEN_SPEC]["gen"]
    checks["generate_tokens_equal"] = bool(np.array_equal(gen["ids"],
                                                          one_ids))
    checks["generate_heads_split"] = gen["mesh"] == (2, 2)
    tok_s = lambda pre, tot: lm["batch"] * n_new / ((tot - pre) / 1e3)  # noqa
    emit({"phase": "mesh_paths", "word_loop": {
              "one_rank": {"printed": one_loop["printed"],
                           "seconds": one_loop["seconds"],
                           "held_bytes": one_loop["held_bytes"],
                           "peak_bytes_over_start": one_peak,
                           "long_run_printed": one_long["printed"],
                           "long_run_seconds": one_long["seconds"]},
              **{k: {kk: vv for kk, vv in v.items()}
                 for k, v in loops.items()},
              "epochs": epochs, "max_batch": max_batch,
              "long_max_batch": MESH_LONG_BATCH},
          "generate": {"spec": MESH_GEN_SPEC, "n_new": n_new,
                       "prefill_ms": gen["prefill_ms"],
                       "one_rank_prefill_ms": one_pre,
                       "decode_tok_s": tok_s(gen["prefill_ms"],
                                             gen["total_ms"]),
                       "one_rank_decode_tok_s": tok_s(one_pre, one_tot),
                       "collectives_rank0": gen["collectives"],
                       "launches_rank0": gen["launches"]},
          "checks": checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"mesh phase failed: {bad}")
    launched = dict(r["launches"])
    launched["flash_fwd"] += gen["launches"]["flash_fwd"]
    return launched


# --- the parallel phase: ring attention, nn.pipe, the ep and sp axes and
# the multi-host start-up, every rank a gloo process on the one card
PAR_RING = dict(bh=64, s=2048, dh=128)  # tiny_lm's prefill heads (B*h 64)
PAR_RANKS = 4                           # sp4, pp4, ep4, dp1 x sp2 x tp2
PAR_PIPE_LM = dict(batch=8, seq=2048, dim=1024, heads=8, classes=10,
                   layers=4)            # a stage a layer over pp4
PAR_PIPE_BATCHES = 2
# the pipelined step against the word path's under strict: test_moe_pipe's
# bounds (its f32 sums run in another order: microbatches of 1 row).  The
# worst element is a weight whose gradient lies within 40x Adam's eps,
# where the update is most sensitive to the sums' order; the word path
# with each batch's rows reversed lands as far from itself (PERF.md,
# section 6: seeds 0 to 3 on the card)
PAR_PIPE_TOL = dict(rtol=1e-4, atol=1e-5)
PAR_EP_BATCHES = 2                      # test_moe_pipe's ep case's corpus
PAR_EP_LR = 0.01                        # and its learning rate
# ep4 against the unsharded run under strict: test_moe_pipe's bounds (the
# loss at 1e-4, each weight within 2e-5 past 2e-4 of its value).  They
# hold for a run free of two discontinuities, in the JAX package's own ep
# run as in this one (PERF.md, section 6): a top-2 route whose margin lies
# within the runs' rounding (a token changes expert, and a unit's first
# gradient takes the other sign: Adam's first step, lr * sqrt(10), each
# way), and a gradient that is rounding noise beside Adam's eps of 1e-6.
# The seed's run is free of both; the phase prints the routes' margins and
# the worst element's gradients, which tell which one a failure is
PAR_EP_LOSS_RTOL, PAR_EP_TOL = 1e-4, dict(rtol=2e-4, atol=2e-5)
PAR_SP_LM = dict(NET_TRAIN_LM)          # bench_prefill's widths
PAR_DIST_LR = 0.01                      # tests/dist_worker.py's run


def _ring_inputs(seed, ring):
    rs = np.random.RandomState(seed)
    shape = (ring["bh"], ring["s"], ring["dh"])
    return tuple(rs.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _ring_rank(mesh, device, seed, ring):
    """ring attention over sp4 on this rank's [64, 512, 128] shards,
    causal and not, forward and the backward of sum(o^2); against the
    single-rank K4 pair over the whole sequence (each rank computes that
    reference after its counted run and checks its own chunk)"""
    import torch
    from tensorforth_tpu_torch.ops import attn
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.ring import ring_attention
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    q, k, v = (torch.from_numpy(t).to(device)
               for t in _ring_inputs(seed, ring))
    # a first call, uncounted and untimed: the hops' buffers and
    # connections, the kernels' libraries
    warm = [mesh.chunk(t, 1, "sp").contiguous().requires_grad_(True)
            for t in (q, k, v)]
    ring_attention(*warm, mesh, False).sum().backward()
    del warm
    out = {}
    for causal in (False, True):
        loc = [mesh.chunk(t, 1, "sp").contiguous().requires_grad_(True)
               for t in (q, k, v)]
        reset_flash_counts()
        before = dict(pm.COUNTS)
        sync()
        t0 = time.perf_counter()
        o = ring_attention(*loc, mesh, causal)
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd = flash_counts()
        t0 = time.perf_counter()
        (o ** 2).sum().backward()
        sync()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        counts = flash_counts()
        hops = {key: pm.COUNTS[key] - before[key] for key in before}
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ref, _lse = attn.flash_attention_lse(*leaves, causal)
        (ref ** 2).sum().backward()
        got = [o.detach()] + [t.grad for t in loc]
        want = [mesh.chunk(ref.detach(), 1, "sp")] + [
            mesh.chunk(t.grad, 1, "sp") for t in leaves]
        out["causal" if causal else "full"] = {
            "fwd_launches": fwd, "launches": counts, "hops": hops,
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "f64_ratio": [f64_ratio(a, b.double()) for a, b in
                          zip(got, want)]}
        del o, loc, ref, leaves
    return out


def _moe_corpus(seed):
    """tiny_moe's stub corpus at its defaults (batches of 8 [8, 16, 1])"""
    rs = np.random.RandomState(seed)
    data = rs.rand(PAR_EP_BATCHES * 8, 8, 16, 1).astype(np.float32)
    return data, rs.randint(0, 4, PAR_EP_BATCHES * 8)


def _pipe_corpus(seed, lm, n_batches):
    rs = np.random.RandomState(seed)
    b = lm["batch"]
    data = rs.rand(n_batches * b, lm["seq"], lm["dim"], 1).astype(np.float32)
    return data, rs.randint(0, lm["classes"], n_batches * b)


def _reversed_rows(n_batches, batch):
    """an index that reverses the rows of each batch: the same batches,
    their sums over the rows in another order"""
    return np.concatenate([np.arange(i * batch, (i + 1) * batch)[::-1]
                           for i in range(n_batches)])


def _par_models(seed, dev, sp_lm, pipe_lm=None):
    """the phase's models, their weights drawn from the seed in one
    order: the same in every process that calls this (tiny_moe first, so
    a fresh draw of it alone has its weights)"""
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(seed)
    out = (zoo.tiny_moe(device=dev), zoo.tiny_transformer(device=dev,
                                                          **sp_lm))
    if pipe_lm is not None:
        out += (zoo.tiny_transformer(device=dev, **pipe_lm),)
    return out


def _fresh_moe(seed, dev):
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.system import System
    System.get_sys().seed(seed)
    return zoo.tiny_moe(device=dev)


def _leaves(m):
    """(layer, slot) of each of m's parameters, in _weights' order"""
    return [(j, k) for j, pl in enumerate(m._params()) for k in range(len(pl))]


def _worst_leaf(m, got, want, rtol):
    """the element of m's parameters where `got` lies furthest from
    `want` past rtol: its leaf (layer, kind, w or b), flat index, values
    and excess |got - want| - rtol |want|"""
    from tensorforth_tpu_torch.nn import funcs
    prog = m._program()
    worst = None
    for i, ((j, k), a, c) in enumerate(zip(_leaves(m), got, want)):
        ex = np.abs(a - c) - rtol * np.abs(c)
        e = int(np.argmax(ex))
        if worst is None or ex.flat[e] > worst["excess"]:
            worst = {"param": i, "layer": j,
                     "kind": funcs._kind_name(prog[j][0]).strip("'"),
                     "which": "wb"[k],
                     "index": e, "got": float(a.flat[e]),
                     "want": float(c.flat[e]), "excess": float(ex.flat[e])}
    return worst


def _word_steps(m, data, labels, batch, lr, epochs, sync, grads=None):
    """the word path's steps (forward, backprop, adam) on m over the
    corpus in batches of `batch`, `epochs` times; each step's seconds
    (the gradients' copies left out).  grads: each step's gradient of
    every parameter (host copies, flat) appended"""
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    classes = m[-1].HWC()
    inp = mmu.tensor(batch, *m[0].shape[1:], device=m.device)
    hot = mmu.tensor(batch, 1, classes, 1, device=m.device)
    eye = np.eye(classes, dtype=np.float32)
    leaves = _leaves(m)
    steps = []
    for _e in range(epochs):
        for i in range(data.shape[0] // batch):
            sl = slice(i * batch, (i + 1) * batch)
            inp.set_numpy(data[sl])
            hot.set_numpy(eye[labels[sl]])
            sync()
            t0 = time.perf_counter()
            m.forward(inp)
            m.backprop(hot)
            sync()
            t1 = time.perf_counter()
            if grads is not None:
                grads.append([m[j].grad[2 + k].numpy().reshape(-1)
                              for j, k in leaves])
            t2 = time.perf_counter()
            m.adam(lr)
            sync()
            steps.append(t1 - t0 + time.perf_counter() - t2)
    return steps


def _at(grads, leaf):
    """each step's gradient at a _worst_leaf element"""
    return [float(g[leaf["param"]][leaf["index"]]) for g in grads]


def _parallel_rank(rank, world, device, seed, ring, sp_lm, pipe_lm,
                   pipe_batches):
    """a rank of the parallel phase: the ring, nn.train over tiny_moe
    under T4_MESH=ep4, the sp forward over (dp1, sp2, tp2), then nn.pipe's
    engine over pp4; rank 0 returns every rank's numbers.  The ranks make
    their models and data from the seed (nothing large is sent to them)"""
    import torch
    import torch.distributed as dist
    from tensorforth_tpu_torch.nn import funcs
    from tensorforth_tpu_torch.nn.train import train_epochs
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    m, t, pipe_m = _par_models(seed, dev, sp_lm, pipe_lm)
    start_w = [float(sum(np.abs(w).sum() for w in _weights(x)))
               for x in (m, t, pipe_m)]
    program, params = pipe_m._program(), pipe_m._params()
    del pipe_m
    out = {"ring": _ring_rank(pm.Mesh(("sp",), (world,)), dev, seed, ring)}
    # --- ep: nn.train over tiny_moe, the experts over ep4
    os.environ["T4_MESH"] = "ep4"
    t0 = time.perf_counter()
    loss = train_epochs(m, _StubDataset(*_moe_corpus(seed), 8), lr=PAR_EP_LR,
                        epochs=2)
    ep_s = time.perf_counter() - t0
    j = next(i for i, spec in enumerate(m._program())
             if spec[0] == funcs.Layer.MOE)
    mine = sum(w.numel() * 4 for w in m._params(True)[j])
    whole = sum(w.numel() * 4 for w in m._params()[j])
    out["ep"] = {"loss": loss, "weights": _weights(m), "seconds": ep_s,
                 "expert_bytes_rank": mine, "expert_bytes_whole": whole,
                 "mesh": repr(funcs.word_mesh())}
    os.environ.pop("T4_MESH")
    # --- sp: tiny_transformer's forward over (dp1, sp2, tp2)
    x = _sp_input(seed, sp_lm, dev)
    tr = ShardedTrainer(t, pm.make_mesh3(world, 1, 2, 2))
    before = dict(pm.COUNTS)
    tr.forward(x)                       # warm
    reset_flash_counts()
    sync()
    t0 = time.perf_counter()
    y = tr.forward(x)
    sync()
    out["sp"] = {"out": y.cpu() if rank == 0 else None,
                 "ms": (time.perf_counter() - t0) * 1e3,
                 "launches": flash_counts(),
                 "collectives": {k: (pm.COUNTS[k] - before[k]) // 2
                                 for k in before}}
    del tr, x, y
    out["pipe"], pipe_loss, pipe_w = _pipe_rank_part(
        rank, world, dev, program, params,
        *_pipe_corpus(seed, pipe_lm, pipe_batches), pipe_lm, pipe_batches)
    every = [None] * world
    dist.all_gather_object(every, {k: v for k, v in out.items()
                                   if k != "sp"} | {
        "sp": {k: v for k, v in out["sp"].items() if k != "out"}})
    return {"ranks": every, "sp_out": out["sp"]["out"],
            "pipe_loss": pipe_loss, "pipe_weights": pipe_w,
            "start_weights": start_w}


def _pipe_rank_part(rank, world, dev, program, params, data, labels, lm,
                    n_batches):
    """nn.pipe's engine (pipeline.pipe_train, the body of each rank that
    train_pipeline starts) over pp on this group's ranks: the rank's flash
    launches, seconds and hops; rank 0's loss and trained weights too"""
    import torch
    from tensorforth_tpu_torch.parallel import mesh as pm
    from tensorforth_tpu_torch.parallel.pipeline import (make_pp_mesh,
                                                         pipe_train)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    b = lm["batch"]
    x, y = torch.from_numpy(data).to(dev), torch.from_numpy(labels).to(dev)
    mesh = make_pp_mesh(world)
    reset_flash_counts()
    before = dict(pm.COUNTS)
    sync()
    t0 = time.perf_counter()
    loss, full, _l = pipe_train(mesh, program, params, x, y, b, 0.0, 1.0,
                                (b, lm["seq"], lm["dim"], 1), lm["classes"],
                                TRAIN_LR, 1, n_batches)
    sync()
    part = {"launches": flash_counts(), "seconds": time.perf_counter() - t0,
            "comm": {k: pm.COUNTS[k] - before[k] for k in before}}
    return part, loss, ([w.cpu().numpy() for pl_ in full for w in pl_]
                        if rank == 0 else None)


def _dist_worker(out_path: str, device: str):
    """a process of the dist check: T4_COORD/T4_NPROC/T4_RANK form the
    group (parallel/dist.py), then nn.train over tests/dist_worker.py's
    model and corpus on the card, {rank, nproc, loss, weights} to
    out_path"""
    import torch
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn.train import train_epochs
    from tensorforth_tpu_torch.parallel.dist import init_distributed
    rank, nproc = init_distributed()
    model = zoo.tiny_transformer(batch=8, seq=8, dim=16, heads=4, classes=4,
                                 layers=2, device=device)
    rs = np.random.RandomState(7)
    for j in range(model.numel - 1):
        for g in model[j].grad[:2]:
            if g is None:
                break
            g.set_numpy((rs.rand(*g.shape).astype(np.float32) - 0.5) * 0.2)
    rs = np.random.RandomState(3)
    data = rs.rand(16, 8, 16, 1).astype(np.float32)
    labels = rs.randint(0, 4, 16)
    loss = train_epochs(model, _StubDataset(data, labels, 8),
                        lr=PAR_DIST_LR, epochs=2)
    ws = [w.tolist() for w in _weights(model)]
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "nproc": nproc, "loss": float(loss),
                   "weights": ws}, f)


def _sp_input(seed, lm, dev):
    import torch
    return torch.from_numpy(np.random.RandomState(seed).rand(
        lm["batch"], lm["seq"], lm["dim"], 1).astype(np.float32)).to(dev)


def _dist_start(tmp, device):
    """two processes started as a cluster starts them, and one alone:
    (the processes, their result files)"""
    from tensorforth_tpu_torch.parallel.launch import free_port
    port = free_port()
    outs = [os.path.join(tmp, f"r{i}.json") for i in range(3)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("T4_COORD", "T4_NPROC", "T4_RANK", "T4_MESH")}

    def start(i, **extra):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             outs[i], str(device)], env=dict(env, **extra),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    procs = [start(i, T4_COORD=f"localhost:{port}", T4_NPROC="2",
                   T4_RANK=str(i), T4_MESH="dp2") for i in range(2)]
    procs.append(start(2))
    return procs, outs


def _dist_finish(procs, outs):
    """the dist processes' results, once each has ended"""
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"dist process {i} failed:\n"
                               f"{logs[i].decode(errors='replace')[-2500:]}")
    return [json.load(open(o)) for o in outs]


class _routing_margins:
    """inside the block every MoE soft-route forward records the smallest
    gap between a token's top_k-th and next gate (the route's margin: a
    gap within the two runs' rounding lets a token's route flip)"""

    def __init__(self):
        self.margins = []

    def __enter__(self):
        import torch
        from tensorforth_tpu_torch.parallel import moe
        self.saved = orig = moe.moe_fwd

        def recorded(x, wr, w1, w2, top_k=2, mesh=None, axis="ep"):
            with torch.no_grad():
                g = torch.sort(moe._gates(x, wr, mesh, axis), dim=-1).values
                e = g.shape[-1]
                if top_k < e:
                    self.margins.append(float(
                        (g[..., e - top_k] - g[..., e - top_k - 1]).min()))
            return orig(x, wr, w1, w2, top_k, mesh, axis)
        moe.moe_fwd = recorded
        return self

    def __exit__(self, *exc):
        from tensorforth_tpu_torch.parallel import moe
        moe.moe_fwd = self.saved


def _ep_references(seed, dev, moe_m, sync):
    """the ep check's one-rank runs from the seed's weights: nn.train
    unsharded (moe_m), the same with each batch's rows reversed (the same
    sums in another order: the f32 order's own spread), and the word
    path's steps with each step's gradients and its routes' margins"""
    from tensorforth_tpu_torch.nn.train import train_epochs
    data, labels = _moe_corpus(seed)
    loss = train_epochs(moe_m, _StubDataset(data, labels, 8), lr=PAR_EP_LR,
                        epochs=2)
    rev = _reversed_rows(PAR_EP_BATCHES, 8)
    m_rev = _fresh_moe(seed, dev)
    train_epochs(m_rev, _StubDataset(data[rev], labels[rev], 8),
                 lr=PAR_EP_LR, epochs=2)
    m_rep, grads = _fresh_moe(seed, dev), []
    with _routing_margins() as route:
        _word_steps(m_rep, data, labels, 8, PAR_EP_LR, 2, sync, grads)
    return (loss, _weights(moe_m), _weights(m_rev), _weights(m_rep), grads,
            route.margins)


def _pipe_compare(m, seed, lm, n_batches, loss, got, per, sync):
    """the pipeline's trained weights (got, rank 0's) against the word
    path's steps on one rank from the same weights (m), and against the
    same steps with each batch's rows reversed (the f32 order's own
    spread); its launches"""
    from tensorforth_tpu_torch.models import zoo
    b = lm["batch"]
    data, labels = _pipe_corpus(seed, lm, n_batches)
    w0 = _weights(m)
    grads = []
    steps = _word_steps(m, data, labels, b, TRAIN_LR, 1, sync, grads)
    want = _weights(m)
    ctl = zoo.tiny_transformer(device=m.device, **lm)
    _pin(ctl, w0)
    rev = _reversed_rows(n_batches, b)
    _word_steps(ctl, data[rev], labels[rev], b, TRAIN_LR, 1, sync)
    w_rev = _weights(ctl)
    del ctl
    rtol = PAR_PIPE_TOL["rtol"]
    per_param = [float(np.max(np.abs(a - c) - rtol * np.abs(c)))
                 for a, c in zip(got, want)]
    excess = max(per_param)
    worst = _worst_leaf(m, got, want, rtol)
    worst["word_path_grads"] = _at(grads, worst)
    rev_worst = _worst_leaf(m, w_rev, want, rtol)
    rev_worst["word_path_grads"] = _at(grads, rev_worst)
    moved = max(float(np.abs(a - c).max()) for a, c in zip(got, w0))
    counts = [p["launches"] for p in per]
    # a stage a layer: each microbatch's forward launches K1 once and its
    # backward K1 again (the layer's vjp) with K2a and K2b
    n_micro = 2 * PAR_RANKS if b % (2 * PAR_RANKS) == 0 else PAR_RANKS
    want_k = {"flash_fwd": 2 * n_micro * n_batches,
              "flash_bwd_dkv": n_micro * n_batches,
              "flash_bwd_dq": n_micro * n_batches}
    checks = {"pipe_weights_match_word_path": excess <= PAR_PIPE_TOL["atol"],
              "pipe_weights_moved": moved > 0,
              "pipe_loss_finite": math.isfinite(loss)}
    if m.device.type == "cuda":
        checks["pipe_stage_launches"] = all(c == want_k for c in counts)
    return {"lm": lm, "stages": PAR_RANKS, "n_micro": n_micro,
            "batches": n_batches, "loss": loss,
            "worst_weight_excess": excess, "tol": PAR_PIPE_TOL,
            "weight_excess_per_param": per_param, "worst_leaf": worst,
            "reversed_rows_worst_weight_excess": rev_worst["excess"],
            "reversed_rows_worst_leaf": rev_worst,
            "max_abs_step": [float(np.abs(a - c).max())
                             for a, c in zip(want, w0)],
            "launches_per_rank": counts, "launches_rank0": counts[0],
            "rank_seconds": [p["seconds"] for p in per],
            "rank_comm": [p["comm"] for p in per],
            "s_per_step_pipeline": max(p["seconds"] for p in per)
            / n_batches,
            "s_per_step_one_rank_word_path": steps, "checks": checks}


def phase_parallel(seed: int = 0, device=None, ring=PAR_RING,
                   pipe_lm=PAR_PIPE_LM, sp_lm=PAR_SP_LM,
                   pipe_batches=PAR_PIPE_BATCHES):
    """the parallel modules on the one card, every rank a gloo process:
    ring attention over sp4 on [64, 2048, 128] (K1 forward and K2a/K2b
    backward on each rank's [64, 512, 128] chunks, causal and not)
    against single-rank K4 over the whole sequence; nn.train over
    tiny_moe under T4_MESH=ep4 against the unsharded run; the sp forward
    over make_mesh3(dp1, sp2, tp2) at bench_prefill's widths (K1 on each
    attention layer's gathered sequence) against one rank; nn.pipe's
    engine through train_pipeline over pp4 on tiny_transformer at
    bench_prefill's width, 4 layers, a stub corpus of 2 batches, against
    the word path's steps on one rank; two processes started by
    T4_COORD/T4_NPROC/T4_RANK training on dp2 against one (started first,
    they run beside the rest).  Under strict, the class the pipelined
    step is held to the word path's in (PAR_PIPE_TOL).  The ep and
    pipeline checks report their worst element, the one-rank gradients
    there, and the same distance between the one-rank run and itself
    with each batch's rows reversed.  Returns the flash kernels' launches
    of the ring's, the sp forward's and the pipeline's rank 0"""
    import torch
    from tensorforth_tpu_torch.nn.ntypes import Layer
    from tensorforth_tpu_torch.parallel import launch
    from tensorforth_tpu_torch.parallel.trainer import ShardedTrainer
    dev = torch_device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    checks = {}
    seconds = {}
    t_part = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="t4_dist_") as tmp:
        procs, outs = _dist_start(tmp, dev)
        try:
            with env_set(T4_PRECISION="strict"), precision_set("strict"):
                moe_m, sp_m, pipe_m = _par_models(seed, dev, sp_lm, pipe_lm)
                start_w = [float(sum(np.abs(w).sum() for w in _weights(x)))
                           for x in (moe_m, sp_m, pipe_m)]
                r = launch.run(_parallel_rank, PAR_RANKS, str(dev), seed,
                               ring, sp_lm, pipe_lm, pipe_batches)
                seconds["ranks"] = time.perf_counter() - t_part
                checks["ranks_start_from_the_same_weights"] = (
                    r["start_weights"] == start_w)
                t_part = time.perf_counter()
                # the one-rank references
                pipe = _pipe_compare(pipe_m, seed, pipe_lm, pipe_batches,
                                     r["pipe_loss"], r["pipe_weights"],
                                     [rk["pipe"] for rk in r["ranks"]], sync)
                del pipe_m
                lm1, w1, w_rev, w_rep, ep_grads, margins = _ep_references(
                    seed, dev, moe_m, sync)
                x = _sp_input(seed, sp_lm, dev)
                one = ShardedTrainer(sp_m)
                one.forward(x)                  # warm
                sync()
                t0 = time.perf_counter()
                y1 = one.forward(x)
                sync()
                sp1_ms = (time.perf_counter() - t0) * 1e3
                n_attn = sum(spec[0] == Layer.ATTN
                             for spec in sp_m._program())
                del one, x
                seconds["one_rank_references"] = (time.perf_counter()
                                                  - t_part)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        t_part = time.perf_counter()
        dist = _dist_finish(procs, outs)
        seconds["dist_wait"] = time.perf_counter() - t_part
    ranks = r["ranks"]
    # --- the ring
    rings = {}
    nr = PAR_RANKS
    chunk = ring["bh"] * (ring["s"] // nr) * ring["dh"] * 4
    for mode in ("full", "causal"):
        per = [rk["ring"][mode] for rk in ranks]
        rings[mode] = {
            "launches_per_rank": [p["launches"] for p in per],
            "fwd_launches_per_rank": [p["fwd_launches"] for p in per],
            "hops_rank0": per[0]["hops"],
            "fwd_ms_per_rank": [p["fwd_ms"] for p in per],
            "bwd_ms_per_rank": [p["bwd_ms"] for p in per],
            "worst_f64_ratio_o_dq_dk_dv": [max(p["f64_ratio"][i] for p in per)
                                           for i in range(4)]}
        checks[f"ring_{mode}_within_tol_f32_f64"] = all(
            v <= 1.0 for v in rings[mode]["worst_f64_ratio_o_dq_dk_dv"])
        # K/V: n - 1 hops each forward and back, one chunk a hop
        checks[f"ring_{mode}_hops"] = all(
            p["hops"]["hops"] == 4 * (nr - 1)
            and p["hops"]["hop_bytes"] == 4 * (nr - 1) * chunk
            and p["hops"]["all_gather"] == 0 for p in per)
        if on_card:
            checks[f"ring_{mode}_launches"] = all(
                p["fwd_launches"]["flash_fwd"] == nr
                and p["launches"]["flash_bwd_dkv"] == nr
                and p["launches"]["flash_bwd_dq"] == nr for p in per)
    # --- ep
    ep = ranks[0]["ep"]
    rtol = PAR_EP_TOL["rtol"]
    ep_w = max(float(np.max(np.abs(a - c) - rtol * np.abs(c)))
               for a, c in zip(ep["weights"], w1))
    ep_rel = max(float(np.abs(a - c).max()) / max(float(np.abs(c).max()),
                                                  1e-30)
                 for a, c in zip(ep["weights"], w1))
    ep_worst = _worst_leaf(moe_m, ep["weights"], w1, rtol)
    ep_worst["word_path_grads"] = _at(ep_grads, ep_worst)
    rev_worst = _worst_leaf(moe_m, w_rev, w1, rtol)
    rev_worst["word_path_grads"] = _at(ep_grads, rev_worst)
    checks["ep_loss"] = abs(ep["loss"] - lm1) <= PAR_EP_LOSS_RTOL * abs(lm1)
    checks["ep_weights"] = ep_w <= PAR_EP_TOL["atol"]
    checks["ep_all_ranks_equal_loss"] = len({rk["ep"]["loss"]
                                            for rk in ranks}) == 1
    checks["ep_quarter_of_the_experts"] = (
        ep["expert_bytes_rank"] * 4 == ep["expert_bytes_whole"])
    # --- sp
    tol = TOL_NN["strict"]
    sp_err = float((r["sp_out"].to(y1.device) - y1).abs().max()
                   / max(float(y1.abs().max()), 1e-30))
    checks["sp_forward_within_tol_nn"] = sp_err <= tol
    if on_card:                         # K1 once an attention layer
        checks["sp_launches"] = all(
            rk["sp"]["launches"] == {"flash_fwd": n_attn, "flash_bwd_dkv": 0,
                                     "flash_bwd_dq": 0} for rk in ranks)
    # --- dist
    d0, d1, d_one = dist
    dw = max(float(np.max(np.abs(np.asarray(a) - np.asarray(c))))
             for a, c in zip(d0["weights"], d_one["weights"]))
    checks["dist_ranks_agree"] = (d0["loss"] == d1["loss"]
                                  and d0["weights"] == d1["weights"]
                                  and (d0["nproc"], d1["nproc"]) == (2, 2))
    checks["dist_matches_one_process"] = (
        abs(d0["loss"] - d_one["loss"]) <= 1e-5 * abs(d_one["loss"])
        and dw <= MESH_W_ATOL)
    checks.update(pipe.pop("checks"))
    emit({"phase": "parallel", "seed": seed, "ranks": PAR_RANKS,
          "backend": "gloo", "precision": "strict", "seconds": seconds,
          "ring": {"shape": ring, "sp": nr, "chunk_bytes": chunk, **rings},
          "pipe": pipe,
          "ep": {"spec": "ep4", "loss": ep["loss"], "loss_one_rank": lm1,
                 "worst_weight_rel_err": ep_rel,
                 "worst_excess_over_rtol": ep_w, "tol": PAR_EP_TOL,
                 "worst_leaf": ep_worst,
                 "reversed_rows_worst_excess_over_rtol": rev_worst["excess"],
                 "reversed_rows_worst_leaf": rev_worst,
                 "word_path_replica_max_diff": _max_diff(w_rep, w1),
                 "smallest_route_margin_per_forward": margins,
                 "expert_bytes_rank": ep["expert_bytes_rank"],
                 "expert_bytes_whole": ep["expert_bytes_whole"],
                 "seconds_2_epochs": ep["seconds"], "mesh": ep["mesh"]},
          "sp": {"mesh": "dp1,sp2,tp2", "lm": sp_lm, "rel_err": sp_err,
                 "tol_nn": tol, "ms_rank0": ranks[0]["sp"]["ms"],
                 "ms_one_rank": sp1_ms, "attention_layers": n_attn,
                 "launches_per_rank": [rk["sp"]["launches"] for rk in ranks],
                 "collectives_rank0": ranks[0]["sp"]["collectives"]},
          "dist": {"processes": 2, "loss": d0["loss"],
                   "loss_one_process": d_one["loss"],
                   "max_weight_diff": dw, "atol": MESH_W_ATOL},
          "checks": checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise RuntimeError(f"parallel phase failed: {bad}")
    launched = dict(ranks[0]["ring"]["full"]["launches"])
    for part in (ranks[0]["ring"]["causal"]["launches"],
                 ranks[0]["sp"]["launches"], pipe["launches_rank0"]):
        for k, v in part.items():
            launched[k] += v
    return launched


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # the parallel phase's dist check starts this script as its processes
    ap.add_argument("--dist-worker", nargs=2, default=None,
                    metavar=("OUT", "DEVICE"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dist_worker:                 # a process of that check only
        _dist_worker(*args.dist_worker)
        return 0
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
    wide = timed("kernel_wide", phase_kernel_wide, args.seed)
    rec["attn_dots"] = timed("kernel_dots", phase_kernel_dots, args.seed)
    gemm_rec = timed("kernel_gemm", phase_kernel_gemm, args.seed)
    layers = LM["layers"]
    ran = dict(timed("serve", phase_serve, args.seed,
                     expect_launches=layers))
    step_launches = launches_per_step(layers)
    per_step = timed("train", phase_train, args.seed,
                     expect_launches=step_launches)
    for name, n in per_step.items():
        ran[name] = ran.get(name, 0) + n
    # the same model with 4 heads: dh 256, whose f32 backward runs on the
    # cluster kernels
    per_step = timed("train_dh256", phase_train, args.seed,
                     lm=dict(LM, heads=4), expect_launches=step_launches)
    for name, n in per_step.items():
        ran[name] = ran.get(name, 0) + n
    # with 2 heads: dh 512, K1, K2a and K2b on clusters of four CTAs,
    # served and trained; with 1 head: dh 1024, on clusters of eight
    for tag, lm in (("dh512", LM_DH512), ("dh1024", LM_DH1024)):
        for name, n in timed(f"serve_{tag}", phase_serve_wide, args.seed,
                             lm=lm).items():
            ran[name] = ran.get(name, 0) + n
        per_step = timed(f"train_{tag}", phase_train, args.seed, lm=lm,
                         expect_launches=launches_per_step(lm["layers"]),
                         wide=True)
        for name, n in per_step.items():
            ran[name] = ran.get(name, 0) + n
    on_tensor_path = timed("tensor", phase_tensor, args.seed)
    timed("nn", phase_nn, args.seed)
    # the per-word control, cut to its first epochs; then t4_30e whole at
    # the defaults, its first epochs held against the control's lines
    control = timed("net", phase_net, epochs=NET_CONTROL_EPOCHS)
    timed("net_fused", phase_net_fused, control=control)
    timed("net_rollback", phase_net_rollback)
    # nn.train's graph launches the flash kernels; the profiler counts them
    for name, n in timed("net_train", phase_net_train).items():
        ran[name] = ran.get(name, 0) + n
    # nn.gen's prefill launches the forward kernel once per attention
    # layer; its word-path step launches what the train phase's does
    per_word = timed("net_gen", phase_net_gen, args.seed, expect_gen={
        "flash_fwd": layers, "flash_fwd_split": layers,
        "flash_bwd_dkv": 0, "flash_bwd_dq": 0},
        expect_step={"flash_fwd": 2 * layers, "flash_fwd_split": 2 * layers,
                     "flash_bwd_dkv": layers, "flash_bwd_dq": layers,
                     "flash_bwd_split": layers})
    for name, n in per_word.items():
        ran[name] = ran.get(name, 0) + n
    timed("moe", phase_moe, args.seed)
    for name, n in timed("attn_bench", phase_attn_bench, args.seed).items():
        ran[name] = ran.get(name, 0) + n
    # the same entry points at a wide head dim: K3's hybrid class on
    # clusters of four CTAs, K8 on the wide route (depth cut: 4 heads, one
    # sweep shape)
    for name, n in timed("attn_bench_dh512", phase_attn_bench, args.seed,
                         **ATTN_BENCH_WIDE).items():
        ran[name] = ran.get(name, 0) + n
    timed("host", phase_host)
    timed("arena", phase_arena)
    for name, n in timed("mesh", phase_mesh, args.seed).items():
        ran[name] = ran.get(name, 0) + n
    for name, n in timed("parallel", phase_parallel, args.seed).items():
        ran[name] = ran.get(name, 0) + n
    emit({"phase_seconds": seconds})
    # no word of either package reaches K5b or K7: the tensor phase calls
    # their wrappers on the words' operands
    launched_by = {"flash_fwd": "generate (dh 128; dh 512 and 1024 in "
                                "serve_dh512 and serve_dh1024 on clusters "
                                "of four and eight CTAs), the train "
                                "steps (dh 128, 256, 512 and 1024), "
                                "attn_bench, "
                                "net_gen (the REPL's nn.gen prefill "
                                "and its word-path step; in the f32 class "
                                "after its split, split_launches on "
                                "generate, the train step and net_gen), "
                                "net_train (inside nn.train's CUDA "
                                "graph, counted by the profiler) and the "
                                "mesh phase's rank 0 (its dp2 "
                                "ShardedTrainer gradient and its dp2,tp2 "
                                "generate's prefills) and the parallel "
                                "phase's rank 0 (its sp4 ring's steps, "
                                "causal and not, its dp1,sp2,tp2 "
                                "forward's attention layers, and the "
                                "microbatches of the first pp4 stage "
                                "that train_pipeline starts)",
                   "flash_bwd_dkv": "the train steps (dh 128, and dh 256, "
                                    "512 and 1024 on the cluster routes), "
                                    "attn_bench, "
                                    "net_gen's word-path step (in the f32 "
                                    "class after the backward's split, "
                                    "split_launches on the train step and "
                                    "net_gen), net_train's graph, the "
                                    "mesh phase's rank 0 (its dp2 "
                                    "ShardedTrainer gradient) and the "
                                    "parallel phase's rank 0 (the ring's "
                                    "backward, the nn.pipe stage's)",
                   "flash_bwd_dq": "the train steps (dh 128, and dh 256, "
                                   "512 and 1024 on the cluster routes), "
                                   "attn_bench, "
                                   "net_gen's word-path step (after the "
                                   "same split), net_train's graph, the "
                                   "mesh phase's rank 0 (its dp2 "
                                   "ShardedTrainer gradient) and the "
                                   "parallel phase's rank 0 (the ring's "
                                   "backward, the nn.pipe stage's)",
                   "flash_bwd_fused": "attn_bench.sweep_bwd_fused (the "
                                      "hybrid class, at dh 128 and at dh "
                                      "512 on clusters of four CTAs; the "
                                      "f32 class's kernels and its split "
                                      "in the kernel phases, `f32` and "
                                      "`f32_dh*` here)",
                   "attn_dots": "attn_bench.bench_attention_oracle (its "
                                "dots-only probe, at dh 128 and at dh 512 "
                                "on the wide route, one CTA of four "
                                "warpgroups)",
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
    rec["flash_fwd"]["f32_dh256"] = rec.pop("flash_fwd_dh256")
    for name, by_tag in wide.items():
        rec[name].update(by_tag)
    rec["flash_bwd_fused"]["f32"] = rec.pop("flash_bwd_fused_f32")
    rec["flash_bwd_fused"]["f32_dh256"] = rec.pop(
        "flash_bwd_fused_f32_dh256")
    for which in ("dkv", "dq"):
        rec[f"flash_bwd_{which}"]["f32_dh256"] = rec.pop(
            f"flash_bwd_{which}_dh256")
    for which, hy in rec.pop("flash_bwd_hybrid").items():
        rec[f"flash_bwd_{which}"].update(
            hybrid=hy, split_launches=ran["flash_bwd_split"])
    # the wide head dims' routes (phase_kernel_wide), each kernel's entry
    wide_tags = tuple(f"{cls}_dh{dh}" for cls in ("f32", "hybrid")
                      for dh in WIDE_DH)
    extra = {"flash_fwd": ("kernel_ms", "split_ms", "split_bound_ms",
                           "split_launches", "library_ms_4d", "route",
                           "f64_ratio_o", "f64_ratio_lse", "hybrid",
                           "f32_dh256") + wide_tags,
             "flash_bwd_dkv": ("kernel_ms", "split_ms", "split_bound_ms",
                               "split_launches", "kernels_and_split_ms",
                               "ms_whole_backward", "library_ms_4d", "route",
                               "f64_ratio_kernel", "hybrid", "f32_dh256")
             + wide_tags,
             "flash_bwd_dq": ("kernel_ms", "split_ms", "split_bound_ms",
                              "split_launches", "kernels_and_split_ms",
                              "ms_whole_backward", "library_ms_4d", "route",
                              "f64_ratio_kernel", "hybrid", "f32_dh256")
             + wide_tags,
             "flash_bwd_fused": ("kernel_ms", "ms_before_the_sums",
                                 "library_bf16_ms", "library_ms_4d",
                                 "blocks", "grid", "f32", "f32_dh256")
             + tuple(f"{cls}_dh{dh}" for cls in ("f32", "hybrid")
                     for dh in WIDE_PROBE_TIMED),
             "attn_dots": ("route", "flash_fwd_ms_on_the_same_operands",
                           "flash_fwd_over_attn_dots")
             + tuple(f"dh{dh}" for dh in WIDE_PROBE_TIMED),
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
