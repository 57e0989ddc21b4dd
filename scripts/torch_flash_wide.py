"""Time the flash kernels K1, K2a and K2b in the f32 class, and K1 and K8
in the bf16 class, over head dims 128 to 1024, and K3 over 384 to 1024 in
both classes, on the card, in the tree it is run from.

Run from the root of a checkout:

    python3 scripts/torch_flash_wide.py --tag NAME

At [64, 2048, 128], [32, 2048, 256], [16, 2048, 384], [16, 2048, 512],
[8, 2048, 1024] (these five do the same operations but dh 384's) and
[16, 2048, dh] for dh 640 to 1024, causal, it times each kernel alone on
its prepared operands (K1 on its split's parts, K2a and K2b after the
backward's split and delta), and prints the SHA-1 of each kernel's output
bits and the clusters the card runs at once; and, on the same inputs
cast to bf16, K1's hybrid class alone (causal, q scaled as its wrapper
scales it) and the dots-only probe K8 alone (not causal, as bench.py's
probe), each with its SHA-1 and clusters; K2a and K2b of the hybrid
class alone on the same casts (causal), with their SHA-1s; and K2a + K2b
of the f32 class with delta and their split (the wrapper's whole
backward) beside PyTorch's scaled_dot_product_attention f32 backward
through a 4-d call on the same inputs; K1 f32 with its split (the
wrapper's whole forward) beside SDPA's f32 forward through a 4-d call;
and at dh 384 to 1024 the fused backward K3 in both classes with its
split, delta and sums (the wrapper's whole call, causal, on the class's
own forward's o and lse), with its SHA-1, beside K2a + K2b's whole
backward in the same class.  A head dim the tree's
kernels do not take (ops.attn.KERNEL_DH) is skipped, so one call to the
card can hold two trees against each other in turns (parent, change,
change, parent): copy this script into the parent's tree, so both draw
the same inputs.  Prints one JSON line; exits 2 without a card.
"""
import argparse
import hashlib
import json
import math
import os
import sys

SHAPES = ((64, 2048, 128), (32, 2048, 256), (16, 2048, 384),
          (16, 2048, 512), (8, 2048, 1024), (16, 2048, 640),
          (16, 2048, 768), (16, 2048, 896), (16, 2048, 1024))


def _sha1(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _bf16_cases(row, q, k, v, reps):
    """K1 hybrid (causal) and K8 alone on the bf16 casts of q, k, v, with
    their output bits and clusters, into row"""
    import chip_smoke as cs
    import torch
    from tensorforth_tpu_torch.ops import attn
    dh = q.shape[-1]
    bf = torch.bfloat16
    qs = (q * (attn.LOG2E / math.sqrt(dh))).to(bf)
    kb, vb, qb = k.to(bf), v.to(bf), q.to(bf)
    row["hybrid_fwd_kernel_ms"] = cs.time_ms(
        lambda: attn._launch_fwd(qs, kb, vb, True, True), reps=reps)
    row["hybrid_fwd_sha1"] = _sha1(attn._launch_fwd(qs, kb, vb, True, True))
    row["dots_kernel_ms"] = cs.time_ms(
        lambda: attn._launch_dots(qb, kb, vb), reps=reps)
    row["dots_sha1"] = _sha1((attn._launch_dots(qb, kb, vb),))
    row["hybrid_clusters_at_once"] = {
        kern: attn.flash_clusters(kern, dh, True, 0)
        for kern in ("fwd", "dots")}
    plan = attn.fwd_plan(*q.shape, True)
    row["hybrid_fwd_plan"] = {key: getattr(plan, key) for key in (
        "cluster", "bq", "bkv", "smem", "ctas") if hasattr(plan, key)}


def _fused_case(row, tag, q, k, v, o, lse, do, hybrid, reps):
    """K3 with its split, delta and sums (causal, chip_smoke's Q block)
    and K2a + K2b's whole backward in the class, on the class's o and
    lse, with K3's output bits, into row"""
    import chip_smoke as cs
    from tensorforth_tpu_torch.ops import attn
    bq = attn._fused_bq("chip_smoke", q.shape[1], None)
    call = (q, k, v, o, lse, do, bq, True, hybrid, None)
    row[tag + "k3_ms"] = cs.time_ms(
        lambda: attn.flash_attention_bwd_fused(*call), reps=reps)
    row[tag + "k3_sha1"] = _sha1(attn.flash_attention_bwd_fused(*call))
    row[tag + "k2_whole_ms"] = cs.time_ms(lambda: attn.flash_attention_bwd(
        q, k, v, o, lse, do, True, hybrid), reps=reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_wide: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import tensorforth_tpu_torch  # noqa: F401  (TF32 off)
    from tensorforth_tpu_torch.ops import attn
    out = {"tag": args.tag, "card": cs.card_line(), "cases": []}
    for b, s, dh in SHAPES:
        if dh not in attn.KERNEL_DH:
            continue
        rs = np.random.default_rng(b + s + dh)
        q, k, v, do = (torch.from_numpy(rs.standard_normal(
            (b, s, dh), dtype=np.float32)).cuda() for _ in range(4))
        row = {"shape": [b, s, dh]}
        _bf16_cases(row, q, k, v, args.reps)
        if hasattr(attn, "flash_clusters"):
            row["clusters_at_once"] = {
                kern: attn.flash_clusters(kern, dh, False, 0)
                for kern in ("fwd", "dkv", "dq")}
        parts = attn._split_qkv(q, k, v, attn.LOG2E / math.sqrt(dh))
        row["fwd_kernel_ms"] = cs.time_ms(
            lambda: attn._launch_fwd(*parts, True, False), reps=args.reps)
        o, lse = attn._launch_fwd(*parts, True, False)
        row["fwd_sha1"] = _sha1((o, lse))
        del parts
        prep = attn._prepare_bwd(q, k, v, o, lse, do, True, False, None)
        for which in ("dkv", "dq"):
            row[which + "_kernel_ms"] = cs.time_ms(
                lambda: attn._launch_bwd(which, *prep), reps=args.reps)
            row[which + "_sha1"] = _sha1(attn._launch_bwd(which, *prep))
        del prep
        row["bwd_f32_ms"] = cs.time_ms(lambda: attn.flash_attention_bwd(
            q, k, v, o, lse, do, True, False), reps=args.reps)
        row["sdpa_bwd_f32_4d_ms"] = cs.time_ms(cs.sdpa_grads(
            q[None], k[None], v[None], do[None], True), reps=args.reps)
        row["fwd_f32_ms"] = cs.time_ms(lambda: attn.flash_attention(
            q, k, v, causal=True), reps=args.reps)
        row["sdpa_fwd_f32_4d_ms"] = cs.time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), reps=args.reps)
        if dh > 256:
            _fused_case(row, "", q, k, v, o, lse, do, False, args.reps)
        # the hybrid class's K2a and K2b alone, on its forward's o and lse
        oh, lh = attn.flash_attention(q, k, v, causal=True, hybrid=True)
        prep = attn._prepare_bwd(q, k, v, oh, lh, do, True, True, None)
        for which in ("dkv", "dq"):
            row["hybrid_" + which + "_kernel_ms"] = cs.time_ms(
                lambda: attn._launch_bwd(which, *prep), reps=args.reps)
            row["hybrid_" + which + "_sha1"] = _sha1(
                attn._launch_bwd(which, *prep))
        if dh > 256:
            _fused_case(row, "hybrid_", q, k, v, oh, lh, do, True, args.reps)
        out["cases"].append(row)
        del prep, q, k, v, do, o, lse, oh, lh
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
