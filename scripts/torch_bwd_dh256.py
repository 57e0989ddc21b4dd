"""Time the port's flash backward in the f32 class at dh 256 (K2a, K2b and
the fused K3) and a tiny_lm train step at dh 256, on the card, in the
tree it is run from.

Run from the root of a checkout:

    python3 scripts/torch_bwd_dh256.py --tag NAME [--skip-train]

At [8, 1024, 256] and [32, 2048, 256] causal, and on the dh-128 route at
[64, 2048, 128] causal, which does the operations of [32, 2048, 256], it
times K2a and K2b alone on prepared operands and the whole two-kernel
backward (delta, the split, both kernels), then K3's f32 class alone on
prepared operands and with its split, delta and sums
(flash_attention_bwd_fused, bq 512 at S 1024 and 1024 at S 2048) and
the SHA-1 of its dq, dk and dv bits (in both classes at dh 128, whose
kernels two trees can share bit for bit); then,
unless --skip-train, chip_smoke.py's train phase on tiny_lm at
bench_prefill's widths with 4 heads (dh 256).  It calls only entry
points that the FMA routes (before the cluster routes) have too, so one
call to the card can hold two trees against each other in turns (parent,
change, change, parent).  Prints one JSON line; exits 2 without a card.
"""
import argparse
import hashlib
import json
import os
import sys

SHAPES = ((8, 1024, 256), (32, 2048, 256), (64, 2048, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--skip-train", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_bwd_dh256: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import tensorforth_tpu_torch  # noqa: F401  (TF32 off)
    from tensorforth_tpu_torch.ops import attn
    out = {"tag": args.tag, "card": cs.card_line(), "cases": []}
    for b, s, dh in SHAPES:
        rs = np.random.RandomState(b + s)
        q, k, v, do = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda() for _ in range(4))
        o, lse = attn.flash_attention(q, k, v, causal=True)
        prep = attn._prepare_bwd(q, k, v, o, lse, do, True, False, None)
        row = {"shape": [b, s, dh],
               "plan": repr(attn.bwd_plan(b, s, dh, False))}
        for which in ("dkv", "dq"):
            row[which + "_kernel_ms"] = cs.time_ms(
                lambda: attn._launch_bwd(which, *prep), reps=args.reps)
        row["ms_whole_backward"] = cs.time_ms(
            lambda: attn.flash_attention_bwd(q, k, v, o, lse, do, True),
            reps=args.reps)
        del prep
        # K3's f32 class: the kernel alone on its prepared operands, then
        # the whole call with its split, delta and sums
        bq = min(1024, s // 2)
        prep = attn._prepare_fused(q, k, v, o, lse, do, False, None)
        row["fused_bq"] = bq
        row["fused_kernel_ms"] = cs.time_ms(
            lambda: attn._launch_fused(*prep, bq, True, False),
            reps=args.reps)
        row["fused_ms"] = cs.time_ms(
            lambda: attn.flash_attention_bwd_fused(q, k, v, o, lse, do, bq,
                                                   True),
            reps=args.reps)
        for hybrid in (False, True) if dh == 128 else (False,):
            h = hashlib.sha1()
            for g in attn.flash_attention_bwd_fused(q, k, v, o, lse, do, bq,
                                                    True, hybrid):
                h.update(g.cpu().numpy().tobytes())
            row["fused_sha1_hybrid" if hybrid else "fused_sha1"] = \
                h.hexdigest()
        out["cases"].append(row)
        del q, k, v, do, o, lse, prep
        torch.cuda.empty_cache()
    if args.skip_train:
        print(json.dumps(out), flush=True)
        return 0
    # the train phase's own record, taken from its emitted line
    lines, emit = [], cs.emit
    cs.emit = lines.append
    try:
        cs.phase_train(0, lm=dict(cs.LM, heads=4))
    finally:
        cs.emit = emit
    train = lines[-1]
    prof = train["profile"]
    out["train"] = dict(
        {key: train[key] for key in (
            "model", "ms_per_step", "split_ms", "first_step_ms",
            "launches_per_step", "max_rel_grad_err_vs_plain_attention",
            "losses", "checks", "peak_mem_gb")},
        profile={key: prof[key] for key in prof if key.startswith(
            ("flash_", "device_"))})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
