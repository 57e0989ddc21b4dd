"""Time the flash kernels K1, K2a and K2b in the f32 class over head dims
128 to 512 at the same work, on the card, in the tree it is run from.

Run from the root of a checkout:

    python3 scripts/torch_flash_wide.py --tag NAME

At [64, 2048, 128], [32, 2048, 256], [16, 2048, 384] and [16, 2048, 512]
causal (the first, second and last do the same operations) it times each
kernel alone on its prepared operands (K1 on its split's parts, K2a and
K2b after the backward's split and delta), and prints the SHA-1 of each
kernel's output bits.  A head dim the tree's kernels do not take
(ops.attn.KERNEL_DH) is skipped, so one call to the card can hold two
trees against each other in turns (parent, change, change, parent).
Prints one JSON line; exits 2 without a card.
"""
import argparse
import hashlib
import json
import math
import os
import sys

SHAPES = ((64, 2048, 128), (32, 2048, 256), (16, 2048, 384),
          (16, 2048, 512))


def _sha1(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:12]


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
        rs = np.random.RandomState(b + s + dh)
        q, k, v, do = (torch.from_numpy(rs.randn(b, s, dh).astype(
            np.float32)).cuda() for _ in range(4))
        row = {"shape": [b, s, dh]}
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
        out["cases"].append(row)
        del prep, q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
