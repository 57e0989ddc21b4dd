"""Print the SHA-1s of K3's (the fused backward) and K1's outputs on
chip_smoke.py's timed wide-probe inputs, in the tree it is run from.

Run from the root of a checkout, on the card:

    python3 scripts/torch_route_bits.py

The inputs are those of chip_smoke.py's `wide_probes` at seed 0
(numpy's default_rng(400 + i) for the i-th head dim, [16, 2048, dh] with
dh 512 and 1024, causal), through `flash_attention` (K1) and
`flash_attention_bwd_fused` (K3) in both classes.  Run it from the roots
of two trees in one call to the card (copy it into the other tree first):
equal lines but for "tree" mean the two trees' K1 and K3 kept their
bits.  Prints one JSON line; exits 2 without a card.
"""
import hashlib
import json
import os
import sys

SEED, BH, S, DHS = 0, 16, 2048, (512, 1024)


def sha1_of(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_route_bits: no CUDA device", file=sys.stderr)
        return 2
    from tensorforth_tpu_torch.ops import attn
    out = {"tree": os.getcwd()}
    for i, dh in enumerate(DHS):
        rs = np.random.default_rng(SEED + 400 + i)
        q, k, v, do = (torch.from_numpy(rs.standard_normal(
            (BH, S, dh), dtype=np.float32)).cuda() for _ in range(4))
        for hybrid in (False, True):
            o, lse = attn.flash_attention(q, k, v, causal=True,
                                          hybrid=hybrid)
            bq = attn._fused_bq("chip_smoke", S, None)
            got = attn.flash_attention_bwd_fused(q, k, v, o, lse, do, bq,
                                                 True, hybrid, None)
            tag = f"{'hybrid' if hybrid else 'f32'}_dh{dh}"
            out["k3_" + tag] = sha1_of(*got)
            out["k1_" + tag] = sha1_of(o, lse)
        del q, k, v, do
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
