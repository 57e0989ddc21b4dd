"""Time the builds of the port's kernel sources with and without nvcc's
--split-compile=0, and compare what ptxas reports for each kernel.

Run from the root of a checkout, on a machine with nvcc:

    python3 scripts/torch_build_time.py

Builds the six sources of tensorforth_tpu_torch/ops/csrc/ with the flags
of ops/_build.py less --split-compile (twice) and with it (once), each
time all six started together as chip_smoke.py's build phase starts them,
into a temporary directory.  Prints the wall time of each round and of
each source, then, per source, the kernels whose registers or spill bytes
differ between the first round without the flag and the round with it.
"""
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tensorforth_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("flash_fwd", "flash_bwd", "flash_bwd_fused", "attn_dots",
           "gemm_sm90", "gemm_sm90_f32")
BASE = [f for f in _build.NVCC_FLAGS if not f.startswith("--split-compile")]


def ptxas(log: str) -> dict:
    """{entry function: (registers, spill store bytes)}"""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            out[cur] = [None, 0]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and cur:
            out[cur][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def build(src: str, flags: list, out: Path):
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *flags, "-o", str(out),
                        str(_build.CSRC / f"{src}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{src}: {r.stderr[-2000:]}")
    return time.perf_counter() - t0, ptxas(r.stdout + r.stderr)


def main() -> None:
    rounds = (("without", BASE), ("with", BASE + ["--split-compile=0"]),
              ("without again", BASE))
    seen = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in rounds:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(SOURCES)) as ex:
                got = list(ex.map(lambda s: build(
                    s, flags, Path(tmp) / f"{name[:4]}-{s}.so"), SOURCES))
            print(f"{name}: {time.perf_counter() - t0:.1f} s;",
                  ", ".join(f"{s} {dt:.1f}" for s, (dt, _) in
                            zip(SOURCES, got)), flush=True)
            seen.setdefault(name, {s: k for s, (_, k) in zip(SOURCES, got)})
    for s in SOURCES:
        a, b = seen["without"][s], seen["with"][s]
        diff = {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
                if a.get(k) != b.get(k)}
        print(f"{s}: {len(a)} kernels, {len(diff)} differ "
              "(registers, spill bytes) without -> with:")
        for k, (x, y) in diff.items():
            print(f"  {k}: {x} -> {y}")


if __name__ == "__main__":
    main()
