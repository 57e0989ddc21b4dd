"""f32 dots of CPU tensors in the order XLA's CPU backend sums them.

The JAX package's linear layers take `jnp.dot` under `jax.jit`: x and
w.T forward, dy.T and x, dy and w backward.  After XLA's passes most are a
plain HLO `dot` (no oneDNN or XNNPACK custom call in the dumped HLO), run
as a contraction on XLA's runtime, and the order in which an output
element's products are summed depends on the shape and the operands'
layout, not on the values.  It was read off by probing `jnp.dot` under
`jax.jit` with inputs whose sums reveal their order (+2^40 and -2^40 at
two products, ones elsewhere: the result counts the ones summed outside
the smallest subtree that holds the pair, which gives the whole tree),
then held bit for bit against random inputs (tests/test_torch_xla_dot.py).

The order, for c [m, n] = a [m, k] b [k, n]:

* each element's products are exact fused multiply-adds into `nch`
  interleaved chains from +0 (chain t takes k = t, t + nch, ...) over the
  whole multiples of nch, folded in adjacent pairs, ((c0 + c1) + (c2 +
  c3)) + ((c4 + c5) + (c6 + c7)); the last k % nch products are rounded
  and summed one after another from +0, and that sum is added to the fold;
* a long reduction is cut into blocks of `kc`: each block is such a sum
  from +0, the first the running sum, each later one added to it;
* `nch` and `kc` follow from (m, k, n) and the layout (`order`).  With a
  row-major and either m > 50 or b stored transposed (the forward x @
  w.T) at any m > 1: by n (4 chains for n <= 24, else by r = n mod 64, 64
  for 0: 4 for r in 1..16 and 33..48, 2 for 17..32, 1 for 49..64; n 2 or
  3 at m 2 or 3: 1), kc = 512 nch.  With a and b row-major and m <= 50: 4
  chains for n <= 16 (n 2 or 3 at m 2 or 3: 1), 1 for n >= 17.  With a
  stored transposed ([k, m]: the backward dy.T @ x): 1 chain.  n = 1 (a
  matrix times a vector): 8 chains, the gemv's lanes.

What it depends on, and how it is read here: the shape and the layout (the
operands' strides: a transposed view is the layout XLA sees when it folds
a transpose into the dot); the ISA (the AVX-512 path, `avx512f` in the
CPU's flags) and the caches (L1d, L2, L3 from
/sys/devices/system/cpu/cpu0/cache), which fix the kernels and the
blocks.  It was probed on one such host (`PROBED_HOST`: AVX-512, L1d 48
KiB, L2 1 MiB, L3 32 MiB); on another the replay stands down.  The
process's CPU affinity (1, 4 or 8 cores) moved no bit.

Small dots read one by one (`READ`), each held bit for bit against a
jitted `jnp.dot` of its shape and layout on random inputs: t4_32a's (64,
5, 3) with b transposed and (64, 5, 2), which XLA runs on its runtime's
dot, read with the pair probe (((p0 + p1) + (p2 + p3)) + p4: the four
chains of the rule above with the fifth product apart, though k is no
multiple of four), and (64, 3, 5), which XLA emits as an elemental loop
(its LLVM IR in the dump): columns 0 to 3 as rounded products summed
from +0 (a vector multiply, then adds), column 4 as a fused multiply-add
chain from +0 (the scalar remainder), so each column group is a plan of
its own (`READ`).  Other shapes with k off the chains' multiples
are no such rule: probed at m 51 to 256 they give other trees.

Where no class was probed bit for bit, `order` gives None and the dot is
torch's: k not a multiple of the chains in the first rule, four chains
past k 2048, two past 1024, one past 4096; one chain past k 64 or n 512
in the second; a transposed a past k 128 (past 256, or at m or n below
128: blocks of about k / 2, not read), or at n % 48 == 1; n = 1 at m or k
not a multiple of 8; both operands transposed.

A row times a matrix inside a program (`fused_order`, read from XLA's
dump, not probed).  What decides it: XLA CPU fuses a dot whose output is
a vector (a row times a matrix, m = 1, or a matrix times a vector, n =
1) with the bitcasts that feed it into a loop fusion
(`bitcast_dot_fusion`, kind kLoop), and every operand of the JAX
package's linear layers is such a bitcast (a reshape of a 4-d activation
or cotangent, or the transpose of an [N, 1] one); a standalone `jnp.dot`
of two parameters is not fused.  The fusion's loop computes an output
element as a reduction over k, which LLVM vectorises.  Read
(`XLA_FLAGS=--xla_dump_to`: the fusion's `*.ir-with-opt.ll`, its order
of adds in `objdump -d` of the `*.obj-file.*.o`) from t4_40b's own
program, for (1, 256, 256), the dW of D's 256 -> 1 layer: a loop of four
interleaved 8-lane accumulators of exact fused multiply-adds
(vfmadd231ps), 32 products a step, folded ((r1 + r0) + r2) + r3, the
lanes reduced as ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7)); the
same loop as in the probed host's dump of a jitted `jnp.dot(x.T,
dy).T`.  Not replayed: t4_32a's row (1, 64, 3) and D's forward (256,
256, 1), whose loops the code generator unrolled and reassociated into
one chain in an order of its own (ROADMAP C11 lists it), read on one
host only; other shapes of the class.  The loop's order is the ISA's,
not the caches'; it is replayed only where `host_matches()` holds, as
the rest.

Where it is used: the linear layer's products on CPU tensors off the
word mesh (nn/funcs.py: `_linear_mm`; the JAX package's mesh runs are
partitioned programs).  Not the conv's (XLA runs a convolution,
not a dot), not the LM tier's (its einsums and projections sit in other
fusions of the JAX program; a tiny_lm step moved away from the JAX
package's values with them replayed), and not on the card, whose numbers
are its class's own.  The replay is C++ (csrc/xla_dot.cpp, built with g++
at first use into build/xla_dot/).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "xla_dot.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "xla_dot"
# the host the order was probed on: ISA and (L1d, L2, L3) bytes
PROBED_HOST = ("avx512f", (48 << 10, 1 << 20, 32 << 20))
# the small dots read one by one: (m, k, n, a_t, b_t) -> the plans of its
# column groups, (first column, end, kc, nch) each (the module docstring);
# nch 4 at k 3 is no whole chain: the three products rounded and summed
# from +0
READ = {(64, 5, 3, False, True): ((0, 3, 5, 4),),
        (64, 5, 2, False, False): ((0, 2, 5, 4),),
        (64, 3, 5, False, False): ((0, 4, 3, 4), (4, 5, 3, 1))}


def order(m: int, k: int, n: int, a_t: bool = False,
          b_t: bool = False):
    """(kc, nch) of the dot [m, k] x [k, n] with a stored transposed
    (a_t: [k, m] in memory) or b stored transposed (b_t: [n, k]), or None
    where no class was probed bit for bit (the module docstring)"""
    if min(m, k, n) < 1 or (a_t and b_t):
        return None
    if n == 1:                             # a matrix times a vector
        ok = not (a_t or b_t) and m % 8 == 0 and k % 8 == 0
        return (k, 8) if ok else None
    if m == 1:       # a row: inside a program XLA fuses such a dot into a
        return None  # loop (fused_order), not this rule
    if a_t:                                # one chain, blocks unprobed
        wide = k <= 128 or (k <= 256 and m >= 128 and n >= 128)
        return (k, 1) if wide and n % 48 != 1 else None
    small = (2, 3)
    if b_t or m > 50:
        r = n % 64 or 64
        nch = (1 if m in small and n in small else
               4 if n <= 24 or r <= 16 or 33 <= r <= 48 else
               2 if r <= 32 else 1)
        if k % nch or k > {1: 4096, 2: 1024, 4: 2048}[nch]:
            return None
        return min(k, 512 * nch), nch
    nch = 1 if n >= 17 or (m in small and n in small) else 4
    if k > (64 if nch == 1 else 2048) or (nch == 1 and n > 512):
        return None
    return k, nch


def fused_order(m: int, k: int, n: int):
    """the interleaved accumulators of a row times a matrix, [1, k] x [k,
    n] with b row-major, as XLA CPU runs it inside a program
    (csrc/xla_dot.cpp: t4_xla_row), or None where that loop was not read
    (the module docstring)"""
    return 4 if (m, k, n) == (1, 256, 256) else None


def _cache_bytes():
    """(L1d, L2, L3) bytes as the kernel lists them for cpu0"""
    base = Path("/sys/devices/system/cpu/cpu0/cache")
    sizes = {}
    for idx in sorted(base.glob("index*")):
        try:
            level = int((idx / "level").read_text())
            kind = (idx / "type").read_text().strip()
            text = (idx / "size").read_text().strip()
        except (OSError, ValueError):
            continue
        if kind == "Instruction":
            continue
        mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(text[-1], 1)
        sizes[level] = int(text.rstrip("KMG")) * mult
    return tuple(sizes.get(lv, 0) for lv in (1, 2, 3))


def _isa() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return ("avx512f" if " avx512f" in line
                            else "avx2" if " avx2" in line else "other")
    except OSError:
        pass
    return "other"


@functools.lru_cache(maxsize=1)
def host_matches() -> bool:
    """the order holds on this host: x86-64 with the probed ISA and
    caches"""
    return (platform.machine() in ("x86_64", "AMD64")
            and (_isa(), _cache_bytes()) == PROBED_HOST)


@functools.lru_cache(maxsize=1)
def _lib():
    """the replay's library, built at first use (None if it cannot be)"""
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD / f"libxla_dot-{digest}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".xla_dot-", dir=_BUILD)
        try:
            out = os.path.join(tmp, so.name)
            r = subprocess.run([gxx, "-O2", "-mfma", "-ffp-contract=off",
                                "-shared", "-fPIC", "-o", out, str(_SRC)],
                               capture_output=True)
            if r.returncode != 0:
                return None
            os.replace(out, so)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    lib.t4_xla_dot.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.t4_xla_row.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.t4_xla_dot.restype = lib.t4_xla_row.restype = ctypes.c_int
    return lib


def fused_mm(a, b):
    """a [1, k] @ b [k, n] (b row-major) of f32 CPU tensors in the order of
    XLA CPU's fused loop, or None where that was not read"""
    (m, k), n = a.shape, b.shape[1]
    nacc = fused_order(m, k, n)
    lib = _lib() if nacc is not None else None
    if lib is None:
        return None
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((1, n), dtype=torch.float32)
    if lib.t4_xla_row(a.data_ptr(), b.data_ptr(), c.data_ptr(), k, n,
                      nacc) != 0:
        return None
    return c


def _transposed(x) -> bool:
    """a 2-D tensor stored column-major (a transposed view of a
    contiguous one), as XLA sees an operand whose transpose it folded
    into the dot"""
    return (x.dim() == 2 and x.shape[0] > 1 and x.shape[1] > 1
            and x.stride() == (1, x.shape[0]))


def mm(a, b):
    """a [m, k] @ b [k, n] of f32 CPU tensors in XLA CPU's order, or None
    where this host or this class has no replay: the caller takes its
    own product"""
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.dtype != torch.float32 or b.dtype != torch.float32
            or a.device.type != "cpu" or b.device.type != "cpu"
            or a.requires_grad or b.requires_grad or not host_matches()):
        return None
    (m, k), n = a.shape, b.shape[1]
    if fused_order(m, k, n) is not None and not _transposed(b):
        return fused_mm(a, b)
    a_t, b_t = _transposed(a), _transposed(b)
    plan = order(m, k, n, a_t, b_t)
    groups = ((0, n, *plan),) if plan is not None else READ.get(
        (m, k, n, a_t, b_t))
    lib = _lib() if groups is not None else None
    if lib is None:
        return None
    a = a.contiguous()
    c = torch.empty((m, n), dtype=torch.float32)
    for j0, j1, kc, nch in groups:
        bj = b[:, j0:j1].contiguous()
        cj = c if j1 - j0 == n else torch.empty((m, j1 - j0))
        if lib.t4_xla_dot(a.data_ptr(), bj.data_ptr(), cj.data_ptr(), m, k,
                          j1 - j0, kc, nch) != 0:
            return None
        if cj is not c:
            c[:, j0:j1] = cj
    return c
