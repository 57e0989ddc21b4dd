"""Device op engine: elementwise maps, broadcast binary ops, matmul,
reductions (the port of tensorforth_tpu/ops/engine.py).  Every function
takes and returns torch tensors on the caller's device and runs eagerly.

Reference behaviour: src/t4math.cu (k_math/k_ts_op/k_tt_op/k_gemm*/k_sum/
k_nvar/k_max), src/mu/tensor.cu host wrappers.

The deferred-scalar ops of the JAX module (sc_op1/sc_op2) wait for the
port of mu/future.py.
"""
from __future__ import annotations

import math

import torch

from ..config import resolve_device

# ---------------------------------------------------------------------------
# elementwise self-ops (reference k_math, t4math.cu:168-199)
# ---------------------------------------------------------------------------
_DU_LNX = 1.0e-12     # log clamp

_MAP = {
    "abs":   lambda x, v: torch.abs(x),
    "neg":   lambda x, v: -x,
    "exp":   lambda x, v: torch.exp(x),
    "ln":    lambda x, v: torch.log(torch.clamp_min(x, _DU_LNX)),
    "log":   lambda x, v: torch.log10(torch.clamp_min(x, _DU_LNX)),
    "tanh":  lambda x, v: torch.tanh(x),
    "relu":  lambda x, v: torch.clamp_min(x, 0.0),
    "sigm":  lambda x, v: torch.sigmoid(x),
    "sqrt":  lambda x, v: torch.sqrt(torch.clamp_min(x, 0.0)),
    "rcp":   lambda x, v: 1.0 / x,
    "sat":   lambda x, v: torch.clamp(x, 0.0, 1.0),
    "fill":  lambda x, v: torch.full_like(x, v),
    "gfill": lambda x, v: v * torch.arange(
        x.numel(), dtype=torch.float32, device=x.device).reshape(x.shape)
        / x.numel(),
    "scale": lambda x, v: x * v,
    "pow":   lambda x, v: torch.pow(x, v),
    "sin":   lambda x, v: torch.sin(x),
    "cos":   lambda x, v: torch.cos(x),
    "add":   lambda x, v: x + v,
    "sub":   lambda x, v: x - v,
    "mul":   lambda x, v: x * v,
    "div":   lambda x, v: x / v,
}


def _f32(v) -> float:
    """a host scalar rounded to f32, as the reference's jnp.float32(v)"""
    return torch.tensor(float(v), dtype=torch.float32).item()


def map_op(op: str, x, v=0.0):
    fn = _MAP.get(op)
    if fn is None:
        raise ValueError(f"map op {op}?")
    return fn(x, _f32(v))


def identity(x):
    """eye over the (H, W) plane: rank-2 direct, rank-4 per (N, C) slice"""
    if x.dim() == 4:
        h, w = x.shape[1], x.shape[2]
        eye = torch.eye(h, w, dtype=torch.float32, device=x.device)
        return eye[None, :, :, None].expand(x.shape).contiguous()
    h, w = x.shape[-2], x.shape[-1]
    return torch.eye(h, w, dtype=torch.float32,
                     device=x.device).expand(x.shape).contiguous()


# ---------------------------------------------------------------------------
# broadcast binary ops (reference k_ts_op / k_tt_op, Tensor::ten_op)
# ---------------------------------------------------------------------------
_BIN = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "max": torch.maximum, "min": torch.minimum,
}


def _bin_op(op: str, a, b):
    fn = _BIN.get(op)
    if fn is None:
        raise ValueError(f"bin op {op}?")
    return fn(a, b)


def ten_op_ts(op: str, a, v):
    """tensor (+) scalar broadcast"""
    return _bin_op(op, a, torch.full_like(a, _f32(v)))


def ten_op_st(op: str, v, a):
    """scalar (+) tensor broadcast (for SUB/DIV ordering)"""
    return _bin_op(op, torch.full_like(a, _f32(v)), a)


def ten_op_tt(op: str, a, b, out_shape):
    """Hadamard with N-broadcast (reference tensor.cu ten_op w/ N bcast)"""
    if a.numel() == b.numel():
        r = _bin_op(op, a.reshape(-1), b.reshape(-1))
    else:
        # one side has N==1: broadcast over leading batch
        big, small, flip = ((a, b, False) if a.numel() > b.numel()
                            else (b, a, True))
        n = big.numel() // small.numel()
        bb = big.reshape(n, small.numel())
        ss = small.reshape(1, small.numel()).expand_as(bb)
        r = _bin_op(op, ss, bb) if flip else _bin_op(op, bb, ss)
    return r.reshape(tuple(out_shape))


# ---------------------------------------------------------------------------
# matmul (reference Tensor::mm)
# ---------------------------------------------------------------------------
# Word-tier matmuls are ALWAYS f32-strict: the interactive `@` tier's
# contract is the reference's 1e-5 verify-lines.  The package keeps TF32
# off (__init__.py), so torch.matmul is a true f32 product on the card.
# They are plain dots outside any hand-written kernel in the JAX package
# too; the gemm2..4 words are the ones that go through ops/gemm.py.
def matmul(a_arr, a_shape, b_arr, b_shape):
    """dispatch rank combinations like TensorVM::_tdot"""
    if len(a_shape) == 2 and len(b_shape) in (1, 2):
        return torch.matmul(a_arr, b_arr)
    # rank-4 N-broadcast: a:[N,H,W,C] @ b:[N,W,K,C] -> [N,H,K,C]
    na = a_shape[0] if len(a_shape) == 4 else 1
    nb = b_shape[0] if len(b_shape) == 4 else 1
    n = max(na, nb)
    a4 = a_arr.reshape((na,) + (tuple(a_shape[1:]) if len(a_shape) == 4
                                else (a_shape[0], a_shape[1], 1)))
    b4 = b_arr.reshape((nb,) + (tuple(b_shape[1:]) if len(b_shape) == 4
                                else (b_shape[0], b_shape[1], 1)))
    a4 = a4.expand((n,) + a4.shape[1:])
    b4 = b4.expand((n,) + b4.shape[1:])
    return torch.einsum("nhwc,nwkc->nhkc", a4, b4)


def _gemm_plain(a, b, c, alpha, beta, ta, tb):
    """gemm and gemm1: the reference-parity A/B baseline, f32-strict"""
    aa = a.T if ta else a
    bb = b.T if tb else b
    return _f32(alpha) * torch.matmul(aa, bb) + _f32(beta) * c


def gemm(a, b, c, alpha=1.0, beta=0.0, ta=False, tb=False, variant=0):
    """alpha*A@B + beta*C; variants 0 and 1 are the library's f32
    product, 2..4 go through the hand-written kernels of ops/gemm.py
    (reference gemm..gemm4 A/B-comparison words, tenvm.cpp:585-589).
    A kernel that cannot build or launch raises: the A/B words must
    benchmark what they claim, so nothing here computes a kernel
    variant another way."""
    if variant >= 2:
        from .gemm import gemm as gemm_kernels
        return gemm_kernels(a, b, c, alpha, beta, ta, tb, variant)
    return _gemm_plain(a, b, c, alpha, beta, ta, tb)


def transpose(a):
    return a.T.contiguous()


# ---------------------------------------------------------------------------
# reductions (reference tensor.cu:224-287; note the reference's std()
# computes sqrt(sum((x-mu)^2))/numel, kept verbatim for output parity)
# ---------------------------------------------------------------------------
def _nvar(x, mu: float) -> float:
    return float(torch.sum((x - _f32(mu)) ** 2))


def t_sum(x) -> float:
    return float(torch.sum(x))


def t_avg(x) -> float:
    return float(torch.sum(x)) / x.numel()


def t_std(x) -> float:
    mu = t_avg(x)
    return math.sqrt(_nvar(x, mu)) / x.numel() if x.numel() else 0.0


def t_norm(x) -> float:
    return math.sqrt(_nvar(x, 0.0))


def t_max(x) -> float:
    return float(torch.max(x))


def t_min(x) -> float:
    return float(torch.min(x))


def t_dot(a, b) -> float:
    return float(torch.dot(a.reshape(-1), b.reshape(-1)))


def has_nan(x) -> int:
    return int(torch.sum(~torch.isfinite(x)))


# ---------------------------------------------------------------------------
# device barrier: the interpreter issues asynchronous device work word by
# word; `clock` (and benchmarks) must observe completed device time, not
# queue time, like the reference's cudaDeviceSynchronize
# ---------------------------------------------------------------------------
def sync(device=None):
    """wait for all work queued on the CUDA device (of the MMU when none
    is given); nothing to wait for on the CPU"""
    if device is None:
        from ..mu.mmu import MMU
        device = MMU.get_mmu().device
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
