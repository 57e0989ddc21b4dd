"""Linear algebra words: inverse / LU / PLU / det / solve (the port of
tensorforth_tpu/ops/linalg.py).

The reference implements pivoted Gauss-Jordan and PLU as per-column CUDA
kernel sequences with host-side pivot search (src/t4math.cu:742-978,
src/mu/tensor.cu:344-456).  The JAX package left these to XLA's linalg
and holds no hand-written kernel for them; the port uses torch.linalg
(cuSOLVER / cuBLAS on the card) with the word-level semantics kept:

  inverse ( A -- A A' )    Gauss-Jordan equivalent
  luinv   ( A -- A A' )    PLU-based inverse
  plu     ( A -- A P LU )  A = P @ L @ U, LU packed as L\\U (unit diag L)
  upper/lower              triangle extraction from a packed L\\U
  det     ( A -- A d )
  solve   ( B A -- B A X ) solves A X = B

The linalg words are ALWAYS f32-strict (the package keeps TF32 off):
they carry the reference's 1e-5 verify-lines (t4_22a inverse
round-trips).
"""
from __future__ import annotations

import numpy as np
import torch

from . import xla_math


def _eye_like(a):
    return torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)


def inverse(a):
    """f32 inverse + one Newton-Schulz refinement step: X' = X(2I - AX).
    Recovers the couple of ulps a blocked f32 LU loses, so `inverse @`
    round-trips print as the identity like the reference's Gauss-Jordan
    (acceptance bar: values within 1e-5 of the CUDA build).
    A singular matrix gives NaN everywhere, as jnp.linalg.inv does (it
    does not raise)."""
    x, info = torch.linalg.inv_ex(a)
    x = torch.where(info != 0, torch.full_like(x, float("nan")), x)
    return x @ (2.0 * _eye_like(a) - a @ x)


def plu(a):
    """returns (P, packed L\\U) with A = P @ L @ U"""
    p, l, u = torch.linalg.lu(a)
    return p, l + u - _eye_like(a)


def tri_upper(lu):
    return torch.triu(lu)


def tri_lower(lu):
    return torch.tril(lu, -1) + _eye_like(lu)


def _det_lu(a):
    """(packed LU, 0-based pivots) of a square matrix: on a CPU tensor
    LAPACK's sgetrf through scipy, the routine XLA CPU calls for
    lax.linalg.lu (torch's own CPU LU rounds differently); on the card
    torch's"""
    if a.device.type == "cpu":
        from scipy.linalg import lapack
        lu, piv, _ = lapack.sgetrf(a.numpy())
        return torch.from_numpy(lu), torch.from_numpy(piv.astype(np.int64))
    lu, piv = torch.linalg.lu_factor(a)
    return lu, piv.to(torch.int64) - 1


def det(a) -> float:
    """jnp.linalg.det's route: closed forms at 2x2 and 3x3 with XLA CPU's
    fused multiply-adds, sign * exp(logdet) of the LU route above that
    (jax/_src/numpy/linalg.py _det_2x2, _det_3x3, _slogdet_lu), so the
    CPU result has the reference's bits (a singular 2x2 gives +0)"""
    n = a.shape[-1]
    if n == 2:
        return float(xla_math.fma(a[0, 0], a[1, 1], -(a[0, 1] * a[1, 0])))
    if n == 3:
        s = xla_math.fma(a[0, 0] * a[1, 1], a[2, 2],
                         a[0, 1] * a[1, 2] * a[2, 0])
        s = xla_math.fma(a[0, 2] * a[1, 0], a[2, 1], s)
        s = xla_math.fma(-(a[0, 2] * a[1, 1]), a[2, 0], s)
        s = xla_math.fma(-(a[0, 0] * a[1, 2]), a[2, 1], s)
        s = xla_math.fma(-(a[0, 1] * a[1, 0]), a[2, 2], s)
        return float(s)
    lu, piv = _det_lu(a)
    diag = torch.diagonal(lu)
    parity = int((piv != torch.arange(n, device=piv.device)).sum()
                 + (diag < 0).sum())
    if bool((diag == 0).any()):
        return 0.0
    logs = xla_math.log(diag.abs())
    logdet = logs[0]
    for v in logs[1:]:                # XLA CPU sums the row in order
        logdet = logdet + v
    sign = torch.tensor(1.0 - 2.0 * (parity % 2), dtype=torch.float32,
                        device=a.device)
    return float(sign * xla_math.exp(logdet.reshape(1))[0])


def solve(a, b):
    """f32 solve + one iterative-refinement step (x += A\\(b - Ax)):
    integer-exact systems print as integers, matching the reference.
    The residual is taken in f64: LAPACK's f32 LU leaves an error that
    an f32 residual cannot see (t4_22a's system printed -8.0001)."""
    x = torch.linalg.solve(a, b)
    r = (b.double() - a.double() @ x.double()).float()
    return x + torch.linalg.solve(a, r)
