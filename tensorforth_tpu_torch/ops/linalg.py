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

import torch


def _eye_like(a):
    return torch.eye(a.shape[-1], dtype=torch.float32, device=a.device)


def inverse(a):
    """f32 inverse + one Newton-Schulz refinement step: X' = X(2I - AX).
    Recovers the couple of ulps a blocked f32 LU loses, so `inverse @`
    round-trips print as the identity like the reference's Gauss-Jordan
    (acceptance bar: values within 1e-5 of the CUDA build)."""
    x = torch.linalg.inv(a)
    return x @ (2.0 * _eye_like(a) - a @ x)


def plu(a):
    """returns (P, packed L\\U) with A = P @ L @ U"""
    p, l, u = torch.linalg.lu(a)
    return p, l + u - _eye_like(a)


def tri_upper(lu):
    return torch.triu(lu)


def tri_lower(lu):
    return torch.tril(lu, -1) + _eye_like(lu)


def det(a) -> float:
    return float(torch.linalg.det(a))


def solve(a, b):
    """f32 solve + one iterative-refinement step (x += A\\(b - Ax)):
    integer-exact systems print as integers, matching the reference.
    The residual is taken in f64: LAPACK's f32 LU leaves an error that
    an f32 residual cannot see (t4_22a's system printed -8.0001)."""
    x = torch.linalg.solve(a, b)
    r = (b.double() - a.double() @ x.double()).float()
    return x + torch.linalg.solve(a, r)
