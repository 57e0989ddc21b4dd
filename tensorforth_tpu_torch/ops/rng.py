"""Stateless device RNG (the port of tensorforth_tpu/ops/rng.py): a
threefry2x32 counter generator in torch that gives the numbers of
``jax.random.uniform`` bit for bit and of ``jax.random.normal`` to
within 2 ulp, so that a seeded transcript (``rand``, ``randn``, Kaiming
init) is the same in both packages.

What is reproduced (jax 0.9, ``jax_threefry_partitionable=True``):
  key       ``PRNGKey(seed)`` keeps the low word: (0, seed & 0xffffffff)
  bits      element i of the flattened shape is x0 ^ x1 of
            threefry2x32(key, (i >> 32, i & 0xffffffff))
  uniform   (bits >> 9 | 0x3f800000 as f32) - 1, in [0, 1)
  normal    sqrt(2) * erfinv(u), u uniform on (-1, 1) from the same
            bits; erfinv is the single-precision polynomial XLA uses
            (Giles, "Approximating the erfinv function")
Distribution semantics as in the reference: v = scale * (bias + u).

torch has few uint32 operations, so the integer work is done in int64
with masks.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# erfinv(x) = p(w) * x with w = -log1p(-x*x): two degree-8 polynomials,
# highest coefficient first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's own log1p and log (Cephes), whose last bits erfinv inherits
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def key_of(seed: int) -> tuple[int, int]:
    """the threefry key of an integer seed"""
    return 0, int(seed) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0, x1):
    """20 rounds of threefry2x32 on int64 tensors holding uint32 values"""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(seed: int, numel: int, device) -> torch.Tensor:
    """`numel` 32-bit words as int64, one per counter value"""
    i = torch.arange(numel, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key_of(seed), i >> 32, i & _M32)
    return x0 ^ x1


def _unit_floats(bits):
    """[0, 1) from the top 23 bits: the mantissa of a float in [1, 2)"""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def _t(c):
    return torch.tensor(c, dtype=torch.float32)


def _fma(a, b, c):
    """a * b + c rounded once: XLA contracts its polynomial steps into
    fused multiply-adds, and the last bits of `randn` depend on it"""
    return (a.double() * b.double() + c.double()).float()


def _horner(x, coeffs):
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _t(c))
    return p


def _log(v):
    """the Cephes single-precision log as XLA's CPU backend vectorizes
    it, for 0 < v < 1"""
    bits = v.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    x = ((bits & 0x007FFFFF) | 0x3F000000).to(torch.int32).view(
        torch.float32)                       # mantissa in [0.5, 1)
    low = x < 0.707106781186547524
    e = e - low.float()
    x = (x - 1.0) + torch.where(low, x, torch.zeros_like(x))
    x2 = x * x
    x3 = x2 * x
    y = _fma(_horner(x, _LOG_P[0:3]), x3, _horner(x, _LOG_P[3:6]))
    y = _fma(y, x3, _horner(x, _LOG_P[6:9])) * x3
    y = y + _t(-2.12194440e-4) * e
    return ((x - 0.5 * x2) + y) + _t(0.693359375) * e


def _log1p(x):
    """XLA's log1p: the Cephes rational form below sqrt(2) - 1, else
    log(1 + x)"""
    x2 = x * x
    r = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + (-0.5 * x2 + r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log(1.0 + x))


def _erfinv(x):
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        p = _fma(p, w, torch.where(lt, a, b).float())
    return p * x


def _draw(shape, dist: str, seed: int, device):
    shape = tuple(int(d) for d in shape)
    f = _unit_floats(random_bits(seed, math.prod(shape), device))
    if dist == "normal":
        # the open interval's lower end, in f32 arithmetic as jax's
        lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
        one = torch.tensor(1.0, dtype=torch.float32)
        span = (one - lo).item()
        u = torch.clamp_min(f * span + lo, lo)
        f = math.sqrt(2.0) * _erfinv(u)
    elif dist != "uniform":
        raise ValueError(f"distribution {dist}?")
    return f.reshape(shape)


def fill(shape, dist: str, bias: float, scale: float, seed: int,
         device="cpu"):
    """scale * (bias + u), u ~ U[0,1) or N(0,1), as an f32 tensor"""
    u = _draw(shape, dist, seed, device)
    return torch.tensor(scale, dtype=torch.float32) * (
        torch.tensor(bias, dtype=torch.float32) + u)


def scalar(dist: str, seed: int) -> float:
    return float(_draw((1,), dist, seed, "cpu")[0])


def uniform_mask(shape, seed: int, device="cpu"):
    """dropout mask source, U[0,1)"""
    return fill(shape, "uniform", 0.0, 1.0, seed, device)
