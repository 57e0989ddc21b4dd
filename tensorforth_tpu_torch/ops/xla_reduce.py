"""Full f32 sums in the order XLA's CPU backend adds them (`jnp.sum`).

The JAX package's reductions (`engine._sum`, `_nvar`, `funcs.loss_fn`,
the backprop trace's Σ/n, the softmax's row sums) are `jnp.sum` under
`jax.jit`.  On the CPU, XLA
compiles such a sum in two stages, read from the dumped HLO and LLVM IR
(`XLA_FLAGS=--xla_dump_to=<dir>`):

1. the tree-reduction rewriter: while a reduced dimension is longer than
   32 it becomes a `reduce-window` of 32 (padded with zeros to a multiple
   of 32, the lower half of the padding first; a dimension of 32 or less is
   one window), each window summed one element after another in row-major
   order from +0;
2. the last `reduce` (every dimension at most 32, size-1 dimensions
   dropped) is a loop nest, major to minor, whose adds LLVM may
   reassociate.  The innermost loop (`m` elements) is unrolled; the loop
   around it (trip count `t`) is vectorised for 2 <= m <= 8 with a width
   `VF` from the cost model (`_vf`): lane l takes the iterations
   l, l + VF, ..., the running sum enters lane 0, the lanes fold in
   halves, and the iterations past the last multiple of VF follow one by
   one.  Outer loops run one after another; anything else is one
   sequential sum.

Elementwise ops are the same IEEE operations in both, with one catch:
where a product feeds the reduce's add inside one fused loop (`(x - mu)
** 2`, the losses' `t * log(o)`), the backend contracts the two into an
FMA.  That happens only where the reduce is the one pass; once windows
are cut the product is a fusion of its own, rounded before the sum.

The replay runs on CPU tensors, through numpy's sequential
`add.accumulate` (one call a block of window columns) and, for the FMA
chains, Python floats (`_fma32`).  XLA's runtime flushes subnormals
(FTZ/DAZ): the replay reads subnormal inputs as zeros and flushes its
result and each FMA's; partial plain sums that cancel into the subnormal
range are not flushed.
CUDA tensors keep `torch.sum`: the card's numbers are its own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import xla_math

_W = 32          # the CPU tree-reduction rewriter's window
_F32 = np.float32


def _vf(t: int, m: int, fused: bool = False) -> int:
    """the vector width LLVM's loop vectoriser picks for the reduce loop of
    trip count `t` around an unrolled body of `m` elements (1: not
    vectorised).  Below 16 iterations only a width that divides `t` is
    taken.  Above, the cost model weighs the vector loop against the
    scalar remainder.  A plain sum loads its body as an interleaved group,
    which it takes only up to 8 (the groups of 7 and 8 are dearer, so 4);
    a fused `(x - mu) ** 2` body is vectorised at any `m` (8 above 8)."""
    if t < 2 or m < 2 or (not fused and m > 8):
        return 1
    if t < 16:
        return t if t in (2, 4, 8) else 1
    if m > 8 or (not fused and m >= 7):
        return 8 if m > 8 else 4
    if t % 8 < 4 or (m == 2 and t >= 24):
        return 8
    return 4


_TINY = 2.0 ** -126


def _fma32(a: float, b: float, c: float) -> float:
    """a * b + c rounded once to f32 (f32 values as Python floats), with
    the runtime's flush of a subnormal result: the f64 product is exact,
    and the f64 sum's error (TwoSum) breaks the one double-rounding case,
    an f64 sum on an f32 halfway point"""
    p = a * b
    s = p + c
    r = float(_F32(s))
    t = s - p
    err = (p - (s - t)) + (c - t)
    d = s - r
    if err and d and abs(d) == math.ldexp(1.0, math.frexp(s)[1] - 25) \
            and (err > 0) == (d > 0):
        r += 2 * d
    return math.copysign(0.0, r) if abs(r) < _TINY else r


def _plain(acc, a):
    return acc + a


def _fma(acc, a, b):
    return _fma32(a, b, acc)


def _bce(acc, t, l1, u, l2):
    return _fma32(t, l1, _fma32(u, l2, acc))


def _seq(arrs, step=_plain, start=None) -> np.ndarray:
    """one sequential f32 chain along the last axis of the arrays from
    `start` (+0 by default): acc = step(acc, a[..., j], ...); a chain of
    FMAs runs on Python floats, one element a step"""
    a = arrs[0]
    if start is None:
        start = np.zeros(a.shape[:-1], _F32)
    if step is _plain:
        return np.add.accumulate(np.concatenate(
            [np.asarray(start, _F32)[..., None], a], axis=-1),
            axis=-1, dtype=_F32)[..., -1]
    lead, n = a.shape[:-1], a.shape[-1]
    cols = [np.asarray(x, _F32).reshape(-1, n).tolist() for x in arrs]
    out = np.asarray(start, _F32).reshape(-1).tolist()
    for k in range(len(out)):
        acc = out[k]
        for vals in zip(*(c[k] for c in cols)):
            acc = step(acc, *vals)
        out[k] = acc
    return np.asarray(out, _F32).reshape(lead)


def _lanes(arrs, vf: int, step=_plain, rows: bool = True) -> np.ndarray:
    """the sums of the blocks arrs[.][r] as one vectorised reduce loop: over
    the block's second-to-last dimension (`rows`) or its flat elements;
    lane l takes the iterations l, l + VF, ..., the running sum enters
    lane 0 at each outer iteration, the lanes fold in halves, and the
    iterations past the last multiple of VF follow one by one"""
    a = arrs[0]
    r = a.shape[0]
    if rows:
        t, m = a.shape[-2], a.shape[-1]
    else:
        t, m = a[0].size, 1
    nv = t // vf * vf
    split = []
    for x in arrs:
        x = x.reshape(r, -1, t, m)
        v = x[:, :, :nv].reshape(r, x.shape[1], nv // vf, vf, m)
        split.append((v.transpose(0, 1, 3, 2, 4).reshape(
            r, x.shape[1], vf, -1), x[:, :, nv:].reshape(r, x.shape[1], -1)))
    acc = np.zeros(r, _F32)
    for o in range(split[0][0].shape[1]):
        start = np.full((r, vf), -0.0, _F32)
        start[:, 0] = acc
        v = _seq([lv[:, o] for lv, _ in split], step, start)
        while v.shape[1] > 1:
            h = v.shape[1] // 2
            v = v[:, :h] + v[:, h:]
        acc = v[:, 0]
        if nv < t:
            acc = _seq([rv[:, o] for _, rv in split], step, acc)
    return acc


def _final(a: np.ndarray, b=None) -> np.ndarray:
    """the sums of the blocks a[r] (every dimension at most 32; of the
    products a * b, one FMA a step, when `b` is given): the loop nest of
    one reduce over the block's dimensions"""
    arrs, step = ((a,), _plain) if b is None else ((a, b), _fma)
    vf = _vf(a.shape[-2], a.shape[-1], b is not None) if a.ndim >= 3 else 1
    if vf == 1:
        return _seq([x.reshape(a.shape[0], -1) for x in arrs], step)
    return _lanes(arrs, vf, step)


def _window(a: np.ndarray) -> np.ndarray:
    """one pass of the tree-reduction rewriter: reduce-windows of 32, each
    window summed as the last reduce sums its block (`_final`)"""
    pads, wins, outs = [], [], []
    for d in a.shape:
        if d > _W:
            k = -(-d // _W)
            lo = (_W * k - d) // 2
            pads.append((lo, _W * k - d - lo))
            wins.append(_W)
            outs.append(k)
        else:
            pads.append((0, 0))
            wins.append(d)
            outs.append(1)
    nd = a.ndim
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    p = np.pad(a, pads).reshape([v for ow in zip(outs, wins) for v in ow])
    p = p.transpose(perm).reshape(
        [int(np.prod(outs))] + [w for w in wins if w > 1])
    return _final(p).reshape([d for d in outs if d > 1])


def _squeeze(a: np.ndarray) -> np.ndarray:
    """[1, dims > 1]: XLA drops size-1 dimensions from the loop nest; the
    runtime reads subnormal inputs as zeros of their sign (DAZ)"""
    a = np.array(a, _F32).reshape([1] + [d for d in a.shape if d > 1])
    tiny = np.abs(a) < _F32(_TINY)
    if tiny.any():
        a[tiny] = np.copysign(_F32(0), a[tiny])
    return a


def _ftz(v) -> np.float32:
    v = _F32(v)
    return _F32(math.copysign(0.0, v)) if abs(v) < _TINY else v


def sum_np(a, b=None) -> np.float32:
    """XLA CPU's f32 sum of every element of the array `a`, or of the
    products a * b as `(x - mu) ** 2` is summed: fused into the reduce,
    one FMA a step, where the reduce is the only pass (no dimension over
    32), rounded first where windows are cut"""
    a = np.asarray(a, _F32)
    if b is not None:
        a, b = np.broadcast_arrays(a, np.asarray(b, _F32))
    if a.size == 0:
        return _F32(0)
    a = _squeeze(a)
    b = None if b is None else _squeeze(b)
    if any(d > _W for d in a.shape[1:]):
        if b is not None:
            a, b = a * b, None
        while any(d > _W for d in a.shape[1:]):
            a = _window(a[0])[None]
    return _ftz(_final(a, b)[0])


_BCE_BLOCKS = np.r_[0:4, 8:12, 16:20, 4:8, 12:16, 20:24]


def _loss_rows(t: int) -> int:
    """the fused loss loop's vector width over `t` rows (1: not
    vectorised)"""
    return 4 if t == 4 else 8 if t in (8, 16) else 1


def _term(arrs, step) -> np.ndarray:
    """a loss's elementwise term, rounded (bce's with its one FMA)"""
    if step is _bce:
        t, l1, u, l2 = (torch.from_numpy(x) for x in arrs)
        return xla_math.fma(t, l1, u * l2).numpy()
    return arrs[0] * arrs[1]


def loss_np(op: str, out, tgt, clamp: float) -> np.float32:
    """`funcs.loss_fn(op, out, tgt)` (`clamp`: its LN_CLAMP) as XLA CPU
    computes it.  XLA folds 1 - o + 1e-6 to 1.00000095 - o and turns `/ n`
    into a product by the f32 1/n.  The reduce runs over the flat vector
    when it has more than 32 elements (windows of its own, the terms
    rounded first), else over the operand's own shape with the terms
    fused in: mse/nll/ce one FMA chain, or lanes over 4, 8 or 16 rows (FMA
    lanes; mse's, and nll's over 8 columns, round their products first);
    bce acc = fma(t, log(o + 1e-6), fma(1 - t, log(1.00000095 - o), acc))
    as a chain, as lanes over 4, 8 or 16 rows, or, for a vector of 25
    elements or more, as 8 flat lanes where the loop stays rolled (25 to
    27 and 32) and as 4 lanes over the blocks of the unrolled loop (28 to
    31).  One element is its term alone."""
    o = torch.from_numpy(np.asarray(out, _F32))
    t = torch.from_numpy(np.asarray(tgt, _F32))
    n = o.shape[0] if o.dim() > 1 else 1
    if o.shape != t.shape:      # loss_fn's flat vectors, and XLA's shape
        o, t = o.reshape(-1), t.reshape(-1)
    if op == "mse":
        d = o - t
        arrs, step, sign = (d, d), _fma, 1
    elif op == "nll":
        arrs, step, sign = (o, t), _fma, -1
    elif op == "ce":
        arrs, step, sign = (t, xla_math.log(torch.clamp(o, min=clamp))), \
            _fma, -1
    elif op == "bce":
        arrs = (t, xla_math.log(o + 1.0e-6), 1.0 - t,
                xla_math.log(torch.tensor(1.0 + 1.0e-6,
                                          dtype=torch.float32) - o))
        step, sign = _bce, -1
    else:
        raise ValueError(op)
    arrs = [_squeeze(x.numpy()) for x in arrs]
    if o.numel() > _W:
        z = sum_np(_term(arrs, step).reshape(-1))
    else:
        a = arrs[0]
        vf = _loss_rows(a.shape[-2]) if a.ndim >= 3 else 1
        if a.size == 1:                 # no loop: the term alone
            z = _term(arrs, step).reshape(())
        elif vf > 1:
            if op == "mse" or (op == "nll" and a.shape[-1] == 8):
                arrs, step = [arrs[0] * arrs[1]], _plain
            z = _lanes(arrs, vf, step)[0]
        elif step is _bce and a.ndim == 2 and 28 <= a.size <= 31:
            # unrolled: 4 lanes over the first 24 terms' blocks of 4 in
            # the order 0, 2, 4, 1, 3, 5 (read from the IR's adds and
            # held on random inputs), the rest one after another
            flat = [x.reshape(1, -1) for x in arrs]
            z = _lanes([f[:, _BCE_BLOCKS] for f in flat], 4, step,
                       rows=False)
            z = _seq([f[:, 24:] for f in flat], step, z)[0]
        elif step is _bce and a.ndim == 2 and a.size >= 25:
            z = _lanes(arrs, 8, step, rows=False)[0]
        else:
            z = _seq([x.reshape(1, -1) for x in arrs], step)[0]
    return _ftz(_F32(sign * z) * _F32(1.0 / n))


def _row_sums(a: np.ndarray) -> np.ndarray:
    """the sums over the last axis of [R, W] rows, as XLA CPU reduces one
    minor dimension: one element after another per row, through windows
    of 32 (padded as `_window` pads) while a row is longer than 32"""
    while a.shape[1] > _W:
        w = a.shape[1]
        k = -(-w // _W)
        lo = (_W * k - w) // 2
        a = _seq([np.pad(a, ((0, 0), (lo, _W * k - w - lo))).reshape(
            a.shape[0], k, _W)])
    return _seq([a])


def col_sums_np(a: np.ndarray) -> np.ndarray:
    """the sums over the first axis of [R, C] (`jnp.sum(x, axis=0)` under
    `jax.jit`, read from t4_40b's and t4_32a's dumped backward programs:
    the rewriter's `reduce-window` of 32 rows, padded as `_window` pads,
    then the `reduce` of the partials fused with the gradient's
    accumulation; in both each column is summed one row after another
    from +0, vectorised across columns), with the runtime's DAZ on the
    inputs and its flush of the result; one row is copied as it is"""
    a = np.array(a, _F32).reshape(a.shape[0], -1)
    if a.shape[0] == 1:              # a reduce of one row is a copy
        return a[0]
    tiny = np.abs(a) < _F32(_TINY)
    a[tiny] = np.copysign(_F32(0), a[tiny])
    while a.shape[0] > _W:
        r = a.shape[0]
        k = -(-r // _W)
        lo = (_W * k - r) // 2
        p = np.pad(a, ((lo, _W * k - r - lo), (0, 0))).reshape(k, _W, -1)
        a = _seq([np.ascontiguousarray(p.transpose(0, 2, 1))])
    out = _seq([np.ascontiguousarray(a.T)])
    tiny = np.abs(out) < _F32(_TINY)
    out[tiny] = np.copysign(_F32(0), out[tiny])
    return out


class _RowSum(torch.autograd.Function):
    """the replayed row sums, with a sum's gradient"""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        a = np.ascontiguousarray(_host(x)).reshape(-1, x.shape[-1])
        return torch.from_numpy(_row_sums(a)).reshape(*x.shape[:-1], 1)

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(dim=-1, keepdim=True) in XLA CPU's order on a CPU f32 tensor
    (the softmax denominators), torch's on the card"""
    if x.device.type != "cpu":
        return x.sum(dim=-1, keepdim=True)
    return _RowSum.apply(x)


def col_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(dim=0) of a 2-D f32 tensor: XLA CPU's order on a CPU tensor
    (col_sums_np), torch's on the card"""
    if x.device.type != "cpu":
        return x.sum(dim=0)
    return torch.from_numpy(col_sums_np(_host(x)))


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().to(torch.float32).numpy()


def xla_sum(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """the sum of every element of `x` (of x * y, fused as `(x - mu) ** 2`
    is, when `y` is given) as a 0-d f32 tensor: XLA CPU's bits on a CPU
    tensor, `torch.sum` on the card"""
    if x.device.type != "cpu":
        return torch.sum(x if y is None else x * y)
    return torch.tensor(sum_np(_host(x), None if y is None else _host(y)),
                        dtype=torch.float32)


def xla_loss(op: str, out: torch.Tensor, tgt: torch.Tensor,
             clamp: float) -> torch.Tensor:
    """`funcs.loss_fn` on CPU tensors, bit for bit XLA CPU's"""
    return torch.tensor(loss_np(op, _host(out), _host(tgt), clamp),
                        dtype=torch.float32)
