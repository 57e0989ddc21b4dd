"""Meshes of torch.distributed ranks (the port of
tensorforth_tpu/parallel/mesh.py).

The JAX package lays a `jax.sharding.Mesh` over the devices of one
process and lets XLA insert the collectives.  Here a mesh is a grid of
ranks of one process group, one process a rank (`parallel/launch.py`
starts the local ones), over named axes: `dp` (the batch), `sp` (the
sequence), `tp` (features), `ep` (MoE experts) and `pp` (pipeline
stages).  Rank r sits at the row-major coordinates of r over the axes, as
the JAX package reshapes its device list.  Every rank makes one torch
group for every line of ranks along an axis, all in one order (torch's
rule), and keeps the groups it belongs to.

The batch is split over `dp` (`shard_batch`: the rank's rows; a sequence
batch `[N/dp, S/sp]` blocks with `shard_seq_batch`), the parameters over
`tp` as `_param_spec` lays them out (mesh.py:111-159 of the JAX package):
linear/proj W row-sharded, conv filters on their last axis (C0), attention
wqkv by rows and wo by columns, embeddings, batchnorm and layernorm
replicated; on a (dp, ep) mesh the dense layers replicate and the MoE
experts shard over `ep`.  `gather_params` all-gathers the shards back, bit
for bit.

On the CPU the group is gloo's.  The card is one H100 and NCCL refuses
two ranks on one GPU, so a mesh there runs its ranks on the one device
over gloo too (gloo's all_reduce and all_gather take CUDA tensors and
stage them through the host; its send/recv takes host tensors only, so
`ppermute` stages each hop through a pinned host buffer itself).
`COUNTS` counts the collectives a rank issued, and the hops, bytes and
host seconds of its point-to-point shifts.
"""
from __future__ import annotations

import datetime
import itertools
import math
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..nn.ntypes import Layer

AXES = ("dp", "sp", "tp", "ep", "pp")
COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "hops": 0,
          "hop_bytes": 0, "hop_s": 0.0}


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """a grid of the ranks 0..size-1 of the default process group over
    named axes (or one rank alone, when no group is up); ranks past the
    grid make its groups and hold no place in it"""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.shape) or any(
                a not in AXES for a in self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names}? "
                             f"({', '.join(AXES)})")
        self.size = math.prod(self.shape)
        up = _group_up()
        self.rank = dist.get_rank() if up else 0
        self.world = dist.get_world_size() if up else 1
        if self.size > self.world:
            raise ValueError(f"mesh {self._spec()} needs {self.size} ranks, "
                             f"the group has {self.world}")
        self.coords = (self._unravel(self.rank) if self.rank < self.size
                       else None)
        self._groups, self._lines, self._bufs = {}, {}, {}
        if self.size > 1:
            # every rank makes every group, in one order (torch's rule)
            for a, name in enumerate(self.axis_names):
                if self.shape[a] == 1:
                    continue
                others = [range(n) for b, n in enumerate(self.shape)
                          if b != a]
                for rest in itertools.product(*others):
                    line = []
                    for i in range(self.shape[a]):
                        c = list(rest)
                        c.insert(a, i)
                        line.append(self._ravel(c))
                    g = dist.new_group(line)
                    if self.rank in line:
                        self._groups[name], self._lines[name] = g, line

    def _unravel(self, r):
        out = []
        for n in reversed(self.shape):
            r, i = divmod(r, n)
            out.append(i)
        return tuple(reversed(out))

    def _ravel(self, coords):
        r = 0
        for i, n in zip(coords, self.shape):
            r = r * n + i
        return r

    def _spec(self):
        return ",".join(f"{a}{n}" for a, n in zip(self.axis_names,
                                                   self.shape))

    def __repr__(self):
        return f"Mesh({self._spec()}, rank={self.rank}, at={self.coords})"

    # --- axes ---------------------------------------------------------------
    def axis_size(self, axis: str) -> int:
        """the ranks along `axis` (1 for an axis the mesh does not have)"""
        if axis not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """this rank's place along `axis` (0 for an axis it does not have)"""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def ranks(self, axis: str) -> list:
        """the global ranks of this rank's line along `axis`"""
        return self._lines.get(axis, [self.rank])

    def group(self, axis: str):
        return self._groups.get(axis)

    dp = property(lambda self: self.axis_size("dp"))
    tp = property(lambda self: self.axis_size("tp"))
    ep = property(lambda self: self.axis_size("ep"))
    sp = property(lambda self: self.axis_size("sp"))
    pp = property(lambda self: self.axis_size("pp"))
    dp_idx = property(lambda self: self.index("dp"))
    tp_idx = property(lambda self: self.index("tp"))
    ep_idx = property(lambda self: self.index("ep"))
    sp_idx = property(lambda self: self.index("sp"))
    pp_idx = property(lambda self: self.index("pp"))
    dp_group = property(lambda self: self.group("dp"))
    tp_group = property(lambda self: self.group("tp"))

    # --- collectives ---------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """sum over the ranks of `axis`, in place"""
        if self.axis_size(axis) > 1:
            COUNTS["all_reduce"] += 1
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, dim: int, axis: str = "tp"):
        """the shards of `axis`'s ranks concatenated along `dim`"""
        n = self.axis_size(axis)
        if n == 1:
            return t
        COUNTS["all_gather"] += 1
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str, index: int):
        """the tensor of the rank at `index` along `axis`, on every rank of
        the axis (in place)"""
        if self.axis_size(axis) > 1:
            COUNTS["broadcast"] += 1
            dist.broadcast(t, self.ranks(axis)[index], group=self.group(axis))
        return t

    def chunk(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """this rank's part of `t` along `dim` over `axis`"""
        n = self.axis_size(axis)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} does not "
                             f"divide over {axis}{n} on its axis {dim}")
        return t.chunk(n, dim=dim)[self.index(axis)]

    def ppermute(self, t: torch.Tensor, axis: str, shift: int = 1,
                 tag: int = 0):
        """t sent to the rank `shift` places on along `axis` (cyclic), and
        the tensor of the rank `shift` places back received: one hop of a
        ring.  Each hop posts its send and its receive at once, so no
        ring order deadlocks; a CUDA tensor goes through a pinned host
        buffer (gloo sends host tensors only) and comes back to its
        device.  A hop never gathers: a rank holds one chunk at a time.
        `tag` keeps the messages of two interleaved shifts apart."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        line, i = self.ranks(axis), self.index(axis)
        dst, src = line[(i + shift) % n], line[(i - shift) % n]
        host = t.detach().contiguous()
        if host.is_cuda:
            host = self._pinned(host.shape, host.dtype, "send").copy_(host)
            recv = self._pinned(host.shape, host.dtype, "recv")
        else:
            recv = torch.empty(host.shape, dtype=host.dtype)
        from .launch import TIMEOUT_S
        works = [dist.isend(host, dst, tag=tag),
                 dist.irecv(recv, src, tag=tag)]
        for w in works:
            w.wait(datetime.timedelta(seconds=TIMEOUT_S))
        out = recv.to(t.device, non_blocking=False)
        COUNTS["hops"] += 1
        COUNTS["hop_bytes"] += host.numel() * host.element_size()
        COUNTS["hop_s"] += time.perf_counter() - t0
        return out

    def _pinned(self, shape, dtype, role):
        """a pinned host buffer of this shape for a hop's send or receive,
        made once (a hop copies out of it before the next one)"""
        key = (tuple(shape), dtype, role)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(shape, dtype=dtype,
                                                pin_memory=True)
        return buf


class Shard(NamedTuple):
    """a rank's part of a tensor: its chunk along `dim` over `axis`"""
    mesh: Mesh
    axis: str
    dim: int

    def part(self, whole):
        return self.mesh.chunk(whole, self.dim, self.axis)

    def whole(self, part):
        return self.mesh.all_gather(part, self.dim, self.axis)

    def shape(self, whole: tuple) -> tuple:
        """the part's shape of a tensor of shape `whole`"""
        n = self.mesh.axis_size(self.axis)
        return tuple(d // n if i == self.dim else d
                     for i, d in enumerate(whole))


class _PPermute(torch.autograd.Function):
    """ppermute with its transpose as the backward: the cotangent goes
    the reverse hop (ppermute's transpose rule)"""

    @staticmethod
    def forward(ctx, t, mesh, axis, shift, tag):
        ctx.mesh, ctx.axis, ctx.shift, ctx.tag = mesh, axis, shift, tag
        return mesh.ppermute(t, axis, shift, tag)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (ctx.mesh.ppermute(g, ctx.axis, -ctx.shift, ctx.tag), None,
                None, None, None)


def ppermute(t, mesh: Mesh, axis: str, shift: int = 1, tag: int = 0):
    """the differentiable ring hop (see Mesh.ppermute)"""
    return _PPermute.apply(t, mesh, axis, shift, tag)


class _Gather(torch.autograd.Function):
    """all-gather along `dim` over `axis`; its cotangent is summed over the
    axis and this rank's part kept (the transpose of an all-gather, a
    reduce-scatter)"""

    @staticmethod
    def forward(ctx, t, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.all_gather(t, dim, axis)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.contiguous().clone(), ctx.axis)
        return (ctx.mesh.chunk(g, ctx.dim, ctx.axis).contiguous(), None,
                None, None)


def gather(t, mesh: Mesh, dim: int, axis: str):
    return _Gather.apply(t, mesh, dim, axis)


class _Reduce(torch.autograd.Function):
    """all-reduce (sum) over `axis`; the cotangent passes as it is: every
    rank of the axis holds the same cotangent of the sum (the ranks
    replicate what follows), which is each part's own"""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce(t, mesh: Mesh, axis: str):
    return _Reduce.apply(t, mesh, axis)


# =============================================================================
# making meshes
# =============================================================================
def _world() -> int:
    return dist.get_world_size() if _group_up() else 1


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, ep: int | None = None) -> Mesh:
    """a (dp, tp) mesh of n ranks (the group's size by default), or (dp,
    ep) when ep is given (expert parallelism: the model axis shards MoE
    experts instead of features); with neither model axis nor dp given,
    the model axis is the largest power of two <= sqrt(n) that divides n,
    as in the JAX package"""
    n = n_devices or _world()
    ax2 = "ep" if ep is not None else "tp"
    m2 = ep if ep is not None else tp
    if dp is None and m2 is None:
        m2 = 1
        while m2 * 2 <= int(math.sqrt(n)) and n % (m2 * 2) == 0:
            m2 *= 2
        dp = n // m2
    elif dp is None:
        dp = n // m2
    elif m2 is None:
        m2 = n // dp
    assert dp * m2 == n, f"mesh {dp}x{m2} != {n} ranks"
    return Mesh(("dp", ax2), (dp, m2))


def make_mesh3(n_devices: int | None = None, dp: int = 2, sp: int = 2,
               tp: int = 2) -> Mesh:
    """the 3-axis mesh of sequence models: data / sequence / tensor"""
    n = n_devices or _world()
    assert dp * sp * tp == n, f"mesh {dp}x{sp}x{tp} != {n} ranks"
    return Mesh(("dp", "sp", "tp"), (dp, sp, tp))


def parse_spec(spec: str):
    """'dp4' / 'dp2,tp2' / 'dp2,ep4' -> {axis: size} (an axis that is not
    named is absent), or None for an empty spec"""
    spec = (spec or "").strip()
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if part[:2] in ("dp", "tp", "ep"):
            out[part[:2]] = int(part[2:])
        else:
            raise ValueError(f"mesh axis {part!r}? (dp, tp and ep)")
    return out


def mesh_from_spec(spec: str) -> Mesh | None:
    """'dp4' / 'dp4,tp2' / 'dp2,ep4' -> Mesh, or None when the spec is
    empty, names one rank, or needs more ranks than the group has (as the
    JAX package degrades to one device)"""
    p = parse_spec(spec)
    if p is None:
        return None
    n = p.get("dp", 1) * p.get("tp", 1) * p.get("ep", 1)
    if n <= 1 or n > _world():
        return None
    return make_mesh(n, dp=p.get("dp"), tp=p.get("tp"), ep=p.get("ep"))


# =============================================================================
# shardings
# =============================================================================
def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """this rank's rows of the batch (its dp part; the other axes' ranks
    share it)"""
    n = x.shape[0]
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not divide over dp{mesh.dp}")
    return mesh.chunk(x, 0, "dp")


def shard_seq_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """sequence activations [N, S, E, 1]: this rank's [N/dp, S/sp] block"""
    return mesh.chunk(shard_batch(x, mesh), 1, "sp").contiguous()


def _param_spec(kind: int, which: str) -> int | None:
    """the axis a parameter is sharded on over 'tp' (None: replicated):
    linear W [E1, E0] by rows (output features), conv filters
    [C1, K, K, C0] on C0, biases on their only axis"""
    if kind in (Layer.LINEAR, Layer.PROJ):
        return 0
    if kind in (Layer.CONV, Layer.DCONV):
        return 3 if which == "w" else 0
    return None


def param_axes(program, mesh: Mesh | None = None) -> list:
    """per layer, (mesh axis, tensor axis) of each of its parameters over
    the mesh's model axis (None: whole).  On a mesh with `ep` and no `tp`
    only the MoE experts shard, over ep; a mesh of neither replicates."""
    model_ax = "ep" if (mesh is not None and "ep" in mesh.axis_names
                        and "tp" not in mesh.axis_names) else "tp"
    out = []
    for kind, _opts, _shape in program:
        if kind in (Layer.CONV, Layer.DCONV, Layer.LINEAR, Layer.PROJ):
            out.append(tuple(None if model_ax == "ep" else
                             ("tp", _param_spec(kind, w)) for w in "wb"))
        elif kind == Layer.ATTN:         # wqkv by rows, wo by columns
            out.append((None, None) if model_ax == "ep"
                       else (("tp", 0), ("tp", 1)))
        elif kind == Layer.MOE:          # experts over the model axis
            out.append(((model_ax, 0), (model_ax, 0)))
        elif kind in (Layer.EMBED, Layer.BATCHNM, Layer.LNORM):
            out.append((None, None))
        else:
            out.append(())
    return out


def _shard(w, ax, mesh):
    if ax is None:
        return w
    return mesh.chunk(w, ax[1], ax[0]).contiguous()


def shard_params(params, program, mesh: Mesh, axes=None) -> tuple:
    """this rank's shards of a model's `_params()` (laid out by `axes`,
    param_axes' by default)"""
    axes = param_axes(program, mesh) if axes is None else axes
    return tuple(tuple(_shard(w, ax, mesh) for w, ax in zip(pl, la))
                 for pl, la in zip(params, axes))


def gather_params(local, program, mesh: Mesh, axes=None) -> tuple:
    """the whole parameters from the shards (an all-gather each)"""
    axes = param_axes(program, mesh) if axes is None else axes
    return tuple(tuple(w if ax is None else mesh.all_gather(w, ax[1], ax[0])
                       for w, ax in zip(pl, la))
                 for pl, la in zip(local, axes))


def shard_params_seq(params, program, mesh: Mesh) -> tuple:
    """this rank's shards on a (dp, sp, tp) mesh (JAX mesh.py:87-108)"""
    return shard_params(params, program, mesh, seq_param_axes(program))


def seq_param_axes(program) -> list:
    """shard_params_seq's layout: linear, attention and proj weights by
    rows over tp (attention's wo too), their biases on their axis, conv
    filters on C0, MoE experts on their first axis; the rest
    replicated"""
    out = []
    for kind, _opts, _shape in program:
        if kind in (Layer.LINEAR, Layer.ATTN, Layer.PROJ):
            out.append((("tp", 0), ("tp", 0)))
        elif kind in (Layer.CONV, Layer.DCONV):
            out.append((("tp", 3), ("tp", 0)))
        elif kind == Layer.MOE:
            out.append((("tp", 0), ("tp", 0)))
        elif kind in (Layer.BATCHNM, Layer.LNORM, Layer.EMBED):
            out.append((None, None))
        else:
            out.append(())
    return out
