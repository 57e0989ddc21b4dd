"""The (dp, tp) mesh over torch.distributed ranks (the port of
tensorforth_tpu/parallel/mesh.py's dp/tp half; the sp axis, `make_mesh3`,
`shard_seq_batch` and `shard_params_seq`, comes with ring attention).

The JAX package lays a `jax.sharding.Mesh` over the devices of one
process and lets XLA insert the collectives.  Here a mesh is a grid of
ranks of one process group, one process a rank (`parallel/launch.py`
starts the local ones): rank r sits at (dp, tp) = (r // tp, r % tp).
The batch is split over `dp` (`shard_batch`: the rank's rows), the
parameters over `tp` as `_param_spec` lays them out (mesh.py:111-159 of
the JAX package): linear/proj W row-sharded, conv filters on their last
axis (C0), attention wqkv by rows and wo by columns, embeddings,
batchnorm and layernorm replicated.  `gather_params` all-gathers the
shards back, bit for bit.

On the CPU the group is gloo's.  The card is one H100 and NCCL refuses
two ranks on one GPU, so a mesh there runs its ranks on the one device
over gloo too (gloo's all_reduce and all_gather take CUDA tensors, and
stage them through the host).  `COUNTS` counts the collectives a rank
issued.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..nn.ntypes import Layer

COUNTS = {"all_reduce": 0, "all_gather": 0}


class Mesh:
    """a dp x tp grid of the ranks of the default process group (or one
    rank alone, when no group is up)"""

    def __init__(self, dp: int, tp: int):
        self.dp, self.tp = int(dp), int(tp)
        self.size = self.dp * self.tp
        up = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if up else 0
        self.world = dist.get_world_size() if up else 1
        if self.size > self.world:
            raise ValueError(f"mesh dp{dp} x tp{tp} needs {self.size} "
                             f"ranks, the group has {self.world}")
        self.dp_idx, self.tp_idx = divmod(self.rank, self.tp)
        self.axis_names = ("dp", "tp")
        self.dp_group = self.tp_group = None
        if self.size > 1:
            # every rank makes every group, in one order (torch's rule)
            for i in range(self.tp):
                g = dist.new_group([d * self.tp + i for d in range(self.dp)])
                if i == self.tp_idx:
                    self.dp_group = g
            for d in range(self.dp):
                g = dist.new_group([d * self.tp + i for i in range(self.tp)])
                if d == self.dp_idx:
                    self.tp_group = g

    @property
    def shape(self):
        return (self.dp, self.tp)

    def __repr__(self):
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"at=({self.dp_idx}, {self.tp_idx}))")

    # --- collectives ---------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """sum over the ranks of `axis` ("dp" or "tp"), in place"""
        n, g = (self.dp, self.dp_group) if axis == "dp" else \
            (self.tp, self.tp_group)
        if n > 1:
            COUNTS["all_reduce"] += 1
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    def all_gather(self, t: torch.Tensor, dim: int, axis: str = "tp"):
        """the shards of `axis`'s ranks concatenated along `dim`"""
        n, g = (self.dp, self.dp_group) if axis == "dp" else \
            (self.tp, self.tp_group)
        if n == 1:
            return t
        COUNTS["all_gather"] += 1
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=g)
        return torch.cat(parts, dim=dim)


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None) -> Mesh:
    """a (dp, tp) mesh of n ranks (the group's size by default); with
    neither axis given, tp is the largest power of two <= sqrt(n) that
    divides n, as in the JAX package"""
    up = dist.is_available() and dist.is_initialized()
    n = n_devices or (dist.get_world_size() if up else 1)
    if dp is None and tp is None:
        tp = 1
        while tp * 2 <= int(math.sqrt(n)) and n % (tp * 2) == 0:
            tp *= 2
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f"mesh {dp}x{tp} != {n} ranks"
    return Mesh(dp, tp)


def parse_spec(spec: str):
    """'dp4' / 'dp2,tp2' -> (dp, tp) or None for an empty spec"""
    spec = (spec or "").strip()
    if not spec:
        return None
    dp = tp = None
    for part in spec.split(","):
        part = part.strip()
        if part.startswith("dp"):
            dp = int(part[2:])
        elif part.startswith("tp"):
            tp = int(part[2:])
        else:
            raise ValueError(f"mesh axis {part!r}? (dp and tp are ported)")
    return dp or 1, tp or 1


def mesh_from_spec(spec: str) -> Mesh | None:
    """'dp4' / 'dp4,tp2' -> Mesh, or None when the spec is empty, names
    one rank, or needs more ranks than the group has (as the JAX package
    degrades to one device)"""
    p = parse_spec(spec)
    if p is None:
        return None
    dp, tp = p
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    if dp * tp <= 1 or dp * tp > world:
        return None
    return make_mesh(dp * tp, dp=dp, tp=tp)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """this rank's rows of the batch (its dp part; tp ranks share it)"""
    n = x.shape[0]
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not divide over dp{mesh.dp}")
    k = n // mesh.dp
    return x[mesh.dp_idx * k:(mesh.dp_idx + 1) * k]


def _param_spec(kind: int, which: str) -> int | None:
    """the axis a parameter is sharded on over 'tp' (None: replicated):
    linear W [E1, E0] by rows (output features), conv filters
    [C1, K, K, C0] on C0, biases on their only axis"""
    if kind in (Layer.LINEAR, Layer.PROJ):
        return 0
    if kind in (Layer.CONV, Layer.DCONV):
        return 3 if which == "w" else 0
    return None


def param_axes(program) -> list:
    """per layer, the tp axis of each of its parameters (None: whole)"""
    out = []
    for kind, _opts, _shape in program:
        if kind in (Layer.CONV, Layer.DCONV, Layer.LINEAR, Layer.PROJ):
            out.append((_param_spec(kind, "w"), _param_spec(kind, "b")))
        elif kind == Layer.ATTN:
            out.append((0, 1))           # wqkv by rows, wo by columns
        elif kind in (Layer.EMBED, Layer.BATCHNM, Layer.LNORM, Layer.MOE):
            out.append((None, None))     # MoE's experts shard over ep (A9)
        else:
            out.append(())
    return out


def _shard(w, ax, mesh):
    if ax is None or mesh.tp == 1:
        return w
    if w.shape[ax] % mesh.tp:
        raise ValueError(f"a parameter of shape {tuple(w.shape)} does not "
                         f"divide over tp{mesh.tp} on its axis {ax}")
    return w.chunk(mesh.tp, dim=ax)[mesh.tp_idx].contiguous()


def shard_params(params, program, mesh: Mesh) -> tuple:
    """this rank's tp shards of a model's `_params()`"""
    return tuple(tuple(_shard(w, ax, mesh) for w, ax in zip(pl, axes))
                 for pl, axes in zip(params, param_axes(program)))


def gather_params(local, program, mesh: Mesh) -> tuple:
    """the whole parameters from the tp shards (an all-gather each)"""
    return tuple(tuple(w if ax is None else mesh.all_gather(w, ax)
                       for w, ax in zip(pl, axes))
                 for pl, axes in zip(local, param_axes(program)))
