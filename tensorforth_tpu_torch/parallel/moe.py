"""Mixture-of-experts feed-forward block and its expert parallelism (the
port of tensorforth_tpu/parallel/moe.py).

Two routing paths, both top-k token-choice with renormalized gates:

* **soft path** (`moe_fwd`): every expert evaluates every token and the
  gates mask afterwards.  Exact, no token drops, FLOPs scale with E.
* **dispatch path** (`moe_fwd_dispatch`): tokens are packed into
  per-expert capacity buffers [E, C, D] (C = ceil(k·S/E·cf)), each
  expert runs one batched product pair over its buffer, and a gather
  with the gates restores token order; assignments past an expert's
  capacity are dropped (contribute zero), primary choices packing
  first.  FLOPs scale with k·cf/E of the dense cost.

Both are static-shaped and read nothing back to the host, so a CUDA
graph can capture them: a dropped assignment goes to one overflow row of
an [E, C+1, D] buffer, which is cut off, and the k choices combine as a
left fold over j (no atomic adds: the bits are the same on every run).
The router's softmax is XLA CPU's on a CPU tensor (nn/funcs.py): gates an
ulp off could flip a top-k choice.  The einsums run in the LM tier's
class (funcs.class_einsum): exact f32 on the CPU.

Over an 'ep' mesh axis (`make_ep_mesh`, `shard_experts`) a rank holds
E/ep experts and their router rows, and the ranks of the axis hold the
same tokens.  Both paths take the mesh: a rank's router scores are
all-gathered into the whole gates (so every rank routes alike), the rank
runs its own experts on the tokens routed to them, and the partial
outputs are all-reduced over ep.  The collectives are differentiable:
the gather's cotangent is summed over ep and cut to the rank's experts,
the sum's passes as it is (what follows runs alike on every rank of the
axis), and an input gradient is a rank's part, to be summed over ep
(nn/funcs.py's MoE backward does).
"""
from __future__ import annotations

import math
import os

import torch

from ..nn import funcs


def capacity_factor() -> float:
    """T4_MOE_CAP, read at call time as the JAX package reads it"""
    return float(os.environ.get("T4_MOE_CAP", "1.25"))


def capture_key():
    """what a captured program's routing depends on: T4_MOE_DISPATCH and
    T4_MOE_CAP (a capture bakes the route and the capacity in)"""
    return (os.environ.get("T4_MOE_DISPATCH", ""),
            os.environ.get("T4_MOE_CAP", "1.25"))


def _ep(mesh, axis):
    return mesh is not None and mesh.axis_size(axis) > 1


def _gates(x, wr, mesh=None, axis="ep"):
    """softmax(x · wrᵀ) over the experts: x [..., D], wr [E, D] (a rank's
    rows over an expert axis: the scores are gathered whole first)"""
    lead = x.shape[:-1]
    scores = funcs.class_einsum("sd,ed->se", x.reshape(-1, x.shape[-1]), wr)
    if _ep(mesh, axis):
        from .mesh import gather
        scores = gather(scores, mesh, 1, axis)
    return funcs.router_softmax(scores).reshape(*lead, scores.shape[-1])


def _ep_sum(y, mesh, axis):
    if not _ep(mesh, axis):
        return y
    from .mesh import reduce
    return reduce(y, mesh, axis)


def moe_fwd(x, wr, w1, w2, top_k: int = 2, mesh=None, axis: str = "ep"):
    """x [N, T, D]; wr [E, D]; w1 [E, D, F]; w2 [E, F, D] -> [N, T, D]
    (over a mesh, wr, w1 and w2 are the rank's experts along `axis`)"""
    gates = _gates(x, wr, mesh, axis)
    e = gates.shape[-1]
    if top_k < e:                        # keep top-k, renormalize
        kth = torch.sort(gates.detach(), dim=-1).values[..., e - top_k:
                                                       e - top_k + 1]
        gates = torch.where(gates >= kth, gates, torch.zeros_like(gates))
        gates = gates / gates.sum(dim=-1, keepdim=True)
    if _ep(mesh, axis):
        gates = mesh.chunk(gates, -1, axis)
    h = torch.relu(funcs.class_einsum("ntd,edf->ntef", x, w1))
    y = funcs.class_einsum("ntef,efd->nted", h, w2)
    return _ep_sum(funcs.class_einsum("nted,nte->ntd", y, gates), mesh,
                   axis)


def dispatch_plan(gates, top_k: int, cf: float):
    """the routing of moe_fwd_dispatch from the gates [S, E]: (k, cap,
    gf [k*S] renormalized gates j-major, flat [k*S] row of each assignment
    in the [E*(C+1), D] buffer, the overflow row C of its expert where
    dropped)"""
    s, e = gates.shape
    k = min(top_k, e)
    # jax.lax.top_k breaks ties toward the lower expert: a stable sort
    order = torch.sort(gates.detach(), dim=-1, descending=True, stable=True)
    idx = order.indices[:, :k]
    g_top = torch.gather(gates, 1, idx)
    g_top = g_top / g_top.sum(dim=-1, keepdim=True)
    cap = max(1, int(math.ceil(k * s / e * cf)))
    # flatten assignments j-major so every token's primary choice wins a
    # buffer slot before any token's secondary choice
    ef = idx.T.reshape(-1)                                     # [k*S]
    gf = g_top.T.reshape(-1)
    onehot = (ef[:, None] == torch.arange(e, device=ef.device)).to(
        torch.int64)                                           # [k*S, E]
    pf = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    flat = ef * (cap + 1) + torch.clamp(pf, max=cap)
    return k, cap, gf, flat


def moe_fwd_dispatch(x, wr, w1, w2, top_k: int = 2,
                     capacity_factor: float = 1.25, mesh=None,
                     axis: str = "ep"):
    """token-dispatch MoE: x [N, T, D]; wr [E, D]; w1 [E, D, F];
    w2 [E, F, D] -> [N, T, D] (the routing and drops of the JAX
    package's, see the module docstring; over an ep mesh the rank's
    experts run the tokens routed to them)"""
    n, t, d = x.shape
    s = n * t
    xt = x.reshape(s, d)
    gates = _gates(xt, wr, mesh, axis)
    e = gates.shape[-1]
    k, cap, gf, flat = dispatch_plan(gates, top_k, capacity_factor)
    # dispatch: token i's j-th assignment is row j*S + i of xt repeated
    src = xt.repeat(k, 1)                                      # [k*S, D]
    xe = xt.new_zeros(e * (cap + 1), d).index_copy(0, flat, src)
    xe = xe.view(e, cap + 1, d)[:, :cap]                       # [E, C, D]
    if _ep(mesh, axis):
        xe = mesh.chunk(xe, 0, axis)                           # my experts
    h = torch.relu(funcs.class_einsum("ecd,edf->ecf", xe, w1))
    ye = funcs.class_einsum("ecf,efd->ecd", h, w2)             # [E, C, D]
    if _ep(mesh, axis):                 # the others' experts read zeros
        lo = mesh.index(axis) * ye.shape[0]
        ye = torch.cat([ye.new_zeros(lo, cap, d), ye,
                        ye.new_zeros(e - lo - ye.shape[0], cap, d)])
    # combine: dropped assignments read the zero overflow row
    ye = torch.cat([ye, ye.new_zeros(e, 1, d)], dim=1).reshape(-1, d)
    vals = (ye.index_select(0, flat) * gf[:, None]).view(k, s, d)
    y = vals[0]
    for j in range(1, k):                # a left fold over the choices
        y = y + vals[j]
    return _ep_sum(y, mesh, axis).reshape(n, t, d)


_DISPATCH_MIN_TOKENS = 256       # below this the buffers don't amortize


def moe_select(token_dims, e: int, top_k: int) -> bool:
    """True -> dispatch path.  `token_dims` are the token axes (e.g.
    (N, T)).  A static-shape decision: dispatch when it is cheaper (k·cf
    well below E) and there are enough tokens to fill the buffers.
    T4_MOE_DISPATCH=1/0 forces/forbids."""
    env = os.environ.get("T4_MOE_DISPATCH", "")
    if env == "1":
        return True
    if env == "0":
        return False
    s = math.prod(int(v) for v in token_dims)
    return (s >= _DISPATCH_MIN_TOKENS and e >= 4
            and top_k * capacity_factor() <= e / 2)


def make_ep_mesh(n_devices: int):
    """a mesh of n ranks over the one axis 'ep'"""
    from .mesh import Mesh
    return Mesh(("ep",), (n_devices,))


def shard_experts(mesh, wr, w1, w2):
    """this rank's experts over 'ep': its rows of the router wr [E, D] and
    its experts of w1 [E, D, F] and w2 [E, F, D]"""
    return tuple(mesh.chunk(w, 0, "ep").contiguous() for w in (wr, w1, w2))
