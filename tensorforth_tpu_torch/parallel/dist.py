"""Multi-host start-up (the port of tensorforth_tpu/parallel/dist.py).

Every process runs the same interpreter; the T4_* environment forms the
process group, and the meshes of parallel/mesh.py span its ranks, laid
out so that data parallelism crosses hosts while the model axis (tp or
ep) stays within one:

    T4_COORD = host:port        rank 0's address (the group's rendezvous)
    T4_NPROC = N                the processes of the cluster
    T4_RANK  = i                this process's rank (0..N-1)

With none of them set, or T4_NPROC=1, everything is a no-op and the
single-process paths run unchanged.  T4_COORD=auto takes the rendezvous
from torch's own environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK:
torchrun's), where the JAX package reads a TPU pod's metadata.  One
process is one rank on one device; the group is gloo's, as the local
ranks' (parallel/launch.py), so ranks may share a card.
"""
from __future__ import annotations

import atexit
import datetime
import os
import socket

import torch.distributed as dist

from . import launch
from .mesh import Mesh, make_mesh

_initialized = False


def _count():
    up = dist.is_available() and dist.is_initialized()
    return (dist.get_rank(), dist.get_world_size()) if up else (0, 1)


def _shutdown():
    """the group's end when the process exits: its threads are torn down
    before the interpreter's (left to its exit, a thread of gloo's still
    joinable aborts the process).  No barrier: a rank that failed, or one
    whose peers are gone, exits at once"""
    if dist.is_initialized():
        dist.destroy_process_group()


def init_distributed() -> tuple[int, int]:
    """idempotent cluster start-up from the T4_* environment:
    (this process's rank, the processes).  One process without it."""
    global _initialized
    coord = os.environ.get("T4_COORD")
    if not coord or _initialized:
        return _count()
    timeout = datetime.timedelta(seconds=launch.TIMEOUT_S)
    if coord == "auto":                    # torchrun's environment
        dist.init_process_group(launch.BACKEND, init_method="env://",
                                timeout=timeout)
    else:
        nproc = int(os.environ.get("T4_NPROC", "1"))
        rank = int(os.environ.get("T4_RANK", "0"))
        if nproc > 1:
            dist.init_process_group(launch.BACKEND,
                                    init_method=f"tcp://{coord}",
                                    world_size=nproc, rank=rank,
                                    timeout=timeout)
    if dist.is_initialized():
        atexit.register(_shutdown)
    _initialized = True
    return _count()


def global_layout(hosts: list, dp: int | None = None, m2: int | None = None,
                  ax2: str = "tp") -> list:
    """the ranks of a (dp, m2) mesh over a cluster whose rank r runs on
    hosts[r]: host-major (each host's ranks in rank order, the hosts in
    the order of their first rank), so dp runs across hosts and the model
    axis within one; a model axis wider than a host refused"""
    order = []
    for h in hosts:
        if h not in order:
            order.append(h)
    by_host = [[r for r, x in enumerate(hosts) if x == h] for h in order]
    n = len(hosts)
    local = min(len(b) for b in by_host)
    if m2 is None:
        m2 = 1 if dp is None else n // dp
    if dp is None:
        dp = n // m2
    assert dp * m2 == n, f"mesh {dp}x{m2} != {n} global ranks"
    if m2 > local:
        raise ValueError(
            f"model axis {ax2}={m2} larger than a host's {local} ranks "
            f"would put its collectives between hosts — refuse (use dp "
            f"across hosts, {ax2} within)")
    assert dp % len(order) == 0, \
        f"dp={dp} must be a multiple of the {len(order)} hosts"
    return [r for b in by_host for r in b]


def make_global_mesh(dp: int | None = None, tp: int | None = None,
                     ep: int | None = None) -> Mesh:
    """a (dp, tp|ep) mesh over every rank of the cluster, dp host-major
    (global_layout); within one process, parallel/mesh.make_mesh"""
    if _count()[1] == 1:
        return make_mesh(dp=dp, tp=tp, ep=ep)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    ax2 = "ep" if ep is not None else "tp"
    m2 = ep if ep is not None else tp
    order = global_layout(hosts, dp, m2, ax2)
    if m2 is None:
        m2 = 1 if dp is None else len(hosts) // dp
    if order != sorted(order):
        raise NotImplementedError(
            "make_global_mesh: the ranks of a host must be consecutive "
            "(start each host's processes with consecutive T4_RANKs)")
    return Mesh(("dp", ax2), (len(hosts) // m2, m2))


def local_batch_slice(global_batch: int) -> slice:
    """the rows of a [global_batch, ...] batch this process feeds"""
    rank, n_proc = _count()
    assert global_batch % n_proc == 0
    per = global_batch // n_proc
    return slice(rank * per, (rank + 1) * per)
