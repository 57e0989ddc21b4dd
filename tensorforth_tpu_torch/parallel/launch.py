"""Start the local ranks of a mesh: one process a rank, a gloo process
group over `tcp://localhost:<free port>`, the same function on every rank
(`torch.multiprocessing`'s spawn: each rank imports the package anew).

`run(fn, world, *args)` returns rank 0's result; a rank that raises
fails the call.  Every rank reads the same inputs; by convention only
rank 0 prints.  On the card every rank takes the one device: NCCL
refuses two ranks on one GPU, so the group is gloo's there too.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKEND = "gloo"
# a collective that a rank never joins raises after this long, so that a
# rank's fault fails the call instead of hanging its peers
TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, out_dir):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(BACKEND, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = fn(rank, world, *args)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "rank0.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(fn, world: int, *args):
    """fn(rank, world, *args) on `world` local ranks; rank 0's result
    (which must be picklable by torch.save)"""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(world, free_port(), fn, args, out_dir),
                 nprocs=world, join=True)
        return torch.load(os.path.join(out_dir, "rank0.pt"),
                          weights_only=False)
