"""Multi-host start-up (parallel/dist.py) on the CPU: test_dist.py's six
cases.  The single-process no-ops run as they are; the start-up is pinned
against a stand-in init_process_group; the host-major layout runs on a
made-up cluster of 4 hosts of 2 ranks; and two real processes, started
with T4_COORD/T4_NPROC/T4_RANK as a cluster would start them, train
through `nn.train` on a dp2 mesh of gloo ranks, against one process and
the JAX package's run on one device (test_dist.py compares its two
processes with one of eight devices, at rtol 1e-5; the JAX package's
f32 sums run in another order than the port's, so that comparison holds
at nn.train's 1e-4, FUTURE_TRAINED's bound).

Run as a script (`python tests/test_torch_dist.py out.json`) this file is
the two-process case's worker, the counterpart of tests/dist_worker.py.
"""
import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_PROCS = 1e-5        # test_dist.py's: two processes against one
TOL_JAX = 1e-4          # one process against the JAX package's one device


def test_init_distributed_noop_without_env(monkeypatch):
    from tensorforth_tpu_torch.parallel import dist
    monkeypatch.delenv("T4_COORD", raising=False)
    assert dist.init_distributed() == (0, 1)


def test_init_distributed_calls_init_process_group(monkeypatch):
    """T4_COORD/T4_NPROC/T4_RANK become init_process_group's tcp address,
    world size and rank; a second call starts nothing"""
    import torch.distributed as tdist
    from tensorforth_tpu_torch.parallel import dist
    calls = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        calls.update(backend=backend, addr=init_method, n=world_size,
                     pid=rank)

    monkeypatch.setattr(tdist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "_initialized", False)
    monkeypatch.setenv("T4_COORD", "10.0.0.1:8476")
    monkeypatch.setenv("T4_NPROC", "4")
    monkeypatch.setenv("T4_RANK", "2")
    dist.init_distributed()
    assert calls == {"backend": "gloo", "addr": "tcp://10.0.0.1:8476",
                     "n": 4, "pid": 2}
    calls.clear()
    dist.init_distributed()
    assert calls == {}
    monkeypatch.setattr(dist, "_initialized", False)


def test_global_mesh_single_process_delegates():
    from tensorforth_tpu_torch.parallel.dist import make_global_mesh
    m = make_global_mesh(dp=1, tp=1)
    assert m.axis_names == ("dp", "tp") and m.shape == (1, 1)


def test_global_mesh_multi_host_layout():
    """a cluster of 4 hosts of 2 ranks each: dp runs across the hosts,
    tp within one (the hosts' ranks in turn); a model axis wider than a
    host is refused"""
    from tensorforth_tpu_torch.parallel.dist import global_layout
    hosts = ["h0", "h0", "h1", "h1", "h2", "h2", "h3", "h3"]
    assert global_layout(hosts, dp=4, m2=2) == list(range(8))
    mixed = ["h0", "h1", "h0", "h1", "h2", "h3", "h2", "h3"]
    assert global_layout(mixed, dp=4, m2=2) == [0, 2, 1, 3, 4, 6, 5, 7]
    with pytest.raises(ValueError, match="between hosts"):
        global_layout(hosts, dp=2, m2=4)


def test_local_batch_slice():
    from tensorforth_tpu_torch.parallel.dist import local_batch_slice
    assert local_batch_slice(64) == slice(0, 64)


# --- the two-process case -------------------------------------------------
class _Corpus:
    def __init__(self, data, labels):
        self._d, self._l = data, labels
        self.size = data.shape[0]

    def _read(self, s, n):
        return self._d[s:s + n], self._l[s:s + n]


class _DS:
    def __init__(self, data, labels, batch):
        self._corpus = _Corpus(data, labels)
        self.batch_sz = batch
        self._mean, self._scale = 0.0, 1.0


def _weights(model, numpy_of):
    """tests/dist_worker.py's weights: RandomState(7) over each layer's
    weight and bias slots"""
    rs = np.random.RandomState(7)
    for j in range(model.numel - 1):
        for g in model[j].grad[:2]:
            if g is None:
                break
            numpy_of(g, ((rs.rand(*g.shape).astype(np.float32) - 0.5)
                         * 0.2))


def _data():
    rs = np.random.RandomState(3)
    return rs.rand(16, 8, 16, 1).astype(np.float32), rs.randint(0, 4, 16)


def worker(out_path: str) -> None:
    """one process of the cluster (or the single one): tests/
    dist_worker.py's model and corpus through nn.train's engine under
    T4_MESH, {rank, nproc, loss, wsum} to out_path"""
    from tensorforth_tpu_torch.parallel.dist import init_distributed
    rank, nproc = init_distributed()
    from tensorforth_tpu_torch.models import zoo
    from tensorforth_tpu_torch.nn.train import train_epochs
    model = zoo.tiny_transformer(batch=8, seq=8, dim=16, heads=4, classes=4,
                                 layers=2, device="cpu")
    _weights(model, lambda g, a: g.set_numpy(a))
    data, labels = _data()
    loss = train_epochs(model, _DS(data, labels, 8), lr=0.01, epochs=2)
    wsum = float(sum(np.sum(np.abs(w.numpy())) for pl in model._params()
                     for w in pl))
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "nproc": nproc, "loss": float(loss),
                   "wsum": wsum}, f)


def early_worker(out_path: str) -> None:
    """a cluster whose rank 1 raises right after start-up while rank 0
    waits in an all-reduce: rank 0's wait ends with an error, it does not
    sit out the group's timeout"""
    import torch
    import torch.distributed as tdist
    from tensorforth_tpu_torch.parallel.dist import init_distributed
    rank, _ = init_distributed()
    if rank == 1:
        raise RuntimeError("rank 1 fails before its first collective")
    try:
        tdist.all_reduce(torch.ones(4))
        said = "returned"
    except RuntimeError:                # gloo: the peer's connection closed
        said = "raised"
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "all_reduce": said}, f)


def _cluster_env():
    """env_for(rank, nproc): the environment of one process of a cluster
    on a free localhost port (nproc 1: a single process)"""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    def env_for(rank, nproc):
        env = dict(os.environ)
        for k in ("T4_MAX_BATCH", "T4_COORD", "T4_MESH"):
            env.pop(k, None)
        env["PYTHONPATH"] = ROOT + ":" + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        if nproc > 1:
            env.update(T4_COORD=f"localhost:{port}", T4_NPROC=str(nproc),
                       T4_RANK=str(rank), T4_MESH="dp2")
        return env
    return env_for


def test_two_process_train_matches_single(tmp_path):
    """two processes form a cluster from T4_COORD/T4_NPROC/T4_RANK (gloo
    over tcp://localhost) and train on its dp2 mesh: their losses and
    weights agree, and agree with one process's run; that one with the
    JAX package's on one device"""
    import subprocess
    from tensorforth_tpu.models import tiny_transformer
    from tensorforth_tpu.nn.train import train_epochs
    env_for = _cluster_env()
    outs = [str(tmp_path / f"r{i}.json") for i in range(3)]
    procs = [subprocess.Popen([sys.executable, __file__, outs[i]],
                              env=env_for(i, 2 if i < 2 else 1),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(3)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace")
            for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i} failed:\n{logs[i][-2500:]}"
    r0, r1, one = (json.load(open(o)) for o in outs)
    assert (r0["nproc"], r1["nproc"], one["nproc"]) == (2, 2, 1)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["loss"] == r1["loss"], "ranks disagree on loss"
    assert r0["wsum"] == r1["wsum"], "ranks disagree on weights"
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=TOL_PROCS)
    np.testing.assert_allclose(r0["wsum"], one["wsum"], rtol=TOL_PROCS)
    jm = tiny_transformer(batch=8, seq=8, dim=16, heads=4, classes=4,
                          layers=2)
    _weights(jm, lambda g, a: g.replace_data(a))
    data, labels = _data()
    jl = train_epochs(jm, _DS(data, labels, 8), lr=0.01, epochs=2)
    jw = float(sum(np.sum(np.abs(np.asarray(w))) for pl in jm._params()
                   for w in pl))
    np.testing.assert_allclose(one["loss"], float(jl), rtol=TOL_JAX)
    np.testing.assert_allclose(one["wsum"], jw, rtol=TOL_JAX)


def test_a_rank_that_fails_early_does_not_hold_the_others(tmp_path):
    """rank 1 raises after start-up, rank 0 is then in an all-reduce: both
    exit well inside the group's timeout (launch.TIMEOUT_S), rank 1 with
    its error and rank 0 with the collective's, and nothing waits for the
    dead rank at exit"""
    import subprocess
    import time
    from tensorforth_tpu_torch.parallel import launch
    env_for = _cluster_env()
    outs = [str(tmp_path / f"r{i}.json") for i in range(2)]
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, __file__, "--early", outs[i]],
                              env=env_for(i, 2), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for i in range(2)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    took = time.monotonic() - t0
    assert took < launch.TIMEOUT_S / 10, f"the ranks took {took:.1f} s"
    assert procs[1].returncode != 0
    assert "rank 1 fails before its first collective" in logs[1]
    assert procs[0].returncode == 0, logs[0][-2500:]
    assert json.load(open(outs[0])) == {"rank": 0, "all_reduce": "raised"}


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "--early":
        early_worker(sys.argv[2])
    else:
        worker(sys.argv[1])
