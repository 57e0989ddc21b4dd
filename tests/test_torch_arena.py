"""The device arena (`T4_ARENA=1`, mu/arena.py): test_arena.py's nine
cases through both packages on the CPU.  In the port each tensor payload
is a view of the one pool at its TLSF offset (the JAX package keeps
`data` None and reads the slot); the word transcripts of the two are
equal, `mstat` prints `Ostore(TLSF:owner)` with the same TLSF numbers,
and the chunk case holds test_arena's own bounds (losses 2e-5, weights
1e-5) against the port's per-word control."""
import ctypes

import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    MODEL, models, pin, same_data_roots, snap, t4p)
from tests.test_torch_chunk import LOOP, run_epochs
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture()
def arena_on(monkeypatch):
    """both packages' MMUs own a 16 MB pool (test_arena's size)"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu_torch.config import Config
    for cfg in (JConfig, Config):
        monkeypatch.setattr(cfg, "ARENA", True)
        monkeypatch.setattr(cfg, "OSTORE_SZ", 1 << 24)


@pytest.fixture()
def t4a(arena_on, t4):
    return t4


@pytest.fixture()
def t4pa(arena_on, t4p):
    assert t4p.sys.mu.arena is not None
    return t4p


def both(t4a, t4pa, text):
    return t4pa.forth(text), t4a.forth(text)


def _pool_view(mmu, t):
    """the payload is the pool's view at the tensor's own offset"""
    d = t.ensure_data()
    return (mmu.arena.owns(d)
            and d.data_ptr() == mmu.arena.buf.data_ptr() + 4 * t.aoff)


def test_arena_is_bound(t4a, t4pa):
    t4pa.forth("2 3 matrix{ 1 2 3 4 5 6 } constant am")
    t4pa.forth("am")
    mmu = t4pa.sys.mu
    t = mmu.du2obj(t4pa.vm.tos)
    assert t.aoff is not None and _pool_view(mmu, t)
    np.testing.assert_array_equal(t.numpy(), [[1, 2, 3], [4, 5, 6]])
    t4a.forth("2 3 matrix{ 1 2 3 4 5 6 } constant am")
    t4a.forth("am")
    jt = t4a.sys.mu.du2obj(t4a.vm.tos)
    assert jt.aoff == t.aoff                  # one TLSF, one sequence


def test_arena_word_math_matches(t4a, t4pa):
    for line in ("abort 2 3 matrix{ 1 2 3 4 5 6 } 3 2 matrix ones @ .",
                 "abort 2 2 matrix ones 2 *= 0.5 *= .",
                 "abort 2 2 matrix{ 1 2 3 4 } 2 2 matrix{ 10 20 30 40 } += .",
                 "abort 3 vector{ 1 2 3 } sum .",
                 "abort 2 2 matrix{ 1 2 3 4 } 1 - 2 / 3 swap / ."):
        got, want = both(t4a, t4pa, line)
        assert got == want, line
        assert "ERROR" not in got


def test_arena_zeros_fill(t4a, t4pa):
    got, want = both(t4a, t4pa,
                     "abort 2 2 matrix zeros . 2 2 matrix ones 7 fill .")
    assert got == want
    assert "+0.0000 +0.0000" in got and "+7.0000 +7.0000" in got


def test_arena_mstat_owner(t4a, t4pa):
    """the Ostore line is the same TLSF's; the owner line counts the
    pool's payloads against the live tensors' bytes"""
    line = "2 2 matrix ones 3 vector{ 1 2 3 } 4 4 matrix zeros mstat"
    got, want = both(t4a, t4pa, line)
    ost = [ln for ln in got.splitlines() if "Ostore" in ln]
    assert "TLSF:owner" in ost[0]
    assert ost == [ln for ln in want.splitlines() if "Ostore" in ln]
    own, other = t4pa.sys.mu.payloads()
    live = sum(o.numel * 4 for o in t4pa.sys.mu._objs.values()
               if not (o.is_model() or o.is_future()))
    assert sum(own) + sum(other) == live and sum(own) == live
    assert f"pool-owned[{len(own)}]={sum(own)}B torch-owned[0]=0B" in got


def test_arena_fragmentation_stress(t4pa):
    """test_arena's churn on the port's MMU: the TLSF stays consistent,
    survivors keep their payloads, everything frees back, and a large
    slot spanning the coalesced space serves"""
    mmu = t4pa.sys.mu
    rs = np.random.RandomState(0)
    live = []
    for step in range(400):
        if live and rs.rand() < 0.5:
            mmu.free_obj(live.pop(rs.randint(len(live))))
        else:
            n = int(rs.randint(1, 2000))
            t = mmu.tensor(n)
            t.replace_data(np.full((n,), float(step), np.float32))
            live.append(t)
        assert mmu._tlsf.t4_tlsf_check() == 0, f"arena corrupt at {step}"
    for t in live[:10]:
        v = t.numpy()
        assert np.all(v == v.reshape(-1)[0])
        assert _pool_view(mmu, t)
    for t in live:
        mmu.free_obj(t)
        assert t.aoff is None and t.data is None   # no view outlives it
    st = (ctypes.c_uint64 * 5)()
    mmu._tlsf.t4_tlsf_status(st)
    assert st[1] == 0, f"leak: used={st[1]}"
    big = mmu.tensor(1 << 21)
    big.replace_data(np.ones((1 << 21,), np.float32))
    assert big.aoff is not None and float(big.numpy()[0]) == 1.0


def test_arena_inplace_no_realloc(t4a, t4pa):
    """in-place word ops write the pool: its buffer never moves, and the
    tensor's view stays where its slot is"""
    mmu = t4pa.sys.mu
    p0 = mmu.arena.pointer()
    for inst in (t4a, t4pa):
        inst.forth("2 2 matrix{ 1 2 3 4 } constant ip0")
        inst.forth("ip0 2 *= drop")
    got, want = both(t4a, t4pa, "ip0 ip0 += .")
    assert got == want
    assert "+4.0000 +8.0000" in got and "+12.0000 +16.0000" in got
    assert mmu.arena.pointer() == p0


def test_arena_model_training_runs(t4a, t4pa, monkeypatch):
    """model parameters in the pool: forward/backprop/adam print the JAX
    package's loss"""
    monkeypatch.setenv("T4_MAX_BATCH", "2")
    monkeypatch.setenv("T4_NO_FUSE", "1")
    monkeypatch.setenv("T4_NO_MACRO", "1")
    setup = ("0 trace\n8 28 28 1 nn.model\n"
             "flatten 16 linear relu 10 linear softmax\nconstant amdl\n"
             "amdl batchsize dataset mnist_train constant adst")
    both(t4a, t4pa, setup)
    got, want = both(t4a, t4pa,
                     "amdl adst forward loss.ce . backprop 0.01 nn.adam drop")
    v = float(got.strip().split()[0])
    assert 0.0 < v < 50.0
    assert got == want


def test_arena_dataset_rebinds_into_pool(t4a, t4pa, monkeypatch):
    """a dataset learns its shape on its first fetch: its slot is taken
    again at the batch's size and the batch is the pool's view there"""
    monkeypatch.setenv("T4_MAX_BATCH", "2")
    mmu = t4pa.sys.mu
    t4pa.forth("0 trace\n8 28 28 1 nn.model flatten 10 linear softmax "
               "constant rdm\nrdm batchsize dataset mnist_train constant rdd")
    t4pa.forth("rdd rewind drop rdd fetch drop")
    ds = next(o for o in mmu._objs.values() if o.is_dataset())
    assert ds.shape == (8, 28, 28, 1)
    assert ds.aoff is not None, "dataset batch not bound into the pool"
    assert mmu._regsz[ds.oid] == 8 * 28 * 28 * 4
    assert ds._fetch_spec is None             # fetched eagerly
    assert _pool_view(mmu, ds)
    a = ds.numpy()
    assert a.shape == (8, 28, 28, 1) and np.any(a != 0.0)
    out = t4pa.forth("rdm rdd forward drop backprop 0.01 nn.adam drop "
                     "rdd fetch drop rdm rdd forward drop drop")
    assert "ERROR" not in out


def test_arena_training_excludes_chunking_but_matches(t4pa, monkeypatch):
    """under the arena a batch is fetched eagerly into the pool, so no
    corpus offset is left for a trace chunk: chunking stays off, and the
    default path matches the per-word control from the same weights
    (test_arena's bounds)"""
    from tensorforth_tpu_torch.nn import cycle
    monkeypatch.setenv("T4_MAX_BATCH", "6")
    monkeypatch.setenv("T4_NO_FUSE", "1")
    t4pa.forth(MODEL.format(name="ak", drop=""))
    s = snap(models(t4pa)[-1])
    t4pa.forth(LOOP.format(v="ak"))
    ha, la, wa = run_epochs(t4pa, "ak", 2)

    monkeypatch.setenv("T4_NO_FUSE", "0")
    monkeypatch.setenv("T4_CHUNK", "3")
    t4pa.forth(MODEL.format(name="al", drop=""))
    ml = models(t4pa)[-1]
    pin(ml, s)
    t4pa.forth(LOOP.format(v="al"))
    cycle.reset_counts()
    hb, lb, wb = run_epochs(t4pa, "al", 2)
    assert cycle.COUNTS["chunks"] == 0, "chunking engaged under the arena"
    assert ml._chunk is None
    assert ha == hb
    assert abs(float(la) - float(lb)) < 2e-5
    for i, (a, b) in enumerate(zip(wa, wb)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                   err_msg=f"param {i} arena != per-word")
