"""The port's VM pool and task words (tensorforth_tpu_torch/vm/multitask.py
and the pool of cli.py) on the CPU, against the JAX package's: the cases
of test_multitask.py and test_vmpool.py through both REPLs, the capture
lock a task holds around its words (runtime/capture.py), and a stress
run of tasks that share the MMU.
"""
import io
import os
import sys
import time

import pytest

from tests.test_torch_repl import t4p  # noqa: F401  (fixture)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TIMEOUT = 60          # seconds any join or wait here may take


def _port_pool(monkeypatch, n=4):
    from tensorforth_tpu_torch.cli import TensorForth
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.debug import Debug
    from tensorforth_tpu_torch.io.aio import AIO
    from tensorforth_tpu_torch.mu.mmu import MMU
    from tensorforth_tpu_torch.system import System
    monkeypatch.setattr(Config, "VM_COUNT", n)
    os.environ.setdefault("T4_SEED", "42")
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf, device="cpu")
    inst.capture = buf

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    inst.forth = run
    return inst


def _jax_pool(monkeypatch, n=4):
    from tensorforth_tpu.cli import TensorForth
    from tensorforth_tpu.config import Config
    from tensorforth_tpu.debug import Debug
    from tensorforth_tpu.io.aio import AIO
    from tensorforth_tpu.mu.mmu import MMU
    from tensorforth_tpu.system import System
    monkeypatch.setattr(Config, "VM_COUNT", n)
    os.environ.setdefault("T4_SEED", "42")
    for free in (System.free_sys, MMU.free_mmu, Debug.free_db, AIO.free_io):
        free()
    buf = io.StringIO()
    inst = TensorForth(fin=io.StringIO(""), fout=buf)
    inst.capture = buf

    def run(script: str) -> str:
        start = buf.tell()
        for line in script.split("\n"):
            inst.run_line(line)
        return buf.getvalue()[start:]

    inst.forth = run
    return inst


@pytest.fixture()
def t4pool(monkeypatch):
    """a port REPL on the CPU with a 4-VM pool (Config.VM_COUNT patched as
    an attribute: T4_VM_COUNT is read once, when config.py is imported)"""
    inst = _port_pool(monkeypatch)
    yield inst
    inst.teardown()


# test_multitask.py's REPL cases, through both REPLs
CASES = {
    "rank": ["rank ."],
    "task_start_join_pull": [": worker 6 7 * ;",
                             "' worker task constant T1",
                             "T1 start", "T1 join", "1 T1 pull ."],
    "send_recv": [": echo recv 2 * ;", "' echo task constant T2",
                  "21 1 T2 send", "T2 start", "T2 join", "1 T2 pull ."],
    "lock_unlock": ["lock 1 2 + . unlock"],
    "bcast": [": two recv recv + ;", "' two task constant T3",
              "5 1 bcast 6 1 bcast", "T3 start T3 join 1 T3 pull ."],
    "tensor_task": [": tt 2 2 matrix ones 3 *= ;", "' tt task constant T4",
                    "T4 start T4 join 1 T4 pull ."],
    "not_a_colon_word": ["' dup task"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_task_words_match_jax(t4, t4p, name):
    lines = CASES[name]
    want = "".join(t4.forth(ln) for ln in lines)
    got = "".join(t4p.forth(ln) for ln in lines)
    assert got == want
    assert "?" not in got.replace("?colon", "") or name == "not_a_colon_word"


def test_pool_created_with_vm_count(t4pool):
    from tensorforth_tpu_torch.vm.vm import VMState
    assert len(t4pool.pool) == 4
    assert t4pool.vm is t4pool.pool[0]
    assert t4pool.pool[0].state == VMState.QUERY
    assert all(vm.state == VMState.STOP for vm in t4pool.pool[1:])
    assert [vm.id for vm in t4pool.pool] == [0, 1, 2, 3]
    d0 = t4pool.pool[0].dict
    assert all(vm.dict is d0 for vm in t4pool.pool[1:])


def test_tally_and_more_job(t4pool):
    from tensorforth_tpu_torch.vm.vm import VMState
    cnt = t4pool._tally()
    assert cnt[VMState.STOP] == 3 and cnt[VMState.QUERY] == 1
    assert t4pool.more_job()
    t4pool.forth("bye")
    assert not t4pool.more_job()


def test_task_claims_pool_vm(t4pool):
    """`task` claims a STOP pool VM and gives it back at its end"""
    from tensorforth_tpu_torch.vm.multitask import TaskPool
    from tensorforth_tpu_torch.vm.vm import VMState
    pool = TaskPool.get()
    assert pool.vm_pool is t4pool.pool
    t4pool.forth(": worker 6 7 * ;")
    t4pool.forth("' worker task constant T1")
    claimed = [vm for vm in t4pool.pool[1:] if vm.state != VMState.STOP]
    assert len(claimed) == 1 and claimed[0].task_claimed
    out = t4pool.forth("T1 start T1 join 1 T1 pull .")
    assert "42 " in out
    assert claimed[0].state == VMState.STOP
    assert claimed[0].word_lock is None       # recycled without the lock


def test_pool_exhaustion_falls_back_to_detached(t4pool):
    from tensorforth_tpu_torch.vm.multitask import TaskPool
    t4pool.forth(": w8 1 2 + drop ;")
    for i in range(5):
        t4pool.forth(f"' w8 task constant X{i}")
    vms = [t.vm for t in TaskPool.get().tasks.values()]
    assert sum(1 for v in vms if v in t4pool.pool) == 3
    assert len(vms) >= 5
    out = t4pool.forth("X0 start X1 start X2 start X3 start X4 start "
                       "X0 join X1 join X2 join X3 join X4 join 1 1 + .")
    assert "2 " in out


def test_pool_trace_line_matches_jax(monkeypatch):
    """main_loop's trace prints the reference's state census and per-VM
    times (ten4.cu:199-220) when the pool holds more than one VM"""
    texts = []
    for make in (_jax_pool, _port_pool):
        inst = make(monkeypatch)
        try:
            inst.sys.fin = io.StringIO("1 2 + .\nbye\n")
            inst.forth("1 trace")
            inst.main_loop()
            texts.append(inst.capture.getvalue())
        finally:
            inst.teardown()
    for text in texts:
        assert "VM.state[STOP,HOLD,QUERY,NEST]=[ 3 0 1 0 ]" in text
        assert "dt=[ " in text
    census = [[ln.split(" dt=")[0] for ln in t.splitlines()] for t in texts]
    assert census[0] == census[1]


def test_single_vm_pool_unchanged(t4p):
    t4p.sys.fin = io.StringIO("1 2 + .\nbye\n")
    t4p.forth("1 trace")
    t4p.main_loop()
    assert "VM[0]" in t4p.capture.getvalue()


@pytest.mark.parametrize("n", [1, 4])
def test_main_loop_continues_after_udf_word(monkeypatch, n):
    """a finished top-level colon word hands the VM back to QUERY, on
    one VM and through the pool's dispatcher"""
    from tensorforth_tpu_torch.vm.vm import VMState
    inst = _port_pool(monkeypatch, n)
    try:
        inst.sys.fin = io.StringIO(": cube dup dup * * ;\n3 cube .\n"
                                   "4 cube .\nbye\n")
        inst.main_loop()
        out = inst.capture.getvalue()
        assert "27 " in out and "64 " in out
        assert inst.vm.state == VMState.STOP
    finally:
        inst.teardown()


# ---------------------------------------------------------------------------
# the capture lock (runtime/capture.py)
# ---------------------------------------------------------------------------
def _task_done(t4p, name):
    from tensorforth_tpu_torch.vm.multitask import TaskPool
    tid = int(float(t4p.forth(f"{name} .").split()[0]))
    return TaskPool.get().tasks[tid].done


def test_task_waits_for_a_capture(t4p):
    """while VM 0 captures (holds CAPTURE_LOCK), a task that runs tensor
    words does not get past its first word; once the capture ends it runs
    on and its result is the one the same words give run in turn"""
    from tensorforth_tpu_torch.runtime.capture import CAPTURE_LOCK
    want = t4p.forth("abort 4 4 matrix ones 3 *= dup @ sum . cr")
    t4p.forth(": tw 4 4 matrix ones 3 *= dup @ sum ;")
    t4p.forth("' tw task constant TW")
    done = _task_done(t4p, "TW")
    with CAPTURE_LOCK:
        t4p.forth("TW start")
        assert not done.wait(0.5), "the task ran during the capture"
    assert done.wait(TIMEOUT)
    got = t4p.forth("TW join 1 TW pull . cr")
    assert got.split()[0] == want.split()[0] == "576"


def test_waiting_words_run_outside_the_lock(t4p):
    """a task blocked in `recv` does not hold the capture lock, so VM 0
    can capture while it waits"""
    from tensorforth_tpu_torch.runtime.capture import CAPTURE_LOCK
    t4p.forth(": echo recv 2 * ;")
    t4p.forth("' echo task constant TE")
    done = _task_done(t4p, "TE")
    t4p.forth("TE start")
    time.sleep(0.2)                          # the task sits in recv
    assert CAPTURE_LOCK.acquire(timeout=TIMEOUT)
    CAPTURE_LOCK.release()
    t4p.forth("21 1 TE send")
    assert done.wait(TIMEOUT)
    assert "42 " in t4p.forth("TE join 1 TE pull .")


def test_capture_holds_the_lock(monkeypatch):
    """nn/cycle.capture (every CUDA graph the port captures) runs its
    warm-up and capture under CAPTURE_LOCK"""
    from tensorforth_tpu_torch.nn import cycle
    from tensorforth_tpu_torch.runtime.capture import CAPTURE_LOCK
    seen = []
    monkeypatch.setattr(cycle, "_capture", lambda *a: seen.append(
        CAPTURE_LOCK._is_owned()))
    cycle.capture(None, None, None)
    assert seen == [True] and not CAPTURE_LOCK._is_owned()


def test_tasks_share_the_mmu_under_stress(t4p):
    """twelve tasks (more than the cores) make and drop tensors on the
    shared MMU with a short switch interval: no update of the object
    table or of the TLSF accounting is lost"""
    import ctypes
    mmu = t4p.sys.mu
    st = (ctypes.c_uint64 * 5)()
    mmu._tlsf.t4_tlsf_status(st)
    used0, objs0, id0 = st[1], len(mmu._objs), mmu._next_id
    t4p.forth(": churn 30 for 3 3 matrix ones 2 *= drop next ;")
    names = [f"S{i}" for i in range(12)]
    for nm in names:
        t4p.forth(f"' churn task constant {nm}")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t4p.forth(" ".join(f"{nm} start" for nm in names))
        for nm in names:
            assert _task_done(t4p, nm).wait(TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    t4p.forth(" ".join(f"{nm} join" for nm in names))
    mmu.sweep()
    mmu._tlsf.t4_tlsf_status(st)
    assert len(mmu._objs) == objs0 and st[1] == used0
    assert mmu._tlsf.t4_tlsf_check() == 0
    assert mmu._next_id - id0 == 12 * 31     # each task's 31 tensors
