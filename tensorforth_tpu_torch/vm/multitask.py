"""Multitasking words — task / rank / start / join / lock / unlock /
send / recv / bcast / pull (the port of tensorforth_tpu/vm/multitask.py).

Reference: src/vm/vm.h:62-79 + eforth.cpp:372-389 declare these behind
DO_MULTITASK but compile them out (the v1 device-resident VM pool was
retired).  Here they are functional: each task is a fresh VM sharing
the dictionary/pmem/MMU, with its own stacks, run on a host thread.
Message passing moves tagged DUs between task stacks through queues.
Device-level parallelism is SPMD (parallel/), not task threads.

On the card every task launches on the device's default stream (torch's
current stream is per thread, and a new thread's is the default one),
so a tensor sent from one VM to another is read in stream order.  A
task holds the capture lock around each word it runs (ForthVM.word_lock;
runtime/capture.py) but the words that wait on another VM (WAITING), so
it never launches while VM 0 captures a CUDA graph.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..runtime.capture import CAPTURE_LOCK

# the words a task runs outside the capture lock: they wait on another
# VM, which may need the lock to get on
WAITING = frozenset(("join", "lock", "recv", "pull"))

class Task:
    def __init__(self, tid: int, vm, pfa: int):
        self.tid = tid
        self.vm = vm
        self.pfa = pfa
        self.thread: threading.Thread | None = None
        self.inbox: queue.Queue = queue.Queue()
        self.done = threading.Event()


class TaskPool:
    _inst = None

    def __init__(self):
        self.tasks: dict[int, Task] = {}
        self.next_id = 1
        self.io_lock = threading.Lock()
        self.vm_pool: list = []              # the CLI's VM handle pool

    @classmethod
    def get(cls) -> "TaskPool":
        if cls._inst is None:
            cls._inst = TaskPool()
        return cls._inst

    def attach_pool(self, pool: list):
        """adopt the CLI's VM handle pool (reference ten4.cu:157-165
        vm_pool): `task` claims STOP pool VMs 1..N-1 before falling back
        to detached VMs, so the CLI's state tally reflects tasks"""
        self.vm_pool = pool

    def _claim_vm(self, parent_vm):
        from .vm import VMState
        for vm in self.vm_pool[1:]:
            if vm.state == VMState.STOP and not any(
                    t.vm is vm and not t.done.is_set()
                    for t in self.tasks.values()):
                vm.ss.clear()                # reset the recycled handle
                vm.rs.clear()
                vm.tos = np.float32(-1.0)
                vm.compile = False
                vm.state = VMState.HOLD      # claimed, not yet started
                vm.task_claimed = True       # the CLI's sweep must not
                return vm                    # resume() an unstarted task
        return type(parent_vm)(self.next_id & 0xF, parent_vm.sys)

    def create(self, parent_vm, pfa: int) -> int:
        tid = self.next_id
        self.next_id += 1
        child = self._claim_vm(parent_vm)
        t = Task(tid, child, pfa)
        self.tasks[tid] = t
        return tid

    def start(self, tid: int):
        t = self.tasks.get(tid)
        if t is None:
            return

        def run():
            from .vm import VMState
            try:
                t.vm.state = VMState.NEST
                t.vm.task_claimed = False
                t.vm.word_lock, t.vm.lock_free = CAPTURE_LOCK, WAITING
                t.vm.ip = 0
                t.vm.rs.push(np.float32(0.0))
                t.vm.ip = t.pfa
                t.vm.nest()
            finally:
                t.vm.word_lock = None
                t.vm.state = VMState.STOP
                t.done.set()

        t.thread = threading.Thread(target=run, daemon=True)
        t.thread.start()

    def join(self, tid: int):
        t = self.tasks.get(tid)
        if t and t.thread:
            t.thread.join()

    def send(self, tid: int, values: list):
        t = self.tasks.get(tid)
        if t:
            t.inbox.put(list(values))

    def recv(self, tid: int) -> list:
        t = self.tasks.get(tid)
        return t.inbox.get() if t else []

    def bcast(self, values: list):
        for t in self.tasks.values():
            t.inbox.put(list(values))

    def pull(self, tid: int, n: int) -> list:
        """pull n items from a stopped task's stack"""
        t = self.tasks.get(tid)
        if not t:
            return []
        t.done.wait()
        return [t.vm.POP() for _ in range(n)][::-1]


def register_multitask_words(dic):
    pool = TaskPool.get()

    def _task(vm):                       # ( w -- tid )
        w = vm.POPi()
        c = vm.dict[w]
        if c.udf:
            vm.PUSH(np.float32(pool.create(vm, c.pfa)))
        else:
            vm.sys.pstr("  ?colon word only\n")

    def _rank(vm):                       # ( -- id )
        vm.PUSH(np.float32(vm.id))

    def _start(vm):                      # ( tid -- )
        pool.start(vm.POPi())

    def _join(vm):                       # ( tid -- )
        pool.join(vm.POPi())

    def _lock(vm):
        pool.io_lock.acquire()

    def _unlock(vm):
        try:
            pool.io_lock.release()
        except RuntimeError:
            pass

    def _send(vm):                       # ( v1..vn n tid -- )
        tid = vm.POPi()
        n = vm.POPi()
        vals = [vm.POP() for _ in range(n)][::-1]
        pool.send(tid, vals)

    def _recv(vm):                       # ( -- v1..vn )
        t = next((t for t in pool.tasks.values() if t.vm is vm), None)
        vals = t.inbox.get() if t else []
        for v in vals:
            vm.PUSH(v)

    def _bcast(vm):                      # ( v1..vn n -- )
        n = vm.POPi()
        vals = [vm.POP() for _ in range(n)][::-1]
        pool.bcast(vals)

    def _pull(vm):                       # ( n tid -- v1..vn )
        tid = vm.POPi()
        n = vm.POPi()
        for v in pool.pull(tid, n):
            vm.PUSH(v)

    for nm, fn in [("task", _task), ("rank", _rank), ("start", _start),
                   ("join", _join), ("lock", _lock), ("unlock", _unlock),
                   ("send", _send), ("recv", _recv), ("bcast", _bcast),
                   ("pull", _pull)]:
        dic.add_code(nm, fn)
