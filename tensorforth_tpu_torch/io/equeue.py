"""Deferred host-op event queue (the port of tensorforth_tpu/io/equeue.py).

Reference: src/io/ostream.h:25-112 + sys.cpp:110-273 — the VM posts
host-side operations (TensorBoard records, file IO) into a binary event
queue that the system drains after the VM yields, so device compute and
host IO overlap.

A single daemon worker drains a FIFO of (work, device tensors) posts.
The port's tensors change in place (the optimizers step payloads, cycle
buffers are replayed), so a post never hands the worker a live payload:
the poster passes tensors of its own making (a clone, or a histogram or
tile computed from the payload at post time) and, on the card, records
a CUDA event on its stream behind them.  The worker copies them to the
host on a side stream that waits on that event only, then runs the work
on the host arrays.  A single worker keeps the reference's strict
ordering: event files are byte-identical to the synchronous path's.
`flush` (the close paths) joins the queue.

T4_SYNC_IO=1 runs every post inline, on the poster's thread.
"""
from __future__ import annotations

import os
import queue
import threading

import torch

from ..runtime.capture import CAPTURE_LOCK


def _host(ts) -> list:
    return [t.detach().cpu().numpy() for t in ts]


class EventQueue:
    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._sync = bool(int(os.environ.get("T4_SYNC_IO", "0")))
        self._side = None            # the worker's copy stream (the card)
        self.errors: list[str] = []

    def _ensure(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="t4-equeue")
            self._worker.start()

    def _run(self):
        while True:
            fn, dev, ev = self._q.get()
            try:
                fn(*self._copy(dev, ev))
            except Exception as ex:              # noqa: BLE001
                self.errors.append(f"{type(ex).__name__}: {ex}")
            finally:
                self._q.task_done()

    def _copy(self, dev, ev) -> list:
        """the posted tensors on the host.  On the card the copy runs on
        the worker's own stream after the poster's event, so it waits for
        the work that made them and for nothing enqueued later; it holds
        the capture lock, since a copy may not run while a CUDA graph is
        being captured (runtime/capture.py)"""
        if ev is None:
            return _host(dev)
        with CAPTURE_LOCK:
            if self._side is None:
                self._side = torch.cuda.Stream(dev[0].device)
            with torch.cuda.stream(self._side):
                self._side.wait_event(ev)
                return _host(dev)

    def post(self, fn, *dev):
        """enqueue fn(*host arrays of dev); runs inline under
        T4_SYNC_IO=1.  dev are tensors that only this post holds"""
        if self._sync:
            fn(*_host(dev))
            return
        ev = None
        if any(t.is_cuda for t in dev):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev[0].device))
        self._ensure()
        self._q.put((fn, dev, ev))

    def pending(self) -> int:
        """posts not yet written (the backlog)"""
        return self._q.unfinished_tasks

    def flush(self):
        """drain every posted op (the reference's sys->flush contract)"""
        if self._worker is not None:
            self._q.join()
        if self.errors:
            errs, self.errors = self.errors, []
            raise RuntimeError("deferred host ops failed: "
                               + "; ".join(errs[:4]))
