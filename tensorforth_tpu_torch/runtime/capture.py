"""One process-wide lock around CUDA graph capture.

torch.cuda.graph captures in CUDA's global mode: while one thread
captures, a call from any other thread that may synchronise or allocate
(a kernel launch that grows the caching allocator, a device-to-host
copy) invalidates the capture.  The port captures on VM 0's thread
(nn/cycle.capture: the fused cycle, the trace chunks, nn.train and the
decoder's windows), while task VMs (vm/multitask.py) and the deferred
host-op worker (io/equeue.py) may touch the card from threads of their
own.  So every capture holds CAPTURE_LOCK, a task VM holds it around each
word it runs (but the words that wait on another VM), and the worker
holds it around each copy.  It is reentrant: a word that captures holds
it twice.
"""
from __future__ import annotations

import threading

CAPTURE_LOCK = threading.RLock()
