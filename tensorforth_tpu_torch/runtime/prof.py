"""The device profiler behind `prof.start`/`prof.stop` and T4_PROFILE
(the port's counterpart of the JAX package's jax.profiler hooks).
`start_trace`/`stop_trace` keep one trace a process, as jax.profiler
does, and word their errors as it does.

torch.profiler traces the host's operators and, where a card is there,
its kernels (CUPTI), and writes one Chrome trace under
<logdir>/plugins/profile/<run>/, the layout TensorBoard's profile plugin
reads (<logdir> is the TensorBoard run directory under -t, else
./t4_profile).
"""
from __future__ import annotations

import os
import time

import torch


class Profiler:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = None                 # the run directory, once stopped
        self._p = None

    def start(self):
        if self._p is not None:
            raise RuntimeError("a profiler trace is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        run = os.path.join(self.logdir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        p = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(run))
        p.start()
        self._p, self.path = p, run

    def stop(self) -> str:
        """end the trace and write it; returns its directory"""
        if self._p is None:
            raise RuntimeError("no profiler trace is running")
        p, self._p = self._p, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        p.stop()
        return self.path


_ACTIVE = None                   # the process's trace (start_trace)


def start_trace(logdir: str):
    """start the process's one trace into logdir (jax.profiler's rule)"""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("Profile has already been started. Only one "
                           "profile may be run at a time.")
    p = Profiler(logdir)
    p.start()
    _ACTIVE = p


def stop_trace() -> str:
    """end the process's trace and write it; returns its directory"""
    global _ACTIVE
    if _ACTIVE is None:
        raise RuntimeError("No profile started")
    p, _ACTIVE = _ACTIVE, None
    return p.stop()
