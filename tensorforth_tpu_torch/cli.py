"""ten4_torch CLI — option parsing and the REPL loop (the port of
tensorforth_tpu/cli.py).

Reference: src/ten4.{h,cu} + src/opt.h.  A pool of Config.VM_COUNT VMs
(T4_VM_COUNT) at the tier that Config.DO_OBJ and Config.DO_NN name (by
default the net level: eForth + tensor words + NN words); VM 0 reads the
input, the others are claimed by the `task` word (vm/multitask.py).
`-t/-r` open the TensorBoard writer (tb/summary.py), `--vu` the corpus
viewer (io/gui.py, io/vu.py).
"""
from __future__ import annotations

import argparse
import os
import sys as _sys
import time

import torch

from .config import Config, resolve_device
from .debug import Debug
from .mu.mmu import MMU
from .system import System
from .vm.vm import VMState, vm_factory


class TensorForth:
    def __init__(self, fin=None, fout=None, verbose: int = 0, device=None,
                 tb_logdir: str = None, tb_run_id: str = None):
        """`device` None means the package default, `cuda`, and raises
        without a GPU; name "cpu" to run there"""
        self.device = resolve_device(device)
        if os.environ.get("T4_COORD"):       # multi-host cluster start-up
            from .parallel.dist import init_distributed
            rank, nproc = init_distributed()
            if verbose:
                print(f"\\ distributed: process {rank}/{nproc}, "
                      f"{nproc} global ranks")
        self.sys = System.get_sys(fin, fout, verbose)
        self.sys.mu = MMU.get_mmu()
        self.sys.mu.device = self.device
        self.sys.db = Debug.get_db(self.sys)
        if tb_logdir and Config.DO_TB:
            from .tb.summary import Summary
            self.sys.tb = Summary(tb_logdir, tb_run_id)
        level = "net" if (Config.DO_OBJ and Config.DO_NN) else (
            "tensor" if Config.DO_OBJ else "forth")
        # VM handle pool (reference ten4.cu:157-196): T4_VM_COUNT VMs
        # sharing the dictionary/pmem/MMU, each with its own stacks.
        # Pool VMs 1..N-1 start STOP and are claimed by the `task` word,
        # which runs them on a host thread (vm/multitask.py).
        self.pool = [vm_factory(level, i, self.sys)
                     for i in range(max(1, Config.VM_COUNT))]
        self.vm = self.pool[0]
        for vm in self.pool:
            vm.init()                        # dict built once (id 0)
        self.vm.state = VMState.QUERY
        from .vm.multitask import TaskPool
        TaskPool.get().attach_pool(self.pool)   # replaces any stale pool
        # reference Debug::self_tests (ten4.cu:225): silent integrity
        # pass at every boot, summary at -v1, full dumps at -v2
        self.sys.db.self_tests(verbose)

    def _run_pool(self):
        """one dispatcher sweep (reference ten4.cu:188-196 run()): VM 0
        consumes the input line; HOLD VMs resume; NEST VMs are busy on
        their own thread and are skipped; returns per-VM ms"""
        dts = []
        for vm in self.pool:
            t0 = time.perf_counter()
            if (vm.state == VMState.HOLD
                    and not getattr(vm, "task_claimed", False)):
                vm.resume()
            elif vm.state == VMState.QUERY:
                vm.outer()
            dts.append((time.perf_counter() - t0) * 1e3)
        return dts

    def _tally(self):
        """VM state census (reference _ten4_tally, ten4.cu:64-76)"""
        cnt = [0, 0, 0, 0]
        for vm in self.pool:
            cnt[vm.state] += 1
        return cnt

    def more_job(self) -> bool:
        """true while any VM is not STOP (reference ten4.cu:181-184)"""
        return self._tally()[VMState.STOP] < len(self.pool)

    def run_line(self, line: str):
        self.sys.load_line(line)
        if len(self.pool) == 1:
            self.vm.outer()
        else:
            self._run_pool()
        self.sys.flush()
        self.sys.mu.sweep()

    def main_loop(self):
        """REPL: readline -> pool sweep -> flush -> sweep (+ per-line
        profile at trace, reference ten4.cu:199-220 per-VM event timing)"""
        while self.more_job():
            if not self.sys.readline():
                break
            dts = self._run_pool()
            if self.sys.trace:
                if len(self.pool) > 1:       # reference profile() VM.dt
                    cnt = self._tally()
                    self.sys.pstr(
                        "\\ VM.state[STOP,HOLD,QUERY,NEST]=[ "
                        + " ".join(str(c) for c in cnt) + " ] dt=[ "
                        + " ".join(f"{d:.2f}" for d in dts) + " ]\n")
                else:
                    self.sys.pstr(
                        f"\\ VM[{self.vm.id}] {dts[0]:.2f} ms\n")
            self.sys.flush()
            self.sys.mu.sweep()

    def teardown(self):
        if self.sys.tb:
            self.sys.tb.close()
        System.free_sys()
        MMU.free_mmu()
        Debug.free_db()
        from .io.aio import AIO
        AIO.free_io()


def _bench(m: int, k: int, n: int, device) -> str:
    """an MxKxN f32 GEMM through torch.matmul (the `@` word's product)"""
    g = torch.Generator(device=device)
    g.manual_seed(1)
    a = torch.rand((m, k), generator=g, device=device)
    b = torch.rand((k, n), generator=g, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    torch.matmul(a, b)
    sync()
    reps = max(1, (1 << 30) // max(1, 2 * m * k * n))
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.matmul(a, b)
    sync()
    dt = (time.perf_counter() - t0) / reps
    return (f"GEMM [{m},{k}]@[{k},{n}]: {dt * 1e3:.3f} ms "
            f"({2.0 * m * k * n / dt / 1e9:.1f} GFLOP/s)")


def _mesh_world() -> int:
    """the local ranks T4_MESH asks for (1: no mesh, already a rank, or a
    cluster's process that T4_COORD starts elsewhere)"""
    import math
    import torch.distributed as dist
    from .parallel.mesh import parse_spec
    spec = parse_spec(os.environ.get("T4_MESH", ""))
    if spec is None or os.environ.get("T4_COORD") or (
            dist.is_available() and dist.is_initialized()):
        return 1
    return math.prod(spec.values())


def _repl_rank(rank, world, text, verbose, device):
    """a rank of the REPL under T4_MESH: every rank reads the same input,
    rank 0 alone prints"""
    import io
    out = _sys.stdout if rank == 0 else io.StringIO()
    t4 = TensorForth(fin=io.StringIO(text), fout=out, verbose=verbose,
                     device=device)
    try:
        t4.main_loop()
    finally:
        out.flush()
        t4.teardown()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ten4_torch", description="tensorForth on PyTorch/CUDA")
    ap.add_argument("-v", "--verbose", type=int, default=0,
                    help="verbosity 0:off 1:trace 2:detailed")
    ap.add_argument("-d", "--device", default=None,
                    help="device: an ordinal of the CUDA cards, or a torch "
                         "device name such as cpu (default: cuda)")
    ap.add_argument("-t", "--tb-logdir", default=None,
                    help="TensorBoard log directory")
    ap.add_argument("-r", "--run-id", default=None,
                    help="TensorBoard run id")
    ap.add_argument("-h2", "--list-devices", action="store_true",
                    help="list devices and properties")
    ap.add_argument("--bench", nargs=3, type=int, metavar=("M", "K", "N"),
                    help="run an MxKxN GEMM benchmark and exit "
                         "(reference opt.h GEMM bench dims)")
    ap.add_argument("--vu", metavar="CORPUS", default=None,
                    help="interactive corpus viewer: an X11 window when "
                         "a display is reachable (io/gui.py, reference "
                         "src/vu/gui.cpp), else the ANSI terminal loop "
                         "(e.g. --vu mnist_train; reference src/vu/)")
    args = ap.parse_args(argv)

    if args.vu:
        from .io.gui import vu_window
        if vu_window(args.vu) < 0:           # no X display: terminal loop
            from .io.vu import vu_loop
            vu_loop(args.vu)
        return 0

    if args.list_devices:
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            print(f"  [{i}] {p.name} platform=cuda "
                  f"sm_{p.major}{p.minor} {p.total_memory >> 20} MiB")
        return 0

    device = args.device
    if device is not None and device.isdigit():
        device = f"cuda:{device}"

    if args.bench:
        print(_bench(*args.bench, resolve_device(device)))
        return 0

    world = _mesh_world()
    if world > 1:                            # T4_MESH: one process a rank
        from .parallel import launch
        launch.run(_repl_rank, world, _sys.stdin.read(), args.verbose,
                   device)
        return 0

    t4 = TensorForth(verbose=args.verbose, device=device,
                     tb_logdir=args.tb_logdir, tb_run_id=args.run_id)
    profile_dir = os.environ.get("T4_PROFILE")
    if profile_dir:                          # device-level tracing hook
        from .runtime import prof
        prof.start_trace(profile_dir)
    try:
        t4.main_loop()
    finally:
        if profile_dir:
            prof.stop_trace()
        t4.teardown()
    return 0


if __name__ == "__main__":
    _sys.exit(main())
