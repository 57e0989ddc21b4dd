"""ten4_torch CLI — option parsing and the REPL loop (the port of
tensorforth_tpu/cli.py).

Reference: src/ten4.{h,cu} + src/opt.h.  One VM, at the tier that
Config.DO_OBJ and Config.DO_NN name (by default the net level: eForth +
tensor words + NN words).
Not ported yet: the VM pool and task words, the TensorBoard writer, the
corpus viewer.
"""
from __future__ import annotations

import argparse
import sys as _sys
import time

import torch

from .config import Config, resolve_device
from .debug import Debug
from .mu.mmu import MMU
from .system import System
from .vm.vm import VMState, vm_factory


class TensorForth:
    def __init__(self, fin=None, fout=None, verbose: int = 0, device=None):
        """`device` None means the package default, `cuda`, and raises
        without a GPU; name "cpu" to run there"""
        self.device = resolve_device(device)
        self.sys = System.get_sys(fin, fout, verbose)
        self.sys.mu = MMU.get_mmu()
        self.sys.mu.device = self.device
        self.sys.db = Debug.get_db(self.sys)
        level = "net" if (Config.DO_OBJ and Config.DO_NN) else (
            "tensor" if Config.DO_OBJ else "forth")
        self.vm = vm_factory(level, 0, self.sys)
        self.vm.init()
        self.vm.state = VMState.QUERY
        # reference Debug::self_tests (ten4.cu:225): silent integrity
        # pass at every boot, summary at -v1, full dumps at -v2
        self.sys.db.self_tests(verbose)

    def more_job(self) -> bool:
        """true while the VM is not STOP (reference ten4.cu:181-184)"""
        return self.vm.state != VMState.STOP

    def _run_vm(self) -> float:
        """one dispatcher sweep (reference ten4.cu:188-196 run()): a HOLD
        VM resumes, a QUERY VM consumes the input line; returns its ms"""
        t0 = time.perf_counter()
        if self.vm.state == VMState.HOLD:
            self.vm.resume()
        elif self.vm.state == VMState.QUERY:
            self.vm.outer()
        return (time.perf_counter() - t0) * 1e3

    def run_line(self, line: str):
        self.sys.load_line(line)
        self.vm.outer()
        self.sys.flush()
        self.sys.mu.sweep()

    def main_loop(self):
        """REPL: readline -> VM -> flush -> sweep (+ per-line time at
        trace, reference ten4.cu:199-220)"""
        while self.more_job():
            if not self.sys.readline():
                break
            dt = self._run_vm()
            if self.sys.trace:
                self.sys.pstr(f"\\ VM[{self.vm.id}] {dt:.2f} ms\n")
            self.sys.flush()
            self.sys.mu.sweep()

    def teardown(self):
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


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ten4_torch", description="tensorForth on PyTorch/CUDA")
    ap.add_argument("-v", "--verbose", type=int, default=0,
                    help="verbosity 0:off 1:trace 2:detailed")
    ap.add_argument("-d", "--device", default=None,
                    help="device: an ordinal of the CUDA cards, or a torch "
                         "device name such as cpu (default: cuda)")
    ap.add_argument("-h2", "--list-devices", action="store_true",
                    help="list devices and properties")
    ap.add_argument("--bench", nargs=3, type=int, metavar=("M", "K", "N"),
                    help="run an MxKxN GEMM benchmark and exit "
                         "(reference opt.h GEMM bench dims)")
    args = ap.parse_args(argv)

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

    t4 = TensorForth(verbose=args.verbose, device=device)
    try:
        t4.main_loop()
    finally:
        t4.teardown()
    return 0


if __name__ == "__main__":
    _sys.exit(main())
