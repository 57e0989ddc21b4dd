"""Global configuration of the PyTorch/CUDA port (the port's own copy of
tensorforth_tpu/config.py, limited to what the ported slices read;
mirrors reference src/ten4_config.h compile-time flags as runtime values).
"""
import os

import torch


class Config:
    # --- capability tiers (reference: T4_DO_OBJ / T4_DO_MATH / T4_DO_NN / T4_DO_TB)
    DO_OBJ  = True
    DO_MATH = True
    DO_NN   = True
    DO_TB   = True

    VM_COUNT = int(os.environ.get("T4_VM_COUNT", "1"))  # VM pool (T4_VM_COUNT)

    # --- sizing (reference: ten4_config.h)
    SS_SZ    = 64          # data stack depth        (T4_SS_SZ)
    RS_SZ    = 64          # return stack depth      (T4_RS_SZ)
    DICT_SZ  = 1024        # dictionary entries      (T4_DICT_SZ)
    NET_SZ   = 128         # max layers per model    (T4_NET_SZ)
    PMEM_SZ  = 1 << 16     # parameter memory bytes  (T4_PMEM_SZ=48K; we round to 64K)
    TFREE_SZ = 1024        # deferred-free list size (T4_TFREE_SZ)
    OSTORE_SZ = int(os.environ.get("T4_OSTORE_SZ",
                                   2 << 30))  # TLSF arena bytes
    # --- device arena ownership: T4_ARENA=1 backs tensor payloads with
    # ONE preallocated device buffer sub-allocated by the native TLSF
    # (reference mmu.cu:37-53 managed-arena model; mu/arena.py); default
    # off keeps payloads as tensors of PyTorch's caching allocator
    ARENA = bool(int(os.environ.get("T4_ARENA", "0")))

    # --- numerics
    # precision class of the f32-I/O GEMM kernels behind gemm2/gemm3
    # (ops/gemm.py): 'fast' = bf16 multiplicands into the tensor cores,
    # f32 accumulate; 'strict' = the 3-pass bf16 split, f32-class
    # accuracy.  Word-tier linalg and the interactive `@`/gemm/gemm1 ops
    # are ALWAYS f32-strict: their contract is the reference's 1e-5
    # verify-lines (ops/engine.py, ops/linalg.py).
    PRECISION = os.environ.get("T4_PRECISION", "fast")

    # --- serving (nn/serve.py)
    # KV cache STORAGE dtype: 'bfloat16' halves, 'int8' quarters the
    # per-step cache stream (int8 = symmetric per-vector scales, lossless
    # int8 -> bf16 load cast, scales folded into the f32 scores/softmax
    # weights); scores/softmax/output stay f32.  T4_DECODE_WIN=N sets
    # power-of-two windowed decode: exact (same ops over a smaller cache
    # prefix), on by default at 512; T4_DECODE_WIN=0 disables.
    KV_DTYPE = os.environ.get("T4_KV_DTYPE", "float32")
    DECODE_WIN = int(os.environ.get("T4_DECODE_WIN", "512"))

    DU_EPS = 1.0e-6        # epsilon compare (reference ten4_types.h:85)

    # --- printing (reference io/aio.h:80-82)
    PRINT_THRES = 10       # max cells per dimension before elision
    PRINT_EDGE  = 3        # edge items shown when eliding
    PRINT_PREC  = 4        # fixed decimals in tensor pretty-print

    # --- deterministic init for QA (reference ten4_config.h MM_DEBUG)
    MM_DEBUG = bool(int(os.environ.get("T4_MM_DEBUG", "0")))

    # --- dataset search roots: T4_DATA, ./data and ~/data (the JAX
    # package's list, less its absolute one); the loader's WARN line
    # prints them
    DATA_ROOTS = [
        os.environ.get("T4_DATA", ""),
        "./data",
        os.path.expanduser("~/data"),
    ]
    # allow the synthetic stand-in when corpus files are missing
    ALLOW_SYNTHETIC_DATA = bool(int(os.environ.get("T4_SYNTH_DATA", "1")))

    APP_NAME = "tensorForth-tpu"   # the model files' header (io/nnio.py)


def default_device() -> torch.device:
    """the device an entry point uses when the caller names none: the
    CUDA card.  There is no silent CPU fallback — a CPU run must ask for
    it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError("tensorforth_tpu_torch: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)
