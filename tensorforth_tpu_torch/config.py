"""Global configuration of the PyTorch/CUDA port (the port's own copy of
tensorforth_tpu/config.py, limited to what the ported slices read).
"""
import os

import torch


class Config:
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

    # --- deterministic init for QA (reference ten4_config.h MM_DEBUG)
    MM_DEBUG = bool(int(os.environ.get("T4_MM_DEBUG", "0")))


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
