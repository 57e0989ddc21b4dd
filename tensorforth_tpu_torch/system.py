"""System singleton — the randomizer front-end of the port (the part of
tensorforth_tpu/system.py that model construction needs; IO streams,
tokenizer and the TensorBoard writer come with the REPL slice).

The seed stream is the JAX package's 63-bit LCG (system.py:77-95).  Each
``next_key()`` seeds a ``torch.Generator`` on the payload's device; the
numbers differ from ``jax.random``'s, so tests carry weights across with
weights.load_jax_params instead of relying on equal seeds.
"""
from __future__ import annotations

import os
import time

import torch


class System:
    _inst = None

    _LCG_MUL = 6364136223846793005
    _LCG_INC = 1442695040888963407

    def __init__(self):
        self._rng_seed = int(os.environ.get(
            "T4_SEED", int(time.time()) & 0x7FFFFFFF))

    # --- singleton ---------------------------------------------------------
    @classmethod
    def get_sys(cls) -> "System":
        if cls._inst is None:
            cls._inst = System()
        return cls._inst

    @classmethod
    def free_sys(cls):
        cls._inst = None

    # --- randomizer front-end (reference sys.cpp:77-95 / util.cu) ----------
    def seed(self, s: int):
        self._rng_seed = int(s) & 0x7FFFFFFF

    def next_key(self) -> int:
        """next seed of the LCG stream"""
        self._rng_seed = (self._rng_seed * self._LCG_MUL
                          + self._LCG_INC) & 0x7FFFFFFFFFFFFFFF
        return self._rng_seed

    def rand_fill(self, t, dist: str, bias: float = 0.0, scale: float = 1.0):
        """fill tensor object t with random values: v = scale*(bias + u),
        u ~ U[0,1) or N(0,1)"""
        g = torch.Generator(device=t.device)
        g.manual_seed(self.next_key())
        draw = torch.randn if dist == "normal" else torch.rand
        u = draw(t.shape, generator=g, dtype=torch.float32, device=t.device)
        t.replace_data(scale * (bias + u))
