"""Carry parameters into a port model.

``load_jax_params(model, params)`` takes the per-layer parameter tuples
of a model with the same ``_program()`` — the JAX package's
``model._params()`` converted to numpy, or another port model's
``_params()`` — and writes them into ``model``'s weight slots.
"""
from __future__ import annotations

import numpy as np
import torch


def load_jax_params(model, params, program=None):
    """write params[j] into layer j of `model`.  Raises ValueError when
    the layer count, a layer's slot count or any array's shape differs
    from the model's, or, if `program` is given, when it is not the
    model's own _program() (kinds, options, shapes)."""
    mine = model._program()
    if program is not None and tuple(program) != mine:
        raise ValueError(f"load_jax_params: program mismatch\n"
                         f"  given: {tuple(program)}\n  model: {mine}")
    have = model._params()
    if len(params) != len(have):
        raise ValueError(f"load_jax_params: {len(params)} layers given, "
                         f"model has {len(have)}")
    staged = []
    for j, (src, dst) in enumerate(zip(params, have)):
        if len(src) != len(dst):
            raise ValueError(f"load_jax_params: layer {j} has {len(dst)} "
                             f"parameter slots, {len(src)} given")
        for i, (a, d) in enumerate(zip(src, dst)):
            t = a if isinstance(a, torch.Tensor) else torch.tensor(
                np.asarray(a))
            if tuple(t.shape) != tuple(d.shape):
                raise ValueError(f"load_jax_params: layer {j} shape "
                                 f"{tuple(t.shape)} != {tuple(d.shape)}")
            staged.append((model[j].grad[i], t))
    # every check passed: write (nothing is half-loaded on a mismatch)
    for slot, t in staged:
        slot.replace_data(t)
    return model
