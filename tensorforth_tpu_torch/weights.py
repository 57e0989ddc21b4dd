"""Carry parameters and training state into and out of a port model.

``load_jax_params(model, params)`` takes the per-layer parameter tuples
of a model with the same ``_program()`` — the JAX package's
``model._params()`` converted to numpy, or another port model's
``_params()`` — and writes them into ``model``'s weight slots.

``dump_state(model)`` and ``load_state(model, state)`` carry a whole
training state: one entry per trainable slot, in the order of the JAX
package's ``Model._trainables()`` (each parametered layer's weight slot,
then its bias slot), holding the weight ``w`` (grad[s]), its gradient
``dw`` (grad[s+2]) and the optimizer's moments ``m`` (mtum[s]) and ``v``
(mtum[s+2]) as numpy arrays in their storage shapes, or None where a slot
is not allocated.
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


STATE_KEYS = ("w", "dw", "m", "v")


def _state_slots(t, s):
    """the Tensor objects behind one trainable slot's state, by key; SGD
    without momentum aliases the moment slot to the weight: no moment"""
    m = t.mtum[s]
    return {"w": t.grad[s], "dw": t.grad[s + 2],
            "m": None if m is t.grad[s] else m, "v": t.mtum[s + 2]}


def dump_state(model):
    """the model's training state as numpy arrays (see the module
    docstring for the order and the keys)"""
    return [{k: None if x is None else x.ensure_data().cpu().numpy().copy()
             for k, x in _state_slots(t, s).items()}
            for t, s in model._trainables()]


def load_state(model, state):
    """write a training state (dump_state's layout, from either package)
    into `model`; moment slots the model has not allocated yet are
    allocated.  A key that is None or missing leaves its slot as it is.
    Raises ValueError when the number of entries or any array's shape
    differs from the model's; nothing is written then."""
    tr = model._trainables()
    if len(state) != len(tr):
        raise ValueError(f"load_state: {len(state)} entries given, model "
                         f"has {len(tr)} trainable slots")
    staged = []
    for j, ((t, s), entry) in enumerate(zip(tr, state)):
        shape = t.grad[s].shape
        for key in STATE_KEYS:
            a = entry.get(key)
            if a is None:
                continue
            a = np.array(a, dtype=np.float32)   # own, writable copy
            if a.shape != shape:
                raise ValueError(f"load_state: entry {j} '{key}' shape "
                                 f"{a.shape} != {shape}")
            staged.append((t, s, key, a))
    for t, s, key, a in staged:
        slot = _state_slots(t, s)[key]
        if slot is None:               # a moment not allocated yet
            slot = model._T4(*t.grad[s].shape)
            t.mtum[s if key == "m" else s + 2] = slot
        slot.set_numpy(a)
    return model
