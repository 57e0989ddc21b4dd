"""Model zoo — the port of tensorforth_tpu/models/zoo.py (the LM family
the serving slice runs; the CNN/GAN/MoE nets come with their slices).
"""
from __future__ import annotations

from ..mu.mmu import MMU
from ..nn.ntypes import Layer


def _new_model(n, h, w, c, device=None):
    mmu = MMU.get_mmu()
    m = mmu.model(device=device)
    m.npush(mmu.tensor(n, h, w, c, device=m.device))
    return m


def tiny_lm(batch: int = 4, seq: int = 16, vocab: int = 32, dim: int = 32,
            heads: int = 4, layers: int = 2, rope: bool = False,
            device=None):
    """character-level language model: [N,S,1,1] token ids -> embed ->
    (lnorm + causal attn + tanh)* -> lnorm -> position-wise proj ->
    per-position softmax; serves autoregressively through nn/serve.py.
    rope=True adds rotary position embeddings to every attention layer.
    device=None builds on the CUDA card (and raises without one)."""
    m = _new_model(batch, seq, 1, 1, device=device)
    m.add(Layer.EMBED, vocab, float(dim))
    flags = 3.0 if rope else 1.0             # causal [+ rope]
    for _ in range(layers):
        m.add(Layer.LNORM)
        m.add(Layer.ATTN, heads, flags)
        m.add(Layer.TANH)
    m.add(Layer.LNORM)
    m.add(Layer.PROJ, vocab)
    m.add(Layer.SOFTMAX)
    return m
