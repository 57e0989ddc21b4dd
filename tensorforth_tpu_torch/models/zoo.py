"""Model zoo — the port of tensorforth_tpu/models/zoo.py: the example
scripts' nets built through the nn API.

  mnist_cnn        : examples/t4_30e.4th nn_c (conv-pool-relu + 2 linear)
  gan_mnist        : examples/t4_40b.4th G/D MLP pair
  tiny_transformer : attention blocks + linear softmax classifier
  tiny_moe         : attention + mixture-of-experts sequence classifier
  tiny_lm          : the LM tier's serving/training model

Every entry point builds on the CUDA card unless the caller passes
device="cpu" (and raises without a card).
"""
from __future__ import annotations

from ..mu.mmu import MMU
from ..nn.ntypes import Layer


def _new_model(n, h, w, c, device=None):
    mmu = MMU.get_mmu()
    m = mmu.model(device=device)
    m.npush(mmu.tensor(n, h, w, c, device=m.device))
    return m


def mnist_cnn(batch: int = 100, device=None):
    """t4_30e nn_c: 0.5 10 conv2d / 2 maxpool / relu / flatten /
    100 linear relu / 10 linear softmax"""
    m = _new_model(batch, 28, 28, 1, device=device)
    m.add(Layer.CONV, 10, 0.5, [3, 1, 0, 1])
    m.add(Layer.MAXPOOL, 2)
    m.add(Layer.RELU)
    m.add(Layer.FLATTEN)
    m.add(Layer.LINEAR, 100, 1.0)
    m.add(Layer.RELU)
    m.add(Layer.LINEAR, 10, 1.0)
    m.add(Layer.SOFTMAX)
    return m


def gan_mnist(batch: int = 256, device=None):
    """t4_40b G (128->256->512->784 tanh) and D (784->512->256->1
    sigmoid, dropout 0.3)"""
    g = _new_model(batch, 128, 1, 1, device=device)
    g.add(Layer.LINEAR, 256, 1.0)
    g.add(Layer.LEAKYRL, 0, 0.2)
    g.add(Layer.LINEAR, 512, 1.0)
    g.add(Layer.LEAKYRL, 0, 0.2)
    g.add(Layer.LINEAR, 784, 1.0)
    g.add(Layer.TANH)

    d = _new_model(batch, 28, 28, 1, device=device)
    d.add(Layer.LINEAR, 512, 1.0)
    d.add(Layer.LEAKYRL, 0, 0.2)
    d.add(Layer.DROPOUT, 0, 0.3)
    d.add(Layer.LINEAR, 256, 1.0)
    d.add(Layer.LEAKYRL, 0, 0.2)
    d.add(Layer.DROPOUT, 0, 0.3)
    d.add(Layer.LINEAR, 1, 1.0)
    d.add(Layer.SIGMOID)
    return g, d


def tiny_transformer(batch: int = 32, seq: int = 16, dim: int = 32,
                     heads: int = 4, classes: int = 10, layers: int = 2,
                     device=None):
    """sequence classifier: [N, S, E, 1] tokens -> (attn + tanh)* ->
    flatten -> linear softmax"""
    m = _new_model(batch, seq, dim, 1, device=device)
    for _ in range(layers):
        m.add(Layer.ATTN, heads)
        m.add(Layer.TANH)
    m.add(Layer.FLATTEN)
    m.add(Layer.LINEAR, classes, 1.0)
    m.add(Layer.SOFTMAX)
    return m


def tiny_moe(batch: int = 8, seq: int = 8, dim: int = 16, experts: int = 4,
             hidden: int = 32, top_k: int = 2, classes: int = 4,
             device=None):
    """sequence classifier with a mixture-of-experts FFN block:
    [N, S, D, 1] -> attn -> moe -> tanh -> flatten -> linear softmax"""
    m = _new_model(batch, seq, dim, 1, device=device)
    m.add(Layer.ATTN, 4)
    m.add(Layer.MOE, experts, float(hidden), [top_k])
    m.add(Layer.TANH)
    m.add(Layer.FLATTEN)
    m.add(Layer.LINEAR, classes, 1.0)
    m.add(Layer.SOFTMAX)
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
