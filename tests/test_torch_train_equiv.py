"""`nn.train` in the port (nn/train.py, the `nn.train` word) against the
port's own word loop and against the JAX package, on the CPU:
test_train_equiv.py's first two cases, test_nn.py's `nn.train` case and
test_lm.py's `0 nn.train`.

The port's epoch step is the word path's functions in the words' order
(forward_pure, loss, backward_pure, adam_step), so `nn.train` lands the
word loop's weights bit for bit.  Against the JAX package's train_epochs
the weights agree within rtol 5e-4 (test_train_equiv.py's own) and
ATOL_JAX (below).
"""
import re

import numpy as np
import pytest

from tests.test_torch_fusion import (  # noqa: F401
    fresh_jax_chunk_programs, host, same_data_roots, t4p)
from tests.test_torch_net_repl import assert_close_transcripts
from tests.test_torch_threads import one_torch_thread  # noqa: F401


# the two packages' f32 GEMMs and Adam round in another order, and Adam's
# m / sqrt(v) magnifies a last-bit difference where a gradient is near
# zero: after 6 steps at 0.01, one of mnist_cnn's 196,000 weights lay
# 1.47e-5 from the JAX package's, all others within 5e-6 (test_train_equiv
# holds the JAX package's own two paths to 5e-6)
ATOL_JAX = 5e-5


class _StubCorpus:
    def __init__(self, data, labels):
        self._data = data
        self._labels = labels
        self.size = data.shape[0]

    def _read(self, start, n):
        return self._data[start:start + n], self._labels[start:start + n]


class _StubDataset:
    """duck-types what the two packages' train_epochs read"""
    def __init__(self, data, labels, batch, mean=0.0, scale=1.0):
        self._corpus = _StubCorpus(data, labels)
        self.batch_sz = batch
        self._mean = mean
        self._scale = scale


def snapshot(model):
    return [tuple(host(w) for w in pl) for pl in model._params()]


def restore(model, snap):
    for j in range(model.numel - 1):
        for k, w in enumerate(snap[j]):
            g = model[j].grad[k]
            g.replace_data(np.asarray(w, np.float32).reshape(g.shape))


def stage(model, n_batches, batch, seed=7):
    rs = np.random.RandomState(seed)
    shp = tuple(model[0].shape[1:])
    data = rs.rand(n_batches * batch, *shp).astype(np.float32)
    classes = model[-1].HWC()
    labels = rs.randint(0, classes, size=n_batches * batch)
    hot = np.eye(classes, dtype=np.float32)[labels].reshape(
        n_batches, batch, 1, classes, 1)
    return (_StubDataset(data, labels, batch),
            data.reshape((n_batches, batch) + shp), hot)


def word_loop(model, x_batches, hot_batches, lr, epochs):
    """the port's word path: forward / backprop / adam a batch"""
    from tensorforth_tpu_torch.mu.mmu import MMU
    mmu = MMU.get_mmu()
    batch = x_batches.shape[1]
    inp = mmu.tensor(*((batch,) + x_batches.shape[2:]), device="cpu")
    hot = mmu.tensor(batch, 1, model[-1].HWC(), 1, device="cpu")
    for _ in range(epochs):
        for b in range(x_batches.shape[0]):
            inp.set_numpy(x_batches[b])
            hot.set_numpy(hot_batches[b].reshape(hot.shape))
            model.forward(inp)
            model.backprop(hot)
            model.adam(lr)


def zoo(pkg, name, **kw):
    """the test's model of a package's zoo (kw: the port's device)"""
    if name == "mnist_cnn":
        return pkg.mnist_cnn(batch=8, **kw)
    return pkg.tiny_transformer(batch=4, seq=8, dim=16, heads=4, classes=4,
                                layers=1, **kw)


@pytest.mark.parametrize("zoo_name", ["mnist_cnn", "tiny_transformer"])
def test_nn_train_matches_word_path(t4, monkeypatch, zoo_name):
    """the port's nn.train lands the port's word loop's weights bit for
    bit, and the JAX package's nn.train's within its test's tolerance"""
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    monkeypatch.delenv("T4_MESH", raising=False)
    from tensorforth_tpu import models as jmodels
    from tensorforth_tpu.nn.train import train_epochs as jtrain
    from tensorforth_tpu_torch import models
    from tensorforth_tpu_torch.nn.train import train_epochs

    jm = zoo(jmodels, zoo_name)
    word, fused = (zoo(models, zoo_name, device="cpu") for _ in range(2))
    p0 = snapshot(jm)
    restore(word, p0)
    restore(fused, p0)
    ds, x, hot = stage(word, n_batches=3, batch=word[0].N())
    lr = 0.01
    word_loop(word, x, hot, lr, epochs=2)
    train_epochs(fused, ds, lr=lr, epochs=2)
    jtrain(jm, ds, lr=lr, epochs=2)
    changed = False
    for j, (pw, pf, pj) in enumerate(zip(snapshot(word), snapshot(fused),
                                         snapshot(jm))):
        for k, (w1, w2, w3) in enumerate(zip(pw, pf, pj)):
            np.testing.assert_array_equal(
                w2, w1, err_msg=f"layer {j} param {k}: nn.train != words")
            np.testing.assert_allclose(
                w2, w3, rtol=5e-4, atol=ATOL_JAX,
                err_msg=f"layer {j} param {k}: the port != the JAX package")
            changed |= not np.allclose(w1, p0[j][k])
    assert changed, "training changed nothing"


def test_nn_train_writes_back_attn(t4, monkeypatch):
    """every parameter kind is written back, attention's wqkv and wo
    too, as the JAX package writes them"""
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)
    from tensorforth_tpu import models as jmodels
    from tensorforth_tpu.nn.train import train_epochs as jtrain
    from tensorforth_tpu_torch import models
    from tensorforth_tpu_torch.nn.ntypes import Layer
    from tensorforth_tpu_torch.nn.train import train_epochs

    jm = zoo(jmodels, "tiny_transformer")
    m = zoo(models, "tiny_transformer", device="cpu")
    p0 = snapshot(jm)
    restore(m, p0)
    ds, _, _ = stage(m, n_batches=2, batch=4)
    assert train_epochs(m, ds, lr=0.01, epochs=1) > 0.0
    jtrain(jm, ds, lr=0.01, epochs=1)
    p1, pj = snapshot(m), snapshot(jm)
    for j in range(m.numel - 1):
        for k in range(len(p1[j])):
            np.testing.assert_allclose(p1[j][k], pj[j][k], rtol=5e-4,
                                       atol=ATOL_JAX)
        if m[j].grad_fn == Layer.ATTN:
            assert not np.allclose(p0[j][0], p1[j][0]), "wqkv not written"
            assert not np.allclose(p0[j][1], p1[j][1]), "wo not written"


NN_TRAIN = """0 trace
16 28 28 1 nn.model
flatten 64 linear relu 10 linear softmax
constant mt
mt batchsize dataset mnist_train constant dst
mt dst 0.001 40 nn.train"""


def test_nn_train_word_learns_as_jax(t4, t4p, monkeypatch):
    """test_nn.py's case through both REPLs: 40 epochs of a 5-batch
    window; the port's model learns (hits >= 5 of 16 on a seen batch)
    and both print the same lines (the final loss within a relative
    1e-4: the two packages' f32 GEMMs sum in another order)"""
    monkeypatch.setenv("T4_MAX_BATCH", "5")
    outs = []
    for inst in (t4p, t4):
        out = inst.forth(NN_TRAIN)
        out += inst.forth("dst rewind\nmt dst forward nn.hit .")
        outs.append(out)
    assert "nn.train 40 epochs done, final loss=" in outs[0]
    last = [ln for ln in outs[0].strip().split("\n") if ln][-1]
    hits = int(float(last.split()[0]))
    assert hits >= 5, f"nn.train failed to learn: {hits}/16"
    assert_close_transcripts(outs[0], outs[1], 1e-4)


def test_nn_train_zero_epochs(t4, t4p):
    """`0 nn.train` is a no-op: train_epochs returns 0 without reading
    the dataset, and the word prints what the JAX package's prints"""
    from tensorforth_tpu_torch.models import mnist_cnn
    from tensorforth_tpu_torch.nn.train import train_epochs
    m = mnist_cnn(batch=10, device="cpu")
    assert train_epochs(m, None, epochs=0) == 0.0
    line = ("0 trace 4 28 28 1 nn.model flatten 10 linear softmax "
            "dup batchsize dataset mnist_train 0.001 0 nn.train .s")
    got = t4p.forth(line)
    assert got == t4.forth(line)
    assert re.search(r"nn.train 0 epochs done, final loss=0\b", got)
