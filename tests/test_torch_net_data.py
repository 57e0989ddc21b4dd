"""The port's corpora, datasets and model files against the JAX
package's, on the CPU: the synthetic stand-in's bytes, the batches a
dataset serves (ds.tell, ds.seek, rewind, normalize, a partial tail
batch), the loaders without scikit-learn, the `save`d model files byte
for byte and loaded across the packages, and the port's copy of
test_real_digits' training gate.
"""
import builtins

import numpy as np
import pytest
import torch

from tests.test_torch_net_repl import same_data_roots  # noqa: F401
from tests.test_torch_repl import t4p  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def per_word_path(monkeypatch):
    monkeypatch.setenv("T4_NO_FUSE", "1")
    monkeypatch.setenv("T4_NO_MACRO", "1")
    monkeypatch.delenv("T4_MAX_BATCH", raising=False)


# --- the synthetic stand-in -----------------------------------------------------
@pytest.mark.parametrize("name", ["mnist_train", "mnist_test",
                                  "cifar10_test"])
def test_synthetic_corpus_is_the_references_bytes(name):
    from tensorforth_tpu.io.loader import Loader as JLoader
    from tensorforth_tpu.io.loader import Synthetic as JSynthetic
    from tensorforth_tpu_torch.io.loader import Loader, Synthetic
    spec = Loader._SYNTH[name]
    assert spec == JLoader._SYNTH[name]
    mine, ref = Synthetic(*spec), JSynthetic(*spec)
    rs = np.random.RandomState(0)
    for pos, n in [(0, 64), (spec[0] - 37, 37)] + [
            (int(p), 50) for p in rs.randint(0, spec[0] - 50, 3)]:
        for a, b in zip(mine._gen(pos, n), ref._gen(pos, n)):
            np.testing.assert_array_equal(a, b)
    if name == "mnist_test":              # the whole corpus, materialized
        d, lbl = mine._read(0, spec[0])
        jd, jl = ref._read(0, spec[0])
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(lbl, jl)


# --- dataset batches ------------------------------------------------------------------
def _ds(inst):
    """the dataset on top of the stack"""
    return inst.vm.mmu.du2obj(inst.vm.tos)


def _data(ds):
    d = ds.ensure_data()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.mark.parametrize("batch", [100, 300])
def test_dataset_batches_match_jax(t4, t4p, batch):
    """mnist_test through `dataset`, `fetch`, `ds.tell`, `ds.seek`,
    `rewind` and `normalize` in both REPLs: the same transcript, and
    after each word the same batch (bytes), host labels and position.
    Batch 300 ends on a partial batch of 100, padded with zeros."""
    steps = [f"{batch} dataset mnist_test", "fetch", "fetch", "ds.tell .",
             "5000 ds.seek", "fetch", "ds.tell .", "rewind", "fetch",
             "128 64 normalize", "fetch", "9900 ds.seek", "fetch",
             "ds.tell .", "fetch", "nn.len ."]
    for step in steps:
        got, want = t4p.forth(step), t4.forth(step)
        assert got == want, step
        if step.endswith(" ."):
            continue
        mine, ref = _ds(t4p), _ds(t4)
        np.testing.assert_array_equal(_data(mine), _data(ref), err_msg=step)
        np.testing.assert_array_equal(mine.label, ref.label, err_msg=step)
        assert (mine.batch_id, mine.done, mine._corpus._pos) == (
            ref.batch_id, ref.done, ref._corpus._pos), step
        if mine.label_dev is not None:   # a full batch: labels on device
            np.testing.assert_array_equal(
                mine.label_dev.numpy(), mine.label.astype(np.int64))
    assert "WARN: corpus files for 'mnist_test' not found" in \
        t4p.forth("abort 10 dataset mnist_test .s")


def test_dataset_and_futures_live_on_the_mmus_device(t4p):
    t4p.forth("50 dataset mnist_test fetch")
    d = _ds(t4p)
    assert d.ensure_data().device.type == "cpu"
    assert d.label_dev.device.type == "cpu"
    assert d._corpus._dev[0] == torch.device("cpu")
    t4p.forth("3 vector{ 1 2 3 } sum")
    f = t4p.vm.future_of(t4p.vm.tos)
    assert f is not None and f.value() == 6.0


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """an empty data root of its own for both packages, their corpus
    registries emptied"""
    from tensorforth_tpu.config import Config as JConfig
    from tensorforth_tpu.io.loader import Loader as JLoader
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.io.loader import Loader
    for c, ld in ((Config, Loader), (JConfig, JLoader)):
        monkeypatch.setattr(c, "DATA_ROOTS", [str(tmp_path)])
        monkeypatch.setattr(ld, "_map", {})
    return tmp_path


@pytest.mark.parametrize("name", ["digits_train", "digits_test",
                                  "photos_train", "photos_test"])
def test_real_corpora_without_scikit_learn(t4, t4p, data_root, monkeypatch,
                                           name):
    """with no scikit-learn the real corpora are not available: both
    REPLs say so the same way and carry on"""
    real_import = builtins.__import__

    def no_sklearn(mod, *a, **kw):
        if mod == "sklearn" or mod.startswith("sklearn."):
            raise ImportError("no sklearn here")
        return real_import(mod, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    from tensorforth_tpu_torch.io.loader import Loader
    assert Loader.get(None, name) is None
    line = f"abort 25 dataset {name} .s"
    got = t4p.forth(line)
    assert got == t4.forth(line)
    assert f"dataset {name}?" in got
    assert "5 " in t4p.forth("abort 2 3 + .")


@pytest.mark.parametrize("name", ["digits_train", "digits_test",
                                  "photos_train"])
def test_real_corpora_are_the_references_bytes(data_root, name):
    pytest.importorskip("sklearn.datasets")
    from tensorforth_tpu.io.loader import Loader as JLoader
    from tensorforth_tpu_torch.io.loader import Loader
    mine = Loader.get(None, name)
    mine.init()
    a = mine._read(0, mine.size)
    JLoader._map = {}
    for f in data_root.rglob("*"):        # the reference writes its own
        if f.is_file():
            f.unlink()
    ref = JLoader.get(None, name)
    ref.init()
    b = ref._read(0, ref.size)
    assert (mine.size, mine.H, mine.W, mine.C) == (
        ref.size, ref.H, ref.W, ref.C)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --- model files ----------------------------------------------------------------------
CNN = ("0 trace 4 8 8 1 nn.model 0.5 4 conv2d 2 maxpool relu "
       "flatten 0.5 dropout 12 linear batchnorm relu 10 linear softmax "
       "constant cm\n"
       "256 vector randn 4 8 8 1 reshape4 constant cx\n"
       "40 vector{ 1 0 0 0 0 0 0 0 0 0  0 1 0 0 0 0 0 0 0 0 "
       "0 0 1 0 0 0 0 0 0 0  0 0 0 1 0 0 0 0 0 0 } 4 1 10 1 reshape4 "
       "constant chot")


def _out(inst):
    vm = inst.vm
    vm_m = vm.mmu.du2obj(vm.tos)
    d = vm_m[-1].ensure_data()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.mark.parametrize("opt", ["", "0.01 nn.adam", "0.1 0.9 nn.sgd"])
def test_model_files_are_the_references_bytes(t4, t4p, tmp_path, opt):
    """a model saved by the JAX package loads into the port, which saves
    the same bytes again; both forwards of the loaded model agree (the
    f32 matmuls sum in another order: 1e-6 of the largest output)"""
    jfile, pfile = tmp_path / "j.t4", tmp_path / "p.t4"
    for inst in (t4p, t4):                 # the same seed: the same cx
        inst.forth(CNN)
    if opt:
        t4.forth(f"cm cx forward chot backprop {opt} drop")
        t4p.forth("cm cx forward drop")    # the same dropout key drawn
    t4.forth(f'cm s" {jfile}" save drop')
    for inst in (t4p, t4):
        inst.forth(f'4 8 8 1 nn.model constant ld ld s" {jfile}" load '
                   "drop")
    t4p.forth(f'ld s" {pfile}" save drop')
    assert pfile.read_bytes() == jfile.read_bytes()
    outs = []
    for inst in (t4p, t4):
        out = inst.forth("ld network")
        assert "NN Model[10/128]" in out
        inst.forth("ld 0 trainable cx forward")
        outs.append((out, _out(inst)))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=0,
                               atol=1e-6 * np.abs(outs[1][1]).max())


def test_port_file_loads_into_the_jax_package(t4, t4p, tmp_path):
    pfile = tmp_path / "p.t4"
    for inst in (t4p, t4):
        inst.forth(CNN)
    t4p.forth("cm cx forward chot backprop 0.01 nn.adam drop")
    t4p.forth(f'cm s" {pfile}" save drop')
    t4.forth(f'4 8 8 1 nn.model constant ld ld s" {pfile}" load drop')
    jfile = tmp_path / "j.t4"
    t4.forth(f'ld s" {jfile}" save drop')
    assert jfile.read_bytes() == pfile.read_bytes()


# --- the real-data gate (tests/test_real_digits.py, through the port) ---------------
def test_real_data_training_gate(t4p, data_root, monkeypatch):
    """the small CNN on 1500 real scans, then the held-out 275 (11 full
    batches): accuracy >= 0.95 through the port's word interface, as
    test_real_digits.py holds the JAX package"""
    pytest.importorskip("sklearn.datasets")
    t4p.forth("""0 trace
25 8 8 1 nn.model
0.5 16 conv2d relu maxpool
flatten 96 linear relu 10 linear softmax
constant m
m batchsize dataset digits_train constant tr""")
    t4p.forth("variable h variable l\n"
              ": ep 0 h ! for forward loss.ce l ! nn.hit h +! "
              "backprop 0.01 nn.adam next ;\n"
              ": ep2 0 h ! for forward loss.ce l ! nn.hit h +! "
              "backprop 0.002 nn.adam next ;")
    for _ in range(16):
        t4p.forth("tr rewind drop m tr ep drop")
    for _ in range(8):
        t4p.forth("tr rewind drop m tr ep2 drop")
    train_hits = int(float(t4p.forth("h @ . cr").split()[0]))
    assert train_hits >= 1450, f"train hits {train_hits}/1500"
    t4p.forth("m batchsize dataset digits_test constant te")
    monkeypatch.setenv("T4_MAX_BATCH", "11")
    t4p.forth("variable g\n: ev 0 g ! for forward nn.hit g +! next ;")
    t4p.forth("te rewind drop m te ev drop")
    hits = int(float(t4p.forth("g @ . cr").split()[0]))
    acc = hits / 275.0
    assert acc >= 0.95, f"real-data held-out accuracy {acc:.3f} < 0.95"
