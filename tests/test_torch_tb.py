"""The port's TensorBoard tier (tensorforth_tpu_torch/tb/, io/equeue.py, the
TB words and `-t/-r`) on the CPU, against the JAX package's: the cases of
test_tb.py, test_native_io.py and test_tb_real_reader.py, event files of
the same words through both packages (equal but for the wall time), the
deferred queue against the synchronous path byte for byte, the snapshot a
post takes, and a truncated t4_40a through both REPLs.
"""
import gzip
import os
import re
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_tb import _parse_fields, _read_records
from tests.test_torch_net_repl import (  # noqa: F401  (autouse fixture)
    assert_close_transcripts, same_data_roots)
from tests.test_torch_repl import (  # noqa: F401  (fixtures)
    ROOT, run_lines, script_lines, t4p)
from tests.test_torch_threads import one_torch_thread  # noqa: F401


TIMEOUT = 60          # seconds a test holds the worker at most


def _event_file(d):
    (f,) = [x for x in os.listdir(d) if "tfevents" in x]
    return os.path.join(d, f)


def _events(path):
    """the file's Events, each without its wall time (field 1)"""
    return [{k: v for k, v in _parse_fields(r).items() if k != 1}
            for r in _read_records(path)]


def _summaries(path):
    """[(step, tag, value fields)] of the file's Summary events"""
    out = []
    for ev in _events(path):
        for s in ev.get(5, []):
            for v in _parse_fields(s)[1]:
                val = _parse_fields(v)
                out.append((ev.get(2, [0])[0], val[1][0].decode(), val))
    return out


# ---------------------------------------------------------------------------
# test_tb.py's cases
# ---------------------------------------------------------------------------
def test_crc32c_vectors():
    from tensorforth_tpu_torch.tb.crc32c import crc32c
    assert crc32c(b"\x00" * 32) == 0x8A9136AA       # RFC 3720
    assert crc32c(b"123456789") == 0xE3069283


def test_event_file_roundtrip(tmp_path):
    from tensorforth_tpu_torch.tb.writer import EventWriter
    w = EventWriter(str(tmp_path), "run1")
    w.step = 5
    w.add_scalar("train/acc", 0.75)
    w.add_text("progress/text", "hello tb")
    w.add_histo("nn/w", np.arange(100, dtype=np.float32), 10)
    w.close()
    recs = _read_records(w.path)
    assert len(recs) == 4                       # file_version + 3 events
    assert _parse_fields(recs[0])[3][0] == b"brain.Event:2"
    ev1 = _parse_fields(recs[1])
    assert ev1[2][0] == 5
    val = _parse_fields(_parse_fields(ev1[5][0])[1][0])
    assert val[1][0] == b"train/acc" and abs(val[2][0] - 0.75) < 1e-6
    ev3 = _parse_fields(recs[3])
    histo = _parse_fields(_parse_fields(_parse_fields(ev3[5][0])[1][0])[5][0])
    assert histo[3][0] == 100.0


def test_png_encoder_matches_jax():
    from tensorforth_tpu.tb.png import raw2png as jraw2png
    from tensorforth_tpu_torch.tb.png import raw2png
    px = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    data = raw2png(px)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (7, 5)
    assert data == jraw2png(px)


def test_tb_words_write_events(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    t4p.sys.tb = Summary(str(tmp_path), "rx")
    t4p.forth("3 .tbstep")
    t4p.forth('0.5 s" train/loss" .scalar')
    t4p.forth('2 2 matrix ones 1 s" img/x" .tile')
    t4p.forth('4 vector{ 1 2 3 4 } 4 s" h/x" .histo')
    t4p.sys.tb.close()
    tags = [(s, t) for s, t, _ in _summaries(_event_file(tmp_path / "rx"))]
    assert tags == [(3, "train/loss"), (3, "img/x"), (3, "h/x")]


def _drive(t4, tmp_path, run, mk):
    t4.sys.tb = mk(str(tmp_path), run)
    t4.forth("1 .tbstep")
    t4.forth('0.25 s" q/loss" .scalar')
    t4.forth("2 .tbstep")
    t4.forth('0.125 s" q/loss" .scalar')
    t4.forth('2 2 matrix ones 1 s" q/img" .tile')
    t4.forth('4 vector{ 1 2 3 5 } 3 s" q/h" .histo')
    t4.forth('s" batch=4" s" q/txt" .text')
    t4.sys.tb.close()
    return _events(_event_file(tmp_path / run))


def test_deferred_queue_matches_sync(t4p, tmp_path, monkeypatch):
    """the worker's records equal the synchronous path's, in order"""
    from tensorforth_tpu_torch.tb.summary import Summary
    monkeypatch.setenv("T4_SYNC_IO", "1")
    sync = _drive(t4p, tmp_path, "sync", Summary)
    monkeypatch.delenv("T4_SYNC_IO")
    assert _drive(t4p, tmp_path, "async", Summary) == sync


def test_projector(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    t4p.sys.tb = Summary(str(tmp_path), "re")
    t4p.forth('2 1 2 1 tensor ones s" e0" .embed')
    t4p.sys.tb.close()
    cfg = tmp_path / "re" / "projector_config.pbtxt"
    assert cfg.exists() and "e0_tensors.tsv" in cfg.read_text()


def test_flatbuffer_builder_matches_jax():
    from tensorforth_tpu.tb.flatbuf import FlatBufferBuilder as JB
    from tensorforth_tpu_torch.tb.flatbuf import FlatBufferBuilder
    out = []
    for cls in (FlatBufferBuilder, JB):
        b = cls()
        s = b.create_string("hello")
        v = b.create_vector_f32([1.0, 2.0, 3.0])
        b.start_table(2)
        b.slot_offset(0, s)
        b.slot_offset(1, v)
        out.append(b.finish(b.end_table()))
    assert b"hello" in out[0] and out[0] == out[1]
    root_rel = struct.unpack_from("<I", out[0], 0)[0]
    assert 0 < root_rel < len(out[0])


def test_tb2gif(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    s = Summary(str(tmp_path), "gif")
    t = t4p.sys.mu.tensor(4, 8, 8, 1)
    for i in range(3):
        s.set_step(i)
        t.set_numpy(np.random.RandomState(i).rand(4, 8, 8, 1).astype("f4"))
        s.tile("gen/image", t, 2)
    s.close()
    out = str(tmp_path / "x.gif")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "scripts", "tb2gif.py"),
                        str(tmp_path / "gif"), "gen/image", out],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "3 frames" in r.stdout
    assert open(out, "rb").read(6) in (b"GIF87a", b"GIF89a")


def test_hparam_word(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    t4p.sys.tb = Summary(str(tmp_path), "hp2")
    t4p.forth('0.5 s" train/x" .scalar')      # open the writer
    t4p.forth('0.001 s" lr" .hparam')
    t4p.forth('100 s" batch" .hparam')
    t4p.sys.tb.close()
    data = open(_event_file(tmp_path / "hp2"), "rb").read()
    assert b"_hparams_/session_start_info" in data
    assert b"lr" in data and b"batch" in data


def test_real_tensorboard_reads_our_events(t4p, tmp_path):
    tb_ea = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    from tensorforth_tpu_torch.models import mnist_cnn
    from tensorforth_tpu_torch.tb.summary import Summary
    s = Summary(str(tmp_path), "rr")
    s.set_step(7)
    s.scalar("train/acc", 0.5)
    s.set_step(8)
    s.scalar("train/acc", 0.75)
    s.text("progress/text", "step 8 looking good")
    t = t4p.sys.mu.tensor(4, 8, 8, 1)
    t.set_numpy(np.random.RandomState(0).rand(4, 8, 8, 1).astype("f4"))
    s.tile("imgs/x", t, 2)
    s.histo("nn/w", t, 10)
    s.graph(mnist_cnn(batch=4, device="cpu"))
    s.close()
    acc = tb_ea.EventAccumulator(str(tmp_path / "rr"), size_guidance={
        "images": 10, "histograms": 10, "scalars": 100, "tensors": 10})
    acc.Reload()
    tags = acc.Tags()
    sc = acc.Scalars("train/acc")
    assert [e.step for e in sc] == [7, 8] and abs(sc[1].value - 0.75) < 1e-6
    img = acc.Images("imgs/x")[0]
    assert img.encoded_image_string[:8] == b"\x89PNG\r\n\x1a\n"
    h = acc.Histograms("nn/w")[0]
    assert int(h.histogram_value.num) == t.numel
    assert "progress/text" in tags["tensors"]
    assert acc.Graph() is not None


# ---------------------------------------------------------------------------
# test_native_io.py's cases: the native writer and readers (csrc/t4io.cpp)
# ---------------------------------------------------------------------------
def _write_all_events(writer):
    writer.add_scalar("loss/train", 0.4375)
    writer.step = 3
    writer.add_scalar("loss/train", -1.25e-3)
    writer.add_text("cfg", "batch=100 lr=0.01")
    writer.add_image("gen/tile", b"\x89PNG\r\n\x1a\n" + bytes(range(64)),
                     28, 56)
    rs = np.random.RandomState(5)
    writer.add_histo("w/conv1", rs.randn(257).astype(np.float32))
    writer.add_histo("const", np.full(8, 2.5))
    writer.add_graph([("conv1", "Conv2D", ["input"]),
                      ("relu1", "Relu", ["conv1"])])
    writer.close()


def test_tb_native_bytes_identical(tmp_path, monkeypatch):
    """the native event framing and the pure-Python encoder write the
    same bytes, and so does the JAX package's writer"""
    from tensorforth_tpu.tb.writer import EventWriter as JWriter
    from tensorforth_tpu_torch.tb import writer
    monkeypatch.setattr(writer.time, "time", lambda: 1755300000.125)
    w_native = writer.EventWriter(str(tmp_path / "nat"))
    assert w_native._lib is not None, "native writer not engaged"
    _write_all_events(w_native)
    w_jax = JWriter(str(tmp_path / "jax"))
    _write_all_events(w_jax)
    monkeypatch.setattr(writer.native, "get_io", lambda: None)
    w_py = writer.EventWriter(str(tmp_path / "py"))
    assert w_py._lib is None
    _write_all_events(w_py)
    nat, py, jx = (open(w.path, "rb").read()
                   for w in (w_native, w_py, w_jax))
    assert nat == py and len(nat) > 200
    assert _events(w_native.path) == _events(w_jax.path)


def test_tb_native_real_reader(tmp_path):
    loader = pytest.importorskip(
        "tensorboard.backend.event_processing.event_file_loader")
    from tensorforth_tpu_torch.tb.writer import EventWriter
    w = EventWriter(str(tmp_path))
    assert w._lib is not None
    w.add_scalar("x", 1.5)
    w.close()
    assert len(list(loader.RawEventFileLoader(w.path).Load())) == 2


def _idx_files(root, n=32):
    d = os.path.join(root, "MNIST", "raw")
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(3)
    imgs = rs.randint(0, 256, size=(n, 28, 28), dtype=np.uint8)
    lbls = rs.randint(0, 10, size=n, dtype=np.uint8)
    with open(os.path.join(d, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, 28, 28))
        f.write(imgs.tobytes())
    with gzip.open(os.path.join(d, "train-labels-idx1-ubyte.gz"), "wb") as f:
        f.write(struct.pack(">II", 0x801, n))
        f.write(lbls.tobytes())
    return imgs, lbls


@pytest.fixture()
def data_root(tmp_path):
    from tensorforth_tpu_torch.config import Config
    from tensorforth_tpu_torch.io.loader import Loader
    old_roots = Config.DATA_ROOTS
    Config.DATA_ROOTS = [str(tmp_path)]
    Loader._map = {}
    yield str(tmp_path)
    Config.DATA_ROOTS = old_roots
    Loader._map = {}


def test_idx_native_matches_python(data_root, monkeypatch):
    imgs, lbls = _idx_files(data_root)
    from tensorforth_tpu_torch.io.loader import Mnist
    from tensorforth_tpu_torch.runtime import native
    args = ("MNIST/raw/train-images-idx3-ubyte",
            "MNIST/raw/train-labels-idx1-ubyte")
    nat = Mnist(*args)
    nat.init()
    np.testing.assert_array_equal(nat._img.reshape(-1, 28, 28), imgs)
    np.testing.assert_array_equal(nat._lbl, lbls)
    monkeypatch.setattr(native, "get_io", lambda: None)
    py = Mnist(*args)
    py.init()
    np.testing.assert_array_equal(nat._img, py._img)
    np.testing.assert_array_equal(nat._lbl, py._lbl)


@pytest.mark.parametrize("gz", [False, True])
def test_cifar_native_matches_python(data_root, monkeypatch, gz):
    d = os.path.join(data_root, "CIFAR10", "cifar-10-batches-bin")
    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(11)
    lbls = rs.randint(0, 10, size=16, dtype=np.uint8)
    chw = rs.randint(0, 256, size=(16, 3, 32, 32), dtype=np.uint8)
    with (gzip.open if gz else open)(
            os.path.join(d, "data_batch.bin" + (".gz" if gz else "")),
            "wb") as f:
        for i in range(16):
            f.write(bytes([lbls[i]]))
            f.write(chw[i].tobytes())
    from tensorforth_tpu_torch.io.loader import Cifar10
    from tensorforth_tpu_torch.runtime import native
    nat = Cifar10("CIFAR10/cifar-10-batches-bin/data_batch.bin")
    nat.init()
    assert nat.size == 16
    np.testing.assert_array_equal(nat._data, chw.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(nat._lbl, lbls)
    monkeypatch.setattr(native, "get_io", lambda: None)
    py = Cifar10("CIFAR10/cifar-10-batches-bin/data_batch.bin")
    py.init()
    np.testing.assert_array_equal(nat._data, py._data)
    np.testing.assert_array_equal(nat._lbl, py._lbl)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def test_event_files_match_jax(t4, t4p, tmp_path):
    """the same TB words through both REPLs write the same events but
    the wall time.  The histogram's sums are torch's f64 reductions in
    the port, numpy's pairwise ones in the JAX package: on `rand` values
    of at most 100 elements (multiples of 2^-23) both are exact"""
    from tensorforth_tpu.tb.summary import Summary as JSummary
    from tensorforth_tpu_torch.tb.summary import Summary
    script = ["7 .tbstep", '0.375 s" a/s" .scalar',
              's" hello" s" a/t" .text',
              '3 4 4 1 tensor rand 2 s" a/tile" .tile',
              '2 3 3 1 tensor ones s" a/img" .image',
              '10 10 matrix rand 13 s" a/h" .histo',
              "8 .tbstep", '12 vector rand 5 s" a/h" .histo',
              "1 2 1 1 nn.model 2 linear relu dup .graph"]
    got = _drive_words(t4p, tmp_path, "p", Summary, script)
    want = _drive_words(t4, tmp_path, "j", JSummary, script)
    assert len(got) == 8 and got == want      # file_version + 7 records


def _drive_words(t4, tmp_path, run, mk, script):
    t4.sys.tb = mk(str(tmp_path), run)
    for line in script:
        t4.forth(line)
    t4.sys.tb.close()
    return _events(_event_file(tmp_path / run))


def test_histo_stats_match_numpy():
    """histo_stats draws np.histogram's bins exactly (its index rule and
    the one-ulp corrections included) on randn values and on values that
    sit on the edges; the sums agree with numpy's to 1e-12"""
    from tensorforth_tpu_torch.tb.summary import histo_stats
    rs = np.random.RandomState(7)
    cases = [rs.randn(5000).astype(np.float32),
             np.linspace(-1, 1, 301).astype(np.float32),
             np.full(9, 2.5, np.float32), np.array([3.0], np.float32),
             (rs.randint(0, 30, 999) / 29.0).astype(np.float32)]
    for d in cases:
        for bins in (1, 7, 30):
            st = histo_stats(torch.from_numpy(d), bins).numpy()
            x = d.astype(np.float64)
            mn, mx = float(x.min()), float(x.max())
            if mn == mx:
                mx = mn + 1.0
            counts, edges = np.histogram(x, bins=bins, range=(mn, mx))
            assert list(st[:3]) == [mn, mx, float(x.size)]
            np.testing.assert_array_equal(st[5:5 + bins], edges[1:])
            np.testing.assert_array_equal(st[5 + bins:], counts)
            np.testing.assert_allclose(st[3:5], [x.sum(), (x * x).sum()],
                                       rtol=1e-12, atol=0)


def test_histo_of_a_nan_is_refused_at_flush(t4p, tmp_path):
    """a NaN leaves the range not finite: the record is refused as the
    JAX package's np.histogram refuses it, and no index leaves the
    edges on the way (on the card that would be a device fault)"""
    from tensorforth_tpu_torch.tb.summary import Summary
    t4p.sys.tb = s = Summary(str(tmp_path), "nan")
    t = t4p.sys.mu.tensor(4)
    t.set_numpy(np.array([1, np.nan, 2, 3], np.float32))
    s.histo("x/h", t, 5)
    with pytest.raises(RuntimeError, match="not finite"):
        s.close()
    t4p.sys.tb = None


def test_tile_pixels_match_jax():
    from tensorforth_tpu.tb.summary import _tile_pixels
    from tensorforth_tpu_torch.tb.summary import tile_pixels
    rs = np.random.RandomState(1)
    for shape, per in (((5, 6, 7, 1), 2), ((4, 3, 3, 3), 4),
                       ((1, 8, 8, 1), 1), ((6, 2, 5, 1), 4)):
        d = rs.rand(*shape).astype(np.float32)
        got = tile_pixels(torch.from_numpy(d), shape, per).numpy()
        np.testing.assert_array_equal(got, _tile_pixels(d, per))
    flat = np.ones((2, 3, 3, 1), np.float32)         # std 0: the scale 64
    np.testing.assert_array_equal(
        tile_pixels(torch.from_numpy(flat), flat.shape, 2).numpy(),
        _tile_pixels(flat, 2))


def test_snapshot_holds_the_values_before_an_in_place_step(t4p, tmp_path):
    """`.histo` of a weight and then an Adam step, which updates the
    weight in place, while the worker is held: the record holds the
    weight as it was at the post"""
    from tensorforth_tpu_torch.tb.summary import Summary, histo_stats
    t4p.sys.tb = s = Summary(str(tmp_path), "snap")
    t4p.forth("2 2 2 1 nn.model 3 linear softmax constant m0")
    t4p.forth("2 3 matrix{ 0 1 0 1 0 0 } constant hot0")
    m = [o for o in t4p.sys.mu._objs.values() if o.is_model()][-1]
    before = m[0].grad[0].ensure_data().clone()
    gate = threading.Event()
    s._q.post(lambda: gate.wait(TIMEOUT))      # hold the worker
    try:
        # the lines without the REPL's flush at each line's end
        for line in ('m0 0 nn.w 5 s" w/h" .histo',
                     "m0 2 2 2 1 tensor rand forward hot0 loss.mse drop "
                     "hot0 backprop 0.5 nn.adam drop"):
            t4p.sys.load_line(line)
            t4p.vm.outer()
        after = m[0].grad[0].ensure_data()
        assert not torch.equal(before, after), "the step did not move w"
        assert s.pending() == 2
    finally:
        gate.set()
    s.close()
    (_, _, val), = _summaries(_event_file(tmp_path / "snap"))
    histo = _parse_fields(val[5][0])
    want = histo_stats(before, 5).numpy()
    assert histo[1][0] == want[0] and histo[2][0] == want[1]
    assert struct.unpack("<5d", histo[7][0]) == tuple(want[10:])
    t4p.sys.tb = None


def test_equeue_backlog_and_errors():
    from tensorforth_tpu_torch.io.equeue import EventQueue
    q = EventQueue()
    gate = threading.Event()
    seen = []
    q.post(lambda: gate.wait(TIMEOUT))
    q.post(lambda a: seen.append(a.tolist()), torch.arange(3))
    try:
        assert q.pending() == 2
    finally:
        gate.set()
    q.flush()
    assert q.pending() == 0 and seen == [[0, 1, 2]]
    q.post(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        q.flush()


def test_cli_tb_logdir_and_run_id(tmp_path):
    """`ten4_torch -t <dir> -r <run>` writes the TB words' events under
    <dir>/<run>"""
    script = ('1 .tbstep\n0.5 s" cli/x" .scalar\n'
              '2 2 matrix ones 1 s" cli/img" .tile\nbye\n')
    r = subprocess.run([sys.executable, os.path.join(ROOT, "ten4_torch"),
                        "--device", "cpu", "-t", str(tmp_path), "-r", "r7"],
                       input=script, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    tags = [t for _, t, _ in _summaries(_event_file(tmp_path / "r7"))]
    assert tags == ["cli/x", "cli/img"]


@pytest.mark.parametrize("fill", ["ones", "rand"])
def test_png_word_matches_jax(t4, t4p, tmp_path, fill):
    """`.png` writes the JAX package's file (its pixels scaled on the
    tensor's device: on `rand`'s small tensor the moments round alike)"""
    out = []
    for inst, name in ((t4p, "p.png"), (t4, "j.png")):
        path = tmp_path / name
        inst.forth(f'abort 2 4 4 1 tensor {fill} s" {path}" .png')
        out.append(path.read_bytes())
    assert out[0][:8] == b"\x89PNG\r\n\x1a\n" and out[0] == out[1]


# --- t4_40a, truncated, through both REPLs ----------------------------------
_SECS = re.compile(r"\d+(\.\d+)? sec\b")


def test_t4_40a_truncated_matches_jax(t4, t4p, tmp_path, monkeypatch):
    """examples/t4_40a.4th at its full width, 3 epochs (`2 cnn`) of 2
    batches (T4_MAX_BATCH=2) at the defaults, through both REPLs with a
    TB writer: the transcripts, the seconds masked, and the logged
    scalars but train/time (the acc equal, the rest within the relative
    1e-4 that test_torch_net_repl holds trained numbers to), then the
    tags and steps of every record"""
    from tensorforth_tpu.tb.summary import Summary as JSummary
    from tensorforth_tpu_torch.tb.summary import Summary
    monkeypatch.setenv("T4_MAX_BATCH", "2")
    lines = [ln.replace("20 cnn", "2 cnn")
             for ln in script_lines("t4_40a.4th")]
    outs, recs = [], []
    for inst, mk, run in ((t4p, Summary, "p"), (t4, JSummary, "j")):
        inst.sys.tb = mk(str(tmp_path), run)
        outs.append(_SECS.sub("T sec", run_lines(inst, lines)))
        inst.sys.tb.close()
        recs.append(_summaries(_event_file(tmp_path / run)))
    assert_close_transcripts(outs[0], outs[1], 1e-4)
    assert "test/acc=" in outs[0] and outs[0].count("epoch=") == 3
    assert [(s, t) for s, t, _ in recs[0]] == [(s, t) for s, t, _ in recs[1]]
    scal = [[(s, t, v[2][0]) for s, t, v in r
             if 2 in v and t != "train/time"] for r in recs]
    assert len(scal[0]) == 3 * 4 and scal[0][0][1] == "train/acc"
    for (s, t, a), (_, _, b) in zip(*scal):
        assert a == b or (t != "train/acc" and abs(a - b) <= 1e-4 * abs(b))
    tags = {t for _, t, _ in recs[0]}
    assert {"mnist/train", "mnist/test", "nn/conv0", "nn/lin6",
            "progress/text"} <= tags


def test_reader_reads_what_the_writer_wrote(t4p, tmp_path):
    """tb/reader.py (chip_smoke's reader where tensorboard is missing):
    the summaries of a file of every kind, and a flipped byte refused"""
    from tensorforth_tpu_torch.tb import reader
    path = _event_file(_drive_dir(t4p, tmp_path))
    got = reader.summaries(path)
    assert [(s, t, k) for s, t, k, _ in got] == [
        (1, "q/loss", "scalar"), (2, "q/loss", "scalar"),
        (2, "q/img", "image"), (2, "q/h", "histo"), (2, "q/txt", "tensor")]
    assert got[1][3] == 0.125 and got[2][3][:8] == b"\x89PNG\r\n\x1a\n"
    assert got[3][3][3] == [4.0]              # the histogram's num
    assert got[4][3][1] == [7] and len(got[4][3][8]) == 1   # DT_STRING
    assert len(reader.records(path)) == len(_read_records(path))
    raw = bytearray(open(path, "rb").read())
    raw[-6] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        reader.records(path)


def _drive_dir(t4p, tmp_path):
    from tensorforth_tpu_torch.tb.summary import Summary
    _drive(t4p, tmp_path, "rd", Summary)
    return tmp_path / "rd"
