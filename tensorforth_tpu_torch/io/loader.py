"""Corpus loaders & registry (the port of tensorforth_tpu/io/loader.py).

Reference: src/ld/{corpus.h,loader.{h,cpp},mnist.{h,cpp},cifar10.{h,cpp}}.
Datasets are searched under Config.DATA_ROOTS (T4_DATA, then ./data ...);
when corpus files are absent a deterministic synthetic corpus with the
same shape and cardinality stands in, so the shipped .4th scripts run
end to end (gate with T4_SYNTH_DATA=0).  IDX and CIFAR records are
parsed with numpy.  The synthetic corpus is the JAX package's byte for
byte; it is made in memory (about 5 s of numpy for mnist_train) rather
than cached on disk.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..config import Config


class Corpus:
    """abstract batch provider: U8 data [size,H,W,C] + U8 labels"""

    def __init__(self):
        self.H = self.W = self.C = 1
        self.size = 0
        self.eof = False
        self._pos = 0
        self._lbl_cache = None   # host labels, set when the dataset
        #                          builds its device-resident corpus

    def init(self):
        raise NotImplementedError

    def rewind(self):
        self._pos = 0
        self.eof = False

    def fetch(self, batch_sz: int, meta_only: bool = False):
        """returns (data[n,H,W,C] u8-ish, labels[n]) or (None, None) at eof

        meta_only: the caller already holds the corpus on device (the
        Dataset's whole-corpus cache) and only needs position
        bookkeeping + host labels — skip the per-batch `_read` (numpy
        work the word loop would pay every batch).  Downgrades
        to a full read on a partial tail batch or when no label cache
        exists, so callers can rely on `data is None` <=> full batch
        served from the device cache."""
        size = self.size
        max_b = int(os.environ.get("T4_MAX_BATCH", "0"))
        if max_b:                           # truncated-epoch fault injection
            size = min(size, max_b * batch_sz)
        if self._pos >= size:
            self.eof = True
            return None, None
        n = min(batch_sz, size - self._pos)
        if meta_only and n == batch_sz and self._lbl_cache is not None:
            d, l = None, self._lbl_cache[self._pos:self._pos + n]
        else:
            d, l = self._read(self._pos, n)
        self._pos += n
        self.eof = self._pos >= size
        return d, l

    def _read(self, pos: int, n: int):
        raise NotImplementedError


def _find(path: str):
    for root in Config.DATA_ROOTS:
        if not root:
            continue
        p = os.path.join(root, path)
        if os.path.exists(p):
            return p
        if os.path.exists(p + ".gz"):
            return p + ".gz"
    return None


def _open(p: str):
    return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")


class Mnist(Corpus):
    """IDX-format reader (reference ld/mnist.cpp big-endian headers)"""

    def __init__(self, img_rel: str, lbl_rel: str):
        super().__init__()
        self.img_rel, self.lbl_rel = img_rel, lbl_rel
        self._img = self._lbl = None

    def available(self) -> bool:
        return (_find(self.img_rel) is not None
                and _find(self.lbl_rel) is not None)

    def init(self):
        if self._img is not None:
            return
        img_p, lbl_p = _find(self.img_rel), _find(self.lbl_rel)
        n, h, w, n2 = self._init_native(img_p, lbl_p)
        if n is None:                              # pure-Python fallback
            with _open(img_p) as f:
                magic, n, h, w = struct.unpack(">IIII", f.read(16))
                assert magic == 0x803, f"bad MNIST image magic {magic:#x}"
                self._img = np.frombuffer(f.read(n * h * w),
                                          dtype=np.uint8).reshape(n, h, w, 1)
            with _open(lbl_p) as f:
                magic, n2 = struct.unpack(">II", f.read(8))
                assert magic == 0x801, f"bad MNIST label magic {magic:#x}"
                self._lbl = np.frombuffer(f.read(n2), dtype=np.uint8)
        assert n2 == n, "label/image count mismatch"
        self.size, self.H, self.W, self.C = n, h, w, 1

    def _init_native(self, img_p: str, lbl_p: str):
        """IDX parse + bulk read in C (csrc/t4io.cpp t4_ld_idx_*);
        returns (None,)*4 when the native lib is unavailable"""
        from ..runtime import native
        lib = native.get_io()
        if lib is None:
            return None, None, None, None
        import ctypes as C
        dims = (C.c_uint32 * 4)()
        hsz = lib.t4_ld_idx_info(img_p.encode(), dims)
        assert hsz > 0 and dims[0] == 0x803, \
            f"bad MNIST image magic {dims[0]:#x}"
        n, h, w = dims[1], dims[2], dims[3]
        img = np.empty(n * h * w, np.uint8)
        got = lib.t4_ld_idx_read(
            img_p.encode(), hsz,
            img.ctypes.data_as(C.POINTER(C.c_uint8)), img.size)
        assert got == img.size, "truncated MNIST image file"
        self._img = img.reshape(n, h, w, 1)
        hsz = lib.t4_ld_idx_info(lbl_p.encode(), dims)
        assert hsz > 0 and dims[0] == 0x801, \
            f"bad MNIST label magic {dims[0]:#x}"
        n2 = dims[1]
        lbl = np.empty(n2, np.uint8)
        got = lib.t4_ld_idx_read(
            lbl_p.encode(), hsz,
            lbl.ctypes.data_as(C.POINTER(C.c_uint8)), lbl.size)
        assert got == lbl.size, "truncated MNIST label file"
        self._lbl = lbl
        return n, h, w, n2

    def _read(self, pos: int, n: int):
        return self._img[pos:pos + n], self._lbl[pos:pos + n]


class Digits(Mnist):
    """REAL handwritten-digit corpus: the UCI ML "Optical Recognition
    of Handwritten Digits" set (NIST-derived, 1797 genuine 8x8 scans)
    bundled with scikit-learn.  On first use the samples are written
    out as standard big-endian IDX files (train 1500 / test 297) and
    then consumed through the SAME reader path as MNIST, so real bytes
    exercise the whole loader stack with no network access.  MNIST proper is
    preferred when its files exist — fetch with scripts/fetch_mnist.py.
    Reference: ld/mnist.cpp:19-92 (IDX format)."""

    def __init__(self, img_rel: str, lbl_rel: str, train: bool):
        super().__init__(img_rel, lbl_rel)
        self._train = train

    def available(self) -> bool:
        return super().available() or self._materialize_idx()

    def _materialize_idx(self) -> bool:
        try:
            from sklearn.datasets import load_digits
        except Exception:
            return False
        root = next((r for r in Config.DATA_ROOTS if r), "./data")
        try:
            d = load_digits()
            # raw ink values are 0..16; rescale to the u8 range so the
            # scripts' (x-mean)/256 normalization convention holds
            img = np.clip(d.images * 15.9375, 0, 255).astype(np.uint8)
            lbl = d.target.astype(np.uint8)
            # seed-pinned stratified split (the standard load_digits
            # methodology; the UCI file is ordered by contributor, so a
            # first/last split would be writer-disjoint)
            per = np.random.RandomState(0).permutation(len(lbl))
            te = np.sort(np.concatenate(
                [per[lbl[per] == c][:30] for c in range(10)])[:297])
            mask = np.zeros(len(lbl), bool)
            mask[te] = True
            sl = ~mask if self._train else mask
            img, lbl = img[sl], lbl[sl]
            os.makedirs(os.path.join(root, "DIGITS/raw"), exist_ok=True)
            with open(os.path.join(root, self.img_rel), "wb") as f:
                f.write(struct.pack(">IIII", 0x803, img.shape[0], 8, 8))
                f.write(np.ascontiguousarray(img).tobytes())
            with open(os.path.join(root, self.lbl_rel), "wb") as f:
                f.write(struct.pack(">II", 0x801, lbl.shape[0]))
                f.write(np.ascontiguousarray(lbl).tobytes())
            return True
        except Exception:
            return False


class Cifar10(Corpus):
    """binary-batch reader: 3073-byte records, NCHW->NHWC transpose
    (reference ld/cifar10.cpp)"""

    REC = 3073

    def __init__(self, rel: str):
        super().__init__()
        self.rel = rel
        self._data = self._lbl = None

    def available(self) -> bool:
        return _find(self.rel) is not None

    def init(self):
        if self._data is not None:
            return
        p = _find(self.rel)
        from ..runtime import native
        lib = native.get_io()
        if lib is not None:
            # record parse + CHW->HWC transpose in C (t4_ld_cifar)
            import ctypes as C
            sz = os.path.getsize(p)
            if p.endswith(".gz"):
                with open(p, "rb") as f:       # gzip ISIZE footer
                    f.seek(-4, 2)
                    sz = struct.unpack("<I", f.read(4))[0]
            cap = max(sz // self.REC, 1)
            data = np.empty((cap, 32, 32, 3), np.uint8)
            lbl = np.empty(cap, np.uint8)
            u8p = C.POINTER(C.c_uint8)
            n = lib.t4_ld_cifar(p.encode(),
                                data.ctypes.data_as(u8p),
                                lbl.ctypes.data_as(u8p), cap)
            assert n > 0, f"no CIFAR records in {p}"
            self._data = np.ascontiguousarray(data[:n])
            self._lbl = lbl[:n].copy()
        else:
            with _open(p) as f:
                raw = np.frombuffer(f.read(), dtype=np.uint8)
            n = len(raw) // self.REC
            raw = raw[:n * self.REC].reshape(n, self.REC)
            self._lbl = raw[:, 0].copy()
            chw = raw[:, 1:].reshape(n, 3, 32, 32)
            self._data = np.ascontiguousarray(chw.transpose(0, 2, 3, 1))
        self.size, self.H, self.W, self.C = n, 32, 32, 3

    def _read(self, pos: int, n: int):
        return self._data[pos:pos + n], self._lbl[pos:pos + n]


class Photos(Cifar10):
    """REAL photographic bytes through the CIFAR-10 reader path (the
    CIFAR-format analog of the digits' real-bytes gate).  scikit-learn
    bundles two genuine RGB photographs (china.jpg / flower.jpg,
    427x640 u8); on first use they are tiled into 32x32 patches and
    written as standard 3073-byte CIFAR batch records (label byte +
    3072 CHW pixels, label 0 = china, 1 = flower), then consumed
    through the SAME Cifar10 reader — record parse, CHW->HWC
    transpose — as a real-scan gate for the path the reference
    reads with ld/cifar10.cpp:21.  13x20 = 260 patches per photo;
    held-out split is a seed-pinned stratified shuffle (25 per class)."""

    def __init__(self, rel: str, train: bool):
        super().__init__(rel)
        self._train = train

    def available(self) -> bool:
        return super().available() or self._materialize_cifar()

    def _materialize_cifar(self) -> bool:
        try:
            from sklearn.datasets import load_sample_images
        except Exception:
            return False
        root = next((r for r in Config.DATA_ROOTS if r), "./data")
        try:
            d = load_sample_images()
            recs, lbls = [], []
            for label, im in enumerate(d.images):      # u8 [427,640,3]
                for i in range(im.shape[0] // 32):
                    for j in range(im.shape[1] // 32):
                        patch = im[32 * i:32 * i + 32,
                                   32 * j:32 * j + 32]     # HWC
                        recs.append(patch.transpose(2, 0, 1))  # CHW
                        lbls.append(label)
            recs = np.asarray(recs, np.uint8)
            lbls = np.asarray(lbls, np.uint8)
            per = np.random.RandomState(0).permutation(len(lbls))
            te = np.sort(np.concatenate(
                [per[lbls[per] == c][:25] for c in range(2)]))
            mask = np.zeros(len(lbls), bool)
            mask[te] = True
            sl = ~mask if self._train else mask
            recs, lbls = recs[sl], lbls[sl]
            if self._train:
                # interleave the classes (the tiling emits all china
                # patches then all flower patches; class-pure batches
                # make the reference's uncorrected Adam oscillate) —
                # real CIFAR batch files are likewise shuffled
                p2 = np.random.RandomState(1).permutation(len(lbls))
                recs, lbls = recs[p2], lbls[p2]
            os.makedirs(os.path.join(root, "PHOTOS/raw"), exist_ok=True)
            with open(os.path.join(root, self.rel), "wb") as f:
                for r, l in zip(recs, lbls):
                    f.write(bytes([int(l)]))
                    f.write(np.ascontiguousarray(r).tobytes())
            return True
        except Exception:
            return False


class Synthetic(Corpus):
    """deterministic stand-in corpus, hard enough that accuracy numbers
    discriminate: each sample is an
    oriented sinusoidal grating — class = (orientation, frequency) pair —
    with a *uniformly random phase* per sample, plus pixel noise.  The
    random phase makes every class-conditional pixel mean identical, so
    a linear (or flatten+linear) model is near chance by construction;
    detecting orientation/frequency needs local nonlinear feature
    extraction (conv -> relu -> pool), which the shipped t4_30e CNN
    topologies provide.  ≥98% therefore certifies real representation
    learning, not prototype memorization."""

    ANGLES = 5           # orientations over [0, pi)
    FREQS = (8.0, 4.0)   # wavelengths in px -> ANGLES*len(FREQS) classes
    # difficulty as the JAX package calibrated it (its loader keeps the
    # record): its t4_30e CNN lands at about 98-99.5% after 20 epochs.
    # The task has an init-dependent failure mode (a class collapses
    # when no conv filter latches onto it), so a gate runs under a fixed
    # T4_SEED.
    NOISE = 128          # uniform per-pixel noise amplitude
    AMP = 40.0           # grating amplitude
    WL_JITTER = 0.20     # per-sample multiplicative frequency jitter

    def __init__(self, size: int, h: int, w: int, c: int, seed: int):
        super().__init__()
        self.size, self.H, self.W, self.C = size, h, w, c
        self._seed = seed
        self._data = None        # the materialized corpus
        self._lbl = None
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        ang = np.pi * np.arange(self.ANGLES) / self.ANGLES
        # per-class projection field (h, w) — phase added per sample
        self._fields = np.stack([
            2.0 * np.pi / wl * (np.cos(a) * xx + np.sin(a) * yy)
            for a in ang for wl in self.FREQS])

    def _u01(self, idx: np.ndarray, salt: int) -> np.ndarray:
        """splitmix64-style counter hash -> U[0,1) float64.

        The corpus is a pure function of (seed, sample index): every
        draw is keyed on the absolute sample (or pixel) index, so every
        read window serves the same bytes for a sample."""
        return (self._hash(idx, salt) >> np.uint64(11)) \
            .astype(np.float64) / float(1 << 53)

    def _hash(self, idx: np.ndarray, salt: int) -> np.ndarray:
        off = np.uint64((self._seed * 0xD1B54A32D192ED03
                         + salt * 0x8CB92BA72F3D8DD7) & 0xFFFFFFFFFFFFFFFF)
        x = idx.astype(np.uint64) + off
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    def available(self) -> bool:
        return True

    def init(self):
        pass

    def _gen(self, pos: int, n: int):
        """generate samples [pos, pos+n) — pure in the sample index"""
        idx = np.arange(pos, pos + n)
        n_cls = self._fields.shape[0]
        lbl = ((idx * 7 + (idx // 10) * 3) % n_cls).astype(np.int64)
        phase = (self._u01(idx, 0) * 2.0 * np.pi)[:, None, None]
        fields = self._fields[lbl]
        if self.WL_JITTER:
            # per-sample frequency jitter blurs the class boundaries in
            # frequency space
            jit = (1.0 + self.WL_JITTER
                   * (2.0 * self._u01(idx, 1) - 1.0))[:, None, None]
            fields = fields * jit
        g = np.sin(fields + phase).astype(np.float32)    # [n, h, w]
        data = 128.0 + np.float32(self.AMP) * g[..., None] \
            * np.ones(self.C, np.float32)
        # per-pixel noise keyed on the absolute pixel index (integer
        # bits straight off the hash)
        hwc = self.H * self.W * self.C
        pix = (idx[:, None] * np.int64(hwc)
               + np.arange(hwc, dtype=np.int64)[None, :]).ravel()
        noise = ((self._hash(pix, 2) >> np.uint64(11))
                 % np.uint64(self.NOISE)) \
            .astype(np.float32).reshape(data.shape)
        data = data + noise - np.float32(self.NOISE / 2)
        return (np.clip(data, 0, 255).astype(np.uint8),
                lbl.astype(np.uint8))

    def _materialize(self):
        """one-time materialization of the whole corpus in memory
        (chunked: the same bytes as one _gen over all of it)"""
        if self._data is not None:
            return
        d = np.empty((self.size, self.H, self.W, self.C), np.uint8)
        lbl = np.empty((self.size,), np.uint8)
        for s in range(0, self.size, 8192):
            e = min(self.size, s + 8192)
            d[s:e], lbl[s:e] = self._gen(s, e - s)
        self._data, self._lbl = d, lbl

    def _read(self, pos: int, n: int):
        self._materialize()
        return self._data[pos:pos + n], self._lbl[pos:pos + n]


class Loader:
    """name -> Corpus registry (reference ld/loader.cpp)"""

    _map: dict = {}

    @classmethod
    def init(cls):
        if cls._map:
            return
        cls._map = {
            "mnist_train": Mnist("MNIST/raw/train-images-idx3-ubyte",
                                 "MNIST/raw/train-labels-idx1-ubyte"),
            "mnist_test": Mnist("MNIST/raw/t10k-images-idx3-ubyte",
                                "MNIST/raw/t10k-labels-idx1-ubyte"),
            "cifar10_train": Cifar10(
                "CIFAR10/cifar-10-batches-bin/data_batch.bin"),
            "cifar10_test": Cifar10(
                "CIFAR10/cifar-10-batches-bin/test_batch.bin"),
            # real handwritten-digit data available offline (no
            # synthetic fallback — this is the real-data gate)
            "digits_train": Digits("DIGITS/raw/train-images-idx3-ubyte",
                                   "DIGITS/raw/train-labels-idx1-ubyte",
                                   True),
            "digits_test": Digits("DIGITS/raw/t10k-images-idx3-ubyte",
                                  "DIGITS/raw/t10k-labels-idx1-ubyte",
                                  False),
            # real photographic bytes in CIFAR record format (offline;
            # exercises the Cifar10 reader end-to-end on real scans)
            "photos_train": Photos("PHOTOS/raw/data_batch.bin", True),
            "photos_test": Photos("PHOTOS/raw/test_batch.bin", False),
        }

    _SYNTH = {
        "mnist_train": (60000, 28, 28, 1, 11),
        "mnist_test": (10000, 28, 28, 1, 77),
        "cifar10_train": (50000, 32, 32, 3, 13),
        "cifar10_test": (10000, 32, 32, 3, 99),
    }

    @classmethod
    def get(cls, ds, name: str):
        cls.init()
        cp = cls._map.get(name)
        if cp is not None and cp.available():
            return cp
        if Config.ALLOW_SYNTHETIC_DATA and name in cls._SYNTH:
            from ..system import System
            System.get_sys().pstr(
                f"\\ WARN: corpus files for '{name}' not found under "
                f"{[r for r in Config.DATA_ROOTS if r]}, "
                f"using deterministic synthetic stand-in\n")
            key = "synth:" + name
            if key not in cls._map:
                cls._map[key] = Synthetic(*cls._SYNTH[name])
            return cls._map[key]
        return None
