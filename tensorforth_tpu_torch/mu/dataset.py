"""Dataset — Tensor subclass with corpus bookkeeping (the port of
tensorforth_tpu/mu/dataset.py).

Reference: src/mu/dataset.{h,cu}.  The whole U8 corpus is put on the
dataset's device once (per corpus and device).  A fetch of a full batch
then records only its corpus offset (`_fetch_spec`): the fused training
cycle slices and normalizes it inside its own program, and any other
reader makes it on first use (`ensure_data`): one slice of the corpus
normalized as (x - mean) * 1/scale in f32, with its labels sliced beside
it on the device (`label_dev`, what the forward's one-hot reads).  The
labels are also kept on the host (`label`, U32).  A partial tail batch
is normalized on the host and padded with zeros.  Dimensions are
discovered on the first fetch (reference dataset.cu:64-121).
"""
from __future__ import annotations

import numpy as np
import torch

from .tensor import T4Type, Tensor


class Dataset(Tensor):
    def __init__(self, batch_sz: int, device=None):
        super().__init__(batch_sz, 1, 1, 1, device=device)
        self.ttype = T4Type.DATASET
        self.batch_sz = batch_sz
        self.batch_id = -1
        self.dataset_size = 0
        self.done = False
        self.label = np.zeros(batch_sz, dtype=np.uint32)
        self.label_dev = None              # device labels of a full batch
        self._mean = 0.0
        self._scale = 1.0 / 256.0
        self._corpus = None
        self._fetch_spec = None            # corpus offset of a deferred batch

    def normalize(self, mean: float, scale: float):
        self._mean = float(mean)
        self._scale = 1.0 / float(scale) if abs(scale) > 1e-12 else 1.0

    def fetch(self, ds_name: str | None = None, rewind: int = 0,
              trace: int = 0) -> "Dataset":
        from ..io.loader import Loader
        if ds_name is not None and self._corpus is None:
            cp = Loader.get(self, ds_name)
            if cp is None:
                from ..system import System
                System.get_sys().perr("", f"dataset {ds_name}? ")
                return self
            self._corpus = cp
            cp.init()
            cp.rewind()        # a NEW binding starts at record 0: the
            #                    registry corpus is process-shared and
            #                    may sit at another dataset's end
            self.shape = (self.batch_sz, cp.H, cp.W, cp.C)   # re-dimension
            self.rank = 4
            self.data = None
            self.dataset_size = cp.size
            self.batch_id = -1
            from .mmu import MMU
            MMU.get_mmu().rebind(self)       # account the real size
        cp = self._corpus
        if cp is None:
            return self
        if rewind:
            cp.rewind()
            self.batch_id = -1
            self.done = False
        data, label = cp.fetch(self.batch_sz,
                               meta_only=self._resident() is not None)
        self.done = cp.eof
        if label is not None:
            self._load(data, label)
            self.batch_id += 1
        return self

    def rewind(self, trace: int = 0):
        return self.fetch(None, rewind=1, trace=trace)

    def _resident(self):
        """(corpus bytes, labels) on this dataset's device, or None"""
        dev = getattr(self._corpus, "_dev", None)
        if dev is not None and dev[0] == self.device:
            return dev[1], dev[2]
        return None

    def _upload(self):
        """the whole corpus onto the device, once per corpus and device
        (the host labels kept for fetches that read no bytes)"""
        cp = self._corpus
        if self._resident() is None and hasattr(cp, "_read"):
            full, full_lbl = cp._read(0, cp.size)
            cp._dev = (self.device,
                       torch.from_numpy(np.array(full, np.uint8)).to(
                           self.device),
                       torch.from_numpy(np.asarray(full_lbl, np.int64)).to(
                           self.device))
            cp._lbl_cache = np.asarray(full_lbl)
        return self._resident()

    def ensure_data(self):
        """make a deferred batch (the per-word forward, printing, a host
        read).  A set _fetch_spec is always newer than .data (_load
        clears it), so it wins"""
        if self._fetch_spec is not None:
            pos, self._fetch_spec = self._fetch_spec, None
            buf, labels = self._resident()
            n = self.batch_sz
            mean = torch.tensor(self._mean, dtype=torch.float32,
                                device=self.device)
            scale = torch.tensor(self._scale, dtype=torch.float32,
                                 device=self.device)
            x = (buf[pos:pos + n].to(torch.float32) - mean) * scale
            if self.aoff is not None:
                self.replace_data(x)         # into the batch's pool slot
            else:
                self.data = x.reshape(self.shape)
            self.label_dev = labels[pos:pos + n]
        return super().ensure_data()

    def _load(self, data: np.ndarray | None, label: np.ndarray):
        """stage the batch just fetched.  data is None when the corpus
        served a full batch by its position alone (the corpus is on the
        device already); such a batch is deferred to its first reader"""
        self._fetch_spec = None            # drop a batch nobody read
        n = self.batch_sz if data is None else data.shape[0]
        res = self._upload()
        if res is not None and n == self.batch_sz:
            self._fetch_spec = self._pos_of_batch()
            self.data = None
            self.label = label.astype(np.uint32)
            self.label_dev = None
            if self.aoff is not None:
                # under the device arena the batch is fetched eagerly into
                # its pool slot, so no corpus offset is left for the fused
                # fetch or a trace chunk to serve (the JAX package's rule)
                self.ensure_data()
            return
        self.label_dev = None                      # host path
        d = (data.astype(np.float32) - self._mean) * self._scale
        if n < self.batch_sz:                      # partial tail batch
            pad = np.zeros((self.batch_sz - n,) + d.shape[1:], np.float32)
            d = np.concatenate([d, pad], axis=0)
            lbl = np.zeros(self.batch_sz, np.uint32)
            lbl[:n] = label
        else:
            lbl = label.astype(np.uint32)
        self.set_numpy(d.reshape(self.shape))
        self.label = lbl

    def _pos_of_batch(self) -> int:
        """corpus offset of the batch just fetched"""
        return self._corpus._pos - self.batch_sz
