"""Summary — PyTorch-SummaryWriter equivalent driving the Forth TB words
(the port of tensorforth_tpu/tb/summary.py).

Reference: tb/summary.{h,cpp}: run-dir management, scalar/text/image/
tile/histo/graph/embed, model-graph op-name mapping.

Host-op deferral (reference ostream.h event queue, sys.cpp flush): every
public method posts the encode+write work to the io.equeue worker, so TB
IO overlaps device compute.  What a record needs of a tensor is computed
where the tensor lies, at post time: the tile's pixels (tile_pixels) and
the histogram's moments and counts (histo_stats) on the card, an
embedding as a clone.  Those new tensors are the snapshot — later
in-place updates of the payload (an optimizer step, a replayed cycle)
cannot reach them — and only they are copied to the host, by the worker,
to be written.  A single FIFO worker preserves record ordering;
`close`/`flush` join the queue.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..io.equeue import EventQueue
from .projector import Projector
from .writer import EventWriter


def tile_pixels(d: torch.Tensor, shape, n_per_row: int, border: int = 1,
                offset: float = 128.0) -> torch.Tensor:
    """N images [N,H,W,C] -> a grid of them [rows*(H+b), n*(W+b), 3] of
    uint8 (b the border), mean/std auto-scaled RGB around `offset`
    (reference Summary::tile, and AIO::t2png with no border and offset
    0), computed where d lies.  The arithmetic is the JAX package's numpy
    one: float32 moments, the scale divided in f64 and rounded to f32,
    truncation to uint8"""
    N, H, W, C = shape
    d = d.detach().reshape(N, H, W, C).to(torch.float32)
    mean, std = d.mean(), d.std(correction=0)
    scale = torch.where(std > 1e-6, 64.0 / std.double(),
                        torch.full_like(std, 64.0, dtype=torch.float64))
    d = ((d - mean) * scale.float() + offset).clamp(0, 255).to(torch.uint8)
    if C == 1:
        d = d.expand(N, H, W, 3)
    d = d[..., :3]
    rows = (N + n_per_row - 1) // n_per_row
    hb, wb = H + border, W + border
    grid = torch.zeros((rows * n_per_row, hb, wb, 3), dtype=torch.uint8,
                       device=d.device)
    grid[:N, :H, :W] = d
    return (grid.reshape(rows, n_per_row, hb, wb, 3)
            .permute(0, 2, 1, 3, 4).reshape(rows * hb, n_per_row * wb, 3))


def histo_stats(d: torch.Tensor, bins: int) -> torch.Tensor:
    """the Histogram proto's fields of d, computed where d lies, as one
    f64 tensor [min, max, num, sum, sum of squares, the bins' right
    edges (bins), the counts (bins)].  Bins as the JAX package's
    np.histogram(d, bins, range=(min, max)) draws them: its linspace
    edges and its index rule with the one-ulp corrections, the last bin
    closed.  The sums are torch's f64 reductions: numpy's pairwise ones
    may round otherwise in the last bit"""
    x = d.detach().reshape(-1).to(torch.float64)
    mn, mx = x.min(), x.max()
    mx = torch.where(mn == mx, mn + 1.0, mx)
    step = (mx - mn) / bins
    edges = torch.arange(bins + 1, dtype=torch.float64,
                         device=x.device) * step + mn
    edges[bins] = mx
    # a NaN or inf leaves the range not finite: the writer refuses the
    # record, and the clamp keeps the indexing below inside the edges
    idx = ((x - mn) / (mx - mn) * bins).nan_to_num(0.0).clamp(
        0, bins).to(torch.int64)
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (x < edges[idx]).to(torch.int64)
    idx = idx + ((x >= edges[idx + 1]) & (idx != bins - 1)).to(torch.int64)
    counts = torch.zeros(bins, dtype=torch.float64, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(x))
    head = torch.stack([mn, mx, torch.full_like(mn, x.numel()), x.sum(),
                        (x * x).sum()])
    return torch.cat([head, edges[1:], counts])


# reference summary.cpp:115-160 layer -> TF op name mapping
_TF_OPS = {
    0: "Identity", 1: "Conv2D", 2: "MatMul", 3: "Reshape", 4: "Relu",
    5: "Tanh", 6: "Sigmoid", 7: "Selu", 8: "LeakyRelu", 9: "Elu",
    10: "Dropout", 11: "Softmax", 12: "LogSoftmax", 13: "AvgPool",
    14: "MaxPool", 15: "MinPool", 16: "FusedBatchNorm", 17: "UpSample",
    18: "Conv2DBackpropInput",
}


def _nhwc(t):
    return (t.N(), t.H(), t.W(), t.C())


class Summary:
    def __init__(self, logdir: str, run_id: str | None = None):
        self.logdir = logdir
        self.run_id = run_id
        self.path = os.path.join(logdir, run_id) if run_id else logdir
        self._w: EventWriter | None = None
        self._proj: Projector | None = None
        self._hparams: dict = {}
        self._q = EventQueue()

    def _writer(self) -> EventWriter:
        if self._w is None:
            self._w = EventWriter(self.logdir, self.run_id)
        return self._w

    def flush(self):
        self._q.flush()

    def pending(self) -> int:
        """records posted and not yet written"""
        return self._q.pending()

    def init(self, tag: str):
        """re-point to a new run directory (.tbinit word)"""
        self.close()
        self.run_id = tag
        self.path = os.path.join(self.logdir, tag)

    def set_step(self, i: int):
        self._q.post(lambda: setattr(self._writer(), "step", int(i)))

    def scalar(self, tag: str, v: float):
        self._q.post(lambda: self._writer().add_scalar(tag, v))

    def text(self, tag: str, txt: str):
        self._q.post(lambda: self._writer().add_text(tag, txt))

    def _png(self, tag: str, px: torch.Tensor):
        def work(px):
            from .png import raw2png
            self._writer().add_image(tag, raw2png(px), px.shape[0],
                                     px.shape[1])
        self._q.post(work, px)

    def image(self, tag: str, t):
        self._png(tag, tile_pixels(t.ensure_data(), _nhwc(t), 1))

    def tile(self, tag: str, t, n_per_row: int):
        self._png(tag, tile_pixels(t.ensure_data(), _nhwc(t),
                                   max(1, int(n_per_row))))

    def histo(self, tag: str, t, bins: int):
        bins = max(1, int(bins))
        if t.numel == 0:
            return

        def work(st):
            self._writer().add_histo_stats(tag, st[:5], st[5:5 + bins],
                                           st[5 + bins:])
        self._q.post(work, histo_stats(t.ensure_data(), bins))

    def graph(self, m):
        if m is None or not m.is_model():
            return
        nodes = []                      # snapshot topology at post time
        prev = "input"
        nodes.append(("input", "Placeholder", []))
        for i in range(m.numel - 1):
            fn = m[i].grad_fn if m[i].grad_fn is not None else 0
            name = f"layer{i}_{_TF_OPS.get(fn, 'Identity')}"
            nodes.append((name, _TF_OPS.get(fn, "Identity"), [prev]))
            prev = name
        self._q.post(lambda: self._writer().add_graph(nodes))

    def embed(self, tag: str, t):
        n = t.N()

        def work(d):
            if self._proj is None:
                self._proj = Projector(self.path)
            self._proj.add_embedding(tag, np.asarray(d, np.float32)
                                     .reshape(n, -1))
        self._q.post(work, t.ensure_data().detach().clone())

    def hparam(self, name: str, value):
        """record a hyperparameter for the HParams dashboard (the
        reference ships tb/hparam.h unwired; here `.hparam` drives it)"""
        self._hparams[name] = value

    def _flush_hparams(self):
        hp = self._hparams
        if not hp or self._w is None:
            return
        from .hparam import HParamWriter
        w = HParamWriter(self._w)
        w.experiment(list(hp.keys()), [])
        w.session_start(hp)
        w.session_end()
        self._hparams = {}

    def close(self):
        self._q.flush()
        if self._w:
            self._flush_hparams()
            self._w.close()
            self._w = None
