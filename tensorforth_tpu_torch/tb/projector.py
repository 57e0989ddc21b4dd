"""Embedding projector output (reference tb/projector.h):
tensors/metadata TSV + projector_config.pbtxt.
"""
from __future__ import annotations

import os

import numpy as np


class Projector:
    def __init__(self, logdir: str):
        self.logdir = logdir
        self._entries = []

    def add_embedding(self, tag: str, data: np.ndarray, labels=None):
        os.makedirs(self.logdir, exist_ok=True)
        safe = tag.replace("/", "_")
        tsv = os.path.join(self.logdir, f"{safe}_tensors.tsv")
        d = np.asarray(data)
        d2 = d.reshape(d.shape[0], -1) if d.ndim > 1 else d.reshape(1, -1)
        with open(tsv, "w") as f:
            for row in d2:
                f.write("\t".join(f"{v:g}" for v in row) + "\n")
        entry = {"tensor_path": os.path.basename(tsv), "tensor_name": tag}
        if labels is not None:
            meta = os.path.join(self.logdir, f"{safe}_metadata.tsv")
            with open(meta, "w") as f:
                for v in labels:
                    f.write(f"{v}\n")
            entry["metadata_path"] = os.path.basename(meta)
        self._entries.append(entry)
        self._write_config()

    def _write_config(self):
        cfg = os.path.join(self.logdir, "projector_config.pbtxt")
        with open(cfg, "w") as f:
            for en in self._entries:
                f.write("embeddings {\n")
                f.write(f'  tensor_name: "{en["tensor_name"]}"\n')
                f.write(f'  tensor_path: "{en["tensor_path"]}"\n')
                if "metadata_path" in en:
                    f.write(f'  metadata_path: "{en["metadata_path"]}"\n')
                f.write("}\n")
