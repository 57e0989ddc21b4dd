"""HParams plugin writer (reference tb/hparam.h — present there but not
wired to a Forth word; exposed here as a Python API and the `.hparam`
word).

Writes the three hparams-plugin summaries (experiment, session start,
session end) as SummaryMetadata-tagged events the TensorBoard HParams
dashboard can read.
"""
from __future__ import annotations

from . import encoder as e


_PLUGIN = "hparams"


def _plugin_value(tag: str, content: bytes) -> bytes:
    meta = e.f_msg(1, e.f_str(1, _PLUGIN) + e.f_bytes(2, content))
    tensor = e.f_varint(1, 7)                     # DT_STRING placeholder
    val = e.f_str(1, tag) + e.f_msg(8, tensor) + e.f_msg(9, meta)
    return e.f_msg(1, val)


def _hparam_proto(name: str, v) -> bytes:
    """google.protobuf.Value: number_value=2 (double), string_value=3"""
    if isinstance(v, (int, float)):
        return e.f_double(2, float(v))
    return e.f_str(3, str(v))


class HParamWriter:
    """session-level hyperparameter records"""

    def __init__(self, writer):
        self._w = writer

    def experiment(self, hparam_names: list, metric_tags: list):
        exp = b""
        for nm in hparam_names:
            exp += e.f_msg(2, e.f_str(1, nm))              # HParamInfo.name
        for mt in metric_tags:
            exp += e.f_msg(3, e.f_msg(1, e.f_str(1, mt)))  # MetricInfo.name.tag
        # HParamsPluginData{version=0 field1, experiment field2}
        content = e.f_varint(1, 0) + e.f_msg(2, exp)
        self._w._write_summary(_plugin_value(
            "_hparams_/experiment", content))

    def session_start(self, hparams: dict, group: str = ""):
        sess = b""
        if group:
            sess += e.f_str(1, group)
        for k, v in hparams.items():
            entry = e.f_str(1, k) + e.f_msg(2, _hparam_proto(k, v))
            sess += e.f_msg(2, entry)                      # map<string,Value>
        content = e.f_varint(1, 0) + e.f_msg(3, sess)
        self._w._write_summary(_plugin_value(
            "_hparams_/session_start_info", content))

    def session_end(self, status: int = 1):
        content = e.f_varint(1, 0) + e.f_msg(4, e.f_varint(1, status))
        self._w._write_summary(_plugin_value(
            "_hparams_/session_end_info", content))
