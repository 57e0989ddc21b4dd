"""The port's attention measurement path (tensorforth_tpu_torch/ops/attn.py:
the fused single-kernel backward and the dots-only probe;
tensorforth_tpu_torch/attn_bench.py) held against the JAX package on the
CPU.  Inputs come from numpy seeds and go through both packages; the
Pallas kernel runs in interpret mode, as tests/test_attention.py runs it.
Tolerances are stated at each test."""
import contextlib
import importlib
import math
import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorforth_tpu.ops import attn_pallas
from tensorforth_tpu_torch import attn_bench
from tensorforth_tpu_torch.ops import _build, attn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """small CPU products: one thread, so the suite's other workers keep
    their cores"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, s, dh, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, dh).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _fwd(q, k, v, causal, hybrid=False):
    """the port's forward residuals (o, lse [B, S]) as torch tensors"""
    return attn.flash_attention_ref(*_t(q, k, v), causal, hybrid)


# ---------------------------------------------------------------------------
# (a) the fused backward's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hybrid", [False, True])
def test_fused_bwd_ref_matches_pallas_interpret(hybrid, causal, with_dlse):
    """b 2, S 512, dh 128, bq 256 (two Q blocks, so the sum over the
    partials is exercised).  f32: within 1e-5 absolute plus 1e-5 relative,
    the tolerance of tests/test_attention.py:364-368 (f32 sums in another
    order; the interpreter's dots are pinned to full f32).  hybrid (bf16
    multiplicands, f32 sums): within 5% of the largest reference value,
    the bound of tests/test_attention.py:221-225."""
    b, s, dh, bq = 2, 512, 128, 256
    q, k, v, do = _inputs(100 + 4 * hybrid + 2 * causal + with_dlse, b, s, dh)
    dlse = (np.random.RandomState(7).randn(b, s).astype(np.float32) * 0.1
            if with_dlse else None)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    with (contextlib.nullcontext() if hybrid
          else jax.default_matmul_precision("highest")):
        o, lse = attn_pallas.flash_attention(
            jq, jk, jv, causal=causal, return_lse=True, interpret=True,
            hybrid=hybrid)
        want = attn_pallas.flash_attention_bwd_fused(
            jq, jk, jv, o, lse, jdo, bq=bq, bkv=256, causal=causal,
            interpret=True, hybrid=hybrid,
            dlse=None if dlse is None else jnp.asarray(dlse))
    got = attn.flash_attention_bwd_fused_ref(
        *_t(q, k, v, np.asarray(o), np.asarray(lse)[..., 0], do), bq=bq,
        causal=causal, hybrid=hybrid,
        dlse=None if dlse is None else torch.tensor(dlse))
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w)
        assert g.shape == (b, s, dh)
        if hybrid:
            err = np.max(np.abs(g.numpy() - w))
            assert err / (np.max(np.abs(w)) + 1e-9) < 0.05, (nm, err)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=nm)


# ---------------------------------------------------------------------------
# (b) fused against split inside the port, and the partials
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bq", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hybrid", [False, True])
def test_fused_ref_matches_two_kernel_ref_and_partials(hybrid, causal, bq):
    """the fused plain version equals the two-kernel plain version within
    1e-5 (the same p and ds; dq and the partials summed in another order);
    the partials are [B, n_q, S, dh], zero in the causal blocks that are
    never visited, and sum to dk and dv"""
    b, s, dh = 2, 256, 128
    q, k, v, do = _inputs(200 + bq + causal, b, s, dh)
    dlse = torch.tensor(np.random.RandomState(9).randn(b, s)
                        .astype(np.float32))
    o, lse = _fwd(q, k, v, causal, hybrid)
    args = (*_t(q, k, v), o, lse, torch.tensor(do))
    want = attn.flash_attention_bwd_ref(*args, causal, hybrid, dlse)
    dq, dkp, dvp = attn.flash_attention_bwd_fused_parts_ref(
        *args, bq, causal, hybrid, dlse)
    n_q = s // bq
    assert dkp.shape == dvp.shape == (b, n_q, s, dh)
    for qi in range(n_q):
        after = slice((qi + 1) * bq, None)
        if causal:
            assert not dkp[:, qi, after].any()
            assert not dvp[:, qi, after].any()
        elif qi < n_q - 1:
            assert dkp[:, qi, after].any() and dvp[:, qi, after].any()
    got = attn.flash_attention_bwd_fused_ref(*args, bq, causal, hybrid, dlse)
    assert torch.equal(got[0], dq)
    assert torch.equal(got[1], dkp.sum(dim=1))
    assert torch.equal(got[2], dvp.sum(dim=1))
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=nm)


@pytest.mark.parametrize("s", [64, 128, 256, 512, 768, 1024, 1536, 2048,
                               2560, 4096, 8192])
def test_fit_block_is_the_jax_packages(s):
    for pref in (512, 1024):
        assert attn._fit_block(s, pref) == attn_pallas._fit_block(s, pref)


def test_fused_default_bq_is_fit_block_1024():
    q, k, v, do = _inputs(3, 1, 1536, 128)
    o, lse = _fwd(q, k, v, True)
    _, dkp, _ = attn.flash_attention_bwd_fused_parts(
        *_t(q, k, v), o, lse, torch.tensor(do), causal=True)
    assert dkp.shape == (1, 2, 1536, 128)       # bq = 768


# ---------------------------------------------------------------------------
# (c) the probe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nh,s,dh", [(2, 1024, 128), (1, 512, 256)])
def test_attn_dots_ref_matches_the_pallas_kernel_body(nh, s, dh):
    """the arithmetic of the kernel body of bench.py:_attn_dots_probe
    (bench.py:692-704), reproduced with jnp.dot on bf16 inputs, since the
    probe builds its pallas_call with no interpret flag: within 1e-3 of the
    largest value.  Both round the scores to bf16 from f32 sums taken in
    another order, and a score that rounds to the neighbouring bf16 value
    moves by a relative 2^-8: 2.3e-4 of the largest value here.  A version
    that does not round the scores differs by 1.7e-3."""
    rs = np.random.RandomState(11)
    q, k, v = (jnp.asarray(rs.randn(nh, s, dh), jnp.bfloat16)
               for _ in range(3))
    ckv = 512

    def body(qb, kb, vb):
        s2 = jnp.dot(qb, kb.T, preferred_element_type=jnp.float32)
        acc = jnp.zeros((s, dh), jnp.float32)
        for i in range(s // ckv):
            acc = acc + jnp.dot(
                s2[:, i * ckv:(i + 1) * ckv].astype(jnp.bfloat16),
                vb[i * ckv:(i + 1) * ckv],
                preferred_element_type=jnp.float32)
        return acc

    want = np.stack([np.asarray(body(q[i], k[i], v[i])) for i in range(nh)])
    tq, tk, tv = (torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = attn.attn_dots_ref(tq, tk, tv)
    assert got.shape == (nh, s, dh) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * np.max(np.abs(want))
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = attn.attn_dots.launches
    assert torch.equal(attn.attn_dots(tq, tk, tv), got)
    assert attn.attn_dots.launches == before


# ---------------------------------------------------------------------------
# (d) what the wrappers refuse, and the CPU path
# ---------------------------------------------------------------------------
def _fused_call(s=512, dh=128, bq=None, device_of_k="cpu"):
    q = torch.zeros(1, s, dh)
    lse = torch.zeros(1, s)
    return lambda: attn.flash_attention_bwd_fused(
        q, q.to(device_of_k), q, q, lse, q, bq=bq)


def _dots_call(s=512, dh=128, dtype=torch.bfloat16, device_of_k="cpu"):
    q = torch.zeros(1, s, dh, dtype=dtype)
    return lambda: attn.attn_dots(q, q.to(device_of_k), q)


@pytest.mark.parametrize("call", [
    pytest.param(_fused_call(dh=64), id="fused-dh64"),
    pytest.param(_fused_call(dh=384), id="fused-dh384"),
    pytest.param(_fused_call(s=480), id="fused-S-not-tiles"),
    pytest.param(_fused_call(bq=192), id="fused-S%bq"),
    pytest.param(_fused_call(bq=32), id="fused-bq-not-tiles"),
    pytest.param(_fused_call(device_of_k="meta"), id="fused-mixed-devices"),
    pytest.param(_dots_call(dh=64), id="dots-dh64"),
    pytest.param(_dots_call(s=100), id="dots-S-not-tiles"),
    pytest.param(_dots_call(dtype=torch.float32), id="dots-f32"),
    pytest.param(_dots_call(device_of_k="meta"), id="dots-mixed-devices"),
])
def test_wrappers_raise(call):
    with pytest.raises(ValueError):
        call()


def test_fused_wrapper_uses_plain_version_on_cpu():
    """CPU tensors take the plain version and launch nothing"""
    q, k, v, do = _inputs(37, 1, 512, 128)
    o, lse = _fwd(q, k, v, True)
    args = (*_t(q, k, v), o, lse, torch.tensor(do))
    before = attn.flash_attention_bwd_fused.launches
    got = attn.flash_attention_bwd_fused(*args, bq=128, causal=True)
    want = attn.flash_attention_bwd_fused_ref(*args, bq=128, causal=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert attn.flash_attention_bwd_fused.launches == before == 0


# ---------------------------------------------------------------------------
# (e) the entry points
# ---------------------------------------------------------------------------
TINY = dict(nh=2, s=128, dh=128, n_iter=2, reps=2)
ENTRY = {
    "bench_attention": (attn_bench.bench_attention,
                        {"hybrid", "f32stream", "plain"}),
    "bench_attention_bwd": (attn_bench.bench_attention_bwd,
                            {"hybrid", "plain"}),
    "bench_attention_oracle": (
        attn_bench.bench_attention_oracle,
        {"fwd", "fwd_causal", "bwd", "bwd_causal", "dots_only_tflops",
         "full_vs_dots_time_ratio"}),
}


def _finite_positive(xs, n):
    return len(xs) == n and all(math.isfinite(x) and x > 0 for x in xs)


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_entry_point_on_cpu_returns_its_keys(name):
    fn, keys = ENTRY[name]
    out = fn(device="cpu", **TINY)
    assert set(out) == keys
    assert all(_finite_positive(xs, TINY["reps"]) for xs in out.values())


def test_attn_dots_probe_on_cpu():
    dots, ratio = attn_bench.attn_dots_probe(device="cpu", **TINY)
    assert _finite_positive(dots, 2) and _finite_positive(ratio, 2)


def test_sweep_bwd_fused_on_cpu():
    out = attn_bench.sweep_bwd_fused(
        "all", n_iter=2, reps=2, device="cpu",
        shapes={"128": (2, 128), "256": (1, 256)}, bqs=(64, 128, 512))
    assert [(r["s"], r["causal"]) for r in out] == [
        (128, False), (128, True), (256, False), (256, True)]
    for r in out:
        fused = [f"fused bq={bq}" for bq in
                 ((128, 64) if r["s"] == 128 else (256, 128, 64))]
        assert list(r["tflops"]) == ["split"] + fused
        assert list(r["vs_control"]) == fused
        assert all(_finite_positive(xs, 2) for part in ("tflops", "vs_control")
                   for xs in r[part].values())
        bq = int(fused[-1].split("=")[1])
        assert r["blocks"][fused[-1]] == r["b"] * r["s"] // bq
        assert r["partial_bytes_written_and_read"][fused[-1]] == (
            4 * (r["s"] // bq) * r["b"] * r["s"] * 128 * 4)
    only = attn_bench.sweep_bwd_fused(
        "256", n_iter=1, reps=1, device="cpu",
        shapes={"128": (2, 128), "256": (1, 256)}, bqs=(128,))
    assert [r["s"] for r in only] == [256, 256]


@pytest.mark.parametrize("fn", [
    attn_bench.bench_attention, attn_bench.bench_attention_bwd,
    attn_bench.bench_attention_oracle, attn_bench.attn_dots_probe,
    attn_bench.sweep_bwd_fused,
    lambda: attn_bench.sweep([], 1, 128, 128, False),
    lambda: attn_bench.main(["fwd"])],
    ids=["bench_attention", "bench_attention_bwd", "bench_attention_oracle",
         "attn_dots_probe", "sweep_bwd_fused", "sweep", "main"])
def test_entry_point_raises_without_a_card(fn):
    """no device named: the card, and here there is none"""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_main_prints_one_json_line_per_function(capsys):
    import json
    assert attn_bench.main(["all", "--device", "cpu", "--tiny"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [list(d) for d in lines] == [
        ["bench_attention"], ["bench_attention_bwd"],
        ["bench_attention_oracle"], ["sweep_bwd_fused"]]


def test_chip_smoke_attn_bench_phase_on_cpu(capsys):
    """chip_smoke's new phase at a tiny size: its checks pass and the CPU
    launches no kernel"""
    sys.path.insert(0, ROOT)
    try:
        cs = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    launches = cs.phase_attn_bench(0, device="cpu", n_iter=1, reps=1,
                                   shapes={"128": (2, 128)}, nh=2, s=128,
                                   dh=128)
    assert launches == dict.fromkeys(
        cs.FLASH_NAMES + cs.PROBE_NAMES, 0)
    assert '"phase": "attn_bench"' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (f) the port stays free of JAX; the build sees the shared headers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rel", ["tensorforth_tpu_torch/attn_bench.py",
                                 "tensorforth_tpu_torch/ops/attn.py",
                                 "tensorforth_tpu_torch/ops/_build.py",
                                 "chip_smoke.py"])
def test_measurement_path_imports_no_jax(rel):
    bad = re.compile(r"^\s*(import|from)\s+(jax|tensorforth_tpu)(\.|\s|$)",
                     re.M)
    with open(os.path.join(ROOT, rel)) as f:
        assert bad.search(f.read()) is None


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "flash_bwd_fused",
                                  "attn_dots", "gemm"])
def test_a_changed_header_gives_a_new_library(name, tmp_path, monkeypatch):
    """the library's file name hashes the source and every shared header,
    so a kernel that includes an edited header is built again"""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / f"{name}.cu").exists()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(name)
    assert before == _build.library_path(name)
    with open(tmp_path / "flash_tile.cuh", "a") as f:
        f.write("// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent
    with open(tmp_path / f"{name}.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path(name) != after
