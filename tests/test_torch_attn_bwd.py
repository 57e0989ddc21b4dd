"""The port's flash-attention backward (tensorforth_tpu_torch/ops/attn.py)
held against the JAX package: the plain version of the two backward
kernels against the Pallas kernels in interpret mode, the autograd
Functions around them against PyTorch's own autograd through the einsum
path, and the flash gate.  CPU only; inputs come from numpy seeds and go
through both packages."""
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorforth_tpu.ops.attn_pallas import (
    flash_attention as jax_flash, flash_attention_bwd as jax_flash_bwd,
    flash_attention_lse as jax_flash_lse)
from tensorforth_tpu_torch.nn import funcs as tfuncs
from tensorforth_tpu_torch.ops import attn


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


def _pallas_bwd(q, k, v, do, causal, hybrid=False):
    """(o, lse [B,S], dq, dk, dv) from the Pallas kernels in interpret
    mode; f32 runs pin the interpreter's dots to full f32, as
    tests/test_attention.py does"""
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))
    with (contextlib.nullcontext() if hybrid
          else jax.default_matmul_precision("highest")):
        o, lse = jax_flash(q, k, v, causal=causal, return_lse=True,
                           interpret=True, hybrid=hybrid)
        grads = jax_flash_bwd(q, k, v, o, lse, do, causal=causal,
                              interpret=True, hybrid=hybrid)
    return (np.asarray(o), np.asarray(lse)[..., 0],
            *(np.asarray(g) for g in grads))


@pytest.mark.parametrize("b,s,causal", [(2, 512, False), (2, 512, True),
                                        (1, 1536, True)])
def test_flash_bwd_ref_matches_pallas_interpret(b, s, causal):
    """dq, dk, dv within 2e-4, the tolerance of test_attention.py:184-186
    (f32 sums in another order).  Both take the Pallas forward's o and
    lse; the port's wrapper takes lse as [B, S]."""
    q, k, v, do = _inputs(s + causal, b, s, 128)
    o, lse, *want = _pallas_bwd(q, k, v, do, causal)
    got = attn.flash_attention_bwd_ref(*_t(q, k, v, o, lse, do),
                                       causal=causal)
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == (b, s, 128)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{nm} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_ref_hybrid_matches_pallas_interpret(causal):
    """hybrid (bf16 multiplicands, f32 sums): within 5% of the largest
    reference value, the bound of test_attention.py:221-225"""
    q, k, v, do = _inputs(13 + causal, 2, 512, 128)
    o, lse, *want = _pallas_bwd(q, k, v, do, causal, hybrid=True)
    got = attn.flash_attention_bwd_ref(*_t(q, k, v, o, lse, do),
                                       causal=causal, hybrid=True)
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        err = np.max(np.abs(g.numpy() - w))
        assert err / (np.max(np.abs(w)) + 1e-9) < 0.05, (nm, causal, err)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_lse_grad_with_dlse_matches_jax(causal):
    """a loss that touches o AND lse, so dlse is dense and non-zero:
    torch.autograd.grad through the port's flash_attention_lse against
    jax.grad through the JAX package's (Pallas kernels in interpret
    mode), within 3e-4 (test_attention.py:275-277)"""
    q, k, v = _inputs(17 + causal, 2, 512, 128, n=3)

    def jloss(q_, k_, v_):
        o, lse = jax_flash_lse(q_, k_, v_, causal, False, True)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                    for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    o, lse = attn.flash_attention_lse(tq, tk, tv, causal)
    assert lse.shape == (2, 512)
    got = torch.autograd.grad((o ** 2).sum() + torch.sin(lse).sum(),
                              (tq, tk, tv))
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4, err_msg=f"{nm} causal={causal}")


def _ref_grads(q, k, v, do, causal):
    """PyTorch's own autograd through the einsum path"""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(tfuncs._sdpa_ref(*leaves, causal), leaves, do)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_flash_branch_grad_matches_autograd(causal):
    """the flash branch of sdpa (plain versions inside, on the CPU):
    forward and torch.autograd.grad equal the einsum path's within 2e-4"""
    q, k, v, do = _t(*_inputs(23 + causal, 2, 512, 128))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tfuncs._sdpa_flash(*leaves, causal)
    np.testing.assert_allclose(o.detach().numpy(),
                               tfuncs._sdpa_ref(q, k, v, causal).numpy(),
                               rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(o, leaves, do)
    for g, w, nm in zip(got, _ref_grads(q, k, v, do, causal),
                        ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"{nm} causal={causal}")


@pytest.mark.parametrize("which", ["o", "lse"])
def test_flash_lse_takes_a_missing_cotangent(which):
    """a loss that touches only o, or only lse: the other cotangent
    arrives as None"""
    q, k, v = _t(*_inputs(29, 1, 512, 128, n=3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = attn.flash_attention_lse(*leaves, True)
    loss = (o ** 2).sum() if which == "o" else torch.sin(lse).sum()
    got = torch.autograd.grad(loss, leaves)

    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o_r, lse_r = attn.flash_attention_ref(*ref, causal=True)
    loss_r = (o_r ** 2).sum() if which == "o" else torch.sin(lse_r).sum()
    for g, w in zip(got, torch.autograd.grad(loss_r, ref,
                                             allow_unused=True)):
        w = torch.zeros_like(g) if w is None else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_sdpa_takes_the_einsum_branch_for_an_ineligible_shape():
    """S = 16: sdpa is the einsum path, bit for bit, in value and in
    gradient, and nothing reaches the flash wrappers"""
    q, k, v, do = _t(*_inputs(31, 4, 16, 8))
    calls = []
    orig = attn.flash_attention
    attn.flash_attention = lambda *a, **kw: calls.append(a) or orig(*a, **kw)
    try:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = tfuncs.sdpa(*leaves, True)
        got = torch.autograd.grad(o, leaves, do)
    finally:
        attn.flash_attention = orig
    assert not calls
    assert torch.equal(o.detach(), tfuncs._sdpa_ref(q, k, v, True))
    for g, w in zip(got, _ref_grads(q, k, v, do, True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("s,dh,ok", [
    (512, 128, True), (2048, 128, True), (1024, 256, True),
    (1536, 128, True), (512, 384, False), (512, 512, False),
    (256, 128, False), (640, 128, False), (512, 64, False)])
def test_flash_gate_admits_only_compiled_head_dims(s, dh, ok):
    """the shape half of the gate: long aligned sequences at a head dim
    the kernels are compiled for.  dh = 384 and 512 take the einsum path
    (the kernels are built for 128 and 256 only)."""
    assert tfuncs._flash_shape_ok(s, dh) is ok
    # the device half: a CPU tensor never passes
    assert not tfuncs._flash_ok(torch.zeros(1, s, dh))


def test_flash_bwd_wrapper_uses_plain_version_on_cpu():
    """CPU tensors take the plain version and launch nothing"""
    q, k, v, do = _t(*_inputs(37, 1, 512, 128))
    o, lse = attn.flash_attention(q, k, v, causal=True)
    before = dict(attn.flash_attention_bwd.launches)
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = attn.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert attn.flash_attention_bwd.launches == before


def test_flash_bwd_wrapper_rejects_mixed_devices():
    q = torch.zeros(1, 512, 128)
    lse = torch.zeros(1, 512)
    with pytest.raises(ValueError):
        attn.flash_attention_bwd(q, q.to("meta"), q, q, lse, q)


def test_mha_layer_backward_matches_jax_vjp():
    """the ATTN layer's backward as backward_segment takes it (the layer
    re-run with grad enabled) against jax.vjp of the JAX _mha_fwd, causal
    with rope, within 1e-5"""
    from tensorforth_tpu.nn import funcs as jfuncs
    rs = np.random.RandomState(41)
    x = rs.randn(2, 12, 16, 1).astype(np.float32)
    wqkv = (rs.randn(48, 16) * 0.3).astype(np.float32)
    wo = (rs.randn(16, 16) * 0.3).astype(np.float32)
    dy = rs.randn(2, 12, 16, 1).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, a, b: jfuncs._mha_fwd(
        x_, a, b, 4, flash=True, causal=True, rope=True),
        jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo))
    want = vjp(jnp.asarray(dy))
    tx, tw, to, tdy = _t(x, wqkv, wo, dy)
    got = tfuncs._vjp(lambda x_, a, b: tfuncs._mha_fwd(
        x_, a, b, 4, flash=True, causal=True, rope=True), (tx, tw, to), tdy)
    for g, w, nm in zip(got, want, ("dx", "dwqkv", "dwo")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=nm)
    # attn_op, the Function that keeps only its inputs, gives the same
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, to)]
    got2 = torch.autograd.grad(tfuncs.attn_op(*leaves, 4, True, True),
                               leaves, tdy)
    for g, g2 in zip(got, got2):
        assert torch.equal(g, g2)
