"""The port's attention path (tensorforth_tpu_torch) held against the JAX
package: the flash kernel's plain version against the Pallas kernel in
interpret mode, and the layer forwards the serving path runs.  CPU only;
inputs come from numpy seeds and go through both packages."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tensorforth_tpu.nn import funcs as jfuncs
from tensorforth_tpu.ops.attn_pallas import flash_attention as jax_flash
from tensorforth_tpu_torch.nn import funcs as tfuncs
from tensorforth_tpu_torch.ops import attn

from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _qkv(seed, b, s, dh):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,s,causal", [(2, 512, False), (2, 512, True),
                                        (1, 1536, True)])
def test_flash_ref_matches_pallas_interpret(b, s, causal):
    """o and lse within 2e-5, the tolerance of test_attention.py:151-154
    (f32 sums in another order)"""
    q, k, v = _qkv(s + causal, b, s, 128)
    with jax.default_matmul_precision("highest"):
        o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               return_lse=True, interpret=True)
    o_t, lse_t = attn.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert lse_t.shape == (b, s)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               rtol=2e-5, atol=2e-5)


def test_flash_ref_hybrid_matches_pallas_interpret():
    """hybrid (bf16 multiplicands, f32 softmax/accumulator) within the
    3e-2 that test_attention.py holds the hybrid kernel to"""
    q, k, v = _qkv(7, 2, 512, 128)
    o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, return_lse=True, interpret=True,
                           hybrid=True)
    o_t, lse_t = attn.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, hybrid=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               rtol=3e-2, atol=3e-2)


def test_flash_wrapper_uses_plain_version_on_cpu():
    """CPU tensors take the plain version and launch nothing"""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 512, 128))
    before = attn.flash_attention.launches
    o, lse = attn.flash_attention(q, k, v, causal=True)
    o_r, lse_r = attn.flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    assert attn.flash_attention.launches == before


def test_flash_wrapper_rejects_mixed_devices():
    q = torch.zeros(1, 512, 128)
    with pytest.raises(ValueError):
        attn.flash_attention(q, q.to("meta"), q)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_matches_jax(causal):
    q, k, v = _qkv(11 + causal, 4, 16, 8)
    want = jfuncs.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal)
    got = tfuncs.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_flash_gate_needs_cuda():
    """_flash_ok admits only CUDA tensors of long aligned shapes"""
    assert not tfuncs._flash_ok(torch.zeros(1, 512, 128))
    assert not tfuncs._flash_ok(torch.zeros(1, 512, 128, device="meta"))


def test_rope_apply_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 12, 16).astype(np.float32)
    pos = np.arange(3, 15)
    want = jfuncs.rope_apply(jnp.asarray(x), jnp.asarray(pos))
    got = tfuncs.rope_apply(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_lnorm_embed_proj_match_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 24, 1).astype(np.float32)
    g = rs.randn(24).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    np.testing.assert_allclose(
        tfuncs._lnorm_fwd(torch.from_numpy(x), torch.from_numpy(g),
                          torch.from_numpy(b), 1e-5).numpy(),
        np.asarray(jfuncs._lnorm_fwd(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), 1e-5)),
        rtol=1e-5, atol=1e-5)

    ids = rs.randint(0, 10, (2, 5, 1, 1)).astype(np.float32)
    table = rs.randn(10, 24).astype(np.float32)
    np.testing.assert_allclose(
        tfuncs._embed_fwd(torch.from_numpy(ids), torch.from_numpy(table),
                          torch.from_numpy(b)).numpy(),
        np.asarray(jfuncs._embed_fwd(jnp.asarray(ids), jnp.asarray(table),
                                     jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)

    w = rs.randn(7, 24).astype(np.float32)
    wb = rs.randn(7).astype(np.float32)
    np.testing.assert_allclose(
        tfuncs._proj_fwd(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(wb)).numpy(),
        np.asarray(jfuncs._proj_fwd(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(wb))),
        rtol=1e-5, atol=1e-5)
