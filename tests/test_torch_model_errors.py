"""The port's layer factory (tensorforth_tpu_torch/nn/model.py Model.add)
against the JAX package's on the same inputs: where the reference prints
an error through System.perr and adds no layer, the port does the same
(same text, same layer count, the same grad_fn left on the input layer,
the same objects and bytes in the MMU), and a softmax layer allocates the
reference's [1, H, W, C] slot in grad[4].  CPU only."""
import io

import pytest

from tensorforth_tpu.mu.mmu import MMU as JMMU
from tensorforth_tpu.nn.ntypes import Layer
from tensorforth_tpu.system import System as JSystem
from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
from tensorforth_tpu_torch.system import System as TSystem

# (case, input [N, H, W, C], layer, n, bias): the reference's early
# returns in _iattn (model.py:349-354) and _iembed (420-422), and a softmax
CASES = [
    ("attn_heads_do_not_divide_e", (2, 8, 12, 1), Layer.ATTN, 5, 1.0),
    ("attn_rope_odd_head_dim", (2, 8, 12, 1), Layer.ATTN, 4, 3.0),
    ("embed_vocab_below_2", (2, 8, 1, 1), Layer.EMBED, 1, 16.0),
    ("softmax", (2, 4, 6, 1), Layer.SOFTMAX, 0, 0.0),
]


def _add(system_cls, mmu_cls, shape, fn, n, bias, **dev):
    """a model of one input tensor in one package, then add(fn, n, bias):
    (model, what System.perr printed, the MMU)"""
    system_cls.free_sys()
    mmu_cls.free_mmu()
    out = io.StringIO()
    system_cls.get_sys().fout = out
    mmu = mmu_cls.get_mmu()
    m = mmu.model(**dev)
    m.npush(mmu.tensor(*shape, **dev))
    m.add(fn, n, bias)
    return m, out.getvalue(), mmu


@pytest.mark.parametrize("case,shape,fn,n,bias", CASES,
                         ids=[c[0] for c in CASES])
def test_model_add_matches_the_reference(case, shape, fn, n, bias):
    mj, said_j, mmu_j = _add(JSystem, JMMU, shape, fn, n, bias)
    mt, said_t, mmu_t = _add(TSystem, TMMU, shape, fn, n, bias,
                             device="cpu")
    assert said_t == said_j
    assert bool(said_j) == (case != "softmax")
    assert mt.numel == mj.numel == (1 if said_j else 2)
    assert mt[0].grad_fn == mj[0].grad_fn == fn
    assert len(mmu_t._objs) == len(mmu_j._objs)
    assert mmu_t._num_alloc == mmu_j._num_alloc
    assert mmu_t._alloc_bytes == mmu_j._alloc_bytes
    gj, gt = mj[0].grad[4], mt[0].grad[4]
    if case == "softmax":
        assert gt.shape == gj.shape == (1,) + tuple(shape[1:])
    else:
        assert gt is None and gj is None
