"""The port's layer factory (tensorforth_tpu_torch/nn/model.py Model.add)
against the JAX package's on the same inputs: where the reference prints
an error through System.perr and adds no layer, the port does the same
(same text, same layer count, the same grad_fn left on the input layer,
the same objects and bytes in the MMU), and a softmax layer allocates the
reference's [1, H, W, C] slot in grad[4].  Every layer kind the port
builds allocates the reference's slots.  forward, backprop and loss given
bad input print through _err as the reference's do, set `err` where it
does, and do not raise.  CPU only."""
import io

import pytest

from tensorforth_tpu.mu.mmu import MMU as JMMU
from tensorforth_tpu.nn.ntypes import Layer
from tensorforth_tpu.system import System as JSystem
from tensorforth_tpu_torch.mu.mmu import MMU as TMMU
from tensorforth_tpu_torch.system import System as TSystem

from tests.test_torch_threads import one_torch_thread  # noqa: F401

# (case, input [N, H, W, C], layer, n, bias): the reference's early
# returns in _iattn (model.py:349-354) and _iembed (420-422), and a softmax
CASES = [
    ("attn_heads_do_not_divide_e", (2, 8, 12, 1), Layer.ATTN, 5, 1.0),
    ("attn_rope_odd_head_dim", (2, 8, 12, 1), Layer.ATTN, 4, 3.0),
    ("embed_vocab_below_2", (2, 8, 1, 1), Layer.EMBED, 1, 16.0),
    ("softmax", (2, 4, 6, 1), Layer.SOFTMAX, 0, 0.0),
    # the early returns of _iconv (K not 1/3/5, a dconv's not 4), _ipool
    # and _iup (k not 2/3), model.py:238-240, 304-306, 454-456
    ("conv_kernel_2", (2, 8, 8, 1), Layer.CONV, 4, [2, 1, 0, 1]),
    ("dconv_kernel_3", (2, 8, 8, 1), Layer.DCONV, 4, [3, 2, 1, 1]),
    ("maxpool_4", (2, 8, 8, 1), Layer.MAXPOOL, 4, 0.0),
    ("avgpool_1", (2, 8, 8, 1), Layer.AVGPOOL, 1, 0.0),
    ("upsample_4", (2, 8, 8, 1), Layer.USAMPLE, 4, 0.0),
]
# layers that build: (case, input, layer, n, bias or conv opt)
BUILDS = [
    ("conv", (2, 8, 8, 3), Layer.CONV, 4, [3, 1, 0, 1]),
    ("conv_k5_s2", (2, 9, 9, 3), Layer.CONV, 4, [5, 2, 0, 1]),
    ("dconv", (2, 4, 4, 3), Layer.DCONV, 2, [4, 2, 1, 1]),
    ("linear", (2, 3, 4, 2), Layer.LINEAR, 5, 1.0),
    ("flatten", (2, 3, 4, 2), Layer.FLATTEN, 0, 0.0),
    ("maxpool", (2, 5, 5, 2), Layer.MAXPOOL, 2, 0.0),
    ("minpool", (2, 7, 5, 2), Layer.MINPOOL, 3, 0.0),
    ("avgpool", (2, 5, 5, 2), Layer.AVGPOOL, 2, 0.0),
    ("batchnorm", (2, 3, 3, 4), Layer.BATCHNM, 0, 0.1),
    ("upsample", (2, 3, 3, 2), Layer.USAMPLE, 3, 0.0),
    ("dropout", (2, 3, 3, 2), Layer.DROPOUT, 0, 0.3),
    ("logsmax", (2, 1, 6, 1), Layer.LOGSMAX, 0, 0.0),
]


def _add(system_cls, mmu_cls, shape, fn, n, bias, **dev):
    """a model of one input tensor in one package, then add(fn, n, bias)
    (a list in place of bias is a conv's opt): (model, what System.perr
    printed, the MMU)"""
    system_cls.free_sys()
    mmu_cls.free_mmu()
    out = io.StringIO()
    system_cls.get_sys().fout = out
    mmu = mmu_cls.get_mmu()
    m = mmu.model(**dev)
    m.npush(mmu.tensor(*shape, **dev))
    if isinstance(bias, list):
        m.add(fn, n, 0.5, bias)
    else:
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


def _slots(t):
    return [None if g is None else tuple(g.shape) for g in t.grad + t.mtum]


@pytest.mark.parametrize("case,shape,fn,n,bias", BUILDS,
                         ids=[c[0] for c in BUILDS])
def test_layers_allocate_the_references_slots(case, shape, fn, n, bias):
    """the same output shape, program, grad/mtum slots and MMU counts"""
    mj, said_j, mmu_j = _add(JSystem, JMMU, shape, fn, n, bias)
    mt, said_t, mmu_t = _add(TSystem, TMMU, shape, fn, n, bias,
                             device="cpu")
    assert said_t == said_j == ""
    assert mt.numel == mj.numel == 2
    assert mt[1].shape == mj[1].shape
    assert mt._program() == mj._program()
    assert _slots(mt[0]) == _slots(mj[0])
    assert mt[0].stride == mj[0].stride
    assert float(mt[0].xparm) == float(mj[0].xparm)
    assert len(mmu_t._objs) == len(mmu_j._objs)
    assert mmu_t._num_alloc == mmu_j._num_alloc
    assert mmu_t._alloc_bytes == mmu_j._alloc_bytes


def _said(system_cls):
    return system_cls.get_sys().fout.getvalue()


@pytest.mark.parametrize("what", ["forward", "backprop_no_onehot",
                                  "backprop_shape", "loss_shape"])
def test_words_print_through_err_and_carry_on(what):
    """nn#forward of a wrong input, backprop without or with a mis-shaped
    one-hot, loss of a mis-shaped target (reference model.py:525-530,
    1190-1199, 1486-1488): the same text, the same err bit, no raise;
    loss gives 0.0"""
    res = []
    for sys_cls, mmu_cls, dev in ((JSystem, JMMU, {}),
                                  (TSystem, TMMU, {"device": "cpu"})):
        m, _, mmu = _add(sys_cls, mmu_cls, (2, 1, 3, 1), Layer.LINEAR, 2,
                         0.0, **dev)
        good = mmu.tensor(2, 1, 3, 1, **dev)
        bad = mmu.tensor(2, 1, 5, 1, **dev)
        if what == "forward":
            out = m.forward(bad)
        else:
            m.forward(good)
            if what == "backprop_no_onehot":
                out = m.backprop()
            elif what == "backprop_shape":
                out = m.backprop(bad)
            else:
                out = m.loss(0, bad)
        res.append((_said(sys_cls), m.err, out is m or out))
    (sj, ej, oj), (st, et, ot) = res
    assert st == sj and st.strip()
    assert et == ej == (0 if what in ("backprop_no_onehot", "loss_shape")
                        else 1)
    assert ot == oj
