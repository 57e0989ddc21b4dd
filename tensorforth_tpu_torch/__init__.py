"""tensorforth_tpu_torch — the PyTorch/CUDA port of tensorforth_tpu.

A second, self-contained package beside the JAX one, which stays the
reference.  It keeps the JAX package's module names and public layouts
so each module can be held against its counterpart.  Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper (sm_90a) under ``ops/``.

Ported so far:
  * the Forth REPL at the tensor level (``cli.TensorForth``, launcher
    ``ten4_torch``): the eForth interpreter (vm/eforth.py) and the
    tensor words (vm/tenvm.py) over ops/engine.py, ops/linalg.py and a
    threefry generator that draws ``jax.random``'s numbers (ops/rng.py);
    the gemm2..4 words run the wgmma GEMM kernel of ops/csrc/gemm_sm90.cu
    (K5a with its rounding pass, K6), and ops/gemm.py also wraps K5b and
    K7 (ops/csrc/gemm_sm90_f32.cu: f32 operands rounded inside one
    launch) and K5a's class highest (ops/csrc/gemm_sm90.cu), with the
    plain versions of all of them;
  * on the LM tier, serving (``models.tiny_lm`` ->
    ``nn.serve.generate``) and training through the word path
    (``Model.forward / loss / backprop / sgd | adam | adamw``), with the
    causal flash attention as CUDA kernels in both directions
    (ops/csrc/flash_fwd.cu, ops/csrc/flash_bwd.cu);
  * the attention measurement path (attn_bench.py), which also runs the
    single-kernel backward (ops/csrc/flash_bwd_fused.cu) and the
    dots-only probe (ops/csrc/attn_dots.cu).
Not ported yet: the NN words (vm/netvm.py), the native inner
interpreter, the VM pool and task words, deferred scalars, TensorBoard.
"""

__version__ = "0.1.0"

import torch as _torch

from .config import Config  # noqa: F401

# the serving and training dots are strict f32 (the JAX package pins
# preferred_element_type=f32 throughout nn/serve.py), and so are the `@`
# and linalg words (ops/engine.py, ops/linalg.py): keep TF32 off
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
