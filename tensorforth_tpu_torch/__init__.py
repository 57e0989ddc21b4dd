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
  * the NN tier: every layer kind, MoE included (parallel/moe.py: soft
    and dispatch routing), through ``Model.add / forward / loss /
    backprop / sgd | adam | adamw``, with the zoo's mnist_cnn,
    gan_mnist, tiny_transformer and tiny_moe; on the card every dot of
    the NN and LM tiers runs in Config.PRECISION's class (nn/funcs.py),
    and exp/log/tanh/logistic are XLA CPU's own routines on CPU tensors
    (ops/xla_math.py);
  * on the LM tier, serving (``models.tiny_lm`` ->
    ``nn.serve.generate``, sampled tokens drawn as jax.random draws
    them; on the card each window segment's decode step is a captured
    CUDA graph) and training through the same word path, with the
    causal flash attention as CUDA kernels in both directions
    (ops/csrc/flash_fwd.cu, ops/csrc/flash_bwd.cu);
  * the REPL at the net level (vm/netvm.py), datasets, model files and
    the fused training paths (nn/cycle.py, nn/train.py);
  * the attention measurement path (attn_bench.py), which also runs the
    single-kernel backward (ops/csrc/flash_bwd_fused.cu) and the
    dots-only probe (ops/csrc/attn_dots.cu: the forward's body,
    ops/csrc/flash_fwd.cuh, with the softmax compiled out).
Not ported yet: the parallel tier (meshes, expert and pipeline
parallelism), the native inner interpreter, the VM pool and task
words, TensorBoard, the device profiler words.
"""

__version__ = "0.1.0"

import torch as _torch

from .config import Config  # noqa: F401

# the `@` and linalg words are strict f32 (ops/engine.py, ops/linalg.py),
# and the NN and LM tiers' bf16 classes need exact products of bf16
# operands: keep TF32 off
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
