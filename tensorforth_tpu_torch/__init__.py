"""tensorforth_tpu_torch — the PyTorch/CUDA port of tensorforth_tpu.

A second, self-contained package beside the JAX one, which stays the
reference.  It keeps the JAX package's module names and public layouts
so each module can be held against its counterpart.  Plain tensor code
is PyTorch; every kernel the JAX package wrote in Pallas becomes a
kernel written by hand for Hopper (sm_90a) under ``ops/``.

Ported so far: the LM serving path, ``models.tiny_lm`` ->
``nn.serve.generate``, with the causal flash-attention forward as a
CUDA kernel (ops/csrc/flash_fwd.cu).
"""

__version__ = "0.1.0"

import torch as _torch

from .config import Config  # noqa: F401

# the serving dots are strict f32 (the JAX package pins
# preferred_element_type=f32 throughout nn/serve.py): keep TF32 off
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
