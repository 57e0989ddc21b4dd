from .tensor import Tensor, T4Type  # noqa: F401
from .mmu import MMU                 # noqa: F401
