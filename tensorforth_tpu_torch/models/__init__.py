from .zoo import tiny_lm  # noqa: F401
