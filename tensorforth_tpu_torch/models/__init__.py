from .zoo import gan_mnist, mnist_cnn, tiny_lm, tiny_moe, tiny_transformer  # noqa: F401
