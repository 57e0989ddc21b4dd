"""NN enums (reference src/nn/ntypes.h); the port's copy of
tensorforth_tpu/nn/ntypes.py."""


class Layer:
    (NONE, CONV, LINEAR, FLATTEN, RELU, TANH, SIGMOID, SELU, LEAKYRL,
     ELU, DROPOUT, SOFTMAX, LOGSMAX, AVGPOOL, MAXPOOL, MINPOOL,
     BATCHNM, USAMPLE, DCONV, ATTN, MOE, LNORM, EMBED, PROJ) = range(24)

    NAMES = ["output ", "conv2d ", "linear ", "flatten", "relu   ",
             "tanh   ", "sigmoid", "selu   ", "leakyrl", "elu    ",
             "dropout", "softmax", "logsmax", "avgpool", "maxpool",
             "minpool", "batchnm", "upsampl", "dconv2d", "attn   ",
             "moe    ", "lnorm  ", "embed  ", "proj   "]


class Loss:
    MSE, BCE, CE, NLL = range(4)
    NAMES = ["MSE", "BCE", "CE", "NLL"]


class Optimizer:
    SGD, SGDM, ADAM, ADAMW = range(4)
