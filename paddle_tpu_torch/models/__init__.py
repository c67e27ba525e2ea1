"""Models built from fluid-style layers: the generation slice's GPTDecoder,
the training slice's Transformer (models/transformer.py), and LeNet-5 and
the ResNets of BASELINE.json's first two configurations."""

from . import gpt_decoder, lenet, resnet, transformer  # noqa: F401
from .gpt_decoder import GPTDecoder  # noqa: F401
from .lenet import lenet5  # noqa: F401
from .resnet import resnet50, resnet_cifar10  # noqa: F401
