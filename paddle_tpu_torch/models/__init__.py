"""Models built from fluid-style layers: the generation slice's GPTDecoder,
the training slice's Transformer (models/transformer.py), LeNet-5 and the
ResNets of BASELINE.json's first two configurations, the stacked dynamic
LSTM, the GRU attention NMT model (machine_translation.py) and the DeepFM
CTR model (deepfm.py), and the rest of the JAX package's CNN zoo:
AlexNet, VGG-16/19, GoogLeNet and SE-ResNeXt-50."""

from . import (  # noqa: F401
    alexnet,
    deepfm,
    googlenet,
    gpt_decoder,
    lenet,
    machine_translation,
    resnet,
    se_resnext,
    stacked_lstm,
    transformer,
    vgg,
)
from .alexnet import alexnet as alexnet_model  # noqa: F401
from .googlenet import googlenet as googlenet_model  # noqa: F401
from .gpt_decoder import GPTDecoder  # noqa: F401
from .lenet import lenet5  # noqa: F401
from .resnet import resnet50, resnet_cifar10  # noqa: F401
from .se_resnext import se_resnext50  # noqa: F401
from .stacked_lstm import stacked_lstm_net  # noqa: F401
from .vgg import vgg16, vgg19  # noqa: F401
