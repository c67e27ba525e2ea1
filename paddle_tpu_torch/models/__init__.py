"""Models built from fluid-style layers: the generation slice's GPTDecoder,
the training slice's Transformer (models/transformer.py), LeNet-5 and the
ResNets of BASELINE.json's first two configurations, the stacked dynamic
LSTM, the GRU attention NMT model (machine_translation.py) and the DeepFM
CTR model (deepfm.py)."""

from . import (  # noqa: F401
    deepfm,
    gpt_decoder,
    lenet,
    machine_translation,
    resnet,
    stacked_lstm,
    transformer,
)
from .gpt_decoder import GPTDecoder  # noqa: F401
from .lenet import lenet5  # noqa: F401
from .resnet import resnet50, resnet_cifar10  # noqa: F401
from .stacked_lstm import stacked_lstm_net  # noqa: F401
