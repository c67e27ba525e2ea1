"""Models built from fluid-style layers: the generation slice's GPTDecoder
and the training slice's Transformer (models/transformer.py)."""

from . import gpt_decoder, transformer  # noqa: F401
from .gpt_decoder import GPTDecoder  # noqa: F401
