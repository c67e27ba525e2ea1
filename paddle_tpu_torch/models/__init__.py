"""Models built from fluid-style layers: the generation slice's GPTDecoder."""

from . import gpt_decoder  # noqa: F401
from .gpt_decoder import GPTDecoder  # noqa: F401
