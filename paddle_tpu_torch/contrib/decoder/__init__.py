from . import beam_search_decoder  # noqa: F401
from .beam_search_decoder import (  # noqa: F401
    BeamSearchDecoder,
    InitState,
    StateCell,
    TrainingDecoder,
)

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]
