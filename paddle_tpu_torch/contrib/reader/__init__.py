from . import ctr_reader  # noqa: F401
from .ctr_reader import ctr_reader as ctr_reader_fn  # noqa: F401

__all__ = ["ctr_reader"]
