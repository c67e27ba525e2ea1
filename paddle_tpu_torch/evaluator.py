"""Evaluator API shim (a copy of paddle_tpu/evaluator.py; reference
python/paddle/fluid/evaluator.py, in-graph metric state with reset/eval
programs, already deprecated there in favor of fluid.metrics).

The metric state is host-side (fluid.metrics.MetricBase): an Evaluator
wraps a metric object with the reset(executor) / eval(executor) call
signatures old training loops use. `DetectionMAP` comes with the detection
layers."""

import warnings

import numpy as np

from . import metrics as _metrics

__all__ = ["ChunkEvaluator", "EditDistance"]


class Evaluator:
    def __init__(self, name, **kwargs):
        warnings.warn(
            "fluid.evaluator is deprecated in the reference and here; use "
            "fluid.metrics",
            DeprecationWarning,
        )
        self.metric = None
        self._fetches = []

    def reset(self, executor, reset_program=None):
        self.metric.reset()

    def eval(self, executor, eval_program=None):
        return self.metric.eval()


class ChunkEvaluator(Evaluator):
    """Chunk F1 over (num_infer, num_label, num_correct) fetched per batch
    (reference evaluator.py:126). Given input/label variables it appends the
    chunk_eval op to the current program (layers.nn.chunk_eval): fetch
    `self.metrics` each step and pass the three counts to update()."""

    def __init__(
        self,
        input=None,
        label=None,
        chunk_scheme=None,
        num_chunk_types=None,
        excluded_chunk_types=None,
        seq_length=None,
    ):
        super().__init__("chunk_eval")
        self.metric = _metrics.ChunkEvaluator("chunk_eval")
        self.metrics = ()
        if input is not None:
            from .layers import nn as _nn

            (
                self.precision,
                self.recall,
                self.f1_score,
                num_infer,
                num_label,
                num_correct,
            ) = _nn.chunk_eval(
                input,
                label,
                chunk_scheme=chunk_scheme,
                num_chunk_types=num_chunk_types,
                excluded_chunk_types=excluded_chunk_types,
                seq_length=seq_length,
            )
            # per-batch count vars, in update()'s argument order
            self.metrics = (num_infer, num_label, num_correct)

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.metric.update(num_infer_chunks, num_label_chunks, num_correct_chunks)


class EditDistance(Evaluator):
    def __init__(self, input=None, label=None, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance")
        self.metric = _metrics.EditDistance("edit_distance")

    def update(self, distances, seq_num):
        self.metric.update(np.asarray(distances), seq_num)
