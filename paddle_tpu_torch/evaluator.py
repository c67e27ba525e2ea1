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

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


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


class DetectionMAP(Evaluator):
    """Mean average precision over accumulated detections (reference
    evaluator.py:298 wraps the detection_map op; here accumulation is
    host-side over per-batch (detections, gt) fetches)."""

    def __init__(
        self,
        input=None,
        gt_label=None,
        gt_box=None,
        gt_difficult=None,
        class_num=None,
        background_label=0,
        overlap_threshold=0.5,
        evaluate_difficult=True,
        ap_version="integral",
    ):
        super().__init__("map_eval")
        self.class_num = class_num
        self.overlap_threshold = overlap_threshold
        self.background_label = background_label
        self.ap_version = ap_version
        self.reset(None)

    def reset(self, executor=None, reset_program=None):
        self._dets = []  # (class, score, matched)
        self._n_gt = {}

    def update(self, detections, gt_labels, gt_boxes):
        """detections: (n, 6) [label, score, x1, y1, x2, y2]; gt per image."""
        dets = np.asarray(detections, np.float64).reshape(-1, 6)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        for c in gt_labels:
            self._n_gt[int(c)] = self._n_gt.get(int(c), 0) + 1
        used = np.zeros(len(gt_labels), bool)
        for d in dets[np.argsort(-dets[:, 1])]:
            c, score = int(d[0]), d[1]
            if c == self.background_label:
                continue
            best, best_j = 0.0, -1
            for j, (gc, gb) in enumerate(zip(gt_labels, gt_boxes)):
                if int(gc) != c or used[j]:
                    continue
                iou = _iou(d[2:6], gb)
                if iou > best:
                    best, best_j = iou, j
            matched = best >= self.overlap_threshold
            if matched:
                used[best_j] = True
            self._dets.append((c, score, matched))

    def eval(self, executor=None, eval_program=None):
        aps = []
        for c, total in self._n_gt.items():
            rows = sorted(
                ((s, m) for cc, s, m in self._dets if cc == c), reverse=True
            )
            if not rows:
                aps.append(0.0)
                continue
            tp = np.cumsum([m for _, m in rows])
            fp = np.cumsum([not m for _, m in rows])
            recall = tp / max(total, 1)
            precision = tp / np.maximum(tp + fp, 1e-12)
            if self.ap_version == "11point":
                ap = np.mean(
                    [
                        precision[recall >= t].max() if (recall >= t).any() else 0.0
                        for t in np.linspace(0, 1, 11)
                    ]
                )
            else:  # integral
                ap = float(np.sum(np.diff(np.concatenate([[0.0], recall])) * precision))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0
