"""Host-side streaming metrics (reference python/paddle/fluid/metrics.py:
MetricBase, Accuracy, Precision, Recall, Auc, EditDistance, CompositeMetric,
DetectionMAP)."""

import numpy as np

__all__ = [
    "MetricBase",
    "Accuracy",
    "Precision",
    "Recall",
    "Auc",
    "CompositeMetric",
    "ChunkEvaluator",
    "EditDistance",
]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                self.__dict__[k] = 0.0

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no updates to Accuracy yet")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += float(np.sum((preds == 1) & (labels == 1)))
        self.fp += float(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += float(np.sum((preds == 1) & (labels == 1)))
        self.fn += float(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim > 1 else preds.reshape(-1)
        bucket = np.clip(
            (pos_prob * self._num_thresholds).astype(int), 0, self._num_thresholds
        )
        np.add.at(self._stat_pos, bucket[labels != 0], 1)
        np.add.at(self._stat_neg, bucket[labels == 0], 1)

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tot_pos, tot_neg = tp[-1], fp[-1]
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp0 = np.concatenate([[0], tp[:-1]])
        fp0 = np.concatenate([[0], fp[:-1]])
        return float(np.sum((fp - fp0) * (tp + tp0) / 2.0) / (tot_pos * tot_neg))


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = (
            self.num_correct_chunks / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            self.num_correct_chunks / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall
            else 0.0
        )
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no updates to EditDistance yet")
        return (
            self.total_distance / self.seq_num,
            self.instance_error / self.seq_num,
        )
