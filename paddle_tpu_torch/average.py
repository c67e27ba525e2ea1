"""WeightedAverage metric accumulator (reference python/paddle/fluid/
average.py:40 — host-side running average for losses/accuracies printed in
train loops)."""

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        value = np.asarray(value, dtype=np.float64)
        if value.size != 1:
            raise ValueError("WeightedAverage.add expects a scalar value")
        self.numerator += float(value.reshape(())) * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError("cannot eval() before any add()")
        return self.numerator / self.denominator
