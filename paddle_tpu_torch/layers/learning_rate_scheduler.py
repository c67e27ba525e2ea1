"""Learning-rate schedules as graph ops (a copy of
paddle_tpu/layers/learning_rate_scheduler.py; reference
python/paddle/fluid/layers/learning_rate_scheduler.py): the schedule is part
of the program, driven by the auto-incremented global step counter, so it
runs in the training step's block, inside its CUDA graph on the card."""

import math

from .. import framework
from . import nn, ops, tensor

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
]


def _decay_step_counter(begin=0):
    counter = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1
    )
    return tensor.cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (reference
    learning_rate_scheduler.py:noam_decay; used by Transformer)."""
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter(begin=1)
        a = step ** -0.5
        b = (warmup_steps ** -1.5) * step
        lr = (d_model ** -0.5) * nn.elementwise_min(a, b)
        return lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    # lr * decay_rate^div  ==  exp(log(lr) + div*log(decay_rate))
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        val = tensor.scale(div, scale=math.log(decay_rate), bias=math.log(learning_rate))
        return ops.exp(val)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        val = tensor.scale(div, scale=-decay_rate, bias=math.log(learning_rate))
        return ops.exp(val)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        denom = tensor.scale(div, scale=float(decay_rate), bias=1.0)
        return nn.elementwise_div(
            tensor.fill_constant([1], "float32", float(learning_rate)), denom
        )


def polynomial_decay(
    learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False
):
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        if cycle:
            ratio = step / float(decay_steps)
            ceiled = nn.elementwise_max(
                ops.ceil(ratio), tensor.fill_constant([1], "float32", 1.0)
            )
            decay_steps_var = tensor.scale(ceiled, scale=float(decay_steps))
            frac = nn.elementwise_div(step, decay_steps_var)
        else:
            capped = nn.elementwise_min(
                step, tensor.fill_constant([1], "float32", float(decay_steps))
            )
            frac = tensor.scale(capped, scale=1.0 / decay_steps)
        base = tensor.scale(frac, scale=-1.0, bias=1.0) ** float(power)
        return tensor.scale(
            base, scale=float(learning_rate - end_learning_rate), bias=float(end_learning_rate)
        )


def piecewise_decay(boundaries, values):
    """Piecewise-constant schedule. The reference builds a Switch control-flow
    block (learning_rate_scheduler.py:piecewise_decay); here, as in the JAX
    package, a branch-free sum of interval indicators."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        pieces = []
        prev = None
        for i, v in enumerate(values):
            lo = boundaries[i - 1] if i > 0 else None
            hi = boundaries[i] if i < len(boundaries) else None
            ind = None
            if lo is not None:
                ge = tensor.cast(step >= float(lo), "float32")
                ind = ge
            if hi is not None:
                lt = tensor.cast(step < float(hi), "float32")
                ind = lt if ind is None else nn.elementwise_mul(ind, lt)
            piece = (
                tensor.fill_constant([1], "float32", float(v))
                if ind is None
                else tensor.scale(ind, scale=float(v))
            )
            pieces.append(piece)
        lr = pieces[0]
        for p in pieces[1:]:
            lr = nn.elementwise_add(lr, p)
        return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    with framework.default_main_program()._lr_schedule_guard():
        step = _decay_step_counter()
        epoch = ops.floor(tensor.scale(step, scale=1.0 / step_each_epoch))
        inner = tensor.scale(epoch, scale=math.pi / epochs)
        cos_v = ops.cos(inner)
        return tensor.scale(cos_v, scale=0.5 * learning_rate, bias=0.5 * learning_rate)
