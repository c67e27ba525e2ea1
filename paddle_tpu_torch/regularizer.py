"""Weight-decay regularizers appended as graph ops (reference
python/paddle/fluid/regularizer.py: L1DecayRegularizer, L2DecayRegularizer,
append_regularization_ops). A copy of paddle_tpu/regularizer.py; the sign
op L1 decay emits is not ported yet."""

from .framework import OpRole, default_main_program

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [param.name]},
            outputs={"Out": [decay.name]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="sign", inputs={"X": [param.name]}, outputs={"Out": [sign.name]}
        )
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [sign.name]},
            outputs={"Out": [decay.name]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += regularizer(param); per-param regularizer overrides the global
    one (reference regularizer.py:25 append_regularization_ops)."""
    params_and_grads = []
    program = default_main_program()
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        if getattr(grad, "is_selected_rows", False):
            # weight decay on a SelectedRows grad would touch EVERY table row
            # (the decay term is param-shaped), densifying the update and
            # defeating the O(touched-rows) cost — the reference raised for
            # this combination (regularization_op + SelectedRows); we skip
            # decay on sparse tables instead
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        with program._optimized_guard([param, grad]):
            block = grad.block
            if param.regularizer is not None:
                regularization_term = param.regularizer(param, grad, block)
            elif regularization is not None:
                regularization_term = regularization(param, grad, block)
            if regularization_term is None:
                params_and_grads.append((param, grad))
                continue
            block.append_op(
                type="elementwise_add",
                inputs={"X": [grad.name], "Y": [regularization_term.name]},
                outputs={"Out": [grad.name]},
                attrs={"axis": -1},
            )
        params_and_grads.append((param, grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
