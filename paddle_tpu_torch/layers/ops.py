"""Unary layer wrappers (reference layers/ops.py, which generates these from
the C++ op protos via layer_function_generator.py; here one generated
function for each op of _UNARY_OPS, the JAX package's list, each lowered by
ops/core_ops.py) and the random-tensor layers."""

from ..layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "tanh_shrink",
    "softshrink",
    "sqrt",
    "rsqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "square",
    "softplus",
    "softsign",
    "brelu",
    "soft_relu",
    "elu",
    "relu6",
    "pow",
    "stanh",
    "hard_sigmoid",
    "swish",
    "gelu",
    "thresholded_relu",
    "hard_shrink",
    "cumsum",
    "sign",
    "log_softmax",
]

__all__ = list(_UNARY_OPS) + ["uniform_random", "gaussian_random"]


def _make_unary(op_type):
    def layer(x, *args, **kwargs):
        # positional/keyword attrs pass straight through to the op
        attrs = dict(kwargs)
        attrs.pop("name", None)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(
            type=op_type,
            inputs={"X": [x.name]},
            outputs={"Out": [out.name]},
            attrs=attrs,
        )
        return out

    layer.__name__ = op_type
    layer.__doc__ = "unary op %s (see ops/core_ops.py)" % op_type
    return layer


for _name in _UNARY_OPS:
    globals()[_name] = _make_unary(_name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out.name]},
        attrs={"shape": list(shape), "dtype": dtype, "min": min, "max": max, "seed": seed},
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random",
        outputs={"Out": [out.name]},
        attrs={"shape": list(shape), "dtype": dtype, "mean": mean, "std": std, "seed": seed},
    )
    return out
