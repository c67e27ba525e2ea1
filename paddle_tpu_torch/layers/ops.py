"""Random-tensor layers (reference layers/ops.py). The generated unary-op
wrappers of the JAX package come with the rest of the op library."""

from ..layer_helper import LayerHelper

__all__ = ["uniform_random", "gaussian_random"]


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
