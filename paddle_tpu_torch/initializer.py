"""Initializers — emitted as ops into the startup program.

Reference analog: python/paddle/fluid/initializer.py (ConstantInitializer,
UniformInitializer, NormalInitializer, TruncatedNormalInitializer,
XavierInitializer, MSRAInitializer, BilinearInitializer,
NumpyArrayInitializer). Each __call__(var, block) appends the init op to the
given (startup) block; the executor materializes values when the startup
program runs — identical flow to the reference.
"""

import numpy as np

from . import framework

__all__ = [
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "MSRA",
    "Bilinear",
    "NumpyArrayInitializer",
    "force_init_on_cpu",
    "init_on_cpu",
]


def force_init_on_cpu():  # compat: placement follows the executor's device
    return False


class init_on_cpu:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return shape[0] if shape else 1, shape[0] if shape else 1
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
        fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class XavierInitializer(Initializer):
    """Glorot init (reference initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (reference initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / fan_in))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """Bilinear upsampling kernel init for conv_transpose (reference
    initializer.py BilinearInitializer)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init needs a 4-D conv weight")
        weight = np.zeros(shape, dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[2:]))):
            x, y = i % shape[3], i // shape[3]
            val = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight[:, :, y, x] = val
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        dt = framework.convert_np_dtype(var.dtype)
        vals = self.value.astype("float32" if framework.is_float_dtype(dt) else "int32")
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": dt,
                "values": vals.reshape(-1).tolist(),
            },
        )


# fluid-style public aliases (reference initializer.py tail)
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
