"""Optimizers: minimize = append_backward + regularization/clip + per-param
optimizer ops (reference python/paddle/fluid/optimizer.py:294
Optimizer.minimize, :197 _create_optimization_pass). A copy of
paddle_tpu/optimizer.py; of its update ops this package lowers `adam` (and
`scale`, which advances the beta pows) so far.

Optimizer state (moments, accumulators) are persistable variables initialized
in the startup program; the update ops write ParamOut/MomentOut under the SAME
variable names, which the executor writes back to the scope (the fused
multi-tensor Adam updates them in place, ops/fused.py).
"""

# optimizer op types with a per-row (SelectedRows) update; the JAX package
# keeps this set in ops/sparse_ops.py, which this package does not port yet
SPARSE_OPTIMIZER_TYPES = ("sgd", "adagrad", "adam")

import contextlib

import numpy as np

from . import framework
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import OpRole, Variable, default_main_program, default_startup_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from . import unique_name

__all__ = [
    "SGD",
    "Momentum",
    "Adagrad",
    "Adam",
    "Adamax",
    "DecayedAdagrad",
    "Ftrl",
    "SGDOptimizer",
    "MomentumOptimizer",
    "AdagradOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "DecayedAdagradOptimizer",
    "RMSPropOptimizer",
    "FtrlOptimizer",
    "AdadeltaOptimizer",
    "ModelAverage",
    "ProximalGD",
    "ProximalAdagrad",
    "ProximalGDOptimizer",
    "ProximalAdagradOptimizer",
    "LarsMomentum",
    "LarsMomentumOptimizer",
]


def _is_selected_rows(grad):
    """True when backward emitted this grad as a SelectedRows pair
    (embedding/selected_rows.py — is_sparse=True lookup tables)."""
    return bool(getattr(grad, "is_selected_rows", False))


def _param_shard_axis(param):
    """Mesh axis the param is row-sharded over ('' when unsharded) — forwarded
    to the sparse update op so it shard_maps the scatter per-rank. Reads the
    legacy per-var attr first, then the program's declarative sharding rules
    (parallel.sharding_rules — where the embedding engine registers its
    `ep` layout)."""
    spec = getattr(param, "sharding_spec", None)
    if not spec:
        rules = getattr(param.block.program, "_sharding_rules", None)
        if rules is not None:
            spec = rules.match(param.name)
    if spec:
        first = spec[0]
        if isinstance(first, (tuple, list)):
            first = first[0] if first else None
        if isinstance(first, str):
            return first
    return ""


def _sparse_grad_io(param, grad):
    """Extra inputs/attrs every *_sparse optimizer op takes."""
    inputs = {"GradRows": [grad.selected_rows_rows]}
    attrs = {
        "axis_name": _param_shard_axis(param),
        "param": param.name,
    }
    return inputs, attrs


def _densify_grad(block, param, grad):
    """SelectedRows → dense (rows, dim) grad for optimizers without a sparse
    kernel. Keeps correctness, loses the O(touched-rows) cost."""
    dense = block.create_var(
        name=unique_name.generate(grad.name + "@DENSE"),
        shape=param.shape,
        dtype=grad.dtype,
        persistable=False,
    )
    block.append_op(
        type="selected_rows_to_dense",
        inputs={"X": [grad.name], "Rows": [grad.selected_rows_rows]},
        outputs={"Out": [dense.name]},
        attrs={"height": int(param.shape[0])},
    )
    return dense


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}  # accum name -> {param name -> var}
        self.helper = None

    # --- learning rate plumbing (reference optimizer.py:87-146) ---
    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr_name = unique_name.generate("learning_rate")
        lr_var = program.global_block().create_var(
            name=lr_name, shape=[1], dtype="float32", persistable=True
        )
        lr_var.stop_gradient = True
        self._learning_rate_map[program] = lr_var
        startup = default_startup_program().global_block()
        sv = startup.create_var(
            name=lr_name, shape=[1], dtype="float32", persistable=True
        )
        Constant(float(self._learning_rate))(sv, startup)

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr.get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if float(param_lr) == 1.0:
            return base
        from .layers import tensor as tensor_layers

        with default_main_program()._lr_schedule_guard():
            return tensor_layers.scale(base, scale=float(param_lr))

    # --- accumulators (reference optimizer.py:148-196) ---
    def _add_accumulator(
        self, name, param, dtype=None, fill_value=0.0, shape=None
    ):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if shape is None:
            shape = list(param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate("%s_%s_%s" % (param.name, name, "acc"))
        block = default_main_program().global_block()
        var = block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True
        )
        var.stop_gradient = True
        # same-shape accumulators inherit the param's mesh placement: a
        # row-sharded embedding table (sharding_spec=("ep", None)) gets its
        # moments row-sharded alongside it — the ZeRO-along-ep composition
        # (executor.state_sharding reads this spec); scalar accumulators
        # (beta pows, shape [1]) stay replicated
        spec = getattr(param, "sharding_spec", None)
        if spec is not None and list(shape) == list(param.shape):
            var.sharding_spec = tuple(spec)
        startup = default_startup_program().global_block()
        sv = startup.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True
        )
        Constant(float(fill_value))(sv, startup)
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # --- hooks ---
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    def _create_optimization_pass(self, parameters_and_grads):
        program = default_main_program()
        block = program.global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None]
        )
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if _is_selected_rows(param_and_grad[1]) and (
                getattr(self, "type", None) not in SPARSE_OPTIMIZER_TYPES
            ):
                # no per-row kernel for this optimizer: densify the
                # SelectedRows pair first (reference merges SelectedRows to
                # LoDTensor before a dense apply the same way)
                with program._optimized_guard(param_and_grad):
                    param_and_grad = (
                        param_and_grad[0],
                        _densify_grad(block, *param_and_grad),
                    )
            with program._optimized_guard(param_and_grad):
                op = self._append_optimize_op(block, param_and_grad)
                optimize_ops.append(op)
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks or [error_clip_callback])

    def apply_gradients(self, params_grads):
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        return self._create_optimization_pass(params_grads)

    def minimize(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None
    ):
        params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set
        )
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    """reference optimizer.py SGDOptimizer → optimizers/sgd_op.cc"""

    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        inputs = {
            "Param": [p.name],
            "Grad": [g.name],
            "LearningRate": [self._create_param_lr(param_and_grad).name],
        }
        if _is_selected_rows(g):
            sp_in, sp_attrs = _sparse_grad_io(p, g)
            inputs.update(sp_in)
            return block.append_op(
                type="sgd_sparse",
                inputs=inputs,
                outputs={"ParamOut": [p.name]},
                attrs=sp_attrs,
            )
        return block.append_op(
            type="sgd",
            inputs=inputs,
            outputs={"ParamOut": [p.name]},
        )


class MomentumOptimizer(Optimizer):
    """reference optimizer.py MomentumOptimizer → optimizers/momentum_op.cc"""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, p)
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "Velocity": [velocity.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [p.name], "VelocityOut": [velocity.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class LarsMomentumOptimizer(MomentumOptimizer):
    """reference optimizer.py LarsMomentumOptimizer → lars_momentum_op.cc"""

    def __init__(
        self,
        learning_rate,
        momentum,
        lars_coeff=0.001,
        lars_weight_decay=0.0005,
        **kwargs,
    ):
        super().__init__(learning_rate, momentum, **kwargs)
        self.type = "lars_momentum"
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, p)
        return block.append_op(
            type="lars_momentum",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "Velocity": [velocity.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [p.name], "VelocityOut": [velocity.name]},
            attrs={
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
            },
        )


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, p)
        inputs = {
            "Param": [p.name],
            "Grad": [g.name],
            "Moment": [moment.name],
            "LearningRate": [self._create_param_lr(param_and_grad).name],
        }
        attrs = {"epsilon": self._epsilon}
        op_type = "adagrad"
        if _is_selected_rows(g):
            sp_in, sp_attrs = _sparse_grad_io(p, g)
            inputs.update(sp_in)
            attrs.update(sp_attrs)
            op_type = "adagrad_sparse"
        return block.append_op(
            type=op_type,
            inputs=inputs,
            outputs={"ParamOut": [p.name], "MomentOut": [moment.name]},
            attrs=attrs,
        )


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(
        self,
        learning_rate=0.001,
        beta1=0.9,
        beta2=0.999,
        epsilon=1e-8,
        lazy_mode=False,
        moment_dtype=None,
        **kwargs,
    ):
        """moment_dtype="bfloat16" stores BOTH moments in bf16 (beyond the
        reference — the 8-bit-Adam family technique): halves
        optimizer-state memory and its memory traffic. The update itself
        still computes in f32 (ops/core_ops.py _opt_f32 upcasts state and
        casts the written-back moments to their storage dtype);
        bias-correction pows stay f32. bf16 keeps f32's exponent range, so
        unlike int8 quantized moments no blockwise rescaling is needed; the
        cost is ~8-bit mantissa noise on m/v."""
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._moment_dtype = moment_dtype

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(
                self._moment1_acc_str, p, dtype=self._moment_dtype
            )
            self._add_accumulator(
                self._moment2_acc_str, p, dtype=self._moment_dtype
            )
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )
            self._add_accumulator(
                self._beta2_pow_acc_str, p, fill_value=self._beta2, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
        inputs = {
            "Param": [p.name],
            "Grad": [g.name],
            "LearningRate": [self._create_param_lr(param_and_grad).name],
            "Moment1": [m1.name],
            "Moment2": [m2.name],
            "Beta1Pow": [b1p.name],
            "Beta2Pow": [b2p.name],
        }
        attrs = {
            "beta1": self._beta1,
            "beta2": self._beta2,
            "epsilon": self._epsilon,
        }
        op_type = "adam"
        if _is_selected_rows(g):
            # lazy Adam (reference adam_op SparseAdamFunctor lazy_mode):
            # untouched rows' params AND moments stay frozen this step
            sp_in, sp_attrs = _sparse_grad_io(p, g)
            inputs.update(sp_in)
            attrs.update(sp_attrs)
            op_type = "adam_sparse"
        return block.append_op(
            type=op_type,
            inputs=inputs,
            outputs={
                "ParamOut": [p.name],
                "Moment1Out": [m1.name],
                "Moment2Out": [m2.name],
            },
            attrs=attrs,
        )

    def _finish_update(self, block, parameters_and_grads):
        """Advance beta^t accumulators with scale ops (reference
        optimizer.py AdamOptimizer._finish_update)."""
        program = default_main_program()
        for p, g in parameters_and_grads:
            if g is None:
                continue
            with program._optimized_guard([p, g]):
                b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
                b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
                block.append_op(
                    type="scale",
                    inputs={"X": [b1p.name]},
                    outputs={"Out": [b1p.name]},
                    attrs={"scale": self._beta1},
                )
                block.append_op(
                    type="scale",
                    inputs={"X": [b2p.name]},
                    outputs={"Out": [b2p.name]},
                    attrs={"scale": self._beta2},
                )


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(
        self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs
    ):
        super().__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
                "Moment": [moment.name],
                "InfNorm": [inf_norm.name],
                "Beta1Pow": [b1p.name],
            },
            outputs={
                "ParamOut": [p.name],
                "MomentOut": [moment.name],
                "InfNormOut": [inf_norm.name],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block, parameters_and_grads):
        program = default_main_program()
        for p, g in parameters_and_grads:
            if g is None:
                continue
            with program._optimized_guard([p, g]):
                b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
                block.append_op(
                    type="scale",
                    inputs={"X": [b1p.name]},
                    outputs={"Out": [b1p.name]},
                    attrs={"scale": self._beta1},
                )


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [moment.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [p.name], "MomentOut": [moment.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, p)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, p)
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "AvgSquaredGrad": [asg.name],
                "AvgSquaredUpdate": [asu.name],
            },
            outputs={
                "ParamOut": [p.name],
                "AvgSquaredGradOut": [asg.name],
                "AvgSquaredUpdateOut": [asu.name],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(
        self,
        learning_rate,
        rho=0.95,
        epsilon=1e-6,
        momentum=0.0,
        centered=False,
        **kwargs,
    ):
        super().__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho, self._epsilon, self._momentum, self._centered = (
            rho,
            epsilon,
            momentum,
            centered,
        )

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            if self._centered:
                self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        momentum = self._get_accumulator(self._momentum_acc_str, p)
        mean_square = self._get_accumulator(self._mean_square_acc_str, p)
        inputs = {
            "Param": [p.name],
            "Grad": [g.name],
            "Moment": [momentum.name],
            "MeanSquare": [mean_square.name],
            "LearningRate": [self._create_param_lr(param_and_grad).name],
        }
        outputs = {
            "ParamOut": [p.name],
            "MomentOut": [momentum.name],
            "MeanSquareOut": [mean_square.name],
        }
        if self._centered:
            mg = self._get_accumulator(self._mean_grad_acc_str, p)
            inputs["MeanGrad"] = [mg.name]
            outputs["MeanGradOut"] = [mg.name]
        return block.append_op(
            type="rmsprop",
            inputs=inputs,
            outputs=outputs,
            attrs={
                "epsilon": self._epsilon,
                "decay": self._rho,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator(self._squared_acc_str, p)
        lin = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "SquaredAccumulator": [sq.name],
                "LinearAccumulator": [lin.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [p.name],
                "SquaredAccumOut": [sq.name],
                "LinearAccumOut": [lin.name],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ProximalGDOptimizer(Optimizer):
    """reference optimizer.py ProximalGDOptimizer → optimizers/proximal_gd_op.cc"""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_gd"
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="proximal_gd",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [p.name]},
            attrs={"l1": self._l1, "l2": self._l2},
        )


class ProximalAdagradOptimizer(Optimizer):
    """reference optimizer.py ProximalAdagradOptimizer →
    optimizers/proximal_adagrad_op.cc"""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_adagrad"
        self._l1, self._l2 = l1, l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, p)
        return block.append_op(
            type="proximal_adagrad",
            inputs={
                "Param": [p.name],
                "Grad": [g.name],
                "Moment": [moment.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [p.name], "MomentOut": [moment.name]},
            attrs={"l1": self._l1, "l2": self._l2},
        )


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (reference optimizer.py ModelAverage
    → operators/average_accumulates_op.cc). Construct AFTER minimize();
    accumulation ops are appended to the main program for every parameter,
    and ``with model_average.apply(exe):`` swaps averaged weights in (restored
    on exit unless need_restore=False)."""

    def __init__(
        self,
        average_window_rate,
        min_average_window=10000,
        max_average_window=10000,
        **kwargs,
    ):
        super().__init__(0.0, **kwargs)
        self.type = "model_average"
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = [
            (p, None)
            for p in default_main_program().global_block().all_parameters()
        ]
        self.helper = LayerHelper(self.__class__.__name__)
        block = default_main_program().global_block()
        for p, _ in self.params_grads:
            self._append_average_accumulate_op(block, p)

    def _append_average_accumulate_op(self, block, param):
        sums = [
            self._add_accumulator("sum_%d" % i, param) for i in (1, 2, 3)
        ]
        counters = [
            self._add_accumulator(n, param, dtype="int64", shape=[1])
            for n in ("num_accumulates", "old_num_accumulates", "num_updates")
        ]
        names = [v.name for v in sums] + [v.name for v in counters]
        with default_main_program()._optimized_guard([param, None]):
            block.append_op(
                type="average_accumulates",
                inputs={
                    "Param": [param.name],
                    "Sums": names[:3],
                    "Counters": names[3:],
                },
                outputs={"SumsOut": names[:3], "CountersOut": names[3:]},
                attrs={
                    "average_window": self.average_window,
                    "min_average_window": self.min_average_window,
                    "max_average_window": self.max_average_window,
                },
            )

    def _build_swap_program(self, to_average):
        prog = framework.Program()
        with framework.program_guard(prog):
            block = prog.global_block()
            for p, _ in self.params_grads:
                # mirror vars by name so the shared scope resolves them
                for v in [p] + [
                    self._get_accumulator("sum_%d" % i, p) for i in (1, 2, 3)
                ] + [
                    self._get_accumulator(n, p)
                    for n in ("num_accumulates", "old_num_accumulates")
                ] + [self._backup_var(p)]:
                    if v.name not in block.vars:
                        block.create_var(
                            name=v.name,
                            shape=v.shape,
                            dtype=v.dtype,
                            persistable=True,
                        )
                if to_average:
                    block.append_op(
                        type="average_apply",
                        inputs={
                            "Param": [p.name],
                            "Sums": [
                                self._get_accumulator("sum_%d" % i, p).name
                                for i in (1, 2, 3)
                            ],
                            "Counters": [
                                self._get_accumulator(n, p).name
                                for n in ("num_accumulates", "old_num_accumulates")
                            ],
                        },
                        outputs={
                            "ParamOut": [p.name],
                            "Backup": [self._backup_var(p).name],
                        },
                    )
                else:
                    block.append_op(
                        type="assign",
                        inputs={"X": [self._backup_var(p).name]},
                        outputs={"Out": [p.name]},
                    )
        return prog

    def _backup_var(self, param):
        return self._add_accumulator("restore_backup", param)

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        executor.run(self._build_swap_program(to_average=True))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self._build_swap_program(to_average=False))


# short aliases matching fluid.optimizer public names
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
