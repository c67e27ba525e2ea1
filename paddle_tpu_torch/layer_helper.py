"""LayerHelper: shared parameter-creation / op-append plumbing for all layers.

Reference analog: python/paddle/fluid/layer_helper.py — every layer function
constructs one of these to create parameters (registered in both the main and
startup programs, with the initializer op appended to the startup program),
create output variables, and append its ops to the main program.
"""

import copy

from . import framework, unique_name
from .framework import Parameter, Variable, default_main_program, default_startup_program
from .initializer import Constant, Xavier
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name", None)
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [copy.deepcopy(attr) for _ in range(length)]
        if len(attr) != length:
            raise ValueError("param_attr length mismatch")
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        return zip(inputs, attrs)

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("input dtype mismatch: %s vs %s" % (dtype, each.dtype))
        return dtype

    def create_parameter(
        self, attr, shape, dtype, is_bias=False, default_initializer=None
    ):
        """Create the Parameter in the main program and append its initializer
        op to the startup program (reference layer_helper.py:create_parameter)."""
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if not is_bias else "b"]))

        shape = [int(s) for s in shape]
        # startup program owns the init op; main program owns the Parameter
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs(with_initializer=True)
        )
        attr.initializer(sp, startup_block)
        return self.main_program.global_block().create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs()
        )

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    # reference-era alias
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        # persistable, whatever the caller passed (the JAX package's copy
        # passes it twice when the caller gives it, and raises)
        kwargs["persistable"] = True
        return block.create_var(name=name, *args, **kwargs)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(
            name=var.name,
            shape=var.shape,
            dtype=var.dtype,
            persistable=True,
        )
        initializer(sv, startup_block)
        return sv

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var.name]},
            outputs={"Out": [tmp.name]},
            attrs=act,
        )
        return tmp
