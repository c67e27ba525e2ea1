"""Gradient clipping as graph rewrites (reference python/paddle/fluid/clip.py:
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip, append_gradient_clip_ops).

A copy of paddle_tpu/clip.py. The optimizer calls append_gradient_clip_ops
on every minimize; with no clip attr set it appends nothing. The clip ops
themselves (clip, clip_by_norm, square, sqrt, elementwise_max) and the
layers GradientClipByGlobalNorm builds from are not ported yet."""

from .framework import default_main_program
from .layer_helper import LayerHelper

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
        )


def error_clip_callback(block, context):  # registered via Optimizer.backward
    pass


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def _create_operators(self, param, grad):
        helper = LayerHelper("gradient_clip")
        helper.append_op(
            type="clip",
            inputs={"X": [grad.name]},
            outputs={"Out": [grad.name]},
            attrs={"min": self.min, "max": self.max},
        )
        return param, grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        helper = LayerHelper("gradient_clip")
        helper.append_op(
            type="clip_by_norm",
            inputs={"X": [grad.name]},
            outputs={"Out": [grad.name]},
            attrs={"max_norm": self.clip_norm},
        )
        return param, grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """scale = clip_norm / max(global_norm, clip_norm), applied to every grad
    (reference clip.py:GradientClipByGlobalNorm — built from square/reduce_sum/
    sum/sqrt/elementwise ops)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_norm"] = self.clip_norm
        from .layers import nn

        sq = nn.reduce_sum(_square(grad))
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        from .layers import nn, ops, tensor

        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = tensor.sums(self.context[self.group_name])
            group_norm = ops.sqrt(group_norm)
            clip_var = tensor.fill_constant(
                shape=[1], dtype=group_norm.dtype, value=self.clip_norm
            )
            scale = nn.elementwise_div(
                x=clip_var, y=nn.elementwise_max(x=clip_var, y=group_norm)
            )
            self.context[group_scale_name] = scale
        helper = LayerHelper("gradient_clip")
        helper.append_op(
            type="elementwise_mul",
            inputs={"X": [grad.name], "Y": [self.context[group_scale_name].name]},
            outputs={"Out": [grad.name]},
            attrs={"axis": -1},
        )
        return param, grad


def _square(x):
    helper = LayerHelper("square")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="square", inputs={"X": [x.name]}, outputs={"Out": [out.name]})
    return out


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Global or per-param clip attr (reference clip.py:set_gradient_clip)."""
    global _gradient_clip_attr
    if param_list:
        for p in param_list:
            if isinstance(p, str):
                p = default_main_program().global_block().var(p)
            p.gradient_clip_attr = clip
    else:
        _gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    context = {}
    clips = []
    program = default_main_program()
    # SelectedRows (sparse) grads pass through unclipped: the clip ops are
    # dense rewrites, and norm-clipping a fixed-capacity values array with
    # duplicate rows would mis-measure the true gradient anyway (the
    # reference's ClipGradByGlobalNorm likewise ignored SelectedRows)
    dense = [
        pg
        for pg in param_grads
        if pg[1] is not None and not getattr(pg[1], "is_selected_rows", False)
    ]
    for p, g in dense:
        with program._optimized_guard([p, g]):
            clip_attr = getattr(p, "gradient_clip_attr", None) or _gradient_clip_attr
            if clip_attr is None:
                clip_attr = NullGradientClipAttr()
            clip_attr._process_context(context=context, param=p, grad=g)
            clips.append(clip_attr)

    res = []
    for (p, g), clip_attr in zip(dense, clips):
        with program._optimized_guard([p, g]):
            res.append(clip_attr._create_operators(param=p, grad=g))
    for p, g in param_grads:
        if g is None or getattr(g, "is_selected_rows", False):
            res.append((p, g))
    return res
