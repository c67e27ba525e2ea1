"""In-graph metric layers (reference python/paddle/fluid/layers/metric_op.py:
accuracy, auc). positive_negative_pair comes with its op."""

from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy (reference metric_op.py accuracy → top_k + accuracy ops)."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="top_k",
        inputs={"X": [input.name]},
        outputs={"Out": [topk_out.name], "Indices": [topk_indices.name]},
        attrs={"k": k},
    )
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={
            "Out": [topk_out.name],
            "Indices": [topk_indices.name],
            "Label": [label.name],
        },
        outputs={
            "Accuracy": [acc_out.name],
            "Correct": [correct.name],
            "Total": [total.name],
        },
    )
    acc_out.stop_gradient = True
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """Streaming AUC (reference metric_op.py auc → auc op with persistable
    stat buffers updated in-graph)."""
    helper = LayerHelper("auc")
    auc_out = helper.create_variable_for_type_inference(dtype="float32")
    batch_out = helper.create_variable_for_type_inference(dtype="float32")
    stat_pos = helper.create_or_get_global_variable(
        name=helper.name + "_stat_pos", dtype="float32", shape=[num_thresholds + 1]
    )
    stat_neg = helper.create_or_get_global_variable(
        name=helper.name + "_stat_neg", dtype="float32", shape=[num_thresholds + 1]
    )
    for var in [stat_pos, stat_neg]:
        helper.set_variable_initializer(var, Constant(value=0.0))
    helper.append_op(
        type="auc",
        inputs={
            "Predict": [input.name],
            "Label": [label.name],
            "StatPos": [stat_pos.name],
            "StatNeg": [stat_neg.name],
        },
        outputs={
            "AUC": [auc_out.name],
            "StatPosOut": [stat_pos.name],
            "StatNegOut": [stat_neg.name],
        },
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    auc_out.stop_gradient = True
    return auc_out, [batch_out, stat_pos, stat_neg]
