"""Structured-prediction / ranking / sampled-loss layers (a copy of
paddle_tpu/layers/loss.py, its ops in ops/loss_ops.py; reference
python/paddle/fluid/layers/nn.py: linear_chain_crf, crf_decoding, warpctc,
ctc_greedy_decoder, nce, hsigmoid, cos_sim, bpr_loss, margin_rank_loss,
rank_loss, edit_distance, sampling_id, huber_loss).

Sequence arguments follow the padded-dense + `<name>@LEN` companion
convention (layers/sequence.py); the reference used LoD tensors."""

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .sequence import _propagate, seq_len_of

__all__ = [
    "linear_chain_crf",
    "crf_decoding",
    "warpctc",
    "ctc_greedy_decoder",
    "nce",
    "hsigmoid",
    "cos_sim",
    "bpr_loss",
    "margin_rank_loss",
    "rank_loss",
    "modified_huber_loss",
    "edit_distance",
    "sampling_id",
    "huber_loss",
]


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood (reference layers/nn.py linear_chain_crf →
    linear_chain_crf_op.cc). `input` is the [B, T, D] emission; the
    [D+2, D] transition parameter is created here (rows 0/1: start/end)."""
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr,
        shape=[size + 2, size],
        dtype=helper.input_dtype(),
    )
    seqlen = length.name if length is not None else seq_len_of(input)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    emission_exps = helper.create_variable_for_type_inference(input.dtype)
    transition_exps = helper.create_variable_for_type_inference(input.dtype)
    log_likelihood = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="linear_chain_crf",
        inputs={
            "Emission": [input.name],
            "Transition": [transition.name],
            "Label": [label.name],
            "SeqLen": [seqlen],
        },
        outputs={
            "Alpha": [alpha.name],
            "EmissionExps": [emission_exps.name],
            "TransitionExps": [transition_exps.name],
            "LogLikelihood": [log_likelihood.name],
        },
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the trained transition parameter (reference
    layers/nn.py crf_decoding → crf_decoding_op.cc)."""
    helper = LayerHelper("crf_decoding", **locals())
    name = param_attr.name if isinstance(param_attr, ParamAttr) else str(param_attr)
    transition = helper.main_program.global_block()._var_recursive(name)
    seqlen = length.name if length is not None else seq_len_of(input)
    viterbi_path = helper.create_variable_for_type_inference("int64")
    inputs = {
        "Emission": [input.name],
        "Transition": [transition.name],
        "SeqLen": [seqlen],
    }
    if label is not None:
        inputs["Label"] = [label.name]
    helper.append_op(
        type="crf_decoding",
        inputs=inputs,
        outputs={"ViterbiPath": [viterbi_path.name]},
    )
    viterbi_path.stop_gradient = True
    return _propagate(viterbi_path, input)


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss (reference layers/nn.py warpctc → warpctc_op.cc). `input`
    is [B, T, num_classes+1] raw logits, `label` [B, L, 1] int; both carry
    length companions."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="warpctc",
        inputs={
            "Logits": [input.name],
            "Label": [label.name],
            "LogitsLength": [seq_len_of(input)],
            "LabelLength": [seq_len_of(label)],
        },
        outputs={"Loss": [loss.name]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """argmax per step, then collapse repeats and drop blanks (reference
    layers/nn.py ctc_greedy_decoder = topk + ctc_align_op)."""
    from .nn import topk

    from .sequence import _new_len_var

    helper = LayerHelper("ctc_greedy_decoder", **locals())
    _, ids = topk(input, k=1)
    out = helper.create_variable_for_type_inference("int64")
    out_len_name = _new_len_var(helper, out)
    helper.append_op(
        type="ctc_align",
        inputs={"Input": [ids.name], "SeqLen": [seq_len_of(input)]},
        outputs={"Output": [out.name], "OutLen": [out_len_name]},
        attrs={"blank": blank, "padding_value": 0},
    )
    out.stop_gradient = True
    return out


def nce(
    input,
    label,
    num_total_classes,
    sample_weight=None,
    param_attr=None,
    bias_attr=None,
    num_neg_samples=None,
    name=None,
    sampler="uniform",
    custom_dist=None,
    seed=0,
    is_sparse=False,
):
    """Noise-contrastive estimation (reference layers/nn.py nce → nce_op.cc).

    custom_dist: list/array of num_total_classes sampling probabilities
    (reference sampler=2 CustomSampler); sample_weight: (batch, 1) Variable
    scaling each row's cost (reference nce_op.h:159)."""
    helper = LayerHelper("nce", **locals())
    dim = input.shape[-1]
    num_neg_samples = int(num_neg_samples or 10)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_total_classes, dim],
        dtype=input.dtype,
    )
    inputs = {"Input": [input.name], "Label": [label.name], "Weight": [w.name]}
    # reference nn.py nce contract: custom_dist and sampler="custom_dist"
    # come together; custom_dist does not silently override another sampler
    if (custom_dist is not None) and sampler not in ("uniform", "custom_dist"):
        raise ValueError(
            "custom_dist conflicts with sampler=%r; pass "
            "sampler='custom_dist' (or leave the default)" % sampler
        )
    if sampler == "custom_dist" and custom_dist is None:
        raise ValueError("sampler='custom_dist' requires custom_dist")
    if custom_dist is not None:
        from .tensor import assign

        dist = np.asarray(custom_dist, dtype="float32").reshape(-1)
        if dist.shape[0] != num_total_classes:
            raise ValueError(
                "custom_dist must have num_total_classes=%d entries, got %d"
                % (num_total_classes, dist.shape[0])
            )
        probs = assign(dist)
        inputs["CustomDistProbs"] = [probs.name]
        sampler = "custom_dist"
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight.name]
    if not (bias_attr is False):
        b = helper.create_parameter(
            attr=helper.bias_attr,
            shape=[num_total_classes, 1],
            dtype=input.dtype,
            is_bias=True,
        )
        inputs["Bias"] = [b.name]
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={
            "Cost": [cost.name],
            "SampleLogits": [sample_logits.name],
            "SampleLabels": [sample_labels.name],
        },
        attrs={
            "num_total_classes": num_total_classes,
            "num_neg_samples": num_neg_samples,
            "sampler": sampler,
            "seed": seed,
        },
    )
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None, name=None):
    """Hierarchical sigmoid over the implicit complete binary tree (reference
    layers/nn.py hsigmoid → hierarchical_sigmoid_op.cc)."""
    helper = LayerHelper("hsigmoid", **locals())
    dim = input.shape[-1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_classes - 1, dim], dtype=input.dtype
    )
    inputs = {"X": [input.name], "Label": [label.name], "W": [w.name]}
    if not (bias_attr is False):
        b = helper.create_parameter(
            attr=helper.bias_attr,
            shape=[num_classes - 1, 1],
            dtype=input.dtype,
            is_bias=True,
        )
        inputs["Bias"] = [b.name]
    cost = helper.create_variable_for_type_inference(input.dtype)
    pre_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs=inputs,
        outputs={"Cost": [cost.name], "PreOut": [pre_out.name]},
        attrs={"num_classes": num_classes},
    )
    return cost


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", **locals())
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X.name], "Y": [Y.name]},
        outputs={"Out": [out.name], "XNorm": [xnorm.name], "YNorm": [ynorm.name]},
    )
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="bpr_loss",
        inputs={"X": [input.name], "Label": [label.name]},
        outputs={"Cost": [out.name]},
    )
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", **locals())
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label.name], "X1": [left.name], "X2": [right.name]},
        outputs={"Out": [out.name], "Activated": [act.name]},
        attrs={"margin": margin},
    )
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", **locals())
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(
        type="rank_loss",
        inputs={"Label": [label.name], "Left": [left.name], "Right": [right.name]},
        outputs={"Out": [out.name]},
    )
    return out


def modified_huber_loss(x, y, name=None):
    helper = LayerHelper("modified_huber_loss", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inter = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="modified_huber_loss",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name], "IntermediateVal": [inter.name]},
    )
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input.name], "Y": [label.name]},
        outputs={"Out": [out.name], "Residual": [residual.name]},
        attrs={"delta": delta},
    )
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    """Batched Levenshtein distance (reference layers/nn.py edit_distance →
    edit_distance_op.cc). `ignored_tokens` are erased from both sequences
    before the distance, via sequence_erase ops as the reference does
    (reference layers/nn.py:4402-4417). Returns (distance [B,1], seq_num [1])."""
    if ignored_tokens:
        from .sequence import sequence_erase

        input = sequence_erase(input, list(ignored_tokens))
        label = sequence_erase(label, list(ignored_tokens))
    helper = LayerHelper("edit_distance", **locals())
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="edit_distance",
        inputs={
            "Hyps": [input.name],
            "Refs": [label.name],
            "HypsLen": [seq_len_of(input)],
            "RefsLen": [seq_len_of(label)],
        },
        outputs={"Out": [out.name], "SequenceNum": [seq_num.name]},
        attrs={"normalized": normalized},
    )
    out.stop_gradient = True
    seq_num.stop_gradient = True
    return out, seq_num


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """Sample a column per row from a probability matrix (reference
    layers/nn.py sampling_id → sampling_id_op.cc)."""
    helper = LayerHelper("sampling_id", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="sampling_id",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
        attrs={"seed": seed},
    )
    out.stop_gradient = True
    return out
