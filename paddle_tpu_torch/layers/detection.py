"""Detection layers (a copy of paddle_tpu/layers/detection.py; reference
python/paddle/fluid/layers/detection.py: prior_box, density_prior_box, anchor_generator, box_coder, iou_similarity,
bipartite_match, target_assign, multiclass_nms→detection_output, ssd_loss,
multi_box_head, roi_pool/roi_align wrappers, polygon_box_transform,
generate_proposals, yolov3 loss).

Variable-count outputs are fixed-capacity (-1 padded) with a count companion
instead of LoD (ops/detection_ops.py)."""

from ..layer_helper import LayerHelper
from .sequence import _new_len_var, seq_len_of

__all__ = [
    "prior_box",
    "density_prior_box",
    "anchor_generator",
    "box_coder",
    "iou_similarity",
    "bipartite_match",
    "target_assign",
    "multiclass_nms",
    "detection_output",
    "ssd_loss",
    "multi_box_head",
    "roi_pool",
    "roi_align",
    "polygon_box_transform",
    "generate_proposals",
    "yolov3_loss",
]


def prior_box(
    input,
    image,
    min_sizes,
    max_sizes=None,
    aspect_ratios=(1.0,),
    variance=(0.1, 0.1, 0.2, 0.2),
    flip=False,
    clip=False,
    steps=(0.0, 0.0),
    offset=0.5,
    name=None,
    min_max_aspect_ratios_order=False,
):
    helper = LayerHelper("prior_box", **locals())
    boxes = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [variances.name]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variance),
            "flip": flip,
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
            "min_max_aspect_ratios_order": min_max_aspect_ratios_order,
        },
    )
    boxes.stop_gradient = True
    variances.stop_gradient = True
    return boxes, variances


def density_prior_box(
    input,
    image,
    densities,
    fixed_sizes,
    fixed_ratios=(1.0,),
    variance=(0.1, 0.1, 0.2, 0.2),
    clip=False,
    steps=(0.0, 0.0),
    offset=0.5,
    name=None,
):
    helper = LayerHelper("density_prior_box", **locals())
    boxes = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [variances.name]},
        attrs={
            "densities": list(densities),
            "fixed_sizes": list(fixed_sizes),
            "fixed_ratios": list(fixed_ratios),
            "variances": list(variance),
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
        },
    )
    boxes.stop_gradient = True
    variances.stop_gradient = True
    return boxes, variances


def anchor_generator(
    input,
    anchor_sizes,
    aspect_ratios,
    variance=(0.1, 0.1, 0.2, 0.2),
    stride=None,
    offset=0.5,
    name=None,
):
    helper = LayerHelper("anchor_generator", **locals())
    anchors = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input.name]},
        outputs={"Anchors": [anchors.name], "Variances": [variances.name]},
        attrs={
            "anchor_sizes": list(anchor_sizes),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variance),
            "stride": list(stride or [16.0, 16.0]),
            "offset": offset,
        },
    )
    anchors.stop_gradient = True
    variances.stop_gradient = True
    return anchors, variances


def box_coder(
    prior_box,
    prior_box_var,
    target_box,
    code_type="encode_center_size",
    box_normalized=True,
    name=None,
):
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op(
        type="box_coder",
        inputs=inputs,
        outputs={"OutputBox": [out.name]},
        attrs={"code_type": code_type, "box_normalized": box_normalized},
    )
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="iou_similarity",
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [out.name]},
        attrs={"box_normalized": box_normalized},
    )
    return out


def bipartite_match(
    dist_matrix, match_type="bipartite", dist_threshold=0.5, name=None
):
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix.name]},
        outputs={
            "ColToRowMatchIndices": [match_indices.name],
            "ColToRowMatchDist": [match_dist.name],
        },
        attrs={"match_type": match_type, "dist_threshold": dist_threshold},
    )
    match_indices.stop_gradient = True
    match_dist.stop_gradient = True
    return match_indices, match_dist


def target_assign(
    input, matched_indices, negative_indices=None, mismatch_value=0, name=None
):
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op(
        type="target_assign",
        inputs=inputs,
        outputs={"Out": [out.name], "OutWeight": [out_weight.name]},
        attrs={"mismatch_value": mismatch_value},
    )
    return out, out_weight


def multiclass_nms(
    bboxes,
    scores,
    score_threshold,
    nms_top_k,
    keep_top_k,
    nms_threshold=0.3,
    normalized=True,
    nms_eta=1.0,
    background_label=0,
    name=None,
):
    """Returns [B, keep_top_k, 6] (-1 padded) with a count companion
    (reference multiclass_nms_op.cc emitted LoD)."""
    helper = LayerHelper("multiclass_nms", **locals())
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    len_name = _new_len_var(helper, out)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes.name], "Scores": [scores.name]},
        outputs={"Out": [out.name], "OutLen": [len_name]},
        attrs={
            "background_label": background_label,
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "nms_threshold": nms_threshold,
            "keep_top_k": keep_top_k,
            "normalized": normalized,
        },
    )
    out.stop_gradient = True
    return out


def detection_output(
    loc,
    scores,
    prior_box,
    prior_box_var,
    background_label=0,
    nms_threshold=0.3,
    nms_top_k=400,
    keep_top_k=200,
    score_threshold=0.01,
    nms_eta=1.0,
):
    """Decode + NMS (reference layers/detection.py detection_output). `loc`
    [B, M, 4] deltas, `scores` [B, M, C] post-softmax."""
    from .nn import transpose

    decoded = box_coder(
        prior_box, prior_box_var, loc, code_type="decode_center_size"
    )  # [B, M, 4]
    scores_t = transpose(scores, [0, 2, 1])  # [B, C, M]
    return multiclass_nms(
        decoded,
        scores_t,
        score_threshold=score_threshold,
        nms_top_k=nms_top_k,
        keep_top_k=keep_top_k,
        nms_threshold=nms_threshold,
        background_label=background_label,
    )


def ssd_loss(
    location,
    confidence,
    gt_box,
    gt_label,
    prior_box,
    prior_box_var=None,
    background_label=0,
    overlap_threshold=0.5,
    neg_pos_ratio=3.0,
    neg_overlap=0.5,
    loc_loss_weight=1.0,
    conf_loss_weight=1.0,
    match_type="per_prediction",
    mining_type="max_negative",
    normalize=True,
    sample_size=None,
):
    """Fused SSD loss (see ops/detection_ops.py _ssd_loss). gt_box/gt_label
    are padded [B, G, ...] with gt_box carrying the @LEN companion."""
    helper = LayerHelper("ssd_loss", **locals())
    loss = helper.create_variable_for_type_inference("float32")
    inputs = {
        "Location": [location.name],
        "Confidence": [confidence.name],
        "GTBox": [gt_box.name],
        "GTLabel": [gt_label.name],
        "GTLen": [seq_len_of(gt_box)],
        "PriorBox": [prior_box.name],
    }
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op(
        type="ssd_loss",
        inputs=inputs,
        outputs={"Loss": [loss.name]},
        attrs={
            "background_label": background_label,
            "overlap_threshold": overlap_threshold,
            "neg_pos_ratio": neg_pos_ratio,
            "loc_loss_weight": loc_loss_weight,
            "conf_loss_weight": conf_loss_weight,
            "match_type": match_type,
        },
    )
    return loss


def multi_box_head(
    inputs,
    image,
    base_size,
    num_classes,
    aspect_ratios,
    min_ratio=None,
    max_ratio=None,
    min_sizes=None,
    max_sizes=None,
    steps=None,
    step_w=None,
    step_h=None,
    offset=0.5,
    variance=(0.1, 0.1, 0.2, 0.2),
    flip=True,
    clip=False,
    kernel_size=1,
    pad=0,
    stride=1,
    name=None,
    min_max_aspect_ratios_order=False,
):
    """SSD heads over multiple feature maps (reference layers/detection.py
    multi_box_head): per map, conv for loc + conf, prior_box; concatenated to
    mbox_loc [B, M, 4], mbox_conf [B, M, C], boxes [M, 4], vars [M, 4]."""
    from . import nn, tensor

    if min_sizes is None:
        # reference ratio schedule (layers/detection.py:1082)
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        if num_layer > 2:
            step = int((max_ratio - min_ratio) / (num_layer - 2))
            for ratio in range(min_ratio, max_ratio + 1, step):
                min_sizes.append(base_size * ratio / 100.0)
                max_sizes.append(base_size * (ratio + step) / 100.0)
            min_sizes = [base_size * 0.1] + min_sizes
            max_sizes = [base_size * 0.2] + max_sizes
        else:
            min_sizes = [base_size * 0.2, base_size * 0.5]
            max_sizes = [base_size * 0.5, base_size * 0.8]

    locs, confs, boxes_list, vars_list = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[0], (list, tuple)) else aspect_ratios
        step = steps[i] if steps else (step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0)
        if not isinstance(step, (list, tuple)):
            step = (step, step)
        box, var = prior_box(
            x, image,
            min_sizes=[mins] if not isinstance(mins, (list, tuple)) else mins,
            max_sizes=[maxs] if maxs and not isinstance(maxs, (list, tuple)) else maxs,
            aspect_ratios=ar, variance=variance, flip=flip, clip=clip,
            steps=step, offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order,
        )
        num_priors = box.shape[2] if box.shape else 0
        nb = num_priors * (box.shape[0] * box.shape[1])
        loc = nn.conv2d(x, num_filters=num_priors * 4,
                        filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.conv2d(x, num_filters=num_priors * num_classes,
                         filter_size=kernel_size, padding=pad, stride=stride)
        # NCHW -> [B, H*W*P, 4|C]
        loc = nn.transpose(loc, [0, 2, 3, 1])
        loc = nn.reshape(loc, [0, -1, 4])
        conf = nn.transpose(conf, [0, 2, 3, 1])
        conf = nn.reshape(conf, [0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_list.append(nn.reshape(box, [-1, 4]))
        vars_list.append(nn.reshape(var, [-1, 4]))

    mbox_loc = tensor.concat(locs, axis=1)
    mbox_conf = tensor.concat(confs, axis=1)
    all_boxes = tensor.concat(boxes_list, axis=0)
    all_vars = tensor.concat(vars_list, axis=0)
    return mbox_loc, mbox_conf, all_boxes, all_vars


def _roi_op(op_type, input, rois, pooled_height, pooled_width, spatial_scale,
            extra_attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {
        "pooled_height": pooled_height,
        "pooled_width": pooled_width,
        "spatial_scale": spatial_scale,
    }
    attrs.update(extra_attrs or {})
    helper.append_op(
        type=op_type,
        inputs={
            "X": [input.name],
            "ROIs": [rois.name],
            "RoisLen": [seq_len_of(rois)],
        },
        outputs={"Out": [out.name]},
        attrs=attrs,
    )
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    """reference layers/nn.py roi_pool → roi_pool_op.h. `rois` is padded
    [B, R, 4] with a @LEN companion (reference used LoD batch mapping)."""
    return _roi_op("roi_pool", input, rois, pooled_height, pooled_width,
                   spatial_scale)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None):
    """reference layers/nn.py roi_align → roi_align_op.h."""
    return _roi_op("roi_align", input, rois, pooled_height, pooled_width,
                   spatial_scale, {"sampling_ratio": sampling_ratio}, name)


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="polygon_box_transform",
        inputs={"Input": [input.name]},
        outputs={"Output": [out.name]},
    )
    return out


def generate_proposals(
    scores,
    bbox_deltas,
    im_info,
    anchors,
    variances,
    pre_nms_top_n=6000,
    post_nms_top_n=1000,
    nms_thresh=0.5,
    min_size=0.1,
    eta=1.0,
    name=None,
):
    """RPN proposal generation (reference detection/generate_proposals_op.cc).
    Returns (rois [B, post_nms_top_n, 4] -1-padded with @LEN companion,
    roi_probs)."""
    helper = LayerHelper("generate_proposals", **locals())
    rois = helper.create_variable_for_type_inference("float32")
    probs = helper.create_variable_for_type_inference("float32")
    len_name = _new_len_var(helper, rois)
    helper.append_op(
        type="generate_proposals",
        inputs={
            "Scores": [scores.name],
            "BboxDeltas": [bbox_deltas.name],
            "ImInfo": [im_info.name],
            "Anchors": [anchors.name],
            "Variances": [variances.name],
        },
        outputs={
            "RpnRois": [rois.name],
            "RpnRoiProbs": [probs.name],
            "RoisLen": [len_name],
        },
        attrs={
            "pre_nms_topN": pre_nms_top_n,
            "post_nms_topN": post_nms_top_n,
            "nms_thresh": nms_thresh,
            "min_size": min_size,
        },
    )
    rois.stop_gradient = True
    probs.stop_gradient = True
    return rois, probs


def yolov3_loss(
    x,
    gtbox,
    gtlabel,
    anchors,
    class_num,
    ignore_thresh,
    loss_weight_xy=None,
    loss_weight_wh=None,
    loss_weight_conf_target=None,
    loss_weight_conf_notarget=None,
    loss_weight_class=None,
    name=None,
):
    """reference layers/detection.py yolov3_loss → yolov3_loss_op.h."""
    helper = LayerHelper("yolov3_loss", **locals())
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="yolov3_loss",
        inputs={
            "X": [x.name],
            "GTBox": [gtbox.name],
            "GTLabel": [gtlabel.name],
        },
        outputs={"Loss": [loss.name]},
        attrs={
            "anchors": list(anchors),
            "class_num": class_num,
            "ignore_thresh": ignore_thresh,
        },
    )
    return loss
