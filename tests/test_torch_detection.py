"""Parity of the port's detection surface with the JAX package on the CPU:
every case of tests/test_detection.py built in both packages from the same
seed-made feeds, the lowerings with gradients (ssd_loss, yolov3_loss, the
RoI ops) op by op, the tie and out-of-range cases the port guards, and
MobileNet-SSD at a small size (width 0.25, 64 x 64, batch 4): its first 3
RMSProp losses and its eval program's detections and mAP. Integer outputs
match exactly; boxes and losses within the stated tolerances."""

import inspect
import os

import numpy as np
import pytest

from torch_rnn_cases import assert_outs_close, assert_runs_close, check_op, lower_both, run_both

TOL = 1e-5  # boxes, IoUs and per-op losses
TRAIN_RTOL = 1e-4  # losses of a few training steps


def _rng(seed):
    return np.random.RandomState(seed)


def _data(fluid, name, arr):
    return fluid.layers.data(name=name, shape=list(arr.shape), dtype=str(arr.dtype),
                             append_batch_size=False)


def _len_var(fluid, var, name, n):
    fluid.default_main_program().global_block().create_var(name=name, shape=(n,),
                                                           dtype="int64")
    var._len_name = name


def _raw_op(fluid, op_type, feeds, outputs, attrs, inputs):
    """A program of one op appended by hand (as tests/test_detection.py
    builds its raw-op cases); returns the output vars."""
    blk = fluid.default_main_program().global_block()
    for name, arr in feeds.items():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
    outs = {}
    for slot, names in outputs.items():
        outs[slot] = [blk.create_var(name=n, shape=None, dtype=None) for n in names]
    blk.append_op(type=op_type, inputs=inputs,
                  outputs={s: [v.name for v in vs] for s, vs in outs.items()}, attrs=attrs)
    return [v for vs in outs.values() for v in vs]


def _both(program_fn, feeds, tol=TOL, steps=1):
    want, got, _, _ = run_both(program_fn, feeds, steps=steps)
    assert_runs_close(got, want, tol, tol)
    return got


# ---------------------------------------------------------------------------
# the cases of tests/test_detection.py and their variants
# ---------------------------------------------------------------------------

PRIOR_CASES = {
    "minmax_flip_clip": dict(min_sizes=[8.0], max_sizes=[16.0], aspect_ratios=[2.0],
                             flip=True, clip=True),
    "mmao_steps": dict(min_sizes=[6.0, 12.0], max_sizes=[10.0, 20.0], aspect_ratios=[2.0, 3.0],
                       flip=True, steps=(7.0, 9.0), offset=0.3, min_max_aspect_ratios_order=True),
    "no_max": dict(min_sizes=[5.0], aspect_ratios=[1.0, 0.5], variance=(0.2, 0.2, 0.1, 0.1)),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_prior_box(case):
    feeds = {"f": np.zeros((1, 8, 4, 5), np.float32), "im": np.zeros((1, 3, 32, 40), np.float32)}

    def program_fn(fluid):
        return fluid.layers.prior_box(_data(fluid, "f", feeds["f"]),
                                      _data(fluid, "im", feeds["im"]), **PRIOR_CASES[case])

    got = _both(program_fn, feeds)
    if case == "minmax_flip_clip":  # the JAX test's own values
        bv = got[0][0]
        np.testing.assert_allclose(bv[0, 0, 0], [0.0, 0.0, 0.2, 0.25], atol=1e-6)


def test_density_prior_box_and_anchor_generator():
    feeds = {"f": np.zeros((1, 8, 3, 4), np.float32), "im": np.zeros((1, 3, 48, 64), np.float32)}

    def program_fn(fluid):
        f, im = _data(fluid, "f", feeds["f"]), _data(fluid, "im", feeds["im"])
        dbox, dvar = fluid.layers.density_prior_box(
            f, im, densities=[2, 1], fixed_sizes=[8.0, 16.0], fixed_ratios=[1.0, 2.0], clip=True)
        anc, avar = fluid.layers.anchor_generator(
            f, anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 16.0])
        return dbox, dvar, anc, avar

    got = _both(program_fn, feeds)
    assert got[0][0].shape == (3, 4, 10, 4) and got[0][2].shape == (3, 4, 6, 4)


def test_box_coder_roundtrip():
    rng = _rng(0)
    m, r = 6, 5
    feeds = {"pb": np.sort(rng.rand(m, 2, 2), axis=1).reshape(m, 4).astype("float32"),
             "pv": np.full((m, 4), 0.1, np.float32),
             "tb": np.sort(rng.rand(r, 2, 2), axis=1).reshape(r, 4).astype("float32")}

    def program_fn(fluid):
        pb, pv, tb = (_data(fluid, n, feeds[n]) for n in ("pb", "pv", "tb"))
        enc = fluid.layers.box_coder(pb, pv, tb, "encode_center_size")
        dec = fluid.layers.box_coder(pb, pv, enc, "decode_center_size")
        raw = fluid.layers.box_coder(pb, None, tb, "encode_center_size", box_normalized=False)
        return enc, dec, raw

    got = _both(program_fn, feeds, tol=1e-4)
    for j in range(m):  # decode(encode(gt)) gives gt against every prior
        np.testing.assert_allclose(got[0][1][:, j], feeds["tb"], atol=1e-4)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_iou_similarity_and_bipartite_match(match_type):
    x = np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32)
    y = np.array([[0, 0, 2, 2], [10, 10, 11, 11], [1, 1, 3, 3], [0.5, 0, 2, 2]], np.float32)
    feeds = {"x": x, "y": y}

    def program_fn(fluid):
        iou = fluid.layers.iou_similarity(_data(fluid, "x", x), _data(fluid, "y", y))
        match, dist = fluid.layers.bipartite_match(iou, match_type=match_type,
                                                   dist_threshold=0.3)
        return iou, match, dist

    got = _both(program_fn, feeds)
    mv = got[0][1].reshape(-1)
    assert mv[0] == 0 and mv[2] == 1 and mv[1] == -1


def test_bipartite_match_batched_ties():
    """Equal distances: the first maximum in row-major order wins, in both
    packages."""
    dist = np.array([[[0.5, 0.5, 0.2], [0.5, 0.5, 0.9]],
                     [[0.3, 0.3, 0.3], [0.3, 0.3, 0.3]]], np.float32)
    for match_type in ("bipartite", "per_prediction"):
        want, got = lower_both("bipartite_match", {"DistMat": [dist]},
                               {"match_type": match_type, "dist_threshold": 0.25})
        assert_outs_close(got, want, TOL, match_type)


def test_target_assign_guards():
    """A match index past the gt rows takes the JAX gather's fill (NaN for
    floats, the integer minimum for ints); -1 pads and an index past the
    priors in NegIndices are dropped as the JAX scatter drops them."""
    rng = _rng(1)
    x = rng.randn(2, 3, 4).astype(np.float32)
    match = np.array([[0, -1, 2, 5], [1, 1, -1, -1]], np.int32)
    neg = np.array([[1, -1, 9], [2, 3, -1]], np.int32)
    for xs in (x, rng.randint(0, 9, (2, 3, 1)).astype(np.int32)):
        want, got = lower_both("target_assign", {"X": [xs], "MatchIndices": [match],
                                                 "NegIndices": [neg]}, {"mismatch_value": 7})
        assert_outs_close(got, want, TOL, str(xs.dtype))  # NaN where NaN


def test_mine_hard_examples_ties():
    loss = np.array([[0.5, 0.5, 0.9, 0.5, 0.1, 0.5]], np.float32)
    match = np.array([[2, -1, -1, -1, -1, -1]], np.int32)
    want, got = lower_both("mine_hard_examples", {"ClsLoss": [loss], "MatchIndices": [match]},
                           {"neg_pos_ratio": 3.0})
    assert_outs_close(got, want, TOL, "mine_hard_examples")
    np.testing.assert_array_equal(got["NegIndices"][0][0, :3], [2, 1, 3])


def test_multiclass_nms():
    boxes = np.array([[[0, 0, 10, 10], [0.5, 0.5, 10.5, 10.5],
                       [20, 20, 30, 30], [50, 50, 60, 60]]], np.float32)
    scores = np.zeros((1, 2, 4), np.float32)
    scores[0, 1] = [0.9, 0.8, 0.7, 0.05]
    feeds = {"b": boxes, "s": scores}

    def program_fn(fluid):
        out = fluid.layers.multiclass_nms(
            _data(fluid, "b", boxes), _data(fluid, "s", scores), score_threshold=0.1,
            nms_top_k=4, keep_top_k=4, nms_threshold=0.5, normalized=False)
        return out, fluid.default_main_program().global_block().var(out._len_name)

    got = _both(program_fn, feeds)
    assert got[0][1].reshape(-1)[0] == 2
    np.testing.assert_allclose(got[0][0][0, 0, :2], [1, 0.9], atol=1e-6)


def test_multiclass_nms_tied_scores():
    """Tied scores within and across classes: the kept boxes and their
    order follow the lower index, as lax.top_k and jnp.argmax do."""
    rng = _rng(2)
    b, m, c = 2, 12, 4
    xy = rng.rand(b, m, 2).astype(np.float32) * 20
    boxes = np.concatenate([xy, xy + 3 + rng.rand(b, m, 2).astype(np.float32) * 5], axis=2)
    scores = np.round(rng.rand(b, c, m) * 4).astype(np.float32) / 4  # few distinct values
    for normalized in (False, True):
        want, got = lower_both("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
                               {"score_threshold": 0.1, "nms_top_k": 8, "keep_top_k": 10,
                                "nms_threshold": 0.3, "normalized": normalized,
                                "background_label": 0})
        assert_outs_close(got, want, TOL, "normalized=%s" % normalized)


def test_roi_pool_and_align():
    b, c, h, w = 1, 1, 6, 6
    feeds = {"x": np.arange(h * w, dtype=np.float32).reshape(b, c, h, w),
             "r": np.array([[[0, 0, 3, 3], [2, 2, 5, 5]]], np.float32),
             "rl": np.array([2], np.int64)}

    def program_fn(fluid):
        xv, rv = _data(fluid, "x", feeds["x"]), _data(fluid, "r", feeds["r"])
        _len_var(fluid, rv, "rl", b)
        return (fluid.layers.roi_pool(xv, rv, 2, 2, 1.0),
                fluid.layers.roi_align(xv, rv, 2, 2, 1.0, sampling_ratio=2))

    got = _both(program_fn, feeds)
    np.testing.assert_allclose(got[0][0][0, 0, 0], [[7, 9], [19, 21]])


RNG_ROI = _rng(3)
ROI_X = RNG_ROI.randn(2, 3, 9, 11).astype(np.float32)
ROI_BOXES = np.concatenate([RNG_ROI.rand(2, 5, 2) * 12, RNG_ROI.rand(2, 5, 2) * 12 + 4],
                           axis=2).astype(np.float32)
ROI_BOXES[0, 1] = [-3, -2, 30, 25]  # past the map on every side
ROI_BOXES[1, 2] = [6, 6, 5, 5]  # inverted
ROI_LEN = np.array([5, 3], np.int32)


@pytest.mark.parametrize("op_type,attrs", [
    ("roi_pool", {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5}),
    ("roi_pool", {"pooled_height": 2, "pooled_width": 4, "spatial_scale": 1.0}),
    ("roi_align", {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
                   "sampling_ratio": -1}),
    ("roi_align", {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.7,
                   "sampling_ratio": 3}),
], ids=["pool_half", "pool_full", "align_default", "align_s3"])
def test_roi_ops_with_grads(op_type, attrs):
    check_op(op_type, {"X": [ROI_X], "ROIs": [ROI_BOXES], "RoisLen": [ROI_LEN]}, attrs, 1e-4)


def test_polygon_box_transform():
    x = np.zeros((1, 4, 3, 2), np.float32)
    x[0, 0, 1, 1] = 2.0
    x[0, 1, 1, 1] = -1.0
    x[0, 3, 2, 0] = 0.5
    want, got = lower_both("polygon_box_transform", {"Input": [x]}, {})
    assert_outs_close(got, want, TOL, "polygon_box_transform")


def test_generate_proposals():
    rng = _rng(0)
    b, a, h, w = 2, 3, 4, 4
    feeds = {"f": np.zeros((b, 8, h, w), np.float32),
             "s": rng.rand(b, a, h, w).astype("float32"),
             "d": (rng.randn(b, a * 4, h, w) * 0.1).astype("float32"),
             "ii": np.array([[64.0, 64.0, 1.0], [48.0, 60.0, 1.0]], np.float32)}

    def program_fn(fluid):
        anchors, variances = fluid.layers.anchor_generator(
            _data(fluid, "f", feeds["f"]), anchor_sizes=[32.0], aspect_ratios=[0.5, 1.0, 2.0],
            stride=[16.0, 16.0])
        rois, probs = fluid.layers.generate_proposals(
            _data(fluid, "s", feeds["s"]), _data(fluid, "d", feeds["d"]),
            _data(fluid, "ii", feeds["ii"]), anchors, variances, pre_nms_top_n=12,
            post_nms_top_n=20, nms_thresh=0.7, min_size=2.0)
        return rois, probs, fluid.default_main_program().global_block().var(rois._len_name)

    got = _both(program_fn, feeds, tol=1e-4)
    n = int(got[0][2][0])
    assert got[0][0].shape == (b, 20, 4) and 1 <= n <= 12


def test_rpn_target_assign():
    anchors = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [100, 100, 110, 110],
                        [1, 1, 9, 9]], "float32")
    feeds = {"an": anchors, "gt": np.array([[[1, 1, 9, 9], [21, 21, 31, 31], [0, 0, 0, 0]],
                                            [[90, 90, 120, 120], [0, 0, 0, 0], [0, 0, 0, 0]]],
                                           "float32"),
             "gl": np.array([2, 1], "int64")}

    def program_fn(fluid):
        return _raw_op(fluid, "rpn_target_assign", feeds,
                       {"TargetLabel": ["tl"], "TargetBBox": ["tb"], "ScoreWeight": ["sw"],
                        "LocWeight": ["lw"]},
                       {"rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3,
                        "rpn_batch_size_per_im": 4, "rpn_fg_fraction": 0.5},
                       {"Anchor": ["an"], "GtBox": ["gt"], "GtLen": ["gl"]})

    got = _both(program_fn, feeds)
    assert got[0][0][0, 3] == 1 and got[0][0][0, 1] == 1 and got[0][0][0, 2] == 0


def test_generate_proposal_labels():
    feeds = {"rr": np.array([[[0, 0, 10, 10], [18, 18, 32, 32], [50, 50, 60, 60],
                              [5, 5, 4, 4]]], "float32"),
             "gc": np.array([[3, 7]], "int64"),
             "gb": np.array([[[1, 1, 9, 9], [20, 20, 30, 30]]], "float32"),
             "gl": np.array([2], "int64")}

    def program_fn(fluid):
        return _raw_op(fluid, "generate_proposal_labels", feeds,
                       {"Rois": ["ro"], "LabelsInt32": ["li"], "BboxTargets": ["bt"],
                        "BboxInsideWeights": ["biw"], "BboxOutsideWeights": ["bow"],
                        "SampleWeight": ["sw2"]},
                       {"fg_thresh": 0.5, "batch_size_per_im": 4},
                       {"RpnRois": ["rr"], "GtClasses": ["gc"], "GtBoxes": ["gb"],
                        "GtLen": ["gl"]})

    got = _both(program_fn, feeds)
    np.testing.assert_array_equal(got[0][1][0], [3, 7, 0, 0])


def test_roi_perspective_transform():
    rng = _rng(4)
    x = rng.randn(1, 2, 6, 7).astype("float32")
    quads = np.array([[[0, 0, 5, 0, 5, 4, 0, 4], [1, 0.5, 5.5, 1, 5, 5, 0.5, 4.5]]], "float32")
    feeds = {"img": x, "rois": quads}

    def program_fn(fluid):
        return _raw_op(fluid, "roi_perspective_transform", feeds, {"Out": ["warped"]},
                       {"transformed_height": 4, "transformed_width": 5, "spatial_scale": 1.0},
                       {"X": ["img"], "ROIs": ["rois"]})

    _both(program_fn, feeds, tol=1e-4)
    check_op("roi_perspective_transform", {"X": [x], "ROIs": [quads]},
             {"transformed_height": 3, "transformed_width": 3, "spatial_scale": 0.9}, 1e-4)


def test_detection_map_host_op():
    feeds = {"dets": np.array([[[1, 0.9, 0, 0, 10, 10], [-1, 0, 0, 0, 0, 0],
                                [2, 0.4, 19, 21, 30, 30]]], "float32"),
             "gts": np.array([[[1, 0, 0, 10, 10], [2, 20, 20, 30, 30], [-1, 0, 0, 0, 0]]],
                             "float32")}

    def program_fn(fluid):
        return _raw_op(fluid, "detection_map", feeds, {"MAP": ["map_out"]},
                       {"overlap_threshold": 0.5}, {"DetectRes": ["dets"], "Label": ["gts"]})

    got = _both(program_fn, feeds)
    assert abs(float(got[0][0][0]) - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# the losses: op by op with their generic grads, and trained a few steps
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b=3, m=20, c=4, g=3):
    prior = np.concatenate([rng.rand(m, 2) * 0.6, rng.rand(m, 2) * 0.6 + 0.35],
                           axis=1).astype(np.float32)
    gt = np.concatenate([rng.rand(b, g, 2) * 0.5, rng.rand(b, g, 2) * 0.4 + 0.5],
                        axis=2).astype(np.float32)
    gt[:, :, 2:] = np.maximum(gt[:, :, 2:], gt[:, :, :2] + 0.1)
    return {"Location": [rng.randn(b, m, 4).astype(np.float32) * 0.5],
            "Confidence": [rng.randn(b, m, c).astype(np.float32)],
            "GTBox": [gt], "GTLabel": [rng.randint(1, c, (b, g, 1)).astype(np.int32)],
            "GTLen": [np.array([2, 3, 1], np.int32)[:b]], "PriorBox": [prior],
            "PriorBoxVar": [np.full((m, 4), 0.1, np.float32)]}


@pytest.mark.parametrize("match_type", ["per_prediction", "bipartite"])
def test_ssd_loss_op(match_type):
    check_op("ssd_loss", _ssd_inputs(_rng(5)), {"match_type": match_type,
                                                "overlap_threshold": 0.3}, 1e-4)


def test_yolov3_loss_op():
    rng = _rng(6)
    b, cls, h, w, anchors = 2, 3, 4, 5, [10, 14, 23, 27, 37, 58]
    gt = np.zeros((b, 4, 4), np.float32)
    gt[0, :3] = [[0.3, 0.4, 0.3, 0.2], [0.7, 0.6, 0.2, 0.4], [0.55, 0.3, 0.1, 0.1]]
    gt[1, :2] = [[0.5, 0.5, 0.6, 0.5], [0.2, 0.8, 0.15, 0.3]]
    check_op("yolov3_loss", {"X": [rng.randn(b, 3 * (5 + cls), h, w).astype(np.float32)],
                             "GTBox": [gt], "GTLabel": [rng.randint(0, cls, (b, 4))
                                                        .astype(np.int32)]},
             {"anchors": anchors, "class_num": cls, "ignore_thresh": 0.5}, 1e-4)


def test_ssd_loss_trains():
    """tests/test_detection.py's multi_box_head + ssd_loss program: the
    first 3 Adam losses in both packages."""
    rng = _rng(2)
    b, g = 4, 3
    imgs = rng.rand(b, 3, 32, 32).astype("float32")
    gts = np.zeros((b, g, 4), np.float32)
    lbls = np.zeros((b, g, 1), np.int64)
    lens = np.array([2, 1, 2, 1], np.int64)
    for i in range(b):
        for j in range(lens[i]):
            x1, y1 = rng.rand(2) * 0.5
            gts[i, j] = [x1, y1, x1 + 0.3, y1 + 0.3]
            lbls[i, j, 0] = rng.randint(1, 3)
    feeds = {"img": imgs, "gt": gts, "lbl": lbls, "gtl": lens}

    def program_fn(fluid):
        img, gt_box, gt_label = (_data(fluid, n, feeds[n]) for n in ("img", "gt", "lbl"))
        _len_var(fluid, gt_box, "gtl", b)
        c1 = fluid.layers.conv2d(img, num_filters=8, filter_size=3, stride=2, padding=1,
                                 act="relu")
        c2 = fluid.layers.conv2d(c1, num_filters=8, filter_size=3, stride=2, padding=1,
                                 act="relu")
        mbox_loc, mbox_conf, boxes, pvars = fluid.layers.multi_box_head(
            inputs=[c1, c2], image=img, base_size=32, num_classes=3,
            aspect_ratios=[[1.0], [1.0]], min_sizes=[8.0, 16.0], max_sizes=[12.0, 24.0],
            flip=False)
        loss = fluid.layers.mean(fluid.layers.ssd_loss(mbox_loc, mbox_conf, gt_box, gt_label,
                                                       boxes, pvars))
        fluid.optimizer.Adam(1e-2).minimize(loss)
        return [loss]

    want, got, _, _ = run_both(program_fn, feeds, steps=3)
    assert_runs_close(got, want, TRAIN_RTOL, 1e-6, "ssd_loss")


def test_yolov3_loss_trains():
    rng = _rng(3)
    b, cls, h, w = 2, 4, 4, 4
    gts = np.zeros((b, 3, 4), np.float32)
    for i in range(b):
        gts[i, :2] = rng.rand(2, 4) * 0.4 + 0.2
    feeds = {"feat": rng.rand(b, 8, h, w).astype("float32"), "gt": gts,
             "lbl": rng.randint(0, cls, (b, 3)).astype("int64")}

    def program_fn(fluid):
        feat, gt, lbl = (_data(fluid, n, feeds[n]) for n in ("feat", "gt", "lbl"))
        x = fluid.layers.conv2d(feat, num_filters=3 * (5 + cls), filter_size=1)
        loss = fluid.layers.mean(fluid.layers.yolov3_loss(x, gt, lbl, [10, 14, 23, 27, 37, 58],
                                                          cls, ignore_thresh=0.7))
        fluid.optimizer.Adam(1e-2).minimize(loss)
        return [loss]

    want, got, _, _ = run_both(program_fn, feeds, steps=3)
    assert_runs_close(got, want, TRAIN_RTOL, 1e-6, "yolov3_loss")


# ---------------------------------------------------------------------------
# MobileNet-SSD at a small size
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_counter_fixed(monkeypatch):
    """The JAX package's learning-rate schedules pass `persistable` twice
    (ROADMAP C, fact 4); patch that one method, as tests/test_torch_loss.py
    does."""
    from paddle_tpu import layer_helper as jlh

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        kwargs["persistable"] = True
        return block.create_var(name=name, *args, **kwargs)

    monkeypatch.setattr(jlh.LayerHelper, "create_or_get_global_variable",
                        create_or_get_global_variable)


def test_mobilenet_ssd_small(jax_counter_fixed):
    """The first 3 RMSProp(piecewise_decay) steps, each loss within rtol
    1e-4, every port step starting from the JAX package's state before that
    step: this model's gradients are ill-conditioned at batch 4 (a 1e-6
    relative change of the image moves the first step's gradients by a few
    percent in either package alone, and RMSProp's first step is about
    lr * sign(g)), so two runs that each step themselves part by more than
    rounding after one step. Then the eval program (detection_output and
    the detection_map host op) in both packages from the JAX package's
    trained state: the same detections and the same mAP, which equals
    DetectionMAP over the fetched rows."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as pfluid
    from paddle_tpu.executor import Executor as JExecutor
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jguard
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.tools import profile_detection as pd

    cfg = pd.SMALL
    feed = pd.synthetic_batch(_rng(cfg["seed"]), cfg)
    jm, pm = pd.build(jfluid, cfg), pd.build(pfluid, cfg)
    names = convert.persistable_names(pm["main"])

    jexe, jscope = JExecutor(), JScope(seed=0)
    states, jloss = [], []
    with jguard(jscope):
        jexe.run(jm["startup"])
        for _ in range(3):
            states.append({n: np.asarray(jscope.vars[n]) for n in names})
            jloss.append(np.asarray(jexe.run(jm["main"], feed=feed,
                                             fetch_list=[jm["loss"].name])[0]))
        trained = {n: np.asarray(jscope.vars[n]) for n in names}
        jeval = jexe.run(jm["test"], feed=feed,
                         fetch_list=[jm["nmsed"], jm["map"], jm["labels"]])

    pexe = pt.Executor(pt.CPUPlace())
    pscope = pt.Scope(seed=0, place=pt.CPUPlace())
    ploss = []
    with pt.scope_guard(pscope):
        pexe.run(pm["startup"])
        for state in states:
            convert.load_into_scope(pscope, state, names)
            ploss.append(pexe.run(pm["main"], feed=feed, fetch_list=[pm["loss"].name])[0])
        convert.load_into_scope(pscope, trained, names)
        peval = pexe.run(pm["test"], feed=feed,
                         fetch_list=[pm["nmsed"], pm["map"], pm["labels"]])
    assert_runs_close([[v] for v in ploss], [[v] for v in jloss], TRAIN_RTOL, 1e-6, "ssd")
    assert jloss[-1] < jloss[0]
    np.testing.assert_array_equal(peval[0][..., 0], np.asarray(jeval[0])[..., 0])
    np.testing.assert_allclose(peval[0], np.asarray(jeval[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(peval[1], np.asarray(jeval[1]), rtol=0, atol=1e-6)
    want = pd.reference_map(peval[0], peval[2], pfluid.evaluator.DetectionMAP, cfg["classes"])
    assert abs(float(peval[1][0]) - want) < 1e-6
    assert (peval[0][:, 0, 0] >= 1).all()  # every image has a detection


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

SPEC = os.path.join(os.path.dirname(__file__), "..", "paddle_tpu", "API.spec")


def _spec_lines():
    """{dotted name: signature} of the API.spec lines of the detection
    layers and Print."""
    import paddle_tpu_torch.layers.detection as det

    out = {}
    with open(SPEC) as f:
        for line in f:
            name, _, sig = line.strip().partition(" ")
            short = name.rsplit(".", 1)[-1]
            if (name.startswith("paddle_tpu.layers.detection.")
                    or name in ("paddle_tpu.layers.Print", "paddle_tpu.layers.control_flow.Print")
                    or (name.startswith("paddle_tpu.layers.") and name.count(".") == 2
                        and short in det.__all__)):
                out[name] = sig
    return out


def test_signatures_match_api_spec():
    import importlib

    import paddle_tpu.evaluator as jev
    import paddle_tpu_torch.evaluator as pev
    import paddle_tpu_torch.layers.detection as det

    spec = _spec_lines()
    assert len(spec) == 2 * len(det.__all__) + 2, sorted(spec)
    for name, sig in spec.items():
        mod, attr = name.replace("paddle_tpu.", "paddle_tpu_torch.", 1).rsplit(".", 1)
        assert str(inspect.signature(getattr(importlib.import_module(mod), attr))) == sig, name
    assert (inspect.signature(pev.DetectionMAP.__init__)
            == inspect.signature(jev.DetectionMAP.__init__))
    assert "DetectionMAP" in pev.__all__
