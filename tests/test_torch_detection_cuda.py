"""The detection lowerings and blocks split at host ops on the card (every
test is marked `cuda` and skips without a CUDA device; the file imports no
JAX, so on the card it runs with `python -m pytest --noconftest
tests/test_torch_detection_cuda.py -m cuda`):

- each detection lowering at small shapes, eager on the card against eager
  on the CPU (floats within 1e-4, integers exactly), then captured alone in
  a CUDA graph and replayed: the replay equals the card's eager run bit for
  bit;
- MobileNet-SSD's eval program at the tests' small size (one device
  segment and the detection_map host op) on the card against the CPU from
  the same state: the same detections and mAP, the segment captured at the
  second run and replayed after;
- a print between two device segments fires on every run of the graph
  path.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import fluid
from paddle_tpu_torch.executor import _on_capture_stream
from paddle_tpu_torch.ops import fused, registry
from paddle_tpu_torch.tools import profile_detection as det

TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs")
    return torch.device("cuda", 0)


def _cases():
    rng = np.random.RandomState(0)
    f32 = np.float32
    m, b, g, c = 40, 3, 4, 5
    pxy = rng.rand(m, 2) * 0.7
    prior = np.concatenate([pxy, pxy + rng.uniform(0.05, 0.4, (m, 2))], 1).astype(f32)
    gt = np.zeros((b, g, 4), f32)
    glen = np.array([2, 4, 1], np.int32)
    for i in range(b):
        xy = rng.rand(glen[i], 2) * 0.5
        gt[i, :glen[i]] = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (glen[i], 2))], 1)
    pvar = np.full((m, 4), 0.1, f32)
    loc = (rng.randn(b, m, 4) * 0.5).astype(f32)
    match = rng.randint(-1, g, (b, m)).astype(np.int32)
    feat = np.zeros((2, 4, 5, 6), f32)
    anchors = (np.sort(rng.rand(5, 6, 3, 2, 2) * 90, axis=3).reshape(5, 6, 3, 4)).astype(f32)
    rois = np.concatenate([rng.rand(2, 6, 2) * 8, rng.rand(2, 6, 2) * 8 + 3], 2).astype(f32)
    return [
        ("prior_box", {"Input": [feat], "Image": [np.zeros((2, 3, 40, 48), f32)]},
         {"min_sizes": [8.0], "max_sizes": [16.0], "aspect_ratios": [2.0, 3.0], "flip": True}),
        ("density_prior_box", {"Input": [feat], "Image": [np.zeros((2, 3, 40, 48), f32)]},
         {"fixed_sizes": [8.0, 16.0], "densities": [2, 1], "clip": True}),
        ("anchor_generator", {"Input": [feat]},
         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0], "stride": [8.0, 8.0]}),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar], "TargetBox": [loc]},
         {"code_type": "decode_center_size"}),
        ("box_coder", {"PriorBox": [prior], "TargetBox": [gt[1]]}, {}),
        ("iou_similarity", {"X": [gt[1]], "Y": [prior]}, {}),
        ("bipartite_match", {"DistMat": [rng.rand(b, g, m).astype(f32)]},
         {"match_type": "per_prediction", "dist_threshold": 0.5}),
        ("target_assign", {"X": [gt], "MatchIndices": [match],
                           "NegIndices": [rng.randint(-1, m + 3, (b, 7)).astype(np.int32)]}, {}),
        ("mine_hard_examples", {"ClsLoss": [rng.rand(b, m).astype(f32)],
                                "MatchIndices": [match]}, {"neg_pos_ratio": 3.0}),
        ("multiclass_nms", {"BBoxes": [loc * 0.1 + prior[None]],
                            "Scores": [np.round(rng.rand(b, c, m) * 8).astype(f32) / 8]},
         {"score_threshold": 0.1, "nms_top_k": 20, "keep_top_k": 15, "nms_threshold": 0.45}),
        ("polygon_box_transform", {"Input": [rng.randn(1, 8, 5, 6).astype(f32)]}, {}),
        ("roi_pool", {"X": [rng.randn(2, 3, 9, 11).astype(f32)], "ROIs": [rois],
                      "RoisLen": [np.array([6, 4], np.int32)]},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.8}),
        ("roi_align", {"X": [rng.randn(2, 3, 9, 11).astype(f32)], "ROIs": [rois],
                       "RoisLen": [np.array([6, 4], np.int32)]},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.8, "sampling_ratio": -1}),
        ("yolov3_loss", {"X": [rng.randn(2, 3 * 8, 4, 5).astype(f32)],
                         "GTBox": [np.abs(rng.rand(2, 4, 4).astype(f32) * 0.5 + 0.1)],
                         "GTLabel": [rng.randint(0, 3, (2, 4)).astype(np.int32)]},
         {"anchors": [10, 14, 23, 27, 37, 58], "class_num": 3, "ignore_thresh": 0.5}),
        ("generate_proposals", {"Scores": [rng.rand(2, 3, 5, 6).astype(f32)],
                                "BboxDeltas": [(rng.randn(2, 12, 5, 6) * 0.2).astype(f32)],
                                "ImInfo": [np.array([[40, 48, 1], [36, 40, 1]], f32)],
                                "Anchors": [anchors], "Variances": [np.ones_like(anchors)]},
         {"pre_nms_topN": 50, "post_nms_topN": 20, "nms_thresh": 0.7, "min_size": 1.0}),
        ("ssd_loss", {"Location": [loc], "Confidence": [rng.randn(b, m, c).astype(f32)],
                      "GTBox": [gt], "GTLabel": [rng.randint(1, c, (b, g, 1)).astype(np.int32)],
                      "GTLen": [glen], "PriorBox": [prior], "PriorBoxVar": [pvar]}, {}),
        ("rpn_target_assign", {"Anchor": [anchors.reshape(-1, 4)], "GtBox": [gt * 90],
                               "GtLen": [glen]},
         {"rpn_batch_size_per_im": 32, "rpn_fg_fraction": 0.5}),
        ("generate_proposal_labels", {"RpnRois": [rois * 9], "GtClasses": [
            rng.randint(1, 9, (b, g)).astype(np.int32)[:2]], "GtBoxes": [gt[:2] * 90],
            "GtLen": [glen[:2]]}, {"batch_size_per_im": 8}),
        ("roi_perspective_transform", {"X": [rng.randn(1, 3, 9, 11).astype(f32)],
                                       "ROIs": [np.array([[[1, 1, 7, 1.5, 7.5, 6, 0.5, 5.5]]],
                                                         f32)]},
         {"transformed_height": 4, "transformed_width": 6}),
    ]


def _ctx(device):
    """A lowering context with its own generators and constant cache, made
    outside any capture (a capture cannot make a generator)."""
    return registry.LowerCtx(device, cache={}, host_random=False,
                             generator=torch.Generator().manual_seed(0),
                             device_generator=torch.Generator(device=device).manual_seed(0))


def _assert_close(got, want, what):
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            g, w = g.detach().cpu().numpy(), w.detach().cpu().numpy()
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg="%s %s" % (what, slot))
            else:
                np.testing.assert_array_equal(g, w, err_msg="%s %s" % (what, slot))


CASES = _cases()


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(CASES)), ids=["%s_%d" % (c[0], i)
                                                     for i, c in enumerate(CASES)])
def test_lowering_on_the_card_eager_and_captured(cuda_device, i):
    op, ins_np, attrs = CASES[i]
    lower = registry.get(op).lower
    cpu = {s: [torch.from_numpy(v) for v in vs] for s, vs in ins_np.items()}
    want = lower(_ctx("cpu"), cpu, dict(attrs))
    static = {s: [v.to(cuda_device) for v in vs] for s, vs in cpu.items()}
    ctx = _ctx(cuda_device)
    with _on_capture_stream(cuda_device):
        eager = lower(ctx, static, dict(attrs))
    torch.cuda.synchronize()
    _assert_close(eager, want, op)
    graph = torch.cuda.CUDAGraph()
    with _on_capture_stream(cuda_device) as stream:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            captured = lower(ctx, static, dict(attrs))
    graph.replay()
    torch.cuda.synchronize()
    for slot in eager:
        for g, e in zip(captured[slot], eager[slot]):
            assert torch.equal(g.nan_to_num(7.0), e.nan_to_num(7.0)), (op, slot)


def _eval_on(place, state, feed, runs):
    model = det.build(fluid, det.SMALL)
    scope, exe = pt.Scope(seed=0, place=place), pt.Executor(place)
    with pt.scope_guard(scope):
        exe.run(model["startup"])
        if state is None:
            state = {n: v.cpu().clone() for n, v in scope.vars.items()
                     if isinstance(v, torch.Tensor)}
        for n, v in state.items():
            scope.vars[n] = v.to(scope.device)
        outs = []
        for _ in range(runs):
            fused.reset_stats()
            outs.append(exe.run(model["test"], feed=feed,
                                fetch_list=[model["nmsed"], model["map"]]))
    return outs, state, pt.Executor.stats()


@pytest.mark.cuda
def test_ssd_eval_segments_on_the_card(cuda_device):
    feed = det.synthetic_batch(np.random.RandomState(0), det.SMALL)
    want, state, _ = _eval_on(pt.CPUPlace(), None, feed, 1)
    got, _, stats = _eval_on(pt.CUDAPlace(0), state, feed, 3)
    assert stats["segments"] == {"device": 1, "host": 1}
    assert stats["graphs"] == {"replays": 1}
    for run in got:
        np.testing.assert_array_equal(run[0][..., 0], want[0][0][..., 0])
        np.testing.assert_allclose(run[0], want[0][0], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(run[1], want[0][1], atol=1e-6)
    assert got[1][0].tobytes() == got[2][0].tobytes()


@pytest.mark.cuda
def test_print_fires_on_every_replay(cuda_device):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2, 3], dtype="float32", append_batch_size=False)
        y = fluid.layers.Print(fluid.layers.scale(x, scale=2.0), message="probe", summarize=2)
        out = fluid.layers.scale(y, scale=3.0)
    scope, exe = pt.Scope(place=pt.CUDAPlace(0)), pt.Executor(pt.CUDAPlace(0))
    buf = io.StringIO()
    fused.reset_stats()
    with pt.scope_guard(scope), contextlib.redirect_stdout(buf):
        got = [exe.run(main, feed={"x": np.ones((2, 3), "float32") * k},
                       fetch_list=[out])[0] for k in range(4)]
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("probe")]
    assert len(lines) == 4 and "mean=6.0" in lines[-1], lines
    assert pt.Executor.stats()["graphs"] == {"captures": 2, "replays": 6}
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, np.full((2, 3), 6.0 * k, "float32"))
