"""Detection ops (a port of paddle_tpu/ops/detection_ops.py; reference
paddle/fluid/operators/detection/ and roi_pool / roi_align / yolov3_loss).

Every lowering keeps the JAX package's static shapes, so each one can be
captured in a CUDA graph: a variable-count result (NMS keeps, proposals) is
a fixed-capacity tensor padded with -1 plus an explicit count, and the
selection loops (NMS, bipartite matching) are Python loops of a fixed
number of rounds over tensors batched across images and classes, with
masks in place of data-dependent branches. No lowering reads a tensor's
value on the host (no `.item()`, `nonzero` or boolean-mask indexing).

Where the JAX package's semantics lean on XLA:
- ties: `lax.top_k` and `jnp.argsort` (stable) put the lower index first;
  here a stable sort does where the indices reach an output, and
  `torch.topk` only where its values alone are used. `torch.argmax` takes
  the first maximum, as `jnp.argmax` does;
- out-of-range indices: a JAX gather by `take_along_axis` fills (NaN, or the
  integer minimum) and a JAX scatter drops; torch faults on both, so each
  index that can leave its range is guarded;
- duplicate scatter targets (yolov3_loss's gt cells): the last valid gt
  wins, by a scatter-max of the gt's position, so the card gives one
  answer.

`detection_map` runs on the host (executor.py _SegmentedBlock), as in the
JAX package and the reference (detection_map_op.cc has no CUDA kernel).
"""

import numpy as np
import torch

from .registry import register, register_host

NEG = -1e9

_F32 = torch.float32
_I32 = torch.int32


def _expand_aspect_ratios(aspect_ratios, flip):
    """reference prior_box_op.h:25 ExpandAspectRatios (starts from 1.0)."""
    out = [1.0]
    for ar in aspect_ratios:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(ar)
        if flip:
            out.append(1.0 / ar)
    return out


def _floats(values, device):
    return torch.tensor(values, dtype=_F32, device=device)


def _grid_boxes(feat, image_hw, centers, half, offsets, clip, variances, pixel):
    """[H, W, P, 4] boxes around each cell center (cx, cy) plus `offsets`
    with half-extents `half`, divided by the image size (prior boxes) or in
    pixels with the reference's -1 on the far corner (anchors); and their
    variances broadcast alike."""
    dev = feat.device
    fh, fw = feat.shape[2], feat.shape[3]
    cx, cy = centers
    hw, hh = (_floats(v, dev) for v in half)
    gx, gy = cx[None, :, None], cy[:, None, None]
    if offsets is not None:
        gx = gx + _floats(offsets[0], dev)
        gy = gy + _floats(offsets[1], dev)
    full = (fh, fw, hw.shape[0])
    if pixel:
        sides = [gx - hw + 0.0, gy - hh + 0.0, gx + hw - 1.0, gy + hh - 1.0]
    else:
        ih, iw = image_hw
        sides = [(gx - hw) / iw, (gy - hh) / ih, (gx + hw) / iw, (gy + hh) / ih]
    boxes = torch.stack([s.expand(full) for s in sides], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _floats(variances, dev).expand(fh, fw, hw.shape[0], 4).contiguous()
    return boxes, var


def _cell_centers(fh, fw, offset, step_w, step_h, device):
    cx = (torch.arange(fw, dtype=_F32, device=device) + offset) * step_w
    cy = (torch.arange(fh, dtype=_F32, device=device) + offset) * step_h
    return cx, cy


@register("prior_box", no_grad=True)
def _prior_box(ctx, ins, attrs):
    """SSD prior boxes (reference detection/prior_box_op.h:33-190), [H, W,
    num_priors, 4]. They depend on the shapes alone: made at the op's first
    run and kept (a constant of the prepared block)."""
    (feat,) = ins["Input"]
    (image,) = ins["Image"]
    min_sizes = [float(v) for v in attrs["min_sizes"]]
    max_sizes = [float(v) for v in attrs.get("max_sizes", [])]
    ars = _expand_aspect_ratios([float(v) for v in attrs.get("aspect_ratios", [1.0])],
                                bool(attrs.get("flip", False)))
    variances = [float(v) for v in attrs.get("variances", [0.1, 0.1, 0.2, 0.2])]
    mmao = bool(attrs.get("min_max_aspect_ratios_order", False))
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = float(attrs.get("step_w", 0.0)) or iw / fw
    step_h = float(attrs.get("step_h", 0.0)) or ih / fh
    offset = float(attrs.get("offset", 0.5))

    half = []  # per-cell prior (w/2, h/2) in the reference's emission order
    for s, mn in enumerate(min_sizes):
        if mmao:
            half.append((mn / 2.0, mn / 2.0))
            if max_sizes:
                m = (mn * max_sizes[s]) ** 0.5 / 2.0
                half.append((m, m))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                half.append((mn * ar**0.5 / 2.0, mn / ar**0.5 / 2.0))
        else:
            for ar in ars:
                half.append((mn * ar**0.5 / 2.0, mn / ar**0.5 / 2.0))
            if max_sizes:
                m = (mn * max_sizes[s]) ** 0.5 / 2.0
                half.append((m, m))

    def make():
        centers = _cell_centers(fh, fw, offset, step_w, step_h, feat.device)
        return _grid_boxes(feat, (ih, iw), centers, ([p[0] for p in half], [p[1] for p in half]),
                           None, bool(attrs.get("clip", False)), variances, False)

    boxes, var = ctx.op_constant(make, "prior_box")
    return {"Boxes": [boxes], "Variances": [var]}


@register("density_prior_box", no_grad=True)
def _density_prior_box(ctx, ins, attrs):
    """reference detection/density_prior_box_op.h: a dense grid of square
    priors per (fixed_size, density) pair, shifted within the cell."""
    (feat,) = ins["Input"]
    (image,) = ins["Image"]
    fixed_sizes = [float(v) for v in attrs["fixed_sizes"]]
    fixed_ratios = [float(v) for v in attrs.get("fixed_ratios", [1.0])]
    densities = [int(v) for v in attrs["densities"]]
    variances = [float(v) for v in attrs.get("variances", [0.1, 0.1, 0.2, 0.2])]
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = float(attrs.get("step_w", 0.0)) or iw / fw
    step_h = float(attrs.get("step_h", 0.0)) or ih / fh
    offset = float(attrs.get("offset", 0.5))

    entries = []  # per-cell (dx, dy, w/2, h/2) in emission order
    for s, fs in enumerate(fixed_sizes):
        density = densities[s]
        shift = step_w / density
        for ar in fixed_ratios:
            bw = fs * ar**0.5
            bh = fs / ar**0.5
            for di in range(density):
                for dj in range(density):
                    dx = -step_w / 2.0 + shift / 2.0 + dj * shift
                    dy = -step_h / 2.0 + shift / 2.0 + di * shift
                    entries.append((dx, dy, bw / 2.0, bh / 2.0))

    def make():
        centers = _cell_centers(fh, fw, offset, step_w, step_h, feat.device)
        return _grid_boxes(feat, (ih, iw), centers, ([e[2] for e in entries],
                                                     [e[3] for e in entries]),
                           ([e[0] for e in entries], [e[1] for e in entries]),
                           bool(attrs.get("clip", False)), variances, False)

    boxes, var = ctx.op_constant(make, "density_prior_box")
    return {"Boxes": [boxes], "Variances": [var]}


@register("anchor_generator", no_grad=True)
def _anchor_generator(ctx, ins, attrs):
    """reference detection/anchor_generator_op.h: RPN anchors in input-image
    pixels, [H, W, num_anchors, 4]."""
    (feat,) = ins["Input"]
    sizes = [float(v) for v in attrs["anchor_sizes"]]
    ratios = [float(v) for v in attrs["aspect_ratios"]]
    variances = [float(v) for v in attrs.get("variances", [0.1, 0.1, 0.2, 0.2])]
    stride = [float(v) for v in attrs["stride"]]
    offset = float(attrs.get("offset", 0.5))
    fh, fw = feat.shape[2], feat.shape[3]

    half = []
    for r in ratios:
        for s in sizes:
            base_w = round((stride[0] * stride[1] / r) ** 0.5)
            base_h = round(base_w * r)
            half.append((s / stride[0] * base_w / 2.0, s / stride[1] * base_h / 2.0))

    def make():
        centers = _cell_centers(fh, fw, offset, stride[0], stride[1], feat.device)
        return _grid_boxes(feat, None, centers, ([p[0] for p in half], [p[1] for p in half]),
                           None, False, variances, True)

    anchors, var = ctx.op_constant(make, "anchor_generator")
    return {"Anchors": [anchors], "Variances": [var]}


def _center_size(box, normalized):
    """(x1, y1, x2, y2) -> (cx, cy, w, h); +1 on w and h when unnormalized
    (the reference box_coder_op.h pixel convention)."""
    plus = 0.0 if normalized else 1.0
    w = box[..., 2] - box[..., 0] + plus
    h = box[..., 3] - box[..., 1] + plus
    cx = (box[..., 0] + box[..., 2]) / 2.0
    cy = (box[..., 1] + box[..., 3]) / 2.0
    return cx, cy, w, h


@register("box_coder", no_grad=True)
def _box_coder(ctx, ins, attrs):
    """reference detection/box_coder_op.h. encode: [row, 4] x [col, 4] ->
    [row, col, 4]; decode: target [row, col, 4] (or [row, 4], broadcast) ->
    [row, col, 4]."""
    (prior,) = ins["PriorBox"]
    (target,) = ins["TargetBox"]
    v = ins.get("PriorBoxVar", [None])[0]
    normalized = bool(attrs.get("box_normalized", True))
    pcx, pcy, pw, ph = _center_size(prior, normalized)
    if attrs.get("code_type", "encode_center_size") == "encode_center_size":
        tcx, tcy, tw, th = _center_size(target, normalized)
        ex = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        ey = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ew = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        eh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([ex, ey, ew, eh], dim=-1)
        if v is not None:
            out = out / v[None, :, :]
    else:
        t = target if target.dim() == 3 else target[:, None, :]
        if v is not None:
            t = t * v[None, :, :]
        dcx = t[..., 0] * pw[None, :] + pcx[None, :]
        dcy = t[..., 1] * ph[None, :] + pcy[None, :]
        dw = torch.exp(t[..., 2]) * pw[None, :]
        dh = torch.exp(t[..., 3]) * ph[None, :]
        plus = 0.0 if normalized else 1.0
        out = torch.stack([dcx - dw / 2.0, dcy - dh / 2.0, dcx + dw / 2.0 - plus,
                           dcy + dh / 2.0 - plus], dim=-1)
    return {"OutputBox": [out]}


def _iou_matrix(a, b, normalized=True):
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M] (the JAX
    package's formula, term for term)."""
    plus = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = (a[..., i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., i] for i in range(4))
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp(ix2 - ix1 + plus, min=0.0)
    ih = torch.clamp(iy2 - iy1 + plus, min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + plus) * (ay2 - ay1 + plus)
    area_b = (bx2 - bx1 + plus) * (by2 - by1 + plus)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10), 0.0)


@register("iou_similarity", no_grad=True)
def _iou_similarity(ctx, ins, attrs):
    """reference detection/iou_similarity_op.h."""
    (x,) = ins["X"]
    (y,) = ins["Y"]
    return {"Out": [_iou_matrix(x, y, bool(attrs.get("box_normalized", True)))]}


def _bipartite(dist):
    """Greedy global-max matching of each image of dist [B, N, M]
    (reference bipartite_match_op.cc:65-139): min(N, M) rounds, each taking
    the largest entry among the unmatched rows and columns. Returns (col ->
    row indices [B, M] int32, -1 where unmatched; col dists [B, M])."""
    b, n, m = dist.shape
    d = dist.to(_F32)
    col_idx = torch.full((b, m), -1, dtype=_I32, device=d.device)
    col_dist = torch.zeros((b, m), dtype=_F32, device=d.device)
    rows = torch.arange(n, device=d.device)
    cols = torch.arange(m, device=d.device)
    for _ in range(min(n, m)):
        flat = torch.argmax(d.reshape(b, n * m), dim=1)
        i, j = flat // m, flat % m
        val = torch.gather(d.reshape(b, n * m), 1, flat[:, None])[:, 0]
        ok = (val > 1e-6)[:, None]
        col_hit = (cols[None, :] == j[:, None]) & ok
        row_hit = (rows[None, :] == i[:, None]) & ok
        col_idx = torch.where(col_hit, i[:, None].to(_I32), col_idx)
        col_dist = torch.where(col_hit, val[:, None], col_dist)
        d = torch.where(row_hit[:, :, None] | col_hit[:, None, :], NEG, d)
    return col_idx, col_dist


@register("bipartite_match", no_grad=True)
def _bipartite_match(ctx, ins, attrs):
    (dist,) = ins["DistMat"]  # [B, N, M] or [N, M]
    batched = dist.dim() == 3
    d = dist if batched else dist[None]
    idx, dst = _bipartite(d)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        # unmatched cols also take their argmax row above the threshold
        # (reference ArgMaxMatch, bipartite_match_op.cc:141)
        am = torch.argmax(d, dim=1).to(_I32)
        amd = torch.amax(d, dim=1)
        take = (idx == -1) & (amd >= float(attrs.get("dist_threshold", 0.5)))
        idx = torch.where(take, am, idx)
        dst = torch.where(take, amd, dst)
    if not batched:
        idx, dst = idx[0], dst[0]
    return {"ColToRowMatchIndices": [idx], "ColToRowMatchDist": [dst]}


def _gather_fill(x, idx):
    """x [B, N, K] taken along axis 1 at idx [B, M], with the JAX gather's
    fill where an index is past N: NaN, or the integer minimum."""
    n = x.shape[1]
    oob = idx >= n
    safe = torch.where(oob, 0, idx).long()
    out = torch.gather(x, 1, safe[:, :, None].expand(-1, -1, x.shape[2]))
    fill = float("nan") if x.is_floating_point() else torch.iinfo(x.dtype).min
    return torch.where(oob[:, :, None], fill, out)


@register("target_assign", no_grad=True)
def _target_assign(ctx, ins, attrs):
    """reference detection/target_assign_op.h: out[i, j] = X[i, match[i, j]]
    where match >= 0, else mismatch_value; weights 1 / 0 alike; the rows
    NegIndices lists (-1 padded) also get weight 1."""
    (x,) = ins["X"]  # [B, N, K]
    (match,) = ins["MatchIndices"]  # [B, M]
    neg = ins.get("NegIndices", [None])[0]
    m = match.to(_I32)
    out = _gather_fill(x, torch.clamp(m, min=0))
    matched = (m >= 0)[:, :, None]
    out = torch.where(matched, out, attrs.get("mismatch_value", 0))
    w = matched.to(_F32)
    if neg is not None:
        b, cols = match.shape
        ni = neg.reshape(b, -1).to(_I32)
        # a scatter-max of 1 at each listed row: -1 pads write 0 at row 0
        # (no effect), and an index past the rows goes to a spare column
        # (the JAX scatter drops it)
        idx = torch.where(ni >= cols, cols, torch.clamp(ni, min=0)).long()
        nmask = torch.zeros((b, cols + 1), dtype=_F32, device=match.device).scatter_reduce(
            1, idx, (ni >= 0).to(_F32), "amax")[:, :cols]
        w = torch.maximum(w, nmask[:, :, None])
    return {"Out": [out.to(x.dtype)], "OutWeight": [w]}


def _stable_desc(x):
    """(values, indices) of x sorted descending along its last dim, equal
    values in index order (lax.top_k's and jnp.argsort's tie order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


@register("mine_hard_examples", no_grad=True)
def _mine_hard_examples(ctx, ins, attrs):
    """reference detection/mine_hard_examples_op.cc (max_negative mining):
    the top neg_pos_ratio * num_pos unmatched priors by loss, as [B, M]
    prior indices, -1 padded."""
    (cls_loss,) = ins["ClsLoss"]
    (match,) = ins["MatchIndices"]
    loc_loss = ins.get("LocLoss", [None])[0]
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    b, m = match.shape
    loss = cls_loss.reshape(b, m)
    if loc_loss is not None and bool(attrs.get("mining_type_hard", False)):
        loss = loss + loc_loss.reshape(b, m)
    matched = match >= 0
    num_pos = matched.sum(dim=1, dtype=_I32)
    num_neg = torch.minimum((num_pos.to(_F32) * neg_pos_ratio).to(_I32), m - num_pos)
    cand = torch.where(matched, NEG, loss)
    order = torch.argsort(-cand, dim=1, stable=True).to(_I32)
    rank = torch.arange(m, dtype=_I32, device=match.device)[None, :]
    return {"NegIndices": [torch.where(rank < num_neg[:, None], order, -1)]}


def nms_rounds(boxes, scores, iou_thr, score_thr, top_k, normalized):
    """Iterative NMS of every (image, class) at once: `top_k` rounds of
    pick-max and suppress (the JAX package's _nms_single_class, a
    lax.scan, vmapped). boxes [B, M, 4], scores [B, C, M] -> (kept scores
    [B, C, top_k], kept box indices [B, C, top_k]), NEG / -1 padded."""
    b, c, m = scores.shape
    s = torch.where(scores > score_thr, scores, NEG)
    pos = torch.arange(m, device=scores.device)
    kept_s, kept_i = [], []
    for _ in range(top_k):
        i = torch.argmax(s, dim=-1)  # [B, C]
        cur = torch.gather(s, 2, i[:, :, None])[:, :, 0]
        ok = cur > NEG / 2
        picked = torch.gather(boxes, 1, i[:, :, None].expand(b, c, 4))  # [B, C, 4]
        iou = _iou_matrix(picked[:, :, None, :], boxes[:, None, :, :], normalized)[:, :, 0, :]
        s_new = torch.where(iou > iou_thr, NEG, s)
        s_new = torch.where(pos == i[:, :, None], NEG, s_new)
        s = torch.where(ok[:, :, None], s_new, s)
        kept_s.append(torch.where(ok, cur, NEG))
        kept_i.append(torch.where(ok, i.to(_I32), -1))
    return torch.stack(kept_s, dim=-1), torch.stack(kept_i, dim=-1)


@register("multiclass_nms", no_grad=True)
def _multiclass_nms(ctx, ins, attrs):
    """reference detection/multiclass_nms_op.cc. Out is [B, keep_top_k, 6]
    (label, score, x1, y1, x2, y2) padded with -1, plus OutLen (the
    reference encodes the counts in LoD)."""
    (bboxes,) = ins["BBoxes"]  # [B, M, 4]
    (scores,) = ins["Scores"]  # [B, C, M]
    bg = int(attrs.get("background_label", 0))
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 16))
    b, c, m = scores.shape
    top_k = min(nms_top_k, m) if nms_top_k > 0 else m
    if keep_top_k <= 0:
        keep_top_k = c * top_k
    ks, ki = nms_rounds(bboxes, scores, float(attrs.get("nms_threshold", 0.3)),
                        float(attrs.get("score_threshold", 0.0)), top_k,
                        bool(attrs.get("normalized", True)))
    cls_ids = torch.arange(c, dtype=_I32, device=scores.device)[:, None].expand(c, top_k)
    ks = torch.where(cls_ids == bg, NEG, ks)  # no background detections
    flat_s, flat_i = ks.reshape(b, -1), ki.reshape(b, -1)
    flat_c = cls_ids.reshape(-1)
    k = min(keep_top_k, flat_s.shape[1])
    top_s, sel = _stable_desc(flat_s)
    top_s, sel = top_s[:, :k], sel[:, :k]
    box_i = torch.clamp(torch.gather(flat_i, 1, sel), min=0).long()
    sel_box = torch.gather(bboxes, 1, box_i[:, :, None].expand(b, k, 4))
    valid = top_s > NEG / 2
    det = torch.cat([
        torch.where(valid, flat_c[sel], -1).to(bboxes.dtype)[:, :, None],
        torch.where(valid, top_s, -1.0)[:, :, None],
        torch.where(valid[:, :, None], sel_box, -1.0),
    ], dim=2)
    return {"Out": [det], "OutLen": [valid.sum(dim=1, dtype=_I32)]}


@register("polygon_box_transform", no_grad=True)
def _polygon_box_transform(ctx, ins, attrs):
    """reference detection/polygon_box_transform_op.cc: at active cells
    (input != 0 is an offset), output = 4 * grid coordinate + the offset."""
    (x,) = ins["Input"]
    b, c, h, w = x.shape
    gx = torch.arange(w, dtype=x.dtype, device=x.device)[None, :].expand(h, w)
    gy = torch.arange(h, dtype=x.dtype, device=x.device)[:, None].expand(h, w)
    grid = torch.stack([gx, gy], 0).repeat(c // 2, 1, 1)  # [C, H, W], x / y alternating
    return {"Output": [torch.where(x != 0, 4.0 * grid[None] + x, 0.0)]}


# ---------------------------------------------------------------------------
# RoI ops (reference operators/roi_pool_op.h, roi_align_op.h). RoIs are
# padded [B, R, 4] + RoisLen; the batch mapping is positional, not LoD.
# ---------------------------------------------------------------------------


def _floor_log2(n, top):
    """floor(log2(n)) of a positive int tensor, exactly, for n <= top."""
    k = torch.zeros_like(n)
    p = 2
    while p <= top:
        k = k + (n >= p).to(n.dtype)
        p *= 2
    return k


def _shift_max(t, dim, step):
    """max(t[i], t[i + step]) along `dim`, t[i] itself past the end."""
    n = t.shape[dim]
    if step >= n:
        return t
    head = torch.maximum(t.narrow(dim, 0, n - step), t.narrow(dim, step, n - step))
    return torch.cat([head, t.narrow(dim, n - step, step)], dim=dim)


def _bin_ranges(lo, hi, n_bins, extent, bin_size):
    """Per RoI and bin, the first and last pixel (along one axis of
    `extent` pixels) whose bin index is that bin: the JAX package's
    per-pixel bin map floor((p - lo) / bin_size), clipped, inside [lo, hi].
    The bin index rises with p, so each bin's pixels are one range."""
    p = torch.arange(extent, dtype=_I32, device=lo.device)
    idx = torch.floor((p - lo[..., None]) / bin_size[..., None]).to(_I32)
    inside = (p >= lo[..., None]) & (p <= hi[..., None])
    idx = torch.clamp(idx, 0, n_bins - 1)
    bins = torch.arange(n_bins, dtype=_I32, device=lo.device)
    hit = inside[..., None, :] & (idx[..., None, :] == bins[:, None])  # [..., bins, extent]
    first = torch.where(hit, p, extent).amin(dim=-1)
    last = torch.where(hit, p, -1).amax(dim=-1)
    return first, last


@register("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """Max over each bin of each RoI. The JAX package masks the whole map
    per bin; here each bin is a range of rows and columns, and its max is
    read from a 2D sparse table of range maxima (levels 2^ky x 2^kx, built
    by shifted maxima) as the max of four overlapping power-of-two blocks:
    the same value, at O(1) a bin and without a map per RoI."""
    (x,) = ins["X"]  # [B, C, H, W]
    (rois,) = ins["ROIs"]  # [B, R, 4]
    (rois_len,) = ins["RoisLen"]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    b, c, h, w = x.shape
    r = rois.shape[1]

    x1, y1, x2, y2 = (torch.round(rois[..., i] * scale).to(_I32) for i in range(4))
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    y_lo, y_hi = _bin_ranges(y1, y2, ph, h, rh.to(_F32) / ph)  # [B, R, ph]
    x_lo, x_hi = _bin_ranges(x1, x2, pw, w, rw.to(_F32) / pw)  # [B, R, pw]

    # tables[ky][kx][b, c, y, x] = max of x over [y, y + 2^ky) x [x, x + 2^kx)
    nky = int(np.floor(np.log2(h))) + 1
    nkx = int(np.floor(np.log2(w))) + 1
    rows_of = [x]
    for k in range(1, nkx):
        rows_of.append(_shift_max(rows_of[-1], 3, 1 << (k - 1)))
    levels = []
    for tx in rows_of:
        col = [tx]
        for k in range(1, nky):
            col.append(_shift_max(col[-1], 2, 1 << (k - 1)))
        levels.append(torch.stack(col, 0))
    table = torch.stack(levels, 0)  # [kx, ky, B, C, H, W]
    # [B, kx * ky * H * W, C]: one row of channels per lookup
    table = table.permute(2, 0, 1, 4, 5, 3).reshape(b, nkx * nky * h * w, c)

    ok = (y_hi >= y_lo)[..., :, None] & (x_hi >= x_lo)[..., None, :]  # [B, R, ph, pw]
    ys0 = torch.clamp(y_lo, 0, h - 1)
    ye = torch.clamp(y_hi, 0, h - 1)
    xs0 = torch.clamp(x_lo, 0, w - 1)
    xe = torch.clamp(x_hi, 0, w - 1)
    ky = _floor_log2(torch.clamp(ye - ys0 + 1, min=1), h)
    kx = _floor_log2(torch.clamp(xe - xs0 + 1, min=1), w)
    ys1 = torch.clamp(ye - (1 << ky) + 1, min=0)
    xs1 = torch.clamp(xe - (1 << kx) + 1, min=0)

    def lookup(yy, xx):
        flat = ((kx[..., None, :] * nky + ky[..., :, None]) * h + yy[..., :, None]) * w \
            + xx[..., None, :]  # [B, R, ph, pw]
        rows = torch.arange(b, device=x.device)[:, None]
        return table[rows, flat.reshape(b, -1).long()]  # [B, R*ph*pw, C]

    pooled = torch.maximum(torch.maximum(lookup(ys0, xs0), lookup(ys1, xs0)),
                           torch.maximum(lookup(ys0, xs1), lookup(ys1, xs1)))
    pooled = pooled.reshape(b, r, ph, pw, c).permute(0, 1, 4, 2, 3)
    pooled = torch.where(ok[:, :, None] & (pooled > NEG / 2), pooled, 0.0)
    valid = (torch.arange(r, device=x.device)[None, :] < rois_len.reshape(-1, 1))
    return {"Out": [torch.where(valid[:, :, None, None, None], pooled, 0.0)]}


def _gather_pixels(feat_t, yi, xi, w):
    """feat_t [B, H * W, C] at integer pixels (yi, xi) [B, ...] -> [B, ...,
    C]."""
    b = feat_t.shape[0]
    flat = (yi.long() * w + xi.long()).reshape(b, -1)
    rows = torch.arange(b, device=feat_t.device)[:, None]
    return feat_t[rows, flat].reshape(tuple(yi.shape) + (feat_t.shape[2],))


@register("roi_align")
def _roi_align(ctx, ins, attrs):
    """Bilinear samples averaged over each bin (reference roi_align_op.h),
    with the JAX package's fixed sampling count of 2 where sampling_ratio
    is not positive (the reference's adaptive ceil(roi / bin) is
    data-dependent)."""
    (x,) = ins["X"]
    (rois,) = ins["ROIs"]
    (rois_len,) = ins["RoisLen"]
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    sampling = int(attrs.get("sampling_ratio", -1))
    s = sampling if sampling > 0 else 2
    b, c, h, w = x.shape
    r = rois.shape[1]
    dev = x.device

    x1, y1, x2, y2 = (rois[..., i] * scale for i in range(4))
    bin_h = torch.clamp(y2 - y1, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1, min=1.0) / pw
    py = torch.arange(ph, dtype=_F32, device=dev)
    px = torch.arange(pw, dtype=_F32, device=dev)
    sy = torch.arange(s, dtype=_F32, device=dev)
    bh, bw = bin_h[..., None, None], bin_w[..., None, None]
    yy = (y1[..., None, None] + py[:, None] * bh + (sy[None, :] + 0.5) * bh / s).reshape(b, r, -1)
    xx = (x1[..., None, None] + px[:, None] * bw + (sy[None, :] + 0.5) * bw / s).reshape(b, r, -1)
    yy, xx = yy[..., :, None], xx[..., None, :]  # the sample grid [B, R, ph*s, pw*s]

    y0 = torch.floor(yy).to(_I32)
    x0 = torch.floor(xx).to(_I32)
    wy1 = (yy - y0)[..., None]
    wx1 = (xx - x0)[..., None]
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
    grid = (b, r, ph * s, pw * s)
    feat_t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)

    def at(yc, xc):
        return _gather_pixels(feat_t, yc.expand(grid), xc.expand(grid), w)

    v = (at(y0c, x0c) * (1 - wy1) * (1 - wx1)
         + at(y1c, x0c) * wy1 * (1 - wx1)
         + at(y0c, x1c) * (1 - wy1) * wx1
         + at(y1c, x1c) * wy1 * wx1)
    inb = ((yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w))[..., None]
    v = torch.where(inb, v, 0.0)
    out = v.reshape(b, r, ph, s, pw, s, c).mean(dim=(3, 5)).permute(0, 1, 4, 2, 3)
    valid = (torch.arange(r, device=dev)[None, :] < rois_len.reshape(-1, 1))
    return {"Out": [torch.where(valid[:, :, None, None, None], out, 0.0)]}


def _last_valid_writer(cells, valid, n_cells):
    """For each of `n_cells` targets, the flat position (into `cells`
    [B, G]) of the last valid entry that writes it, -1 where none does: the
    sequential order of a scatter-set, made deterministic on the card."""
    pos = torch.arange(cells.numel(), device=cells.device).reshape(cells.shape)
    idx = torch.where(valid, cells, n_cells).reshape(-1).long()
    win = torch.full((n_cells + 1,), -1, dtype=torch.long, device=cells.device)
    win = win.scatter_reduce(0, idx, torch.where(valid, pos, -1).reshape(-1), "amax")
    return win[:n_cells]


@register("yolov3_loss")
def _yolov3_loss(ctx, ins, attrs):
    """reference operators/yolov3_loss_op.h: sigmoid xy and raw wh
    regression, BCE objectness with an ignore threshold, BCE class loss; each
    gt box is assigned to its best shape-matched anchor at its grid cell."""
    (x,) = ins["X"]  # [B, A * (5 + cls), H, W]
    (gtbox,) = ins["GTBox"]  # [B, G, 4] relative (cx, cy, w, h)
    (gtlabel,) = ins["GTLabel"]  # [B, G]
    anchors = [float(v) for v in attrs["anchors"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    b, _, h, w = x.shape
    a = len(anchors) // 2
    g = gtbox.shape[1]
    aw, ah = ctx.op_constant(lambda: (_floats(anchors[0::2], x.device),
                                      _floats(anchors[1::2], x.device)), "anchors")
    in_w, in_h = w * 32.0, h * 32.0  # downsample 32 (reference yolov3_loss_op.h)

    p = x.reshape(b, a, 5 + class_num, h, w)
    px, py = torch.sigmoid(p[:, :, 0]), torch.sigmoid(p[:, :, 1])
    pw_, ph_ = p[:, :, 2], p[:, :, 3]
    pobj = torch.sigmoid(p[:, :, 4])
    pcls = torch.sigmoid(p[:, :, 5:])

    valid_gt = (gtbox[..., 2] > 1e-6) & (gtbox[..., 3] > 1e-6)
    gw, gh = gtbox[..., 2] * in_w, gtbox[..., 3] * in_h
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None], ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best_a = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=-1)  # [B, G]
    gi = torch.clamp((gtbox[..., 0] * w).to(_I32), 0, w - 1)
    gj = torch.clamp((gtbox[..., 1] * h).to(_I32), 0, h - 1)
    tx = gtbox[..., 0] * w - gi
    ty = gtbox[..., 1] * h - gj
    tw = torch.log(torch.clamp(gw / aw[best_a], min=1e-9))
    th = torch.log(torch.clamp(gh / ah[best_a], min=1e-9))
    box_w = 2.0 - gtbox[..., 2] * gtbox[..., 3]  # bigger boxes weigh less

    bi = torch.arange(b, device=x.device)[:, None]
    cells = ((bi * a + best_a) * h + gj) * w + gi
    win = _last_valid_writer(cells, valid_gt, b * a * h * w)
    has = (win >= 0).reshape(b, a, h, w)
    src = torch.clamp(win, min=0)

    def scatter(vals, fill=0.0):
        return torch.where(has, vals.reshape(-1)[src].reshape(b, a, h, w), fill)

    obj_mask = has.to(_F32)
    tx_t, ty_t, tw_t, th_t, w_t = (scatter(v) for v in (tx, ty, tw, th, box_w))
    lab = torch.clamp(gtlabel.reshape(b, g).to(_I32), 0, class_num - 1)
    cls_cells = (((bi * a + best_a) * class_num + lab) * h + gj) * w + gi
    n_cls = b * a * class_num * h * w
    cls_buf = (_last_valid_writer(cls_cells, valid_gt, n_cls) >= 0).to(_F32).reshape(
        b, a, class_num, h, w)

    # predicted boxes with IoU above the threshold against any gt are not
    # penalized as background
    grid_x = torch.arange(w, dtype=_F32, device=x.device)[None, None, None, :]
    grid_y = torch.arange(h, dtype=_F32, device=x.device)[None, None, :, None]
    bx, by = (px + grid_x) / w, (py + grid_y) / h
    bw = torch.exp(pw_) * aw[None, :, None, None] / in_w
    bh = torch.exp(ph_) * ah[None, :, None, None] / in_h
    pred = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                       dim=-1).reshape(b, a * h * w, 4)
    gt_corners = torch.stack([gtbox[..., 0] - gtbox[..., 2] / 2, gtbox[..., 1] - gtbox[..., 3] / 2,
                              gtbox[..., 0] + gtbox[..., 2] / 2, gtbox[..., 1] + gtbox[..., 3] / 2],
                             dim=-1)
    iou = torch.where(valid_gt[:, None, :], _iou_matrix(pred, gt_corners), 0.0)
    best_iou = iou.amax(dim=2).reshape(b, a, h, w)
    noobj_mask = (best_iou < ignore_thresh).to(_F32) * (1 - obj_mask)

    def bce(pred, tgt, mask):
        pred = torch.clamp(pred, 1e-7, 1 - 1e-7)
        return -(tgt * torch.log(pred) + (1 - tgt) * torch.log(1 - pred)) * mask

    loss_xy = (bce(px, tx_t, obj_mask * w_t) + bce(py, ty_t, obj_mask * w_t)).sum(dim=(1, 2, 3))
    loss_wh = (torch.square(pw_ - tw_t) * obj_mask * w_t
               + torch.square(ph_ - th_t) * obj_mask * w_t).sum(dim=(1, 2, 3))
    loss_obj = (bce(pobj, obj_mask, obj_mask) + bce(pobj, obj_mask, noobj_mask)).sum(dim=(1, 2, 3))
    loss_cls = bce(pcls, cls_buf, obj_mask[:, :, None]).sum(dim=(1, 2, 3, 4))
    return {"Loss": [loss_xy + loss_wh + loss_obj + loss_cls]}


@register("generate_proposals", no_grad=True)
def _generate_proposals(ctx, ins, attrs):
    """reference detection/generate_proposals_op.cc: decode the anchor
    deltas, clip to the image, drop small boxes, take the top pre_nms_topN,
    NMS. Out: [B, post_nms_topN, 4] (-1 padded), the probabilities and the
    counts (the reference emits LoD)."""
    (scores,) = ins["Scores"]  # [B, A, H, W]
    (deltas,) = ins["BboxDeltas"]  # [B, A * 4, H, W]
    (im_info,) = ins["ImInfo"]  # [B, 3] (h, w, scale)
    (anchors,) = ins["Anchors"]  # [H, W, A, 4]
    variances = ins.get("Variances", [None])[0]
    pre_n = int(attrs.get("pre_nms_topN", 256))
    post_n = int(attrs.get("post_nms_topN", 64))
    min_size = float(attrs.get("min_size", 0.0))
    b, a, h, w = scores.shape
    anc = anchors.reshape(h * w * a, 4)

    s = scores.permute(0, 2, 3, 1).reshape(b, -1)  # HWA order
    d = deltas.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(b, -1, 4)
    if variances is not None:
        d = d * variances.reshape(h * w * a, 4)
    pcx, pcy, pw_, ph_ = _center_size(anc, True)
    cx = d[..., 0] * pw_ + pcx
    cy = d[..., 1] * ph_ + pcy
    bw = torch.exp(torch.clamp(d[..., 2], max=10.0)) * pw_
    bh = torch.exp(torch.clamp(d[..., 3], max=10.0)) * ph_
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1, im_info[:, 1] - 1,
                      im_info[:, 0] - 1], dim=1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    ok = ((boxes[..., 2] - boxes[..., 0] >= min_size)
          & (boxes[..., 3] - boxes[..., 1] >= min_size))
    s = torch.where(ok, s, NEG)
    k = min(pre_n, s.shape[1])
    top_s, top_i = _stable_desc(s)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    top_boxes = torch.gather(boxes, 1, top_i[:, :, None].expand(b, k, 4))
    kept_s, kept_i = nms_rounds(top_boxes, top_s[:, None, :], float(attrs.get("nms_thresh", 0.7)),
                                NEG / 2, min(post_n, k), False)
    kept_s, kept_i = kept_s[:, 0], kept_i[:, 0]
    valid = kept_i >= 0
    out_boxes = torch.gather(top_boxes, 1,
                             torch.clamp(kept_i, min=0).long()[:, :, None].expand(-1, -1, 4))
    out_boxes = torch.where(valid[:, :, None], out_boxes, -1.0)
    count = valid.sum(dim=1, dtype=_I32)
    pad = post_n - out_boxes.shape[1]
    if pad > 0:
        out_boxes = torch.cat([out_boxes, torch.full((b, pad, 4), -1.0, device=s.device)], 1)
        kept_s = torch.cat([kept_s, torch.full((b, pad), NEG, device=s.device)], 1)
    probs = torch.where(kept_s > NEG / 2, kept_s, -1.0)
    return {"RpnRois": [out_boxes], "RpnRoiProbs": [probs], "RoisLen": [count]}


@register("ssd_loss")
def _ssd_loss(ctx, ins, attrs):
    """SSD loss in one lowering (reference python layers/detection.py
    ssd_loss composes iou_similarity -> bipartite_match -> target_assign ->
    mine_hard_examples -> smooth_l1 + softmax CE), batched over the images.
    Returns the per-image loss [B, 1]."""
    (loc,) = ins["Location"]  # [B, M, 4]
    (conf,) = ins["Confidence"]  # [B, M, C]
    (gtbox,) = ins["GTBox"]  # [B, G, 4]
    (gtlabel,) = ins["GTLabel"]  # [B, G, 1] or [B, G]
    (gtlen,) = ins["GTLen"]  # [B]
    (prior,) = ins["PriorBox"]  # [M, 4]
    pb_var = ins.get("PriorBoxVar", [None])[0]
    bg = int(attrs.get("background_label", 0))
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    b, m, _ = loc.shape
    g = gtbox.shape[1]
    glabel = gtlabel.reshape(b, g).to(_I32)
    glen = gtlen.reshape(-1).to(_I32)
    pcx, pcy, pw, ph = _center_size(prior, True)

    gt_valid = torch.arange(g, device=loc.device)[None, :] < glen[:, None]
    iou = torch.where(gt_valid[:, :, None], _iou_matrix(gtbox, prior), 0.0)  # [B, G, M]
    match, _ = _bipartite(iou)
    if attrs.get("match_type", "per_prediction") == "per_prediction":
        am = torch.argmax(iou, dim=1).to(_I32)
        amd = torch.amax(iou, dim=1)
        match = torch.where((match == -1) & (amd >= overlap_t), am, match)
    pos = match >= 0
    num_pos = pos.sum(dim=1, dtype=_I32)
    safe = torch.clamp(match, min=0).long()

    # confidence loss, over the positives and the mined hard negatives
    tgt_label = torch.where(pos, torch.gather(glabel, 1, safe), bg)
    logp = torch.log_softmax(conf, dim=2)
    cls_loss = -torch.gather(logp, 2, tgt_label.long()[:, :, None])[:, :, 0]
    num_neg = torch.minimum((num_pos.to(_F32) * neg_ratio).to(_I32), m - num_pos)
    order = torch.argsort(-torch.where(pos, NEG, cls_loss), dim=1, stable=True)
    rank = torch.empty_like(order).scatter(
        1, order, torch.arange(m, device=loc.device).expand(b, m))
    neg = (~pos) & (rank < num_neg[:, None])
    conf_loss = torch.where(pos | neg, cls_loss, 0.0).sum(dim=1)

    # localization loss: smooth L1 on the encoded targets of the positives
    mgt = torch.gather(gtbox, 1, safe[:, :, None].expand(b, m, 4))
    tcx = (mgt[..., 0] + mgt[..., 2]) / 2
    tcy = (mgt[..., 1] + mgt[..., 3]) / 2
    tw = torch.clamp(mgt[..., 2] - mgt[..., 0], min=1e-8)
    th = torch.clamp(mgt[..., 3] - mgt[..., 1], min=1e-8)
    enc = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph, torch.log(tw / pw),
                       torch.log(th / ph)], dim=-1)
    if pb_var is not None:
        enc = enc / pb_var
    diff = torch.abs(loc - enc)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(dim=-1)
    loc_loss = torch.where(pos, sl1, 0.0).sum(dim=1)

    denom = torch.clamp(num_pos.to(_F32), min=1.0)
    return {"Loss": [((conf_w * conf_loss + loc_w * loc_loss) / denom).reshape(b, 1)]}


# ---------------------------------------------------------------------------
# training-time target assignment (reference detection/rpn_target_assign_op.cc,
# generate_proposal_labels_op.cc), as the JAX package redesigned it: every
# anchor / RoI gets a label in place (-1 ignore, 0 bg, 1..C fg) and per-row
# weights carry the sampling quota, ranked by overlap instead of drawn
# ---------------------------------------------------------------------------


def _box_deltas(src, gt):
    """Encode gt relative to src (the reference's BoxToDelta)."""
    scx, scy, sw, sh = _center_size(src, True)
    gcx, gcy, gw, gh = _center_size(gt, True)
    return torch.stack([
        (gcx - scx) / torch.clamp(sw, min=1e-6),
        (gcy - scy) / torch.clamp(sh, min=1e-6),
        torch.log(torch.clamp(gw, min=1e-6) / torch.clamp(sw, min=1e-6)),
        torch.log(torch.clamp(gh, min=1e-6) / torch.clamp(sh, min=1e-6)),
    ], dim=-1)


def _quota_cut(score, n_take):
    """The n_take-th largest score of each image [B, 1] (the JAX package's
    lax.top_k cut; only its value is used, so the tie order does not
    matter)."""
    return torch.topk(score, min(n_take, score.shape[1]), dim=1).values[:, -1:]


def _gather_rows(x, idx):
    """x [B, G, K] at idx [B, N] along axis 1 -> [B, N, K]."""
    return torch.gather(x, 1, idx.long()[:, :, None].expand(-1, -1, x.shape[2]))


@register("rpn_target_assign", no_grad=True, stochastic=True)
def _rpn_target_assign(ctx, ins, attrs):
    """Per-anchor RPN labels and targets. Anchor [N, 4], GtBox [B, G, 4],
    GtLen [B] -> TargetLabel [B, N] (-1 ignore / 0 bg / 1 fg), TargetBBox
    [B, N, 4] deltas, ScoreWeight / LocWeight [B, N] marking the quota."""
    (anchors,) = ins["Anchor"]
    (gtboxes,) = ins["GtBox"]
    (gtlen,) = ins["GtLen"]
    pos_thr = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thr = float(attrs.get("rpn_negative_overlap", 0.3))
    quota = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    n = anchors.shape[0]
    b, g = gtboxes.shape[:2]

    gmask = torch.arange(g, device=anchors.device)[None, :] < gtlen.reshape(-1, 1).to(_I32)
    iou = _iou_matrix(anchors, gtboxes) * gmask[:, None, :].to(anchors.dtype)  # [B, N, G]
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    # anchors that are the best of some valid gt are fg too (reference :167):
    # a scatter-max, so a padded gt row (its argmax lands on anchor 0) never
    # undoes a valid gt's write; argmax indices are always in range
    best_per_gt = torch.argmax(iou, dim=1)  # [B, G]
    forced_fg = torch.zeros((b, n), dtype=_F32, device=anchors.device).scatter_reduce(
        1, best_per_gt, gmask.to(_F32), "amax") > 0
    is_fg = forced_fg | (best_iou >= pos_thr)
    label = torch.where(is_fg, 1, -1)
    label = torch.where((best_iou < neg_thr) & ~is_fg, 0, label)
    deltas = _box_deltas(anchors, _gather_rows(gtboxes, best_gt))
    n_fg = int(quota * fg_frac)
    fg_cut = _quota_cut(torch.where(label == 1, best_iou, -1.0), n_fg)
    fg_w = (label == 1) & (best_iou >= torch.clamp(fg_cut, min=0.0))
    bg_score = torch.where(label == 0, -best_iou, -2.0)  # prefer low overlap
    bg_cut = _quota_cut(bg_score, quota - n_fg)
    bg_w = (label == 0) & (bg_score >= bg_cut)
    return {
        "TargetLabel": [label.to(_I32)],
        "TargetBBox": [deltas],
        "ScoreWeight": [(fg_w | bg_w).to(anchors.dtype)],
        "LocWeight": [fg_w.to(anchors.dtype)],
    }


@register("generate_proposal_labels", no_grad=True, stochastic=True)
def _generate_proposal_labels(ctx, ins, attrs):
    """Class labels and box targets of RoIs (reference
    generate_proposal_labels_op.cc). RpnRois [B, R, 4], GtClasses [B, G],
    GtBoxes [B, G, 4], GtLen [B] -> Rois (passed through), LabelsInt32
    [B, R], BboxTargets [B, R, 4], BboxInside/OutsideWeights [B, R, 4],
    SampleWeight [B, R]."""
    (rois,) = ins["RpnRois"]
    (gtcls,) = ins["GtClasses"]
    (gtboxes,) = ins["GtBoxes"]
    (gtlen,) = ins["GtLen"]
    fg_thr = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    quota = int(attrs.get("batch_size_per_im", 512))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    b, r = rois.shape[:2]
    g = gtboxes.shape[1]

    gmask = torch.arange(g, device=rois.device)[None, :] < gtlen.reshape(-1, 1).to(_I32)
    valid_roi = rois[..., 2] > rois[..., 0]
    iou = _iou_matrix(rois, gtboxes) * gmask[:, None, :].to(rois.dtype)
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    is_fg = (best_iou >= fg_thr) & valid_roi
    is_bg = (best_iou < bg_hi) & (best_iou >= bg_lo) & valid_roi
    labels = torch.where(is_fg, torch.gather(gtcls.to(_I32), 1, best_gt), 0)
    deltas = _box_deltas(rois, _gather_rows(gtboxes, best_gt))
    n_fg = int(quota * fg_frac)
    fg_cut = _quota_cut(torch.where(is_fg, best_iou, -1.0), n_fg)
    fg_w = is_fg & (best_iou >= torch.clamp(fg_cut, min=0.0))
    bg_score = torch.where(is_bg, -best_iou, -2.0)
    bg_cut = _quota_cut(bg_score, quota - n_fg)
    bg_w = is_bg & (bg_score >= bg_cut)
    inside = torch.where(fg_w[..., None], 1.0, 0.0).expand(b, r, 4).contiguous()
    return {
        "Rois": [rois],
        "LabelsInt32": [labels.to(_I32)],
        "BboxTargets": [deltas],
        "BboxInsideWeights": [inside],
        "BboxOutsideWeights": [inside],
        "SampleWeight": [(fg_w | bg_w).to(rois.dtype)],
    }


def _solve(a, rhs):
    """Batched Gaussian elimination with partial pivoting, a [..., n, n]
    and rhs [..., n] -> x [..., n]: the LU solve of jnp.linalg.solve in a
    fixed number of tensor steps (a library solve may sync the host to
    check its pivots, which a captured graph cannot do)."""
    n = a.shape[-1]
    m = torch.cat([a, rhs[..., None]], dim=-1)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        piv = torch.argmax(torch.abs(m[..., k:, k]), dim=-1) + k
        perm = torch.where(rows == k, piv[..., None],
                           torch.where(rows == piv[..., None], k, rows))
        m = torch.gather(m, -2, perm[..., None].expand(m.shape))
        factor = torch.where(rows > k, m[..., :, k] / m[..., k:k + 1, k], 0.0)
        m = m - factor[..., None] * m[..., k:k + 1, :]
    x = torch.zeros_like(rhs)
    for k in reversed(range(n)):
        xk = (m[..., k, n] - (m[..., k, :n] * x).sum(-1)) / m[..., k, k]
        x = torch.where(rows == k, xk[..., None], x)
    return x


def _abs(d):
    """|d| with jnp.abs's derivative at 0 (+1; torch.abs takes 0 there),
    which a sample point on a pixel edge reaches."""
    return torch.where(d >= 0, d, -d)


@register("roi_perspective_transform")
def _roi_perspective_transform(ctx, ins, attrs):
    """Warp quadrilateral regions to axis-aligned crops (reference
    detection/roi_perspective_transform_op.cc): per RoI of 8 coords (x1..y4
    clockwise), the homography that maps the output rectangle onto the quad,
    then bilinear sampling. RoIs are [B, R, 8]."""
    (x,) = ins["X"]  # [B, C, H, W]
    (rois,) = ins["ROIs"]  # [B, R, 8]
    oh = int(attrs.get("transformed_height", 8))
    ow = int(attrs.get("transformed_width", 8))
    scale = float(attrs.get("spatial_scale", 1.0))
    b, c, h, w = x.shape
    r = rois.shape[1]
    dev = x.device

    # the 8 projective parameters from 4 correspondences (output-rect
    # corners, clockwise from the top left)
    dst = [(0.0, 0.0), (ow - 1.0, 0.0), (ow - 1.0, oh - 1.0), (0.0, oh - 1.0)]
    zero = torch.zeros_like(rois[..., 0])
    eq, rhs = [], []
    for k, (sx, sy) in enumerate(dst):
        tx, ty = rois[..., 2 * k] * scale, rois[..., 2 * k + 1] * scale
        eq.append(torch.stack([zero + sx, zero + sy, zero + 1.0, zero, zero, zero,
                               -sx * tx, -sy * tx], dim=-1))
        rhs.append(tx)
        eq.append(torch.stack([zero, zero, zero, zero + sx, zero + sy, zero + 1.0,
                               -sx * ty, -sy * ty], dim=-1))
        rhs.append(ty)
    mat = torch.stack(eq, dim=-2) + 1e-8 * torch.eye(8, device=dev)
    p = _solve(mat, torch.stack(rhs, dim=-1))
    hom = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1).reshape(b, r, 3, 3)

    gy, gx = torch.meshgrid(torch.arange(oh, dtype=_F32, device=dev),
                            torch.arange(ow, dtype=_F32, device=dev), indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (oh, ow, 3)
    src = torch.einsum("hwk,brjk->brhwj", grid, hom)
    sx = src[..., 0] / torch.clamp(src[..., 2], min=1e-8)
    sy = src[..., 1] / torch.clamp(src[..., 2], min=1e-8)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    feat_t = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    out = torch.zeros((b, r, oh, ow, c), dtype=x.dtype, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = (1 - _abs(sx - xi)) * (1 - _abs(sy - yi))
            inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            xc = torch.clamp(xi, 0, w - 1).to(_I32)
            yc = torch.clamp(yi, 0, h - 1).to(_I32)
            out = out + _gather_pixels(feat_t, yc, xc, w) * (wgt * inb)[..., None]
    return {"Out": [out.permute(0, 1, 4, 2, 3)]}


# detection_map runs on the host: mAP is a metric over variable-length
# match lists, never on the training path. Inputs ride padded: DetectRes
# [B, N, 6] ([label, score, x1, y1, x2, y2], rows with label < 0 ignored),
# Label [B, G, 5] ([label, x1, y1, x2, y2], label < 0 padding).


def _host_array(value):
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").numpy()
    return np.asarray(value)


@register_host("detection_map")
def _detection_map_host(op, scope):
    from ..evaluator import DetectionMAP

    dets = _host_array(scope.find_var(op.input("DetectRes")[0]))
    labels = _host_array(scope.find_var(op.input("Label")[0]))
    ev = DetectionMAP(
        class_num=int(op.attrs.get("class_num", 0) or 0) or None,
        background_label=int(op.attrs.get("background_label", 0)),
        overlap_threshold=float(op.attrs.get("overlap_threshold", 0.5)),
        ap_version=op.attrs.get("ap_type", op.attrs.get("ap_version", "integral")),
    )
    for img_dets, img_gts in zip(dets, labels):
        valid_g = img_gts[img_gts[:, 0] >= 0]
        ev.update(img_dets[img_dets[:, 0] >= 0], valid_g[:, 0], valid_g[:, 1:5])
    scope.set_var(op.output("MAP")[0],
                  torch.tensor([ev.eval()], dtype=_F32, device=scope.device))
