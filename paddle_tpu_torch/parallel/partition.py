"""Program partitioner for the pp tier: cut a topologically-ordered op list
into N contiguous pipeline stages (the counterpart of
paddle_tpu/parallel/partition.py, numpy code with the same cuts).

Two sources of the cut, mirroring the reference pipeline optimizer's split
(reference pipeline_trainer + device_guard sections) vs modern practice:

- EXPLICIT: ops carry `framework.PIPELINE_STAGE_ATTR` (appended under
  `fluid.device_guard("pp:<k>")`). Stage ids must be non-decreasing along
  the block's op order (the op list is already topological — a later op may
  not run on an earlier stage); unannotated ops inherit the surrounding
  stage.

- ANALYTIC: balance stages by per-op cost (dot FLOPs = 2·M·N·K, conv FLOPs
  = 2·out·Cin·kh·kw, everything else bandwidth-bound at in+out bytes),
  converted to microseconds against the card's data-sheet peaks so a
  matmul-heavy op and a byte-heavy op land on one scale, plus each op's
  parameter read bytes (a stage that owns more weight bytes pays more
  memory traffic per microbatch). The cut minimizes
  the maximum stage weight over the LEGAL cut points the caller provides
  (a cut is legal when every live value crossing it is microbatch-major, so
  the schedule can pack it into the boundary buffer).
"""

import numpy as np

from ..framework import PIPELINE_STAGE_ATTR

__all__ = [
    "analytic_op_flops_bytes",
    "analytic_op_time_us",
    "stages_from_attrs",
    "balanced_partition",
]

# the card's data-sheet peaks (NVIDIA H100 SXM: 67 TFLOP/s of f32 on the
# CUDA cores, 3.35 TB/s of HBM3), the figures chip_smoke.py's bounds use;
# only their RATIO matters here — the partition is invariant to rescaling
# both. The cuts may differ from the JAX package's, whose ratio is another
# chip's; the math of a pipeline does not depend on where it is cut.
_PEAK_MM_FLOPS_PER_US = 67.0e6  # 67 TFLOP/s
_PEAK_BW_BYTES_PER_US = 3.35e6  # 3.35 TB/s


def _size(aval):
    return int(np.prod(aval.shape)) if aval.shape else 1


def _bytes(aval):
    return _size(aval) * np.dtype(aval.dtype).itemsize


def analytic_op_flops_bytes(op_type, in_avals, out_avals):
    """(flops, bytes) estimate for one op — the counting model underneath
    analytic_op_time_us, exposed separately so observability/opprof.py can
    report per-op FLOPs with the SAME numbers the pipeline partitioner
    balances on.

    in_avals: {slot: [aval, ...]} of the op's inputs; out_avals likewise.
    At the Program level: dot-family ops get 2·M·N·K, conv gets
    2·out_elems·Cin·kh·kw, everything else is bandwidth-bound.
    """
    flat_in = [a for vs in in_avals.values() for a in vs if a is not None]
    flat_out = [a for vs in out_avals.values() for a in vs if a is not None]
    nbytes = sum(_bytes(a) for a in flat_in) + sum(_bytes(a) for a in flat_out)
    flops = 0
    if op_type in ("mul", "matmul") and flat_out:
        out = flat_out[0]
        ys = in_avals.get("Y") or []
        if ys and out.shape:
            y = ys[0]
            # contraction length: mul flattens to [M,K]@[K,N]; matmul keeps
            # batch dims, contracting y's second-to-last (or only) dim
            k = y.shape[-2] if len(y.shape) >= 2 else (y.shape[0] if y.shape else 1)
            flops = 2 * _size(out) * int(k)
    elif op_type in ("conv2d", "depthwise_conv2d", "conv2d_transpose") and flat_out:
        out = flat_out[0]
        fs = in_avals.get("Filter") or []
        if fs:
            f = fs[0]
            # filter [Co, Ci, kh, kw] → per-output-elem 2·Ci·kh·kw MACs
            per_out = 2 * int(np.prod(f.shape[1:]))
            flops = _size(out) * per_out
    elif op_type in ("lstm", "gru", "sequence_conv") and flat_out:
        # recurrent mats dominate: approximate as bandwidth + 2·out·hidden
        out = flat_out[0]
        h = out.shape[-1] if out.shape else 1
        flops = 2 * _size(out) * int(h)
    return flops, nbytes


def analytic_op_time_us(op_type, in_avals, out_avals):
    """Roofline time estimate for one op: max(FLOP time, byte time), from
    analytic_op_flops_bytes against the card's peaks."""
    flops, nbytes = analytic_op_flops_bytes(op_type, in_avals, out_avals)
    return max(flops / _PEAK_MM_FLOPS_PER_US, nbytes / _PEAK_BW_BYTES_PER_US)


def stages_from_attrs(ops, n_stages):
    """Explicit device_guard override: returns a per-op stage-id list, or
    None when no op carries the attr. Unannotated ops inherit the previous
    op's stage (stage 0 before the first annotation); annotations must be
    non-decreasing and < n_stages."""
    if not any(op.attrs.get(PIPELINE_STAGE_ATTR) is not None for op in ops):
        return None
    stages = []
    cur = 0
    for op in ops:
        s = op.attrs.get(PIPELINE_STAGE_ATTR)
        if s is not None:
            s = int(s)
            if s < cur:
                raise ValueError(
                    "device_guard stage %d on op %r goes BACKWARD from stage "
                    "%d: pipeline stages must be non-decreasing in program "
                    "order" % (s, op.type, cur)
                )
            if s >= n_stages:
                raise ValueError(
                    "device_guard stage %d on op %r >= pipeline depth %d"
                    % (s, op.type, n_stages)
                )
            cur = s
        stages.append(cur)
    return stages


def balanced_partition(weights, legal_cuts, n_stages):
    """Cut `weights` (per-op cost, program order) into `n_stages` contiguous
    segments minimizing the max segment weight, cutting only AFTER indices in
    `legal_cuts` (cut k = boundary between op k and op k+1). Returns the
    per-op stage-id list.

    Feasibility check + binary search over the bottleneck value with a
    greedy placement (cut at the last legal point that keeps the running
    segment under the bound) — exact for this minimax objective on a
    sequence with restricted cut points.
    """
    n = len(weights)
    if n_stages < 1:
        raise ValueError("n_stages must be >= 1")
    if n_stages == 1:
        return [0] * n
    legal = sorted(set(int(k) for k in legal_cuts if 0 <= int(k) < n - 1))
    if len(legal) < n_stages - 1:
        raise ValueError(
            "cannot cut %d ops into %d pipeline stages: only %d legal cut "
            "points (values crossing the others are not microbatch-major; "
            "pin stages explicitly with device_guard or lower pp)"
            % (n, n_stages, len(legal))
        )

    def greedy(bound):
        """Stage-id assignment with every segment <= bound, using at most
        n_stages segments and leaving enough legal cuts for the rest; None
        if infeasible."""
        cuts = []
        seg_start = 0
        i = 0
        li = 0  # index into legal
        acc = 0.0
        for i in range(n):
            acc += weights[i]
            remaining_stages = n_stages - 1 - len(cuts)
            if acc > bound and remaining_stages > 0:
                # cut at the last legal point in [seg_start, i-1]
                best = None
                for k in legal:
                    if seg_start <= k < i:
                        best = k
                if best is None:
                    return None
                cuts.append(best)
                seg_start = best + 1
                acc = float(sum(weights[seg_start : i + 1]))
                if acc > bound:
                    return None
        # the last segment must keep to the bound too: without this check
        # (the JAX package's greedy has none) a bound below the optimum looks
        # feasible, and the search ends with nearly every op in the last
        # stage
        if acc > bound:
            return None
        # force remaining cuts (every stage must be non-empty of ops? allow
        # trailing cuts at remaining legal points after seg_start)
        while len(cuts) < n_stages - 1:
            nxt = [k for k in legal if k >= seg_start and k < n - 1 and k not in cuts]
            if not nxt:
                return None
            cuts.append(nxt[0])
            seg_start = nxt[0] + 1
        return sorted(cuts)

    lo = max(weights) if weights else 0.0
    # a hair above the total: the running sums above add in program order,
    # and Python's sum of floats compensates, so the two may differ in the
    # last place
    hi = (float(sum(weights)) or 1.0) * (1.0 + 1e-9)
    best_cuts = greedy(hi)
    if best_cuts is None:
        # bound=total always feasible given enough legal cuts
        raise ValueError("internal: partition infeasible at total weight")
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        got = greedy(mid)
        if got is None:
            lo = mid
        else:
            hi = mid
            best_cuts = got
    stages = []
    cur = 0
    cut_set = set(best_cuts)
    for i in range(n):
        stages.append(cur)
        if i in cut_set:
            cur += 1
    return stages
