"""Op-level attribution: the layer BELOW step telemetry (the torch
counterpart of paddle_tpu/observability/opprof.py).

StepStats answers "how long was the step"; this module answers the three
questions one level down, each a leg of the same subsystem:

1. COST ATTRIBUTION: a per-op table (count, total/mean device ms, FLOPs,
   bytes, % of step, Roof%) exported as an "op_profile" telemetry record
   and rendered by tools/op_profile.py. `device_profile` builds it from a
   torch.profiler trace (profiler.xla_trace) of the op-by-op path, where
   each CUDA kernel is attributed to the `op/<display name>` range that
   launched it; a replayed CUDA graph is one launch and cannot be split by
   op. `host_profile` builds it from the host profiler's per-op events
   (FLAGS_profile_ops). Every record carries the roofline peaks it was
   rendered against: the H100's (67 TFLOP/s of f32 on the CUDA cores,
   3.35 TB/s of HBM3, the figures parallel/partition.py counts with).

2. TENSOR-STATS INSTRUMENTATION: FLAGS_tensor_stats=<glob> selects ops
   whose outputs get mean/std/absmax/nonfinite-count computed ON THE
   DEVICE inside the step (inside the captured CUDA graph on the card,
   into one [n, 4] tensor the graph owns), read with ONE host sync a run,
   streamed as "tensor_stats" records + per-op registry gauges.

3. NAN PROVENANCE: when the resilience NaN guard or FLAGS_check_nan_inf
   trips and FLAGS_nan_provenance is set, the step is replayed op by op
   from its pre-step state and the generator state it started from
   (localize_nonfinite), stopping at the FIRST op emitting a non-finite
   output, and a provenance record (op type/name, input stats, attrs, step
   index) plus a health/nan_provenance counter are written.

Everything here is off by default; the only hot-path cost when disabled is
the flags lookup the executor already pays.

Reference analog: operator.cc per-op RecordEvent tables + the op-level
FLAGS_check_nan_inf raise site (operator.cc:778), and device_tracer.cc's
kernel->op correlation.
"""

import fnmatch
import math
import sys
import threading

__all__ = [
    "STAT_FIELDS",
    "op_display_name",
    "iter_block_ops",
    "match_ops",
    "stats_spec",
    "program_op_costs",
    "build_record",
    "device_profile",
    "host_profile",
    "export_record",
    "render_table",
    "render_rollup",
    "PEAK_MM_TFLOPS",
    "PEAK_BW_GBS",
    "record_tensor_stats",
    "last_tensor_stats",
    "localize_nonfinite",
    "write_provenance",
    "last_provenance",
]

STAT_FIELDS = ("mean", "std", "absmax", "nonfinite")

_lock = threading.Lock()
_last_tensor_stats = None
_last_provenance = None


# ---------------------------------------------------------------------------
# op identity
# ---------------------------------------------------------------------------


def op_display_name(op):
    """'<type>:<first real output var>': fluid ops are anonymous, so the
    first output is the stable instance handle."""
    from ..ops.registry import EMPTY_VAR_NAME

    for name in op.output_arg_names:
        if name != EMPTY_VAR_NAME:
            return "%s:%s" % (op.type, name)
    return op.type


def iter_block_ops(block):
    """Yield every op of a block INCLUDING control-flow sub-blocks (While/
    cond bodies live as Block-valued attrs — the instrumentation pass must
    see them the way the reference's op walk saw sub-block descs)."""
    from .. import framework

    for op in block.ops:
        yield op
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                for sub in iter_block_ops(v):
                    yield sub


def match_ops(ops, pattern):
    """Ops whose display name, type, or any output var name matches the
    glob (fnmatch, case-sensitive). `ops` is an iterable of Operators or a
    Block (walked recursively)."""
    from .. import framework
    from ..ops.registry import EMPTY_VAR_NAME

    if isinstance(ops, framework.Block):
        ops = iter_block_ops(ops)
    out = []
    for op in ops:
        names = [op_display_name(op), op.type] + [
            n for n in op.output_arg_names if n != EMPTY_VAR_NAME
        ]
        if any(fnmatch.fnmatchcase(n, pattern) for n in names):
            out.append(op)
    return out


def stats_spec(ops, pattern):
    """((display_name, first_output_var), ...) for FLAGS_tensor_stats
    matches: what executor._PerOpProfiledBlock instruments."""
    from ..ops.registry import EMPTY_VAR_NAME

    spec = []
    seen = set()
    for op in match_ops(ops, pattern):
        for name in op.output_arg_names:
            if name != EMPTY_VAR_NAME:
                if name not in seen:
                    seen.add(name)
                    spec.append((op_display_name(op), name))
                break
    return tuple(spec)


# ---------------------------------------------------------------------------
# leg 1: cost attribution
# ---------------------------------------------------------------------------


def program_op_costs(ops, aval_of):
    """{display name: (flops, bytes)} from the Program-level counting model
    (parallel.partition.analytic_op_flops_bytes — the same numbers the pp
    partitioner balances on). `aval_of(name)` returns an object with
    .shape/.dtype or None for unknown vars."""
    from ..ops.registry import EMPTY_VAR_NAME
    from ..parallel import partition as _part

    costs = {}
    for op in ops:
        in_avals = {
            slot: [aval_of(n) if n != EMPTY_VAR_NAME else None for n in names]
            for slot, names in op.inputs.items()
        }
        out_avals = {
            slot: [aval_of(n) if n != EMPTY_VAR_NAME else None for n in names]
            for slot, names in op.outputs.items()
        }
        flops, nbytes = _part.analytic_op_flops_bytes(op.type, in_avals, out_avals)
        key = op_display_name(op)
        f0, b0 = costs.get(key, (0, 0))
        costs[key] = (f0 + flops, b0 + nbytes)
    return costs


def block_aval_resolver(block, feed_avals=None):
    """aval_of(name) over a block's declared vars, with -1 (batch) dims
    resolved from the fed batch size when one is known."""
    import numpy as np

    feed_avals = feed_avals or {}
    batch = None
    for a in feed_avals.values():
        if getattr(a, "shape", None):
            batch = int(a.shape[0])
            break

    class _A(object):
        __slots__ = ("shape", "dtype")

        def __init__(self, shape, dtype):
            self.shape = shape
            self.dtype = dtype

    def aval_of(name):
        a = feed_avals.get(name)
        if a is not None:
            return a
        try:
            v = block._var_recursive(name)
        except KeyError:
            return None
        if v.shape is None or v.dtype is None:
            return None
        shape = tuple(
            (batch if (d == -1 and batch is not None) else abs(int(d)))
            for d in v.shape
        )
        try:
            dtype = np.dtype("uint16" if v.dtype == "bfloat16" else v.dtype)
        except TypeError:
            return None
        return _A(shape, dtype)

    return aval_of


def build_record(table, step_ms=None, source="torch.profiler", step=None, costs=None):
    """Assemble the "op_profile" telemetry record from a per-op table
    ({key: row}). `costs` ({display: (flops, bytes)}, program_op_costs)
    fills FLOPs and bytes. % of step is against `step_ms` when the caller
    measured one, else against the summed device time (self-normalized).
    The record carries the roofline peaks (the H100's) its Roof% reads."""
    rows = []
    total_ms = sum(r["total_ms"] for r in table.values())
    denom = step_ms if step_ms else total_ms
    for key in sorted(table, key=lambda k: -table[k]["total_ms"]):
        r = dict(table[key])
        if costs and not r["flops"]:
            f, b = costs.get(key, (0, 0))
            # also try the type-level key a type-only attribution collapsed to
            if not f and ":" not in key:
                f = sum(c[0] for k, c in costs.items() if k.startswith(key + ":"))
                b = sum(c[1] for k, c in costs.items() if k.startswith(key + ":"))
            r["flops"] = r["flops"] or int(f)
            r["bytes"] = r["bytes"] or int(b)
        r["total_ms"] = round(r["total_ms"], 4)
        r["mean_ms"] = round(r["total_ms"] / max(r["count"], 1), 4)
        r["min_ms"] = round(r["min_ms"], 4) if r["count"] else 0.0
        r["max_ms"] = round(r["max_ms"], 4)
        r["pct"] = round(100.0 * r["total_ms"] / denom, 2) if denom else 0.0
        rows.append(r)
    rec = {
        "kind": "op_profile",
        "source": source,
        "total_device_ms": round(total_ms, 4),
        "peak_tflops": PEAK_MM_TFLOPS,
        "peak_bw_gbs": PEAK_BW_GBS,
        "ops": rows,
    }
    if step_ms is not None:
        rec["step_ms"] = round(step_ms, 4)
    if step is not None:
        rec["step"] = step
    return rec


def _new_row(key):
    return {
        "op": key,
        "type": key.split(":", 1)[0],
        "count": 0,
        "total_ms": 0.0,
        "min_ms": float("inf"),
        "max_ms": 0.0,
        "flops": 0,
        "bytes": 0,
    }


def _add(row, count, total, mn, mx):
    row["count"] += count
    row["total_ms"] += total
    row["min_ms"] = min(row["min_ms"], mn)
    row["max_ms"] = max(row["max_ms"], mx)


def _block_costs(block, feed_avals):
    """{key: (flops, bytes)} of a block's ops by display name, and of each
    fused run under the name the op-by-op path gives it (its members'
    sum)."""
    from ..executor import _run_label
    from ..ops import registry as _reg

    ops = [op for op in iter_block_ops(block)]
    costs = program_op_costs(ops, block_aval_resolver(block, feed_avals))
    top = [op for op in block.ops
           if _reg.is_registered(op.type) and not _reg.get(op.type).skip_exec]
    for run in _reg.op_runs(top):
        if len(run) > 1:
            parts = [costs.get(op_display_name(m), (0, 0)) for m in run]
            costs[_run_label(run)[len("op/"):]] = (
                sum(p[0] for p in parts), sum(p[1] for p in parts))
    return costs


def device_profile(executor, log_dir, step_ms=None, block=None, feed_avals=None):
    """Leg 1 from a device trace: the per-op table of a
    profiler.xla_trace log dir (torch.profiler's kernels, each attributed to
    the op range that launched it), as an op_profile record with
    source="torch.profiler". The trace must hold an op-by-op step
    (FLAGS_profile_ops under the profiler): a replayed CUDA graph raises.
    `block`/`feed_avals` give the analytic FLOPs and bytes of each row.
    `executor` is accepted for the JAX package's signature (its compiled
    HLO has no counterpart here). Returns the record (also exported when
    telemetry is active)."""
    from .. import profiler as _prof

    table = _prof.device_op_profile(log_dir, print_table=False)
    rows = {}
    for key, (count, total, mn, mx) in table.items():
        _add(rows.setdefault(key, _new_row(key)), count, total, mn, mx)
    costs = _block_costs(block, feed_avals) if block is not None else None
    rec = build_record(rows, step_ms=step_ms, source="torch.profiler", costs=costs)
    export_record(rec)
    return rec


def host_profile(table=None, step_ms=None, block=None, feed_avals=None):
    """Leg 1 from the HOST profiler's per-op events
    (FLAGS_profile_ops runs under the profiler record 'op/<display>'
    events with a device sync per op, executor._PerOpProfiledBlock). The
    same record shape as device_profile, with source="host_events"."""
    from .. import profiler as _prof

    if table is None:
        table, _snapshot = _prof._aggregate()
    rows = {}
    for name, (count, total, mn, mx) in table.items():
        # profiler names are nested paths ('run/block0/op/<display>'); take
        # the op/ leaf and skip everything else
        if "op/" not in name:
            continue
        key = name.rsplit("op/", 1)[1]
        if not key or "/" in key:
            continue
        _add(rows.setdefault(key, _new_row(key)), count, total, mn, mx)
    costs = _block_costs(block, feed_avals) if block is not None else None
    rec = build_record(rows, step_ms=step_ms, source="host_events", costs=costs)
    export_record(rec)
    return rec


def _fmt_flops(f):
    if not f:
        return "-"
    for unit in ("", "K", "M", "G", "T", "P"):
        if f < 1000 or unit == "P":
            return "%.4g%s" % (f, unit)
        f /= 1000.0


# roofline peaks for the Roof% column / headroom rollup: the H100's data-
# sheet figures (NVIDIA H100 SXM: 67 TFLOP/s of f32 on the CUDA cores,
# 3.35 TB/s of HBM3), the ones parallel/partition.py counts with; every
# record build_record writes carries them, and a record's own
# "peak_tflops"/"peak_bw_gbs" win over these
PEAK_MM_TFLOPS = 67.0
PEAK_BW_GBS = 3350.0


def _roofline_ms(row, peak_tflops, peak_bw_gbs):
    """Roofline minimum busy ms for one row — max of the compute leg
    (flops / peak matmul throughput) and the memory leg (bytes / peak HBM
    bandwidth); None when the row carries neither cost."""
    f = row.get("flops", 0) or 0
    b = row.get("bytes", 0) or 0
    if not f and not b:
        return None
    return max(f / (peak_tflops * 1e9), b / (peak_bw_gbs * 1e6))


def _row_roof_pct(r, peak_tflops, peak_bw_gbs):
    roof = _roofline_ms(r, peak_tflops, peak_bw_gbs)
    if roof is None or not r["total_ms"]:
        return "-"
    return "%.1f" % min(100.0 * roof / r["total_ms"], 100.0)


def render_table(record, top=20):
    """op_profile record -> the printable top-k table (shared by
    tools/op_profile.py and interactive use). Roof% is achieved fraction of
    the per-row roofline minimum (100 = nothing left to win)."""
    peak_tflops = record.get("peak_tflops", PEAK_MM_TFLOPS)
    peak_bw_gbs = record.get("peak_bw_gbs", PEAK_BW_GBS)
    lines = [
        "---------------->    Op Profile (%s)    <----------------"
        % record.get("source", "?"),
        "%-44s %7s %10s %10s %8s %10s %6s %6s"
        % ("Op", "Count", "Total(ms)", "Mean(ms)", "FLOPs", "Bytes", "%",
           "Roof%"),
    ]
    for r in record.get("ops", [])[:top]:
        lines.append(
            "%-44s %7d %10.4f %10.4f %8s %10s %6.2f %6s"
            % (
                r["op"][:44],
                r["count"],
                r["total_ms"],
                r.get("mean_ms", r["total_ms"] / max(r["count"], 1)),
                _fmt_flops(r.get("flops", 0)),
                _fmt_flops(r.get("bytes", 0)),
                r.get("pct", 0.0),
                _row_roof_pct(r, peak_tflops, peak_bw_gbs),
            )
        )
    total = record.get("total_device_ms")
    if total is not None:
        tail = "total device ms: %.4f" % total
        if record.get("step_ms") is not None:
            tail += "   step ms: %.4f   coverage: %.1f%%" % (
                record["step_ms"],
                100.0 * total / record["step_ms"] if record["step_ms"] else 0.0,
            )
        lines.append(tail)
    return "\n".join(lines)


def render_rollup(record, top=10):
    """Category (op type) rollup ranked by roofline HEADROOM — the busy ms
    above each category's roofline minimum, i.e. the time a kernel
    substitution could still win back. Raw ms ranks a category that is big
    but already optimal above one that is smaller but 3x off roofline;
    headroom is the attack-order signal. Rows without cost analysis are
    assumed AT roofline (they claim no headroom)."""
    peak_tflops = record.get("peak_tflops", PEAK_MM_TFLOPS)
    peak_bw_gbs = record.get("peak_bw_gbs", PEAK_BW_GBS)
    cats = {}
    for r in record.get("ops", []):
        c = cats.setdefault(
            r.get("type") or r["op"],
            {"count": 0, "total_ms": 0.0, "roof_ms": 0.0},
        )
        c["count"] += r["count"]
        c["total_ms"] += r["total_ms"]
        roof = _roofline_ms(r, peak_tflops, peak_bw_gbs)
        c["roof_ms"] += min(
            roof if roof is not None else r["total_ms"], r["total_ms"]
        )
    lines = [
        "----------------> Category rollup (by headroom) <----------------",
        "%-28s %7s %10s %12s %12s %6s"
        % ("Category", "Count", "Total(ms)", "Roofline(ms)", "Headroom(ms)",
           "Roof%"),
    ]
    ranked = sorted(
        cats.items(), key=lambda kv: kv[1]["roof_ms"] - kv[1]["total_ms"]
    )
    for name, c in ranked[:top]:
        headroom = c["total_ms"] - c["roof_ms"]
        pct = 100.0 * c["roof_ms"] / c["total_ms"] if c["total_ms"] else 0.0
        lines.append(
            "%-28s %7d %10.4f %12.4f %12.4f %6.1f"
            % (name[:28], c["count"], c["total_ms"], c["roof_ms"], headroom,
               pct)
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# telemetry plumbing shared by all three legs
# ---------------------------------------------------------------------------


def _current_step():
    from . import stepstats as _ss

    if _ss.active():
        return _ss.collector()._step
    return None


def export_record(record):
    """Ship any opprof record through the telemetry JSONL path when
    FLAGS_telemetry_dir is configured; a no-op sink otherwise. Never raises
    (same contract as the step-record path)."""
    try:
        from . import stepstats as _ss

        if not _ss.active():
            return False
        col = _ss.collector()
        if record.get("step") is None:
            record["step"] = col._step
        exp = col._get_exporter()
        if exp is None:
            return False
        exp.write_record(record)
        return True
    except Exception as e:  # telemetry must never break the run
        if not getattr(export_record, "_warned", False):
            export_record._warned = True
            print(
                "opprof export failed (disabled for this message): %r" % e,
                file=sys.stderr,
            )
        return False


# ---------------------------------------------------------------------------
# leg 2: tensor stats
# ---------------------------------------------------------------------------


def record_tensor_stats(names, stats, step=None):
    """Executor hook: `names` are the instrumented op display names (block
    order), `stats` the host [n, 4] float array the run computed on the
    device (columns = STAT_FIELDS). Stashes the last reading, streams a
    "tensor_stats" record, and maintains labelled registry gauges."""
    global _last_tensor_stats

    per_op = {}
    for name, row in zip(names, stats):
        per_op[name] = {
            "mean": float(row[0]),
            "std": float(row[1]),
            "absmax": float(row[2]),
            "nonfinite": int(row[3]),
        }
    with _lock:
        _last_tensor_stats = per_op
    try:
        from . import registry as _registry

        reg = _registry.default_registry()
        for name, st in per_op.items():
            if math.isfinite(st["absmax"]):
                reg.gauge(
                    "tensor_stats/absmax", "per-op output abs-max (FLAGS_tensor_stats)"
                ).set(st["absmax"], op=name)
            reg.gauge(
                "tensor_stats/nonfinite",
                "per-op non-finite output count (FLAGS_tensor_stats)",
            ).set(st["nonfinite"], op=name)
    except Exception:
        pass
    export_record({"kind": "tensor_stats", "step": step, "ops": per_op})
    return per_op


def last_tensor_stats():
    """Most recent per-op stats dict from an instrumented run (or None)."""
    with _lock:
        return dict(_last_tensor_stats) if _last_tensor_stats else None


# ---------------------------------------------------------------------------
# leg 3: NaN provenance
# ---------------------------------------------------------------------------


def _host_stats(value):
    """Small host-side description of one array for the provenance record:
    finite-mean/std, absmax, nonfinite count, shape, dtype."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        value = value.to("cpu")
    a = np.asarray(value)
    d = {"shape": list(a.shape), "dtype": str(a.dtype)}
    if a.dtype.kind == "f" and a.size:
        finite = np.isfinite(a)
        n_bad = int(a.size - finite.sum())
        d["nonfinite"] = n_bad
        if n_bad < a.size:
            good = a[finite]
            d["mean"] = float(good.mean())
            d["std"] = float(good.std())
            d["absmax"] = float(np.abs(good).max())
    return d


def _clean_attrs(attrs):
    """Scalar/short attrs only — sub-blocks and role metadata add noise."""
    from .. import framework

    out = {}
    for k, v in sorted(attrs.items()):
        if k.startswith("__") or k == framework.OpRole.OP_ROLE_KEY:
            continue
        if isinstance(v, framework.Block):
            continue
        if isinstance(v, (bool, int, float, str)):
            out[k] = v
        elif isinstance(v, (list, tuple)) and len(v) <= 8 and all(
            isinstance(x, (bool, int, float, str)) for x in v
        ):
            out[k] = list(v)
    return out


def localize_nonfinite(ops, env, ctx, step=None):
    """Op-by-op NaN localization: replay `ops` in Program order over a copy
    of `env` (name -> tensor: the step's feeds + pre-step state) through
    their lowerings one op at a time (no fused runs, no capture), checking
    each op's float outputs for non-finite values. The walk costs one
    device sync per op (a diagnosis path, never a training path), and
    `ctx` (a registry.LowerCtx) draws from generators set to the state the
    step started from, so a random op (dropout) replays the step's mask.
    Returns the provenance dict for the first offending op, or None if the
    replay stays finite. Host ops (send/recv, save) are skipped: replaying
    their side effects while diagnosing would corrupt the cluster's state."""
    import torch

    from ..ops import registry as _reg
    from ..ops.registry import EMPTY_VAR_NAME

    env = dict(env)
    with torch.no_grad():
        for idx, op in enumerate(ops):
            opdef = _reg.get(op.type)
            if opdef.skip_exec or opdef.is_host:
                continue
            in_vals = {
                n: env.get(n)
                for n in op.input_arg_names
                if n != EMPTY_VAR_NAME and env.get(n) is not None
            }
            _reg.lower_op(ctx, op, env, opdef)
            bad = []
            for n in op.output_arg_names:
                if n == EMPTY_VAR_NAME:
                    continue
                v = env.get(n)
                if isinstance(v, torch.Tensor) and v.is_floating_point() and not bool(
                    torch.isfinite(v).all()
                ):
                    bad.append(n)
            if bad:
                return {
                    "kind": "nan_provenance",
                    "step": step,
                    "op_index": idx,
                    "op_type": op.type,
                    "op": op_display_name(op),
                    "outputs": bad,
                    "output_stats": {n: _host_stats(env[n]) for n in bad},
                    "input_stats": {n: _host_stats(v) for n, v in in_vals.items()},
                    "attrs": _clean_attrs(op.attrs),
                }
    return None


def write_provenance(record, reason="nan_guard"):
    """Record a localized NaN: health counter, telemetry record when
    configured, one stderr line always (the operator asked for provenance —
    it must surface even without a telemetry dir), and the in-process
    stash read by last_provenance()."""
    global _last_provenance

    rec = dict(record)
    rec["kind"] = "nan_provenance"
    rec["reason"] = reason
    if rec.get("step") is None:
        step = _current_step()
        if step is not None:
            rec["step"] = step
    with _lock:
        _last_provenance = rec
    try:
        from ..resilience import health as _health

        _health.incr("nan_provenance")
    except Exception:
        pass
    export_record(rec)
    print(
        "[nan_provenance] first non-finite output at op #%s %s (%s) "
        "outputs=%s step=%s"
        % (
            rec.get("op_index"),
            rec.get("op"),
            reason,
            rec.get("outputs"),
            rec.get("step"),
        ),
        file=sys.stderr,
        flush=True,
    )
    return rec


def last_provenance():
    """Most recent NaN provenance record of this process (or None)."""
    with _lock:
        return dict(_last_provenance) if _last_provenance else None
