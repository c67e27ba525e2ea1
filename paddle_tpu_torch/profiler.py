"""Host-side event profiler (the torch counterpart of the host half of
paddle_tpu/profiler.py).

Reference analog: platform/profiler.{h,cc} (RecordEvent RAII pairs wrapping
every op run, EnableProfiler/DisableProfiler aggregation tables, sorted
summaries) and python/paddle/fluid/profiler.py:221 (the `with
profiler.profiler(...)` context manager).

On the card a block runs as a replayed CUDA graph, so host events are per
phase (`run/block0`, a whole call). While the profiler is on and
FLAGS_profile_ops is set, Executor.run takes the op-by-op block instead and
brackets every op (or fused run) in its own event, with a device sync after
each, so the table attributes time per op: a diagnosis mode, never a
training mode.

The device half (the JAX package's xla_trace and device_op_profile, on
torch.profiler): `xla_trace(log_dir)` records the CPU and CUDA activity of
its body and writes a chrome trace under `log_dir`; inside it every
RecordEvent is also a torch.profiler range. `device_op_profile(log_dir)`
reads those traces and attributes each CUDA kernel to the innermost
`op/<display name>` range open when it was launched (the launch's
correlation id ties the kernel to its runtime call): the per-op device
table of the op-by-op path. A replayed CUDA graph is one launch and
cannot be split by op, so a trace that holds only graph launches raises.
"""

import contextlib
import glob
import itertools
import json
import os
import threading
import time

__all__ = [
    "RecordEvent",
    "device_op_profile",
    "is_profiling",
    "profiler",
    "reset_profiler",
    "start_profiler",
    "stop_profiler",
    "xla_trace",
]

_state = {"on": False, "mode": "All", "trace": False}
_events = []  # (name, start_s, end_s, thread_id)
_events_lock = threading.Lock()
_tls = threading.local()


def is_profiling():
    return _state["on"]


class RecordEvent:
    """RAII event (reference platform/profiler.h:66). Nesting is recorded via
    name stacking, like the reference's pushed event pairs."""

    def __init__(self, name):
        self.name = name
        self._start = None
        self._pushed = False
        self._range = None

    def __enter__(self):
        if _state["trace"]:
            import torch

            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _state["on"]:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            stack.append(self.name)
            self._pushed = True
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # pop whenever we pushed: profiling may have been stopped by another
        # thread mid-event, and a leaked stack entry would prefix every event
        # of the next session
        if self._pushed:
            end = time.perf_counter()
            stack = _tls.stack
            full = "/".join(stack)
            stack.pop()
            self._pushed = False
            if _state["on"]:
                with _events_lock:
                    _events.append((full, self._start, end, threading.get_ident()))
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return False


def reset_profiler():
    with _events_lock:
        _events.clear()


def start_profiler(state="All"):
    """state in {CPU, GPU, All}, kept for API parity: host events are
    recorded whatever it is."""
    _state["mode"] = state
    _state["on"] = True


def _aggregate():
    table = {}
    with _events_lock:
        snapshot = list(_events)
    for name, start, end, _tid in snapshot:
        row = table.setdefault(name, [0, 0.0, float("inf"), 0.0])
        dt = (end - start) * 1000.0
        row[0] += 1
        row[1] += dt
        row[2] = min(row[2], dt)
        row[3] = max(row[3], dt)
    return table, snapshot


_SORT_KEYS = {
    None: lambda kv: 0,
    "default": lambda kv: 0,
    "calls": lambda kv: -kv[1][0],
    "total": lambda kv: -kv[1][1],
    "max": lambda kv: -kv[1][3],
    "min": lambda kv: -kv[1][2],
    "ave": lambda kv: -(kv[1][1] / kv[1][0]),
}


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    """Print the aggregation table (reference DisableProfiler's summary) and
    return it as {name: [calls, total_ms, min_ms, max_ms]}; with a
    `profile_path` (the reference's default, which tools/timeline.py reads),
    also dump the raw events there as JSON; None dumps nothing."""
    _state["on"] = False
    table, snapshot = _aggregate()
    rows = sorted(table.items(), key=_SORT_KEYS.get(sorted_key, _SORT_KEYS[None]))
    header = "%-50s %8s %12s %12s %12s %12s" % (
        "Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)", "Ave(ms)",
    )
    lines = ["------------------------->    Profiling Report    <-------------------------", header]
    for name, (calls, total, mn, mx) in rows:
        lines.append(
            "%-50s %8d %12.4f %12.4f %12.4f %12.4f"
            % (name[:50], calls, total, mn, mx, total / calls)
        )
    print("\n".join(lines))
    if profile_path:
        with open(profile_path, "w") as f:
            json.dump(
                {
                    "events": [
                        {"name": n, "start": s, "end": e, "tid": t}
                        for n, s, e, t in snapshot
                    ]
                },
                f,
            )
    return table


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile"):
    """`with profiler.profiler('All', 'total'):` (reference profiler.py:221)."""
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


_trace_seq = itertools.count()


@contextlib.contextmanager
def xla_trace(log_dir):
    """Device-side trace of the body through torch.profiler (the CUPTI
    device_tracer analog): CPU activity, and CUDA's where a card is in use,
    written as a chrome trace `trace-<pid>-<n>.json` under `log_dir` when
    the body ends. Yields the torch.profiler.profile object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    _state["trace"] = True
    try:
        yield prof
    finally:
        _state["trace"] = False
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(log_dir, "trace-%d-%d.json" % (os.getpid(), next(_trace_seq))))


def _innermost(ranges, ts):
    """The key of the shortest (start, end, key) range holding ts, or None."""
    inside = [r for r in ranges if r[0] <= ts <= r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None


def _trace_kernels(log_dir):
    """([(op key or None, kernel name, device ms)], graph launches) of every
    chrome trace xla_trace wrote under `log_dir`: each kernel attributed to
    the innermost `op/<key>` range open when its runtime call launched it
    (matched by correlation id; the launching thread's ranges first), or,
    where the trace holds no such call, to the innermost op range its
    device start falls in."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True))
    if not paths:
        raise FileNotFoundError("no trace under %r: run xla_trace first" % log_dir)
    kernels, graph_launches = [], 0
    for path in paths:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        ranges = {}  # thread -> [(start, end, key)]
        launches = {}  # correlation id -> (thread, ts)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            name = ev.get("name", "")
            thread = (ev.get("pid"), ev.get("tid"))
            if cat == "user_annotation" and "op/" in name:
                key = name.rsplit("op/", 1)[1]
                ranges.setdefault(thread, []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)), key))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = (thread, float(ev["ts"]))
                if "GraphLaunch" in name:  # cudaGraphLaunch, cuGraphLaunch
                    graph_launches += 1
        every = [r for rs in ranges.values() for r in rs]
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat") != "kernel":
                continue
            launch = launches.get((ev.get("args") or {}).get("correlation"))
            key = None
            if launch is not None:
                # the launching thread's own range, or, for a launch from
                # another thread (autograd's device thread runs a backward
                # while the op's thread waits in its range), the range open
                # when it launched
                key = (_innermost(ranges.get(launch[0], ()), launch[1])
                       or _innermost(every, launch[1]))
            if key is None:
                # no runtime call in the trace (a library launching through
                # a cudart of its own): the op-by-op path syncs the card
                # inside each op's range, so the kernel ran within the range
                # of the op that launched it
                key = _innermost(every, float(ev["ts"]))
            kernels.append((key, ev.get("name", "?"), float(ev.get("dur", 0)) / 1e3))
    return kernels, graph_launches


def device_op_profile(log_dir, hlo_text=None, print_table=True):
    """Fold an xla_trace's CUDA kernels onto framework ops (reference
    analog: device_tracer.cc correlating CUPTI kernels to RecordEvent
    annotations into the same profiler table): {key: [count, total_ms,
    min_ms, max_ms]} in stop_profiler's table shape, a kernel launched
    inside an op range under that op's display name, any other under
    "kernel:<its name>". The ranges are the op-by-op path's
    (FLAGS_profile_ops under the profiler): a trace whose kernels all came
    from replayed CUDA graphs raises, since a graph is one launch and
    cannot be split by op. `hlo_text` is accepted for the JAX package's
    signature and unused."""
    kernels, graph_launches = _trace_kernels(log_dir)
    if graph_launches and not any(key is not None for key, _, _ in kernels):
        raise RuntimeError(
            "device_op_profile: the trace under %r holds only CUDA graph launches (%d): a "
            "replayed graph is one launch and cannot be split by op; trace a step on the "
            "op-by-op path (FLAGS_profile_ops under profiler.profiler)" % (log_dir, graph_launches))
    table = {}
    for key, name, ms in kernels:
        row = table.setdefault(key if key is not None else "kernel:" + name[:60],
                               [0, 0.0, float("inf"), 0.0])
        row[0] += 1
        row[1] += ms
        row[2] = min(row[2], ms)
        row[3] = max(row[3], ms)
    if print_table and table:
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])
        lines = [
            "------------------->    Device Profiling Report (CUDA)    <-------------------",
            "%-50s %8s %12s %12s %12s %12s"
            % ("Op", "Kernels", "Total(ms)", "Min(ms)", "Max(ms)", "Ave(ms)"),
        ]
        for name, (calls, total, mn, mx) in rows:
            lines.append(
                "%-50s %8d %12.4f %12.4f %12.4f %12.4f"
                % (name[:50], calls, total, mn, mx, total / calls)
            )
        print("\n".join(lines))
    return table
