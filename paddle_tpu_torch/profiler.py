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
training mode. The device-side trace (the JAX package's xla_trace and
device_op_profile) is not here; torch.profiler is the tool on the card.
"""

import contextlib
import json
import threading
import time

__all__ = [
    "RecordEvent",
    "is_profiling",
    "profiler",
    "reset_profiler",
    "start_profiler",
    "stop_profiler",
]

_state = {"on": False, "mode": "All"}
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

    def __enter__(self):
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
