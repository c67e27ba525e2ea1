"""Telemetry export: rotation-safe JSONL event sink + Prometheus scrape file
(the torch counterpart of paddle_tpu/observability/export.py: the same
file names and record fields, so tools/monitor.py reads either package's
directory).

Flag-gated (FLAGS_telemetry_dir, FLAGS_telemetry_interval_steps, flags.py):
when a dir is set, every recorded step appends one JSON line to a PER-HOST
shard file `telemetry-host<k>.jsonl` (k = the torch.distributed rank, 0
without a process group), and every `interval_steps` steps a `snapshot`
record (full metric registry, health counters, device-memory watermarks,
pipeline-bubble estimate) plus a Prometheus text file `metrics-host<k>.prom`
are written.

Schema (every record): {"kind": "step"|"snapshot", "step": int, "ts": float,
"host": int, ...}. Step records carry wall_ms/n_steps/feed_stall_ms/
cache_hit/nan_trip (+ pp/n_micro/schedule/loss when present); snapshot
records carry metrics/health/mem/bubble. tools/monitor.py renders the
stream.

Rotation: a shard that crosses `max_bytes` is renamed to `<name>.1`
(previous `.1` dropped) and a fresh shard is started. Writes are
line-buffered appends; the Prometheus file and the merged view are written
atomically (tmp + rename) so a scraper never reads a torn file.

Multi-process: each rank writes only its own shard; rank 0 additionally
maintains `telemetry-merged.jsonl`, a ts-sorted merge of every shard it can
see (meaningful when the telemetry dir is shared storage; the shards remain
the ground truth), when the group has more than one rank.

Device-memory watermarks ride the snapshot records from the CUDA caching
allocator's counters (torch.cuda.max_memory_allocated / memory_allocated
and the card's total memory), which read host-side counters and add no
device sync; the field is omitted on the CPU.
"""

import glob
import json
import os
import threading
import time

__all__ = [
    "TelemetryExporter",
    "device_memory_stats",
    "merge_host_shards",
    "SHARD_PATTERN",
]

SHARD_PATTERN = "telemetry-host*.jsonl*"
MERGED_NAME = "telemetry-merged.jsonl"


def _process_index():
    """This process's rank: torch.distributed's when a process group is up,
    else 0 (one process per host)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _process_count():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def device_memory_stats():
    """{mem_peak_bytes, mem_bytes_in_use, mem_limit_bytes} of this process's
    card (the current CUDA device), or {} where no card is in use (CPU)."""
    try:
        import torch

        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        dev = torch.cuda.current_device()
        return {
            "mem_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
            "mem_bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "mem_limit_bytes": int(torch.cuda.get_device_properties(dev).total_memory),
        }
    except Exception:
        return {}


def _atomic_write(path, text):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def read_records(path):
    """Parse one JSONL file, skipping torn trailing lines (a crash mid-append
    leaves at most one)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def merge_host_shards(out_dir, out_name=MERGED_NAME):
    """ts-sorted merge of every host shard (rotated shards included) into
    `out_name`, written atomically. Returns the merged path (or None when no
    shards exist). Normally called by rank 0 at flush time; also usable
    post-hoc on a collected log dir."""
    paths = sorted(glob.glob(os.path.join(out_dir, SHARD_PATTERN)))
    paths = [p for p in paths if not p.endswith(".tmp")]
    if not paths:
        return None
    records = []
    for p in paths:
        records.extend(read_records(p))
    records.sort(key=lambda r: (r.get("ts", 0), r.get("host", 0)))
    out = os.path.join(out_dir, out_name)
    _atomic_write(out, "".join(json.dumps(r) + "\n" for r in records))
    return out


class TelemetryExporter:
    def __init__(self, out_dir, interval_steps=50, max_bytes=64 << 20,
                 registry=None):
        from . import registry as _registry

        self.out_dir = out_dir
        self.interval_steps = max(int(interval_steps), 1)
        self.max_bytes = max_bytes
        self.registry = registry or _registry.default_registry()
        self.host = _process_index()
        os.makedirs(out_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._shard_path = os.path.join(
            out_dir, "telemetry-host%d.jsonl" % self.host
        )
        self._prom_path = os.path.join(
            out_dir, "metrics-host%d.prom" % self.host
        )
        self._fh = open(self._shard_path, "a")
        self._steps_since_flush = 0

    # ---- sink -----------------------------------------------------------
    def _write(self, record):
        record.setdefault("ts", time.time())
        record["host"] = self.host
        line = json.dumps(record) + "\n"
        with self._lock:
            self._fh.write(line)
            self._fh.flush()
            if self._fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self):
        self._fh.close()
        os.replace(self._shard_path, self._shard_path + ".1")
        self._fh = open(self._shard_path, "a")

    def write_record(self, record):
        """Append one arbitrary (non-step) record to this host's shard —
        the sink for op_profile / tensor_stats / nan_provenance records
        (observability/opprof.py). The record must carry a "kind"; ts/host
        are stamped like every other line."""
        if not record.get("kind"):
            raise ValueError("telemetry record needs a 'kind': %r" % (record,))
        self._write(dict(record))

    def on_step(self, step_record, collector=None):
        self._write(step_record)
        self._steps_since_flush += step_record.get("n_steps", 1)
        if self._steps_since_flush >= self.interval_steps:
            self.flush(collector)

    def flush(self, collector=None):
        """Interval work: snapshot record into the shard, Prometheus scrape
        file, rank-0 merged view."""
        self._steps_since_flush = 0
        from ..resilience import health as _health

        snap = {
            "kind": "snapshot",
            "step": getattr(collector, "_step", None) if collector else None,
            "metrics": self.registry.snapshot(),
            "health": _health.snapshot(),
        }
        mem = device_memory_stats()
        if mem:
            snap["mem"] = mem
            self.registry.gauge(
                "device/mem_peak_bytes",
                "peak bytes allocated on this process's card",
            ).set(mem["mem_peak_bytes"])
        if collector is not None:
            bub = collector.bubble_estimate()
            if bub is not None:
                snap["bubble"] = bub
        self._write(snap)
        _atomic_write(self._prom_path, self.registry.to_prometheus())
        if self.host == 0 and _process_count() > 1:
            try:
                merge_host_shards(self.out_dir)
            except OSError:
                pass  # shared-fs hiccup: shards remain the ground truth

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
