"""ModelPublisher — atomic version publishing into a model repository (the
torch port of paddle_tpu/online/publisher.py: the same manifests, npz keys
and bits, and LATEST.json fields for the same arrays).

The repository is a plain directory speaking the resilience.async_ckpt
format: full base checkpoints (``eckpt-%08d``) plus incremental delta chains
(``eckpt-delta-%08d``), topped by an atomic ``LATEST.json`` pointer naming
the newest committed version. Readers (online.reloader.HotReloader, an
offline engine rebuild) never coordinate with the writer: a version exists
iff its manifest landed, and the pointer — written with the same
tmp→fsync→rename ladder, strictly AFTER the manifest — only ever names
committed versions.

Publish policy (docs/online.md):

- the FIRST publish, any ``force_base``, and every time the live chain
  reaches ``max_chain`` links cuts a full base (compaction) — bounding both
  replay length for a cold reader and the window a lost delta can cost;
- otherwise a delta ships only what changed since the previous publish:
  dense params that fail an equality check against the last published
  snapshot, and embedding tables as (touched row ids, row values) from the
  EmbeddingEngine's SelectedRows bookkeeping;
- after a base commits, the stale chain (deltas rooted at older bases) is
  GC'd manifest-first; base GC itself is write_elastic_checkpoint's
  ``keep_last``;
- a publish is SKIPPED (returns None) when nothing changed, and THROTTLED
  when the slowest acknowledged consumer trails the last published version
  by more than the staleness contract's budget — see online.staleness.

The values may be device tensors (a trainer's scope on the card) or numpy
arrays. Nothing here copies a whole table to the host for bookkeeping:

- byte counts are numel x element size;
- a delta's touched table rows are gathered on the table's device
  (index_select on the ids) and only those rows cross to the host;
- the dense dirtiness check runs where the values live: the snapshot of
  each dense value is a clone on its own device (a tensor) or a host copy
  (a numpy array), compared by value equality (torch.equal /
  np.array_equal: NaN never equals, -0.0 equals 0.0, as in the JAX
  package). A dirty dense value is copied to the host once, by the delta
  writer.
"""

import json
import os
import time

import numpy as np
import torch

from ..resilience import async_ckpt
from ..resilience.async_ckpt import _atomic_write
from . import staleness as _staleness

__all__ = ["ModelPublisher", "LATEST", "read_latest"]

LATEST = "LATEST.json"


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


def read_latest(repo):
    """The repository's LATEST.json pointer dict, or None when absent or
    torn (the writer is atomic; tolerance here is for foreign files)."""
    try:
        with open(os.path.join(repo, LATEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _nbytes(a):
    """Bytes of a tensor or array, without a host copy."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def _take_rows(a, ids):
    """The rows `ids` of table `a` as a host array (or a bf16 tensor, which
    the delta writer widens): gathered on the table's device first."""
    if isinstance(a, torch.Tensor):
        idx = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)).to(a.device)
        rows = a.detach().index_select(0, idx)
        return rows if rows.dtype == torch.bfloat16 else rows.cpu().numpy()
    return np.asarray(a)[ids]


def _snapshot(a):
    """The dirtiness baseline of one dense value, on its own device."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    return np.array(np.asarray(a))


def _unchanged(prev, cur):
    if prev is None:
        return False
    if isinstance(cur, torch.Tensor):
        return (isinstance(prev, torch.Tensor) and prev.device == cur.device
                and prev.dtype == cur.dtype and prev.shape == cur.shape
                and torch.equal(prev, cur.detach()))
    cur = np.asarray(cur)
    return (not isinstance(prev, torch.Tensor) and prev.shape == cur.shape
            and np.array_equal(prev, cur))


class ModelPublisher:
    """One trainer's publishing face onto a model-repository directory."""

    def __init__(self, repo, num_hosts=1, host_id=0, keep_bases=2,
                 max_chain=8, contract=None, name=None):
        self.repo = repo
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.keep_bases = int(keep_bases)
        self.max_chain = int(max_chain)
        self.contract = contract or _staleness.StalenessContract()
        self.name = name or os.path.basename(os.path.normpath(repo)) or "repo"
        os.makedirs(repo, exist_ok=True)

        # adopt an existing chain (trainer restart onto a live repository)
        self._base_step = None
        self._parent_step = None
        self._chain_len = 0
        self._last_train_step = None
        found = async_ckpt.resolve_delta_chain(repo)
        if found is not None:
            base_step, _d, chain = found
            self._base_step = base_step
            self._parent_step = chain[-1][0] if chain else base_step
            self._chain_len = len(chain)
            self._last_train_step = self._parent_step
        # dense snapshots from the last publish, for dirtiness checks; the
        # adopted case starts empty, so the first delta after a restart
        # conservatively ships every dense param
        self._last_dense = {}
        self.published = 0
        self.throttled = 0
        self.skipped_clean = 0

        reg = _registry()
        self._m_publishes = reg.counter(
            "online/publishes", "versions published, by kind label"
        )
        self._m_throttled = reg.counter(
            "online/publish_throttled",
            "publishes skipped because a consumer exceeded max_staleness",
        )
        self._m_skipped = reg.counter(
            "online/publish_skipped_clean",
            "publish intervals with nothing dirty to ship",
        )
        self._m_version = reg.gauge(
            "online/published_version", "newest committed version (train step)"
        )
        self._m_chain = reg.gauge(
            "online/delta_chain_len", "deltas since the live base"
        )
        self._m_ms = reg.histogram(
            "online/publish_ms", "wall ms per committed publish"
        )
        self._m_bytes = reg.counter(
            "online/published_bytes", "payload bytes shipped, by kind label"
        )

    # ---------------------------------------------------------------- policy
    def should_publish(self, train_step=None):
        """The staleness throttle: False while the slowest acknowledged
        consumer trails the last PUBLISHED version by more than the
        contract's step budget (a wedged fleet can only catch up to what is
        already published — pushing more would just grow its replay debt).
        `train_step` is unused in the decision but kept for callers logging
        intent."""
        if self._last_train_step is None:
            return True  # nothing published yet: nothing to be behind on
        ok = self.contract.should_publish(self.repo, self._last_train_step)
        if not ok:
            self.throttled += 1
            self._m_throttled.inc()
        return ok

    # --------------------------------------------------------------- publish
    def publish(self, arrays, train_step, touched=None, cursor=None,
                force_base=False):
        """Commit one version of `arrays` (name -> full tensor or array, the
        serve set) stamped with `train_step`. `touched` maps embedding table
        name -> row ids updated since the LAST publish; tables named there
        ship rows-only in delta mode. Returns the pointer dict committed, or
        None when a delta publish found nothing dirty."""
        t0 = time.perf_counter()
        touched = {
            n: np.asarray(ids).reshape(-1)
            for n, ids in (touched or {}).items()
            if n in arrays
        }
        want_base = (
            force_base
            or self._base_step is None
            or self._chain_len >= self.max_chain
        )
        st = _staleness.stamp(train_step)
        if want_base:
            pointer = self._publish_base(arrays, train_step, cursor, st)
        else:
            pointer = self._publish_delta(
                arrays, train_step, touched, cursor, st
            )
            if pointer is None:
                self.skipped_clean += 1
                self._m_skipped.inc()
                return None
        self._snapshot_dense(arrays, touched)
        self._last_train_step = int(train_step)
        self.published += 1
        self._m_version.set(float(train_step))
        self._m_chain.set(float(self._chain_len))
        self._m_ms.observe((time.perf_counter() - t0) * 1e3)
        return pointer

    def _publish_base(self, arrays, train_step, cursor, st):
        async_ckpt.write_elastic_checkpoint(
            self.repo, arrays, int(train_step),
            num_hosts=self.num_hosts, host_id=self.host_id,
            cursor=cursor, keep_last=self.keep_bases,
        )
        self._base_step = int(train_step)
        self._parent_step = int(train_step)
        self._chain_len = 0
        if self.host_id == 0:
            # the stale chains now root at GC'd/old bases: retire them
            # manifest-first so a reader mid-walk sees a skippable dir,
            # never a half-deleted manifest-ful one
            async_ckpt.gc_elastic_deltas(
                self.repo, keep_base_step=self._base_step
            )
        self._m_publishes.inc(kind="base")
        self._m_bytes.inc(
            int(sum(_nbytes(a) for a in arrays.values())), kind="base",
        )
        return self._write_pointer(train_step, "base", st)

    def _publish_delta(self, arrays, train_step, touched, cursor, st):
        dense = {}
        rows = {}
        nbytes = 0
        for name, a in arrays.items():
            if name in touched:
                ids = touched[name]
                if ids.size == 0:
                    continue
                vals = _take_rows(a, ids)
                rows[name] = (ids, vals, list(a.shape))
                nbytes += _nbytes(vals) + ids.nbytes
                continue
            if _unchanged(self._last_dense.get(name), a):
                continue
            dense[name] = a
            nbytes += _nbytes(a)
        if not dense and not rows:
            return None
        async_ckpt.write_elastic_delta(
            self.repo, int(train_step), self._base_step, self._parent_step,
            dense, rows,
            num_hosts=self.num_hosts, host_id=self.host_id,
            cursor=cursor, stamp=st,
        )
        self._parent_step = int(train_step)
        self._chain_len += 1
        self._m_publishes.inc(kind="delta")
        self._m_bytes.inc(int(nbytes), kind="delta")
        return self._write_pointer(train_step, "delta", st)

    def _write_pointer(self, train_step, kind, st):
        pointer = {
            "version": int(train_step),
            "kind": kind,
            "base_step": self._base_step,
            "chain_len": self._chain_len,
            "stamp": st,
        }
        if self.host_id == 0:
            _atomic_write(
                os.path.join(self.repo, LATEST), json.dumps(pointer)
            )
        return pointer

    def _snapshot_dense(self, arrays, touched):
        # the next delta's dirtiness baseline, each on its value's device
        # (tables are excluded: their dirtiness is the touched-rows set)
        self._last_dense = {
            n: _snapshot(a) for n, a in arrays.items() if n not in touched
        }

    def stats(self):
        return {
            "published": self.published,
            "throttled": self.throttled,
            "skipped_clean": self.skipped_clean,
            "base_step": self._base_step,
            "chain_len": self._chain_len,
            "last_train_step": self._last_train_step,
        }
