"""Host-side allocator for the paged KV-cache pool (the vLLM block manager
analog, sized for the GenerationEngine's fixed-shape decode step) plus the
prefix cache that shares immutable full pages across requests.

The device side is dumb on purpose: per layer, one persistable
``[n_pages * page_size, feat]`` pool tensor that the compiled programs
gather/scatter through block tables (ops/generation_ops.py). All policy
lives here, on the host, where it costs nothing per token:

- **page free-list + refcounts** — page 0 is a reserved *scratch* page that
  is never handed out. Idle decode slots and padded prefill tail positions
  write there (their block-table entries are 0), so a fixed-shape program
  can always run all slots without conditionals; scratch contents are
  garbage by design and masked out of every attention read. Every live page
  carries a refcount: 1 for a private page, +1 per extra slot sharing it,
  +1 while the prefix cache holds it. A page returns to the free list only
  at refcount 0.
- **slot free-list** — a slot is one decode lane in the fixed [max_slots]
  step. Admission takes a slot + enough pages for the request's worst case
  (prompt + max_new tokens, the reservation-at-admit policy: admission can
  never deadlock mid-decode needing a page that isn't there). Shared prefix
  pages satisfy the leading part of the reservation without consuming free
  pages.
- **page reuse on retirement** — release() drops one reference per table
  entry; pages nobody else holds return to their free list and the next
  admission reuses them without touching the device (stale rows are
  overwritten by prefill/decode writes before any read, see
  docs/serving.md lifecycle).

**PrefixCache** is a prompt-token trie over *full* pages: the key for depth
k is the exact first ``k * page_size`` prompt tokens (token tuples, not
hashes — no collisions), the value the pool page holding those positions'
K/V. Shared pages are immutable by construction — a prefill after a prefix
hit starts at the first uncached position, and decode writes land at
positions >= the prompt length, so no program ever writes through a shared
table entry; copy-on-write is unnecessary. Lookup always leaves at least
the final prompt token uncached (its hidden state must be computed to
produce the first sampled logits). Eviction is LRU over unreferenced
entries (descendants first, so the trie never has unreachable tails) and
runs on demand when admission wants pages the free list can't supply.

Thread-safety: the GenerationScheduler's worker thread is the only caller;
a lock still guards acquire/release so `stats()` from other threads is
consistent.
"""

import threading

import numpy as np

__all__ = ["PagedKVPool", "PoolExhausted", "PrefixCache"]

SCRATCH_PAGE = 0


class PoolExhausted(RuntimeError):
    """No free slot or not enough free pages for the reservation."""


class PagedKVPool:
    def __init__(self, n_pages, page_size, max_slots, max_pages_per_slot,
                 storage_dtype="float32", row_bytes=0):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        if page_size < 1 or max_slots < 1 or max_pages_per_slot < 1:
            raise ValueError("page_size/max_slots/max_pages_per_slot must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.max_pages_per_slot = int(max_pages_per_slot)
        # storage mode is bookkeeping only (the device arrays live with the
        # engine): "int8" pools store per-row levels + f32 per-page scale
        # vectors at ~1/4 the f32 bytes per token, so the same HBM budget
        # funds >= 2x the pages/slots. row_bytes is the caller-computed
        # device bytes per pooled token row across all layers (levels +
        # scales), surfaced through stats() for the monitor's kv-pool row.
        self.storage_dtype = str(storage_dtype)
        self.row_bytes = int(row_bytes)
        self._lock = threading.Lock()
        # LIFO free lists: hottest pages get reused first (best for any
        # future device-side page cache locality)
        self._free_pages = list(range(1, self.n_pages))
        self._free_slots = list(range(self.max_slots - 1, -1, -1))
        self._tables = {}  # slot -> np.int32 [max_pages_per_slot]
        self._refs = {}  # page -> live reference count (slots + prefix cache)

    @property
    def pool_rows(self):
        return self.n_pages * self.page_size

    def pages_for(self, n_positions):
        """Pages needed to hold `n_positions` cached tokens."""
        return -(-int(n_positions) // self.page_size)

    def can_admit(self, n_positions, n_shared=0):
        need = max(0, self.pages_for(n_positions) - int(n_shared))
        with self._lock:
            return (
                bool(self._free_slots)
                and need <= len(self._free_pages)
                and self.pages_for(n_positions) <= self.max_pages_per_slot
            )

    def acquire(self, n_positions, shared_pages=()):
        """Reserve a slot + pages for a request whose cache will hold at most
        `n_positions` tokens. `shared_pages` (prefix-cache hits, already
        alive) fill the leading table entries and gain a reference each;
        only the remainder is drawn from the free list. Returns
        (slot, block_table) where block_table is the slot's np.int32
        [max_pages_per_slot] page list, scratch-0 padded. Raises
        PoolExhausted when it can't."""
        need = self.pages_for(n_positions)
        shared = [int(p) for p in shared_pages]
        if need > self.max_pages_per_slot:
            raise PoolExhausted(
                "%d positions need %d pages > max_pages_per_slot %d"
                % (n_positions, need, self.max_pages_per_slot)
            )
        if len(shared) > need:
            raise ValueError("more shared pages than the reservation needs")
        need_new = need - len(shared)
        with self._lock:
            if not self._free_slots:
                raise PoolExhausted("no free decode slot")
            if need_new > len(self._free_pages):
                raise PoolExhausted(
                    "need %d pages, %d free" % (need_new, len(self._free_pages))
                )
            slot = self._free_slots.pop()
            table = np.full(self.max_pages_per_slot, SCRATCH_PAGE, np.int32)
            for i, pid in enumerate(shared):
                if self._refs.get(pid, 0) < 1:
                    raise ValueError("shared page %d is not alive" % pid)
                table[i] = pid
                self._refs[pid] += 1
            for i in range(need_new):
                pid = self._free_pages.pop()
                table[len(shared) + i] = pid
                self._refs[pid] = 1
            self._tables[slot] = table
            return slot, table

    def release(self, slot):
        """Retire a slot: drop one reference per page; pages nobody else
        holds return to the free list for reuse."""
        with self._lock:
            table = self._tables.pop(slot, None)
            if table is None:
                return
            for p in table:
                if p != SCRATCH_PAGE:
                    self._unref_locked(int(p))
            self._free_slots.append(slot)

    def pin_pages(self, pages):
        """Add one reference to each (alive) page — the prefix cache's hold."""
        with self._lock:
            for p in pages:
                p = int(p)
                if self._refs.get(p, 0) < 1:
                    raise ValueError("pin of dead page %d" % p)
                self._refs[p] += 1

    def unpin_pages(self, pages):
        """Drop one reference from each page; frees those reaching zero."""
        with self._lock:
            for p in pages:
                self._unref_locked(int(p))

    def page_refcount(self, page):
        with self._lock:
            return self._refs.get(int(page), 0)

    def _unref_locked(self, page):
        c = self._refs.get(page, 0) - 1
        if c > 0:
            self._refs[page] = c
        else:
            self._refs.pop(page, None)
            self._free_pages.append(page)

    def block_table(self, slot):
        with self._lock:
            t = self._tables.get(slot)
            return None if t is None else t.copy()

    def stats(self):
        with self._lock:
            in_use = (self.n_pages - 1) - len(self._free_pages)
            slots = self.max_slots - len(self._free_slots)
            return {
                "pages_total": self.n_pages - 1,  # scratch excluded
                "pages_in_use": in_use,
                "pages_shared": sum(1 for c in self._refs.values() if c > 1),
                "slots_total": self.max_slots,
                "slots_in_use": slots,
                "slot_occupancy": slots / float(self.max_slots),
                "storage_dtype": self.storage_dtype,
                "resident_bytes": self.row_bytes * self.n_pages * self.page_size,
            }


class _PrefixNode:
    __slots__ = ("page", "stamp")

    def __init__(self, page, stamp):
        self.page = page
        self.stamp = stamp


class PrefixCache:
    """Prompt-token trie over immutable full KV pages (module docstring)."""

    def __init__(self, pool, capacity_pages=None):
        self.pool = pool
        # default cap: the whole pool minus one slot's worst case, so the
        # cache alone can never wedge admission even before eviction runs
        if capacity_pages is None:
            capacity_pages = max(
                0, pool.n_pages - 1 - pool.max_pages_per_slot
            )
        self.capacity_pages = int(capacity_pages)
        self._lock = threading.Lock()
        self._nodes = {}  # tuple(prompt[:k*page_size]) -> _PrefixNode
        self._clock = 0
        self.hits = 0  # lookups that found >= 1 page
        self.misses = 0
        self.pages_hit = 0
        self.pages_eligible = 0
        self.evictions = 0

    def lookup(self, prompt):
        """Page ids for the longest cached prefix of `prompt`, capped so at
        least the final prompt token is always prefilled (its hidden state
        produces the first sampled logits). Each returned page is PINNED
        (+1 reference) so an eviction between lookup and acquire can never
        free it — the caller unpins once acquire() has taken the slot's own
        reference (or on admission failure). Counters feed the
        gen/prefix_hit_rate telemetry."""
        ps = self.pool.page_size
        prompt = tuple(int(t) for t in prompt)
        eligible = (len(prompt) - 1) // ps
        pages = []
        with self._lock:
            self._clock += 1
            for i in range(eligible):
                node = self._nodes.get(prompt[: (i + 1) * ps])
                if node is None:
                    break
                node.stamp = self._clock
                pages.append(node.page)
            self.pages_eligible += eligible
            self.pages_hit += len(pages)
            if pages:
                self.hits += 1
            elif eligible:
                self.misses += 1
        if pages:
            self.pool.pin_pages(pages)
        return pages

    def insert(self, prompt, table):
        """Publish a finished prefill's full prompt pages into the trie.
        Valid by the immutability invariant: pages 0..len(prompt)//ps - 1
        hold exactly the prompt tokens' K/V and nothing ever rewrites
        them. Already-cached depths are left alone."""
        ps = self.pool.page_size
        prompt = tuple(int(t) for t in prompt)
        n_full = len(prompt) // ps
        added = 0
        with self._lock:
            self._clock += 1
            for i in range(n_full):
                key = prompt[: (i + 1) * ps]
                if key in self._nodes:
                    self._nodes[key].stamp = self._clock
                    continue
                if len(self._nodes) >= self.capacity_pages:
                    if not self._evict_locked(1):
                        break
                page = int(table[i])
                if page == SCRATCH_PAGE:
                    break
                self.pool.pin_pages([page])
                self._nodes[key] = _PrefixNode(page, self._clock)
                added += 1
        return added

    def evict_for(self, n_pages):
        """Free up to `n_pages` unreferenced cached pages (LRU). Returns the
        number actually evicted — admission retries when > 0."""
        with self._lock:
            return self._evict_locked(n_pages)

    def _evict_locked(self, n_pages):
        # children before parents: a longer key is always at least as cold
        # as its prefix's extension, and dropping a parent first would leave
        # unreachable descendants pinned
        order = sorted(
            self._nodes.items(), key=lambda kv: (kv[1].stamp, -len(kv[0]))
        )
        evicted = 0
        for key, node in order:
            if evicted >= n_pages:
                break
            # only pages no slot is reading (our pin is the sole reference)
            if self.pool.page_refcount(node.page) != 1:
                continue
            if any(
                k != key and k[: len(key)] == key for k in self._nodes
            ):
                continue  # has live descendants; they sort earlier anyway
            del self._nodes[key]
            self.pool.unpin_pages([node.page])
            self.evictions += 1
            evicted += 1
        return evicted

    def reclaimable(self):
        """Cached pages only the trie holds — evictable on demand (the
        scheduler counts these as available when budgeting admissions)."""
        with self._lock:
            return sum(
                1
                for n in self._nodes.values()
                if self.pool.page_refcount(n.page) == 1
            )

    def clear(self):
        with self._lock:
            for node in self._nodes.values():
                self.pool.unpin_pages([node.page])
            n = len(self._nodes)
            self._nodes.clear()
            return n

    def stats(self):
        with self._lock:
            elig = self.pages_eligible
            return {
                "cached_pages": len(self._nodes),
                "capacity_pages": self.capacity_pages,
                "lookups_hit": self.hits,
                "lookups_miss": self.misses,
                "pages_hit": self.pages_hit,
                "pages_eligible": elig,
                "hit_rate": (self.pages_hit / elig) if elig else 0.0,
                "evictions": self.evictions,
            }
