"""Autoregressive generation serving: prefill/decode split over a paged
KV-cache pool, with token-level continuous batching (the torch counterpart
of paddle_tpu/serving/generation.py).

**GenerationEngine** builds exactly TWO variant families through
`executor.aot_serve_lowering(return_state=True)`:

- *prefill* — one CHUNK program per pow2 bucket up to `prefill_chunk`
  (batch 1): the chunk's rows take positions `gen_start + [0, t)`, write
  their K/V into the slot's pages, and attend the pool causally-by-position
  through the same `paged_attention` op decode uses — so a long prompt
  prefills as a sequence of fixed-shape chunk calls interleaved with decode
  steps by the scheduler, and a chunk at start 0 covering the whole prompt
  IS whole-prompt prefill.
- *decode* — ONE fixed shape, `[max_slots]`: every live slot advances one
  token through `paged_attention`. Idle slots ride along pointing at the
  scratch page.

Each variant is built once, at warmup(), as a callable over its lowered
block. On the card it is captured there as a CUDA graph (the JAX engine
compiles each variant at warmup): run once op by op and then captured, both
on feeds that touch only the scratch page (every block table entry and
position 0), so no real page is written; the hot loop replays the graphs,
so it never rebuilds or captures again whatever the prompt/output length
mix (`stats()["traces"]` counts the captures, on the CPU the builds, and is
the proof the smoke run asserts). A variant first asked for after warmup
is built and captured where it is asked for, on the scheduler thread. The
graphs share one memory pool: each call's fetches are copied to the host
before the next replay. The KV pools are preallocated on the device and every variant updates them in
place (kv_cache_write's index_copy_), the torch form of the JAX package's
donated pool buffers.
On a CUDA device paged_attention runs the hand-written kernels of
ops/paged_flash.py, over f32 pools or, for a model with kv_dtype="int8",
over int8 level pools with per-row f32 scale pools (about a quarter of the
f32 bytes a cached token, so twice the slots fit in fewer bytes);
`stats()["kernel_dispatches"]` counts the launches of each form.

Admission consults a **PrefixCache** (kv_cache.py): requests whose prompt
shares full cached pages with an earlier prompt start prefill at the first
uncached position, with the shared (refcounted, immutable) pages filling
the leading block-table entries.

**GenerationScheduler** extends ContinuousBatcher into a token-level
scheduler: the worker loop admits queued requests into free decode slots
*mid-batch* between steps, interleaves prefill chunks with decode under a
queue-pressure policy, runs one decode step for all live slots, and retires
slots on EOS/max-len, releasing their pages for reuse.

Sampling (greedy / temperature / top-k) happens host-side on the fetched
logits with a per-request counter-based RNG stream seeded from the scope
seed — so a request's tokens are a pure function of (params, prompt,
sampling config, seed), independent of which slot it lands in or who
shares the batch.
"""

import threading
import time

import numpy as np
import torch

from .. import flags as _flags
from ..executor import Scope, aot_serve_lowering, scope_guard
from ..ops import paged_flash as _pf
from ..place import to_device
from ..observability import tracing as _tracing
from ..observability.tracing import NULL_SPAN
from .batcher import (
    ContinuousBatcher,
    QueueFullError,
    RequestTimeout,
    ServingFuture,
    ShutdownError,
)
from .kv_cache import PagedKVPool, PoolExhausted, PrefixCache

__all__ = [
    "GenerationEngine",
    "GenerationScheduler",
    "GenRequest",
    "GenResult",
]


def _pow2_buckets(lo, hi):
    out = []
    b = max(2, lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(sorted(set(out)))


class GenRequest:
    """One generation request (validated by scheduler/engine entry points).
    temperature None/0 means greedy; top_k limits sampling to the k most
    likely tokens; seed pins the request's sample stream (defaults to a
    per-engine counter so concurrent requests draw independent streams)."""

    __slots__ = ("prompt", "max_new_tokens", "eos_id", "temperature",
                 "top_k", "seed")

    def __init__(self, prompt, max_new_tokens=16, eos_id=None,
                 temperature=None, top_k=None, seed=None):
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.temperature = None if not temperature else float(temperature)
        self.top_k = None if not top_k else int(top_k)
        self.seed = None if seed is None else int(seed)
        if not self.prompt:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class GenResult:
    __slots__ = ("tokens", "finish_reason", "prompt_len")

    def __init__(self, tokens, finish_reason, prompt_len):
        self.tokens = tokens
        self.finish_reason = finish_reason
        self.prompt_len = prompt_len


class _SlotRun:
    """Engine-side state of one admitted request occupying a decode slot."""

    __slots__ = ("req", "slot", "table", "tokens", "next_pos", "rng",
                 "pf_pos", "done", "finish_reason", "future", "t_submit",
                 "t_first", "span")

    def __init__(self, req, slot, table, rng):
        self.req = req
        self.slot = slot
        self.table = table
        self.tokens = []
        self.next_pos = len(req.prompt)
        self.rng = rng
        self.pf_pos = 0  # next prompt position to prefill (past prefix hits)
        self.done = False
        self.finish_reason = None
        self.future = None
        self.t_submit = None
        self.t_first = None
        self.span = NULL_SPAN

    def result(self):
        return GenResult(list(self.tokens), self.finish_reason,
                         len(self.req.prompt))


class _Variant:
    __slots__ = ("fn", "ro", "mut_names", "feed_names")

    def __init__(self, fn, ro, mut_names, feed_names):
        self.fn = fn
        self.ro = ro
        self.mut_names = mut_names
        self.feed_names = feed_names


class GenerationEngine:
    """Prefill/decode engine for one decoder model over one paged pool.

    `model` implements the GPTDecoder protocol: build_prefill / build_decode
    / kv_pool_names / ensure_params / d_model / max_context / eos_id (see
    models/gpt_decoder.py — the hook point for other decode-loop models).
    `place` (or `scope`'s device) picks the device: the card by default,
    the CPU only for an explicit CPUPlace().
    """

    def __init__(self, model, name="generation", scope=None, place=None,
                 max_slots=4, page_size=8, pool_pages=None, max_context=None,
                 prefill_buckets=None, prefill_chunk=None, prefix_cache=True,
                 cache_dir=None):
        if cache_dir is None:
            cache_dir = _flags.get_flags("serving_cache_dir")["serving_cache_dir"]
        if cache_dir:
            raise NotImplementedError(
                "cache_dir: the persistent compile cache is not ported; "
                "variants are built in-process at warmup()"
            )
        kv_dtype = getattr(model, "kv_dtype", "float32")
        self.model = model
        self.name = name
        self.max_context = int(max_context or model.max_context)
        if self.max_context > model.max_context:
            raise ValueError(
                "max_context %d exceeds the model's position table %d"
                % (self.max_context, model.max_context)
            )
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_pages = -(-self.max_context // self.page_size)
        if pool_pages is None:
            # full reservation capacity for every slot, plus scratch page 0
            pool_pages = self.max_slots * self.max_pages + 1
        self.pool_pages = int(pool_pages)
        self.pool = PagedKVPool(
            self.pool_pages, self.page_size, self.max_slots, self.max_pages,
            storage_dtype=kv_dtype,
        )
        # prefill builds one chunk program per pow2 bucket up to
        # prefill_chunk; prompts longer than the largest bucket run as a
        # sequence of chunk calls, so buckets stop growing with the context
        # window (default cap 32 rows: past that a chunk's FLOPs amortize
        # its launch and chunking wins back scheduler interleaving)
        chunk = int(prefill_chunk) if prefill_chunk else min(self.max_context, 32)
        self.prefill_buckets = tuple(sorted(set(
            int(b)
            for b in (
                prefill_buckets
                or _pow2_buckets(2, min(self.max_context, chunk))
            )
        )))
        if self.prefill_buckets[-1] > self.max_context:
            raise ValueError("prefill bucket > max_context")
        self.prefill_chunk = self.prefill_buckets[-1]
        # longest admissible prompt must leave room for >= 1 generated
        # token; chunking covers any prompt up to the context bound
        self.max_prompt_len = self.max_context - 1
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None

        if scope is None:
            scope = Scope(place=place)
        elif place is not None and to_device(place) != scope.device:
            raise ValueError("scope lives on %s, not on %r" % (scope.device, place))
        self.scope = scope
        self.device = scope.device
        # the memory pool every variant's graph captures into
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        model.ensure_params(self.scope, self.device)
        pool_rows = self.pool_pages * self.page_size
        self.kv_dtype = kv_dtype
        # the pools are preallocated once on the device; every variant writes
        # them in place. int8 pool mode (model.kv_dtype == "int8"): level
        # pools are int8 and each gains a [pool_rows] f32 per-row scale pool
        # sibling (model.kv_scale_names)
        self._state = {}
        for pair in model.kv_pool_names():
            for n in pair:
                arr = torch.zeros(
                    (pool_rows, model.d_model),
                    dtype=torch.int8 if kv_dtype == "int8" else torch.float32,
                    device=self.device,
                )
                self.scope.vars[n] = arr
                self._state[n] = arr
        for pair in getattr(model, "kv_scale_names", lambda: [])():
            for n in pair:
                # scale 1.0 everywhere: scratch-page reads dequantize to
                # finite values before they are masked
                arr = torch.ones((pool_rows,), dtype=torch.float32, device=self.device)
                self.scope.vars[n] = arr
                self._state[n] = arr
        self.kv_state_bytes = sum(
            a.numel() * a.element_size() for a in self._state.values()
        )
        self.pool.row_bytes = self.kv_state_bytes // pool_rows

        # persistent decode-step feed buffers: the hot loop allocates
        # nothing. Rows are slot-owned — armed when a slot's prefill
        # completes, refreshed for the runs in each step, zeroed (back to
        # the scratch page) at finish(). A mid-prefill slot therefore keeps
        # writing scratch during interleaved decode steps (its table row is
        # still zeros), and a live slot skipped by one step merely rewrites
        # its last K/V row with identical bits.
        self._dec_feeds = {
            "dec_tokens": np.zeros((self.max_slots, 1), np.int64),
            "dec_positions": np.zeros((self.max_slots, 1), np.int64),
            "dec_block_table": np.zeros(
                (self.max_slots, self.max_pages), np.int32
            ),
        }

        self._variants = {}
        self._build_lock = threading.Lock()
        self._sample_counter = 0
        self.tokens_generated = 0

        from ..observability import registry as _registry

        reg = _registry.default_registry()
        p = "serving/%s" % self.name
        self._m_tokens = reg.counter(p + "/gen_tokens", "tokens generated")
        self._m_prefills = reg.counter(p + "/gen_prefills", "prompts prefilled")
        self._m_steps = reg.counter(p + "/gen_steps", "decode steps executed")
        self._m_traces = reg.counter(
            p + "/traces", "generation variants built"
        )
        self._m_slots = reg.gauge(p + "/gen_slots_live", "live decode slots")
        self._m_slots_total = reg.gauge(
            p + "/gen_slots_total", "decode slot capacity of the KV pool"
        )
        self._m_slots_total.set(float(self.max_slots))
        self._m_occ = reg.gauge(
            p + "/gen_slot_occupancy", "live slots / max_slots"
        )
        self._m_pages = reg.gauge(
            p + "/gen_kv_pages_used", "KV pool pages in use"
        )
        self._m_step_ms = reg.histogram(
            p + "/gen_step_ms", "one decode step, wall ms"
        )
        self._m_prefill_ms = reg.histogram(
            p + "/gen_prefill_ms", "one prefill chunk call, wall ms"
        )
        self._m_chunks = reg.counter(
            p + "/gen_prefill_chunks", "prefill chunk calls executed"
        )
        self._m_prefix_hit = reg.gauge(
            p + "/gen_prefix_hit_rate",
            "prefix-cache page hit rate (pages hit / pages eligible)",
        )
        self._m_pages_shared = reg.gauge(
            p + "/gen_pages_shared", "KV pool pages held by > 1 reference"
        )
        self._m_paged_flash = reg.gauge(
            p + "/gen_paged_flash_dispatches",
            "paged flash-attention CUDA kernel launches",
        )
        self._m_kv_bytes = reg.gauge(
            p + "/gen_kv_bytes",
            "resident KV state bytes (level pools + scale pools)",
        )
        self._m_kv_bytes.set(float(self.kv_state_bytes))
        # precision label for the monitor's serve rows: 0 = fp32 pools
        self._m_precision = reg.gauge(
            p + "/precision",
            "KV storage precision (0 = fp32, 1 = int8)",
        )
        self._m_precision.set(1.0 if kv_dtype == "int8" else 0.0)
        # parameter hot swap (the JAX engine's set_params) is not ported:
        # the version a request was served by stays 0
        self.model_version = 0

    # ---- geometry / cache keys --------------------------------------------
    def geometry(self):
        return {
            "page_size": self.page_size,
            "pool_pages": self.pool_pages,
            "max_slots": self.max_slots,
            "max_pages": self.max_pages,
            "max_context": self.max_context,
            "kv_dtype": self.kv_dtype,
        }

    # ---- variants ---------------------------------------------------------
    def _variant(self, kind):
        """Stateful callable for 'decode' or 'prefill:<bucket>', built on
        first sight."""
        v = self._variants.get(kind)
        if v is not None:
            return v
        with self._build_lock:
            v = self._variants.get(kind)
            if v is not None:
                return v
            pool_rows = self.pool_pages * self.page_size
            if kind == "decode":
                main, _, feeds, fetches = self.model.build_decode(
                    self.max_slots, self.page_size, self.max_pages, pool_rows
                )
            elif kind.startswith("prefill:"):
                t = int(kind.split(":", 1)[1])
                main, _, feeds, fetches = self.model.build_prefill(
                    t, self.page_size, self.max_pages, pool_rows
                )
            else:
                raise ValueError("unknown variant kind %r" % kind)
            v = self._build_variant(kind, main, feeds, fetches)
            self._variants[kind] = v
            return v

    @property
    def traces(self):
        """Variants captured on the card (a lowering-flag flip captures a
        variant again: the JAX engine's compile-cache misses), built on the
        CPU."""
        if self.device.type != "cuda":
            return len(self._variants)
        return sum(v.fn.captures() for v in self._variants.values())

    def _build_variant(self, kind, main, feed_names, fetch_names):
        """Lower the variant's program and run it on scratch-only feeds (zero
        tokens, positions and block tables: every row it writes lands in the
        scratch page): on the card twice, the op-by-op warmup and then the
        capture, on the CPU once."""
        with scope_guard(self.scope):
            serve, ro, mut = aot_serve_lowering(
                main, feed_names, fetch_names, self.scope, return_state=True,
                graph_pool=self._graph_pool,
            )
        v = _Variant(serve, ro, sorted(mut), list(feed_names))
        block = main.global_block()
        scratch = {n: np.zeros(block.var(n).shape, block.var(n).dtype) for n in feed_names}
        cuda = self.device.type == "cuda"
        for _ in range(2 if cuda else 1):
            self._call(v, scratch)
        if not cuda:
            self._m_traces.inc()
        return v

    def warmup(self):
        """Build the decode step and every prefill bucket (captured on the
        card). Returns the variant count; after this the hot loop never
        builds or captures."""
        self._variant("decode")
        for b in self.prefill_buckets:
            self._variant("prefill:%d" % b)
        return len(self._variants)

    def _call(self, variant, np_feeds):
        """Run one variant (a graph replay on the card: the feeds are staged
        into its static buffers); returns its fetches as host numpy arrays
        (the copy back is the step's device sync, and ends before the next
        replay can overwrite them)."""
        feeds = {n: np_feeds[n] for n in variant.feed_names}
        mut_in = {n: self._state[n] for n in variant.mut_names}
        captured = variant.fn.captures()
        fetches, new_mut = variant.fn(feeds, variant.ro, mut_in)
        if variant.fn.captures() != captured:
            self._m_traces.inc(variant.fn.captures() - captured)
        self._state.update(new_mut)
        return [f.cpu().numpy() for f in fetches]

    # ---- admission / prefill / decode / retire -----------------------------
    def prefill_bucket(self, n):
        """Smallest chunk bucket covering `n` remaining prompt tokens, or
        the largest (= prefill_chunk) when the remainder spans chunks."""
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    def can_admit(self, req):
        """Whether a free slot + pages exist for this request right now."""
        budget = len(req.prompt) + self._max_new(req)
        return self.pool.can_admit(budget)

    def _max_new(self, req):
        # a request can never run past the context window
        return min(req.max_new_tokens, self.max_context - len(req.prompt))

    def free_slots(self):
        return self.max_slots - self.pool.stats()["slots_in_use"]

    def admit(self, req):
        """Reserve a slot + pages for one request — host work only, no
        device call. Prefix-cache hits fill the leading block-table entries
        and skip those pages' prefill; the caller then advances the prompt
        with prefill_step() until it returns True. Raises PoolExhausted
        when no capacity (after trying to evict cold cached pages),
        ValueError on an inadmissible request."""
        L = len(req.prompt)
        if L > self.max_prompt_len:
            raise ValueError(
                "prompt of %d tokens exceeds max_prompt_len %d"
                % (L, self.max_prompt_len)
            )
        max_new = self._max_new(req)
        shared = []
        if self.prefix_cache is not None:
            shared = self.prefix_cache.lookup(req.prompt)  # pages pinned
        try:
            try:
                slot, table = self.pool.acquire(L + max_new, shared)
            except PoolExhausted:
                need = self.pool.pages_for(L + max_new) - len(shared)
                if self.prefix_cache is None or not self.prefix_cache.evict_for(need):
                    raise
                slot, table = self.pool.acquire(L + max_new, shared)
        finally:
            if shared:
                self.pool.unpin_pages(shared)  # slot ref (or nothing) holds now
        seed = req.seed
        if seed is None:
            seed = (self.scope._seed, self._sample_counter)
            self._sample_counter += 1
        run = _SlotRun(req, slot, table, np.random.default_rng(seed))
        run.pf_pos = len(shared) * self.page_size
        self._set_pool_gauges()
        return run

    def prefill_step(self, run):
        """Advance one admitted run by ONE prefill chunk (one device call).
        Returns True when the prompt is fully prefilled — the first token
        has then been sampled and the run is decodable (or already done)."""
        req = run.req
        L = len(req.prompt)
        start = run.pf_pos
        remaining = L - start
        if remaining <= 0:
            raise ValueError("prefill_step on a fully prefilled run")
        c = self.prefill_bucket(remaining)
        n_real = min(c, remaining)
        tokens = np.zeros((1, c, 1), np.int64)
        tokens[0, :n_real, 0] = req.prompt[start:start + n_real]
        span = _tracing.current()
        if span:
            span = span.child(
                "engine.prefill", chunk=c, start=start, rows=n_real,
                kv_dtype=self.kv_dtype, model_version=self.model_version,
            )
        t0 = time.perf_counter()
        try:
            (logits,) = self._call(
                self._variant("prefill:%d" % c),
                {
                    "gen_tokens": tokens,
                    "gen_start": np.array([start], np.int64),
                    "gen_last": np.array([n_real - 1], np.int64),
                    "gen_pages": run.table,
                },
            )
        except Exception as e:
            span.error(e).end()
            raise
        prefill_ms = (time.perf_counter() - t0) * 1e3
        span.tag(device_ms=round(prefill_ms, 3)).end()
        self._m_prefill_ms.observe(prefill_ms)
        self._m_chunks.inc()
        run.pf_pos = start + n_real
        if run.pf_pos < L:
            return False
        self._m_prefills.inc()
        # parity surface: tests assert these rows bit-stable under
        # batching/admission/chunking changes (docs/serving.md contract)
        self.last_prefill_logits = logits[0]
        self._append_token(run, self.last_prefill_logits, self._max_new(req))
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, run.table)
        # arm the slot's persistent decode-feed rows only now: until the
        # last chunk lands, an interleaved decode step must keep this slot
        # on the scratch page, never writing a page a chunk already filled
        self._dec_feeds["dec_block_table"][run.slot] = run.table
        self._dec_feeds["dec_tokens"][run.slot, 0] = run.tokens[-1]
        self._dec_feeds["dec_positions"][run.slot, 0] = run.next_pos
        self._set_pool_gauges()
        return True

    def start(self, req):
        """Admit one request and run its whole prefill back-to-back,
        sampling the first token. Returns a _SlotRun (possibly already
        done). Raises PoolExhausted when no capacity, ValueError on an
        inadmissible request. The scheduler instead interleaves
        prefill_step() chunks with decode steps."""
        run = self.admit(req)
        try:
            while not self.prefill_step(run):
                pass
            return run
        except Exception:
            self.finish(run)
            raise

    def decode_step(self, runs):
        """One fixed-shape decode step advancing every run in `runs` by one
        token (all must be live). Finished runs are NOT auto-released — the
        caller retires them via finish()."""
        if not runs:
            return
        feeds = self._dec_feeds
        tokens, positions = feeds["dec_tokens"], feeds["dec_positions"]
        for run in runs:
            if run.done:
                raise ValueError("decode_step on a finished run")
            tokens[run.slot, 0] = run.tokens[-1]
            positions[run.slot, 0] = run.next_pos
        span = _tracing.current()
        if span:
            span = span.child(
                "engine.decode", slots=len(runs),
                kv_dtype=self.kv_dtype, model_version=self.model_version,
            )
        t0 = time.perf_counter()
        try:
            (logits,) = self._call(self._variant("decode"), feeds)
        except Exception as e:
            span.error(e).end()
            raise
        self.last_logits = logits  # parity surface, see prefill_step()
        step_ms = (time.perf_counter() - t0) * 1e3
        span.tag(device_ms=round(step_ms, 3)).end()
        self._m_step_ms.observe(step_ms)
        self._m_steps.inc()
        for run in runs:
            run.next_pos += 1
            self._append_token(run, logits[run.slot], self._max_new(run.req))

    def finish(self, run):
        """Retire a run's slot: pages return to the pool for reuse (cached
        prefix pages stay alive under the trie's reference) and the slot's
        persistent decode-feed rows drop back to the scratch page so the
        next tenant can't inherit a stale table."""
        self.pool.release(run.slot)
        self._dec_feeds["dec_block_table"][run.slot] = 0
        self._dec_feeds["dec_tokens"][run.slot] = 0
        self._dec_feeds["dec_positions"][run.slot] = 0
        self._set_pool_gauges()

    def _append_token(self, run, logits_row, max_new):
        tok = self._sample(logits_row, run.req, run.rng)
        run.tokens.append(tok)
        self.tokens_generated += 1
        self._m_tokens.inc()
        eos = run.req.eos_id
        if eos is None:
            eos = getattr(self.model, "eos_id", None)
        if eos is not None and tok == eos:
            run.done, run.finish_reason = True, "eos"
        elif len(run.tokens) >= max_new:
            run.done, run.finish_reason = True, "length"

    def _sample(self, logits, req, rng):
        if not req.temperature:
            # greedy stays on the raw fetch dtype: the float64 upcast can't
            # change the argmax winner and costs real time per decode step
            return int(np.asarray(logits).argmax())
        logits = np.asarray(logits, np.float64)
        z = logits / req.temperature
        if req.top_k and req.top_k < z.size:
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z = np.where(z < kth, -np.inf, z)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(z.size, p=p))

    def _set_pool_gauges(self):
        st = self.pool.stats()
        self._m_slots.set(st["slots_in_use"])
        self._m_occ.set(st["slot_occupancy"])
        self._m_pages.set(st["pages_in_use"])
        self._m_pages_shared.set(st["pages_shared"])
        self._m_paged_flash.set(sum(_pf.kernel_launches().values()))
        if self.prefix_cache is not None:
            self._m_prefix_hit.set(self.prefix_cache.stats()["hit_rate"])

    # ---- convenience / stats ----------------------------------------------
    def generate(self, prompt, max_new_tokens=16, **kw):
        """Serial one-request decode (no scheduler): admit, step to
        completion, retire. The whole-sequence tests' reference path."""
        req = GenRequest(prompt, max_new_tokens=max_new_tokens, **kw)
        run = self.start(req)
        try:
            while not run.done:
                self.decode_step([run])
        finally:
            self.finish(run)
        return run.result()

    def stats(self):
        out = {
            "variants": len(self._variants),
            "traces": self.traces,
            "model_version": self.model_version,
            "tokens_generated": self.tokens_generated,
            "prefill_buckets": list(self.prefill_buckets),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self._m_chunks.value(),
            "geometry": self.geometry(),
            "pool": self.pool.stats(),
            # CUDA kernel launches so far (process-wide, per launch — not per
            # build): the smoke run asserts both forms moved
            "kernel_dispatches": _pf.kernel_launches(),
            "kv": {
                "dtype": self.kv_dtype,
                "resident_bytes": self.kv_state_bytes,
            },
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        return out


class _Pending:
    __slots__ = ("req", "future", "t_submit", "span")

    def __init__(self, req, span=NULL_SPAN):
        self.req = req
        self.future = ServingFuture()
        self.t_submit = time.perf_counter()
        self.span = span


class GenerationScheduler(ContinuousBatcher):
    """Token-level continuous scheduler over a GenerationEngine.

    Reuses the ContinuousBatcher shell (bounded queue, condition variable,
    worker thread, outcome metrics, drain/shutdown) but replaces the batch
    dispatcher with a step loop:

      1. admit queued requests into free slots — normally at most
         `prefill_per_step` prefills per step (prefill latency rides on top
         of every live slot's token latency), escalating to ALL free slots
         when the queue is deeper than `pressure_queue` (throughput beats
         tail latency once a backlog forms);
      2. run ONE fixed-shape decode step for every live slot;
      3. retire finished slots (EOS / max-new / context bound), releasing
         their pages, and resolve their futures with GenResult.

    The queue is bounded in REQUESTS (one row each — a generation request's
    device debt is a slot, not its prompt length).
    """

    def __init__(self, engine, max_queue_requests=64, timeout_ms=30000.0,
                 prefill_per_step=1, pressure_queue=4):
        self.prefill_per_step = max(1, int(prefill_per_step))
        self.pressure_queue = int(pressure_queue)
        self._runs = {}  # slot -> _SlotRun
        self._prefills = []  # admitted runs still working through chunks
        self._drain_flag = True
        from ..observability import registry as _registry

        reg = _registry.default_registry()
        p = "serving/%s" % engine.name
        self._m_ttft_ms = reg.histogram(
            p + "/gen_ttft_ms", "submit -> first token, wall ms"
        )
        self._m_token_ms = reg.histogram(
            p + "/gen_token_ms", "per-token latency (decode step wall)"
        )
        super().__init__(
            engine,
            max_queue_rows=max_queue_requests,
            max_batch_delay_ms=0.0,
            timeout_ms=timeout_ms,
        )

    # ---- client side ------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None, temperature=None,
               top_k=None, seed=None, parent=None):
        """Enqueue one generation request; returns a ServingFuture resolving
        to a GenResult. `parent` optionally links the request's trace span
        under a caller span (or an X-Fleet-Trace header value)."""
        req = GenRequest(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            temperature=temperature, top_k=top_k, seed=seed,
        )
        if len(req.prompt) > self.engine.max_prompt_len:
            raise ValueError(
                "prompt of %d tokens exceeds max_prompt_len %d"
                % (len(req.prompt), self.engine.max_prompt_len)
            )
        pending = _Pending(req, span=_tracing.tracer().start_span(
            "serving.genrequest", parent=parent, model=self.engine.name,
            prompt_len=len(req.prompt), max_new=req.max_new_tokens,
        ))
        with self._cond:
            if not self._alive or self._draining:
                self._m_requests.inc(outcome="shutdown")
                pending.span.tag(outcome="shutdown").end("error")
                raise ShutdownError("scheduler is shut down")
            if self._queued_rows + 1 > self.max_queue_rows:
                self._m_requests.inc(outcome="rejected")
                pending.span.tag(outcome="rejected").end("error")
                raise QueueFullError(
                    "queue full (%d requests queued, limit %d)"
                    % (self._queued_rows, self.max_queue_rows)
                )
            pending.span.event("queued", depth=self._queued_rows)
            self._queue.append(pending)
            self._queued_rows += 1
            self._m_depth.set(self._queued_rows)
            self._cond.notify_all()
        return pending.future

    def run(self, prompt, timeout=None, **kw):
        return self.submit(prompt, **kw).result(
            self.timeout * 2 if timeout is None else timeout
        )

    # ---- step loop --------------------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while (self._alive and not self._queue and not self._runs
                       and not self._prefills):
                    self._cond.wait()
                if not self._alive:
                    if not self._drain_flag:
                        self._fail_runs_locked()
                        return
                    if (not self._queue and not self._runs
                            and not self._prefills):
                        return
                admits = self._admit_requests_locked()
            self._step(admits)

    def _admit_requests_locked(self):
        """Pop queued requests that fit free capacity right now. Admission
        is host-only (slot + page reservation); the chunk budget in _step
        governs device-side prefill pacing, so an in-flight chunked
        prefill never blocks admitting the next request — a short prompt
        admitted behind a long one overtakes it in the
        shortest-remaining-first chunk order. Pages held only by the
        prefix cache count as free — admit() evicts them on demand."""
        budget = self.prefill_per_step
        if len(self._queue) >= self.pressure_queue:
            budget = self.engine.max_slots
        pool = self.engine.pool
        st = pool.stats()
        slots_left = st["slots_total"] - st["slots_in_use"]
        pages_left = st["pages_total"] - st["pages_in_use"]
        if self.engine.prefix_cache is not None:
            pages_left += self.engine.prefix_cache.reclaimable()
        admits = []
        while self._queue and len(admits) < min(budget, slots_left):
            nxt = self._queue[0]
            if now_expired(nxt, self.timeout):
                self._queue.pop(0)
                self._queued_rows -= 1
                self._m_requests.inc(outcome="timeout")
                nxt.span.tag(outcome="timeout").end("error")
                nxt.future._set_error(RequestTimeout(
                    "queued %.0f ms > timeout %.0f ms"
                    % ((time.perf_counter() - nxt.t_submit) * 1e3,
                       self.timeout * 1e3)
                ))
                continue
            # reservation-aware: each admit here WILL acquire pages before
            # the pool state refreshes, so account for the whole batch
            need = pool.pages_for(
                len(nxt.req.prompt) + self.engine._max_new(nxt.req)
            )
            if need > pages_left:
                break
            pages_left -= need
            admits.append(self._queue.pop(0))
            self._queued_rows -= 1
        self._m_depth.set(self._queued_rows)
        return admits

    def _step(self, admits):
        eng = self.engine
        for pending in admits:
            queue_ms = (time.perf_counter() - pending.t_submit) * 1e3
            self._m_queue_ms.observe(queue_ms)
            try:
                run = eng.admit(pending.req)
            except PoolExhausted as e:
                # capacity raced away (shouldn't happen single-threaded,
                # but never drop a request on the floor)
                self._m_requests.inc(outcome="error")
                pending.span.error(e).tag(outcome="error").end()
                pending.future._set_error(e)
                continue
            except Exception as e:
                self._m_requests.inc(outcome="error")
                pending.span.error(e).tag(outcome="error").end()
                err = RuntimeError("admit failed: %s" % (repr(e),))
                err.__cause__ = e
                pending.future._set_error(err)
                continue
            run.future = pending.future
            run.t_submit = pending.t_submit
            run.span = pending.span
            run.span.tag(
                prefix_hit=run.pf_pos > 0, prefix_tokens=run.pf_pos,
                kv_dtype=eng.kv_dtype,
            ).event("admitted", slot=run.slot, queue_ms=round(queue_ms, 3))
            self._prefills.append(run)

        # advance prefill chunk-by-chunk: normally one chunk per step (its
        # latency rides on every live slot's token), draining every pending
        # prompt when the queue is deep OR when no slot is decoding (then
        # there is nobody to stall). Chunks go shortest-remaining-first, so
        # a short prompt admitted behind a half-prefilled long one
        # overtakes it and samples its first token next step — the
        # queue-pressure escalation bounds how long the long prompt can be
        # overtaken. TTFT starts at the chunk that samples the first token.
        if self._prefills:
            n_chunks = self.prefill_per_step
            if not self._runs or self._queued_rows >= self.pressure_queue:
                n_chunks = len(self._prefills)
            order = sorted(self._prefills,
                           key=lambda r: len(r.req.prompt) - r.pf_pos)
            for run in order[:n_chunks]:
                try:
                    with _tracing.tracer().activate(run.span):
                        finished = eng.prefill_step(run)
                except Exception as e:
                    self._prefills.remove(run)
                    self._m_requests.inc(outcome="error")
                    run.span.error(e).tag(outcome="error").end()
                    err = RuntimeError("prefill failed: %s" % (repr(e),))
                    err.__cause__ = e
                    run.future._set_error(err)
                    eng.finish(run)
                    continue
                if finished:
                    self._prefills.remove(run)
                    run.t_first = time.perf_counter()
                    ttft_ms = (run.t_first - run.t_submit) * 1e3
                    self._m_ttft_ms.observe(ttft_ms)
                    run.span.event("first_token", ttft_ms=round(ttft_ms, 3))
                    if run.done:
                        self._retire(run)
                    else:
                        self._runs[run.slot] = run

        live = list(self._runs.values())
        if live:
            t0 = time.perf_counter()
            try:
                # the decode step is shared across slots; its engine.decode
                # span hangs off one representative request's trace
                with _tracing.tracer().activate(live[0].span):
                    eng.decode_step(live)
            except Exception as e:
                for run in live:
                    self._m_requests.inc(outcome="error")
                    run.span.error(e).tag(outcome="error").end()
                    err = RuntimeError("decode failed: %s" % (repr(e),))
                    err.__cause__ = e
                    run.future._set_error(err)
                    eng.finish(run)
                self._runs.clear()
                return
            step_ms = (time.perf_counter() - t0) * 1e3
            for run in live:
                self._m_token_ms.observe(step_ms)
                if run.done:
                    del self._runs[run.slot]
                    self._retire(run)

    def _retire(self, run):
        self.engine.finish(run)
        self._m_requests.inc(outcome="ok")
        self._m_latency_ms.observe((time.perf_counter() - run.t_submit) * 1e3)
        run.span.tag(
            outcome="ok", finish_reason=run.finish_reason,
            tokens=len(run.tokens),
            decode_steps=max(0, len(run.tokens) - 1),
            model_version=self.engine.model_version,
        ).end()
        run.future._set_result(run.result())

    def _fail_runs_locked(self):
        for run in list(self._runs.values()) + self._prefills:
            self._m_requests.inc(outcome="shutdown")
            run.span.tag(outcome="shutdown").end("error")
            run.future._set_error(ShutdownError("scheduler closed"))
            self.engine.finish(run)
        self._runs.clear()
        del self._prefills[:]

    def close(self, drain=True, timeout=30.0):
        self._drain_flag = bool(drain)
        return super().close(drain=drain, timeout=timeout)

    def stats(self):
        with self._cond:
            return {
                "queued_requests": self._queued_rows,
                "live_slots": len(self._runs),
                "prefilling": len(self._prefills),
                "alive": self._alive,
            }


def now_expired(pending, timeout):
    return (time.perf_counter() - pending.t_submit) > timeout
