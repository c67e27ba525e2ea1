"""Executor: runs a block's ops as torch calls on one device (the torch
counterpart of paddle_tpu/executor.py).

Where the JAX package traces a whole block into one jitted XLA computation
(`jax.jit(run, donate_argnums=(2,))`), this executor prepares a block once
and, on the card, captures it as a CUDA graph:

- `_PerOpProfiledBlock` interprets the block straight-line (the reference's
  Executor::RunPreparedContext loop, executor.cc:389-396): each op's
  lowering is one or a few eager torch calls. It runs every block on the
  CPU (which has no graphs, and is asked for explicitly), blocks that
  create persistables (a startup program), blocks that hold an open-ended
  `while` (its condition is read on the host every iteration, which a
  capture cannot do), and, on the card, the diagnosis mode: while the
  profiler is on and FLAGS_profile_ops is set, never cached, with an event
  and a device sync per op (the JAX package's `_PerOpProfiledBlock`, taken
  at the same point).
- `_CompiledBlock` is the card's form, and the one place that decides
  whether a block captures. A block that creates persistables or holds an
  open-ended `while` runs op by op every call, counted under that reason
  in `Executor.stats()["op_by_op"]` ("creates_persistables",
  "open_ended_while"), through Executor.run and serving alike. Otherwise
  call 1 of a cache key runs op by op
  on a side stream: the warmup a capture needs (kernel libraries load, lazy
  buffers and the arrival counters of that stream are made, the allocator
  warms). Call 2 captures the block as a CUDA graph and replays it once,
  so the state advances once per call. Later calls replay. A capture or a
  replay that fails raises; nothing carries on op by op. The graphs of one
  Executor (or of one GenerationEngine) share one memory pool, so each
  feed shape does not keep a step's intermediates of its own.
- `_SegmentedBlock` runs a block that holds host ops (save / load,
  detection_map) or prints at its top level: each maximal run of device
  ops is a block of its own (a `_CompiledBlock` on the card, captured
  under the rule above), and the host ops and prints run between the
  replays, so a print prints on every run (the JAX package's
  `_SegmentedBlock`). A block holding one anywhere else (inside a
  sub-block, or served) runs op by op, under the reason "host_op".
- FLAGS_check_nan_inf scans the fetches and the persistables a run wrote
  once it has run (after the replay on the graph path). FLAGS_benchmark
  synchronizes the device before a run returns.
- The resilience step guard (FLAGS_resilience_nan_guard, the JAX package's
  Executor._skip_nan_step): before a run that updates persistables, each
  of them is copied on its device into a buffer the executor keeps; a run
  whose fetches or updated state hold a NaN or an Inf (one device
  reduction, one host sync) is rolled back to those copies bit for bit,
  its `learning_rate*` and `*loss_scaling*` vars are multiplied by
  FLAGS_resilience_lr_decay, and health counts `nan_steps_skipped` and
  `lr_decays`. The `nan_grad` fault (resilience/faults.py) poisons the
  first floating feed of such a run before it reaches the block. Every run
  entry beats the elastic watchdog (resilience/elastic.py heartbeat).
- Observability (observability/): with telemetry active (FLAGS_telemetry_
  dir or _log_every) every run records a step (host wall, cache hit, the
  guard's trip, the loss when the fetch is already on the host: no sync of
  its own). FLAGS_tensor_stats instruments the matched ops' outputs: their
  [mean, std, absmax, nonfinite] are computed on the device as each value
  is final, inside the captured graph on the card, and read with one host
  sync a run; the pattern is part of the cache key. FLAGS_nan_provenance:
  when the guard or FLAGS_check_nan_inf trips, the step is replayed op by
  op from its pre-step state and the generator state it started from
  (_localize_nan), naming the first op with a non-finite output.

State model: a Scope holds name -> torch.Tensor on one device. Persistable
vars the block reads are state; those it also writes (parameters written by
a startup program, KV pools written by kv_cache_write) come back as updated
state. A lowering may update a state tensor in place (kv_cache_write and
the fused Adam do), which is the torch form of the JAX package's donated
buffers. A graph reads and writes the tensors it captured: a written state
tensor that a lowering did not update in place is copied back into its
input inside the graph, so the scope's tensors keep their addresses; a
state name rebound in the scope (io.load_*, scope.set_var) to a tensor of
the same shape and dtype is copied into the captured one before a replay,
and any other change raises.

Placement: an Executor takes the card (CUDAPlace(0)) unless given a
place; with no CUDA device and no explicit CPUPlace() it raises. A Scope
made without a place, the process scope (global_scope()) among them, takes
the device of the first executor that runs on it.
"""

import contextlib
import itertools
import sys
import threading
import time
import types

import numpy as np
import torch

from . import flags as _flags
from . import framework
from . import profiler as _prof
from .framework import Variable
from .observability.opprof import op_display_name
from .ops import fused, registry
from .ops.control_flow_ops import is_open_ended_while, walk_ops
from .ops.registry import EMPTY_VAR_NAME
from .place import to_device

__all__ = [
    "Executor",
    "Scope",
    "global_scope",
    "scope_guard",
    "aot_serve_lowering",
    "export_block",
]

class Scope:
    """name -> device tensor store (reference scope.h:134, flat) on one
    device, plus the torch.Generators that random ops draw from. A scope
    made without a place takes the device of the first executor that runs
    on it (as the reference's Scope(seed) has none); `place=` binds it at
    once."""

    _uid_counter = itertools.count()

    def __init__(self, seed=0, place=None):
        self._device = None if place is None else to_device(place)
        self.vars = {}
        self._seed = seed
        self._generator = None  # lazy, like the JAX package's rng key
        self._device_generator = None
        self._uid = next(Scope._uid_counter)
        # name -> (mesh, axis) of the vars held as this rank's rows only
        # (parallel/collectives.py shard_state: ZeRO-1 moments, ep tables)
        self.row_shards = {}

    @property
    def device(self):
        """The scope's torch.device; an unbound scope that is asked for it
        before any executor ran on it takes the card (CUDAPlace(0))."""
        if self._device is None:
            self._device = to_device(None)
        return self._device

    def drop_kids(self):
        """A no-op, as in the reference (paddle_tpu/executor.py:264): the
        scope is flat, with no child scopes to drop."""

    def bind(self, device):
        """The scope's device, binding an unbound scope to `device` (the
        process scope takes the first executor's)."""
        if self._device is None:
            self._device = torch.device(device)
        return self._device

    @property
    def generator(self):
        """CPU torch.Generator seeded from the scope seed: a startup
        program's random init draws on the host, so a seed gives the same
        parameters on every device."""
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(int(self._seed))
        return self._generator

    @generator.setter
    def generator(self, value):
        self._generator = value

    @property
    def device_generator(self):
        """torch.Generator on the scope's device, seeded from the scope
        seed: the stochastic ops of every block but a startup program
        (dropout, the random ops) draw on the device from it, with no host
        round trip, and a CUDA graph registers it."""
        if self._device_generator is None:
            self._device_generator = torch.Generator(device=self.device).manual_seed(
                int(self._seed)
            )
        return self._device_generator

    def reseed(self, seed):
        """Restart both generators from `seed` (an explicit
        program.random_seed, as the JAX package rekeys its rng)."""
        self._seed = int(seed)
        self._generator = self._device_generator = None

    def find_var(self, name):
        return self.vars.get(name)

    def var_names(self):
        """reference scope.h LocalVarNames()"""
        return list(self.vars)

    def var(self, name):
        return self.vars.setdefault(name, None)

    def set_var(self, name, value):
        self.vars[name] = value


_global_scope = None
_scope_tls = threading.local()


def _scope_stack():
    st = getattr(_scope_tls, "stack", None)
    if st is None:
        st = _scope_tls.stack = []
    return st


def global_scope():
    """The innermost scope_guard's scope, else the process scope: created on
    first use with no device, it takes the device of the first executor
    that runs on it (the card if it is asked for its device first)."""
    global _global_scope
    st = _scope_stack()
    if st:
        return st[-1]
    if _global_scope is None:
        _global_scope = Scope()
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack().append(self.scope)

    def __exit__(self, *args):
        _scope_stack().pop()


def _var_dtype(block, name):
    v = block.vars.get(name)
    if v is None and block.has_var_recursive(name):
        v = block._var_recursive(name)
    if v is None or v.dtype is None:
        return None
    return registry.torch_dtype(v.dtype)


def to_tensor(value, device, dtype=None):
    """A feed value (numpy array, scalar or tensor) as a tensor on `device`
    with `dtype` (the declared var dtype), copying only when needed."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        value = torch.from_numpy(np.ascontiguousarray(arr))
    return value.to(device=device, dtype=dtype)


def _apply_pass_pipeline(program, scope, feed_names, fetch_names, pipeline=None):
    """The single choke point where graph passes rewrite a program before it
    runs (paddle_tpu_torch/passes). `pipeline` None defers to
    FLAGS_pass_pipeline; ""/"off"/() returns the program untouched. The
    rewritten program is memoized per (program version, pipeline, scope,
    feed/fetch), so repeated runs hand the executor the SAME object and its
    block cache stays hot."""
    if pipeline is None:
        pipeline = _flags.get_flags("pass_pipeline")["pass_pipeline"]
    from .passes import manager as _pm

    if not _pm.resolve_pipeline(pipeline):
        return program
    out = _pm.apply_cached(
        program, pipeline, scope=scope,
        feed_names=feed_names, fetch_names=fetch_names,
    )
    # the sharding rules live on the Program object (sharding_rules.
    # program_rules): the rewritten program shares the source's rule set, so
    # a placement survives the pipeline
    rules = getattr(program, "_sharding_rules", None)
    if out is not program and rules is not None:
        out._sharding_rules = rules
    return out


# the flags a lowering reads while it lowers (the paged attention tier, the
# quant GEMM tier, the fp8 product policy, the pass pipeline): a captured
# graph holds what they chose, so each value takes a graph of its own
_LOWERING_FLAGS = ("paged_flash", "quantized_gemm", "fp8_matmul", "pass_pipeline")


def _lowering_flags():
    return tuple(sorted(_flags.get_flags(_LOWERING_FLAGS).items()))


def _profile_ops():
    """Whether calls take the op-by-op diagnosis path: the profiler is on and
    FLAGS_profile_ops is set (the JAX package's condition)."""
    return _prof.is_profiling() and _flags.get_flags("profile_ops")["profile_ops"]


def _dtype_name(v):
    """A feed value's dtype by one name whatever holds it: a numpy array's
    float32 and a tensor's torch.float32 are both "float32"."""
    name = str(getattr(v, "dtype", type(v).__name__))
    return name[len("torch."):] if name.startswith("torch.") else name


def _feed_signature(feed):
    """(name, shape, dtype) of each feed value: a graph's feed buffers have
    one shape, so the executor keys its blocks on them as the JAX package
    keys its compiled blocks. A batch pulled from a reader (tensors staged
    on the device) keys as the same batch fed as numpy arrays."""
    return tuple(sorted(
        (n, tuple(np.shape(v)), _dtype_name(v)) for n, v in feed.items()
    ))


def _run_label(run):
    """A unit of registry.op_runs as the per-op profiler names it: the op's
    type, or the fused family, and its first output."""
    op = run[-1]
    outs = [n for n in op.output_arg_names if n != EMPTY_VAR_NAME]
    kind = op.type if len(run) == 1 else "fused_%s" % run[0].attrs.get(
        registry.PALLAS_KERNEL_ATTR)
    return "op/%s:%s" % (kind, outs[0] if outs else "")


def _exec_ops(block):
    """The ops of `block` an executor runs (not the feed / fetch markers);
    raises for an op without a lowering."""
    unknown = sorted(
        {op.type for op in walk_ops(block.ops) if not registry.is_registered(op.type)}
    )
    if unknown:
        raise NotImplementedError("ops without lowering: %s" % unknown)
    return [op for op in block.ops if not registry.get(op.type).skip_exec]


def _call_host(op, scope):
    with _prof.RecordEvent("host_op/%s" % op.type):
        registry.get(op.type).host_fn(op, scope)
    fused.note_segment("host")


def _flags_opprof():
    return _flags.get_flags(("tensor_stats", "nan_provenance"))


def _stat_row(v):
    """[mean, std, absmax, nonfinite] of a float tensor as one f32 tensor on
    its device (FLAGS_tensor_stats; None for anything else)."""
    if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
        return None
    x = v.detach().float()
    if not x.numel():
        return torch.zeros(4, dtype=torch.float32, device=x.device)
    return torch.stack([x.mean(), x.std(correction=0), x.abs().amax(),
                        (~torch.isfinite(x)).sum().float()])


class _PerOpProfiledBlock:
    """A block prepared for straight-line execution, op by op: the op list
    in the units a run lowers and the names each unit leaves dead (dropped
    after their last reader, so a run holds only live intermediates), the
    state split (read-only vs written persistables), the persistables the
    block creates, the declared feed dtypes, and the per-op values that
    outlive a run (LowerCtx.cache). Its call is the CPU's form of a run and
    the card's diagnosis form; `per_op` brackets every op (or fused run) in
    a profiler event and, on the card, syncs the device after it, so the
    event holds the op's device time too (the reference's per-op tables)."""

    def __init__(self, block, feed_names, fetch_names, scope, ops=None, mesh=None,
                 tensor_stats=""):
        self.feed_names = list(feed_names)
        # a ParallelExecutor's block: its lowerings see this rank's mesh
        # (ctx.mesh), and `plan` (parallel_executor._ParallelPlan, set by
        # the PE past one rank or under sharding rules) brings the
        # gradients to their parameters' layouts and averages them over
        # the batch axes before the first optimizer unit, and runs the
        # ZeRO-1 updates. `sharding` is the PE's Resolver (the fused
        # families decline on what it places) and `stored` the layouts of
        # the state this rank holds as pieces (sharding_rules.storage_specs):
        # with any, every run follows its values' layouts
        # (sharding_rules.Layouts)
        self.mesh = mesh
        self.plan = None
        self.sharding = None
        self.stored = None
        self.fetch_names = list(fetch_names)
        self.ops = _exec_ops(block) if ops is None else list(ops)
        self.stochastic = any(registry.get(op.type).stochastic for op in walk_ops(self.ops))
        self.open_ended_while = any(is_open_ended_while(op) for op in walk_ops(self.ops))
        # a host op or a print a capture would run once (Executor.run splits
        # a block at its top-level ones instead; one inside a sub-block, or
        # in a served block, keeps the block op by op)
        self.host_ops = any(registry.get(op.type).splits_graph for op in walk_ops(self.ops))
        self.cache = {}

        # classify external inputs: fed names are args; persistable names found
        # in the scope are state; anything else must be produced by the block
        produced = set()
        state_names = []
        fed = set(self.feed_names)
        for op in self.ops:
            for name in op.input_arg_names:
                if name == EMPTY_VAR_NAME:
                    continue
                if name in fed or name in produced or name in state_names:
                    continue
                if scope.find_var(name) is not None:
                    state_names.append(name)
                else:
                    raise RuntimeError(
                        "variable %r used by op %s is neither fed, in scope, nor "
                        "produced earlier in the block" % (name, op)
                    )
            produced.update(n for n in op.output_arg_names if n != EMPTY_VAR_NAME)
        for name in self.fetch_names:
            if name not in fed and name not in produced and name not in state_names:
                if scope.find_var(name) is not None:
                    state_names.append(name)
                else:
                    raise RuntimeError("fetch var %r has no value" % name)

        persistable = {
            name
            for name in state_names + list(produced)
            if block.has_var_recursive(name) and block._var_recursive(name).persistable
        }
        self.mut_names = sorted(set(state_names) & produced)
        self.ro_names = sorted(set(state_names) - produced)
        self.created_persistables = sorted((persistable & produced) - set(state_names) - fed)
        self.feed_dtypes = {n: _var_dtype(block, n) for n in self.feed_names}
        # why the card may not capture this block (None: it captures)
        if self.created_persistables:
            self.capture_declined = "creates_persistables"
        elif self.open_ended_while:
            self.capture_declined = "open_ended_while"
        elif self.host_ops:
            self.capture_declined = "host_op"
        else:
            self.capture_declined = None
        # FLAGS_tensor_stats: (display name, var) of the matched ops'
        # outputs, whose statistics a run computes on the device as each
        # value is final (before it is dropped, or at the end), stacked
        # into one [n, 4] tensor (`tstat`: (names, tensor) of the last run)
        self.tstat_spec = ()
        if tensor_stats:
            from .observability import opprof

            self.tstat_spec = opprof.stats_spec(self.ops, tensor_stats)
        self.tstat = None
        self.runs = list(registry.op_runs(self.ops))
        self.dead = registry.dead_after(
            self.runs, set(self.fetch_names) | set(self.mut_names) | set(self.created_persistables))

        # cross-check against the inplace_donation_plan pass when one rode in
        # on this program AND it analyzed this exact run (the global block,
        # not a pserver's optimize sub-block; same scope, feed,
        # fetch, nothing unanalyzable): divergence means a pass corrupted
        # def-use, so fail loudly
        plan = getattr(block.program, "_donation_plan", None)
        if (
            ops is None
            and block.idx == 0  # the plan analyzed the global block
            and plan
            and not plan.get("unknown")
            and plan.get("scope_uid") == scope._uid
            and plan.get("feed") == sorted(self.feed_names)
            and list(plan.get("fetch", ())) == list(self.fetch_names)
            and (plan["mut"] != self.mut_names or plan["ro"] != self.ro_names)
        ):
            raise RuntimeError(
                "inplace_donation_plan disagrees with the block's state "
                "classification: plan mut=%s ro=%s vs mut=%s ro=%s — a pass "
                "likely corrupted def-use edges"
                % (plan["mut"], plan["ro"], self.mut_names, self.ro_names)
            )

    def fn(self, feeds, ro_state, mut_state, ctx, per_op=False, scope=None):
        """Run the block: (fetches, new_mut, created). `feeds` are tensors on
        ctx.device in their declared dtypes. A host op runs in line on a
        view of `scope` (the op-by-op path of a block that holds one)."""
        env = {}
        env.update(ro_state)
        env.update(mut_state)
        env.update(feeds)
        sync = per_op and ctx.device.type == "cuda"
        plan = self.plan
        stats = {} if self.tstat_spec else None
        watched = {var for _, var in self.tstat_spec}
        if self.stored:
            from .parallel.sharding_rules import Layouts

            ctx.layout = Layouts(self.mesh, self.stored)
        for i, (run, dead) in enumerate(zip(self.runs, self.dead)):
            if plan is not None and i == plan.sync_at:
                with _prof.RecordEvent("dp/grad_sync"):
                    plan.sync(env, ctx.layout)
            lower = self._lower if plan is None or i not in plan.zero1_units else plan.lower
            if per_op:
                with _prof.RecordEvent(_run_label(run)):
                    lower(ctx, run, env, scope)
                    if sync:
                        torch.cuda.synchronize(ctx.device)
            else:
                lower(ctx, run, env, scope)
            # an intermediate is dropped after its last reader, so the
            # step's memory (and a captured graph's pool) holds only what
            # is live
            for n in dead:
                if stats is not None and n in watched:
                    stats[n] = _stat_row(env.get(n))
                env.pop(n, None)
        if stats is not None:
            self._stack_stats(stats, env)
        return self._results(env, ctx)

    def _stack_stats(self, stats, env):
        for _, var in self.tstat_spec:
            if var not in stats:
                stats[var] = _stat_row(env.get(var))
        present = [(name, stats[var]) for name, var in self.tstat_spec
                   if stats[var] is not None]
        self.tstat = (tuple(n for n, _ in present),
                      torch.stack([r for _, r in present])) if present else None

    def _results(self, env, ctx):
        """(fetches, new_mut, created) of a run's env: a fetched piece is
        gathered whole, written state goes back in its stored layout."""
        layout = ctx.layout
        if layout is not None:
            ctx.layout = None
            for n in self.fetch_names:
                env[n] = layout.whole(n, env[n])
            for n in self.mut_names:
                want = self.stored.get(n)
                have = layout.spec(n, env[n])
                if have != want:
                    env[n] = layout.convert(env[n], have, want)
        fetches = [env[n] for n in self.fetch_names]
        new_mut = {n: env[n] for n in self.mut_names}
        # an op may legally omit a declared output slot — only bind names
        # that actually materialized
        created = {n: env[n] for n in self.created_persistables if n in env}
        return fetches, new_mut, created

    def _lower(self, ctx, run, env, scope):
        op = run[0]
        if not registry.get(op.type).is_host:
            registry.lower_run(ctx, run, env)
            return
        # a host op sees a scratch view of the scope, so the run's
        # intermediates do not leak into it (the JAX package's
        # _PerOpProfiledBlock)
        before = set(scope.vars)
        scope.vars.update(env)
        _call_host(op, scope)
        env.update(scope.vars)
        for name in set(scope.vars) - before:
            if name not in self.mut_names and name not in self.created_persistables:
                scope.vars.pop(name, None)

    def ctx(self, scope, is_test=False):
        return registry.LowerCtx(
            scope.device, generator=scope.generator, is_test=is_test,
            device_generator=scope.device_generator, cache=self.cache,
            host_random=bool(self.created_persistables), mesh=self.mesh,
            sharding=self.sharding,
        )

    def state(self, scope):
        return ({n: scope.vars[n] for n in self.ro_names},
                {n: scope.vars[n] for n in self.mut_names})

    def run(self, scope, feeds, ro, mut, is_test=False, per_op=False):
        """(fetches, new_mut, created) of one op-by-op run over the state
        `ro` and `mut`; `feeds` are cast onto the scope's device."""
        feeds = {n: to_tensor(v, scope.device, self.feed_dtypes.get(n))
                 for n, v in feeds.items()}
        return self.fn(feeds, ro, mut, self.ctx(scope, is_test), per_op, scope)

    def __call__(self, scope, feeds, per_op=False):
        ro, mut = self.state(scope)
        fetches, new_mut, created = self.run(scope, feeds, ro, mut, per_op=per_op)
        scope.vars.update(new_mut)
        scope.vars.update(created)
        return fetches


_capture_streams = {}
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _on_capture_stream(device):
    """Run the body on the device's capture stream, ordered after the
    current stream's work and before its later work: a block's warmup call
    makes the per-stream state (arrival counters, library workspaces) its
    capture then finds."""
    with _capture_lock:
        stream = _capture_streams.get(device)
        if stream is None:
            stream = _capture_streams[device] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        cur.wait_stream(stream)


class _FeedStage:
    """A graph's feed buffers on the device, one per feed in its declared
    dtype (the value's where none is declared), filled from host values
    through pinned buffers of their own by copies queued on the stream."""

    def __init__(self, names, dtypes, feeds, device):
        self.bufs, self._pinned, self._copied = {}, {}, None
        for n in names:
            v = feeds[n]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            self.bufs[n] = torch.empty(v.shape, dtype=dtypes.get(n) or v.dtype, device=device)

    def fill(self, feeds):
        """Copy `feeds` into the buffers: a value already on the device by a
        device-to-device copy, a host value through its pinned buffer,
        waiting first (once) for the last copy out of the pinned buffers to
        have run. A fill of device values alone never waits on the host."""
        waited = False
        for n, buf in self.bufs.items():
            v = feeds[n]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(buf.shape):
                raise ValueError("feed %r: shape %s, the graph was captured at %s"
                                 % (n, tuple(v.shape), tuple(buf.shape)))
            if v.device == buf.device:
                buf.copy_(v)
                continue
            if not waited and self._copied is not None:
                self._copied.synchronize()  # the pinned buffers' last copies have run
            waited = True
            pin = self._pinned.get(n)
            if pin is None:
                pin = self._pinned[n] = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            pin.copy_(v)
            buf.copy_(pin, non_blocking=True)
        if waited:
            self._copied = torch.cuda.Event()
            self._copied.record()


@contextlib.contextmanager
def _counted_capture():
    """Around a CUDA graph capture (which runs nothing): takes what the
    kernel wrappers and fused lowerings counted during it back out, into
    the [(counter dict, counts)] it yields, which _add_counts adds again at
    every replay."""
    counts = []
    before = [(d, dict(d)) for d in fused.counter_dicts()]
    try:
        yield counts
    finally:
        for d, b in before:
            counts.append((d, {k: v - b.get(k, 0) for k, v in d.items() if v != b.get(k, 0)}))
            d.clear()
            d.update(b)


def _add_counts(counts):
    for d, delta in counts:
        for k, v in delta.items():
            d[k] = d.get(k, 0) + v


class _CudaGraph:
    """One prepared block captured as a CUDA graph over static feed buffers
    and the state tensors given at capture, replayed by `replay`. Its
    intermediates live in `pool` (a torch graph pool handle, which graphs
    replayed one at a time may share; None: a pool of its own).

    Generators: the scope's device generator (where the block draws random
    numbers) and every pinned-seed generator of the block's cache are
    registered with the graph, so a replay advances the former's Philox
    offset exactly as an eager run does; the latter restart from their
    seeds before every replay. Counters: what the kernel wrappers and fused
    lowerings counted during the capture (which ran nothing) is taken back
    out, and added at every replay. `state_copies` counts the state
    tensors a replay had to copy into the captured ones (a rebound value):
    a hot swap that copies into the captured tensors itself leaves it
    still."""

    def __init__(self, block, feeds, ro, mut, ctx, pool=None):
        from .ops import fused

        device = ctx.device
        self.ro, self.mut = dict(ro), dict(mut)
        self.state_copies = 0
        self._ptrs = {n: t.data_ptr() for d in (ro, mut) for n, t in d.items()}
        self.stage = _FeedStage(block.feed_names, block.feed_dtypes, feeds, device)
        self.stage.fill(feeds)
        self.device_generator = ctx.device_generator if block.stochastic else None
        self.seeded = registry.seeded_generators(ctx.cache)
        self.graph = torch.cuda.CUDAGraph()
        if self.device_generator is not None:
            self.graph.register_generator_state(self.device_generator)
        for gen, _ in self.seeded:
            self.graph.register_generator_state(gen)
        with _counted_capture() as self.counts, _on_capture_stream(device) as stream:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                fetches, new_mut, _ = block.fn(self.stage.bufs, self.ro, self.mut, ctx)
                for n, t in new_mut.items():
                    held = self.mut[n]
                    if t.data_ptr() != held.data_ptr():
                        held.copy_(t)
                    elif t.shape != held.shape or t.stride() != held.stride():
                        raise RuntimeError("%r: written as a different view of its storage" % n)
        self.fetches = fetches
        # FLAGS_tensor_stats: the capture's stats tensor, which every replay
        # rewrites
        self.tstat = block.tstat

    def replay(self, feeds, ro, mut):
        """(fetches, mut) of one replay over `feeds`; `ro` and `mut` are the
        state the caller holds now, each name's tensor the captured one or a
        rebound tensor of the same shape and dtype, copied into it. The
        fetches are the graph's own tensors, overwritten by the next
        replay of any graph of its pool."""
        for given, held in ((ro, self.ro), (mut, self.mut)):
            for n, t in given.items():
                cur = held[n]
                if t is cur and t.data_ptr() == self._ptrs[n]:
                    continue
                if (t is cur or t.shape != cur.shape or t.dtype != cur.dtype
                        or t.device != cur.device):
                    raise RuntimeError(
                        "state %r changed under a captured CUDA graph: %s %s on %s, captured "
                        "%s %s on %s (a rebound value must keep the shape and dtype)"
                        % (n, tuple(t.shape), t.dtype, t.device, tuple(cur.shape), cur.dtype,
                           cur.device))
                with torch.no_grad():
                    cur.copy_(t)
                self.state_copies += 1
        self.stage.fill(feeds)
        for gen, seed in self.seeded:
            gen.manual_seed(seed)
        self.graph.replay()
        _add_counts(self.counts)
        return self.fetches, self.mut


class _CompiledBlock:
    """A prepared block in the card's form: call 1 runs it op by op on the
    capture stream (the warmup a capture needs), call 2 captures it as a
    CUDA graph in `pool` and replays it, later calls replay. The Executor
    keeps one under each cache key, a _ServeBlock one for each value of the
    lowering flags. A block whose capture_declined is set (a startup
    program, a block holding an open-ended while) runs op by op every
    call, counted under that reason (ops.fused.OP_BY_OP)."""

    def __init__(self, block, pool, is_test=False):
        self.block = block
        self.pool = pool
        self.is_test = is_test
        self._warm = False
        self.graph = None

    def run(self, scope, feeds, ro, mut):
        """(fetches, new_mut, created) of one call over the state `ro` and
        `mut`; once captured, the fetches are the graph's own tensors.
        Only a block that declines capture creates persistables."""
        block = self.block
        if block.capture_declined is not None:
            fused.note_op_by_op(block.capture_declined)
            return block.run(scope, feeds, ro, mut, self.is_test)
        if not self._warm:
            with _on_capture_stream(scope.device):
                fetches, new_mut, _ = block.run(scope, feeds, ro, mut, self.is_test)
            self._warm = True
            return fetches, new_mut, {}
        ctx = block.ctx(scope, self.is_test)
        if self.graph is None:
            # the warmup's intermediates, cached by the allocator, go back
            # to the card before the capture fills the graph's own pool
            torch.cuda.empty_cache()
            self.graph = _CudaGraph(block, feeds, ro, mut, ctx, self.pool)
            fused.note_graph("captures")
        elif block.stochastic and ctx.device_generator is not self.graph.device_generator:
            raise RuntimeError("the scope's device generator was replaced (reseeded) after "
                               "its block was captured")
        fused.note_graph("replays")
        return self.graph.replay(feeds, ro, mut) + ({},)

    def tensor_stats(self):
        """(names, [n, 4] tensor) of the last call's FLAGS_tensor_stats."""
        return self.graph.tstat if self.graph is not None else self.block.tstat

    def __call__(self, scope, feeds):
        """One Executor.run over the scope's state: the fetches. From the
        capture on, the scope holds the captured tensors."""
        ro, mut = self.block.state(scope)
        fetches, new_mut, created = self.run(scope, feeds, ro, mut)
        scope.vars.update(new_mut)
        scope.vars.update(created)
        if self.graph is not None:
            scope.vars.update(self.graph.ro)
        return fetches


class _MultiStepBlock:
    """k steps of one block in one call (the JAX package's _MultiStepBlock,
    which scans the block's lowering over stacked feeds in one XLA call).

    `inner` is the block form one step runs through: on the CPU a
    _PerOpProfiledBlock, on the card the _CompiledBlock of the same cache
    key a single-step run takes (its graph is captured at the key's second
    step and replayed after). The stacked feeds (a leading k axis) go to
    the device in one copy a feed, through a pinned buffer of the call's
    own; each step's feeds are views of them, which a replay copies device
    to device into its feed buffers, and each step's fetches are copied
    device to device into stacked outputs. Nothing between the steps waits on the host, and
    the call's fetches come back with one host synchronization
    (`to_host`). The state advances through the scope as k single runs
    advance it, the device generator's Philox offset included (a replay
    advances it as an eager run does), so the result is k single runs bit
    for bit."""

    def __init__(self, inner, steps_per_run):
        if steps_per_run < 1:
            raise ValueError("steps_per_run must be >= 1")
        prepared = _prepared(inner)
        if prepared.created_persistables:
            raise RuntimeError(
                "steps_per_run>1 requires a block that creates no new persistables (run the "
                "startup program separately first); this block creates %s"
                % prepared.created_persistables)
        self.inner = inner
        self.block = prepared
        self.steps_per_run = int(steps_per_run)

    def _stage(self, stacked, device):
        """The stacked feeds on `device`: one copy a feed."""
        out = {}
        for n, v in stacked.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(np.asarray(v)))
            if t.shape[:1] != (self.steps_per_run,):
                raise ValueError("feed %r: leading axis %s, steps_per_run=%d"
                                 % (n, tuple(t.shape[:1]), self.steps_per_run))
            dtype = self.block.feed_dtypes.get(n) or t.dtype
            if device.type == "cuda" and t.device.type == "cpu":
                # a pinned buffer of this call's own: the caching host
                # allocator records the queued copy out of it and hands the
                # memory out again only once that copy has run, so a later
                # call cannot overwrite a batch still waiting for the card
                pin = torch.empty(t.shape, dtype=dtype, pin_memory=True)
                pin.copy_(t)
                t = pin.to(device, non_blocking=True)
            else:
                t = t.to(device=device, dtype=dtype)
            out[n] = t
        return out

    def __call__(self, scope, stacked):
        """The fetches of k steps, each stacked [k, ...] on the device."""
        feeds = self._stage(stacked, scope.device)
        outs = None
        for i in range(self.steps_per_run):
            fetches = self.inner(scope, {n: v[i] for n, v in feeds.items()})
            if outs is None:
                outs = [torch.empty((self.steps_per_run,) + tuple(f.shape), dtype=f.dtype,
                                    device=f.device) for f in fetches]
            for o, f in zip(outs, fetches):
                o[i].copy_(f)
        return outs

    @staticmethod
    def to_host(fetches):
        """numpy copies of the stacked fetches after one host
        synchronization: on the card each is copied into pinned memory
        behind the call's work, and the host waits once."""
        if not fetches or fetches[0].device.type != "cuda":
            return [(f.float() if f.dtype == torch.bfloat16 else f).detach()
                    .to("cpu", copy=True).numpy() for f in fetches]
        host = []
        for f in fetches:
            f = f.float() if f.dtype == torch.bfloat16 else f
            pin = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
            pin.copy_(f, non_blocking=True)
            host.append(pin)
        torch.cuda.current_stream(fetches[0].device).synchronize()
        return [h.numpy() for h in host]


class _PipelinedBlock(_PerOpProfiledBlock):
    """A training block as a microbatch pipeline over the mesh's pp axis
    (the JAX package's _PipelinedBlock, paddle_tpu/executor.py:753).

    1. The ops split by op role: the forward (Forward / Loss), the backward
       (not run: torch.autograd differentiates each stage's lowered
       forward), and the optimizer section (Optimize / LRSched), run after
       the pipeline on every rank as in the single-device block, so ZeRO-1,
       lr schedules and clipping compose unchanged.
    2. The forward is cut into pp contiguous stages: `device_guard("pp:k")`
       annotations (framework.PIPELINE_STAGE_ATTR) win, else
       parallel.partition balances the analytic per-op time plus parameter
       bytes over the legal cuts (every value crossing a cut leads with the
       microbatch, so it can be sent a microbatch at a time). The shapes
       come from the forward lowered once on meta tensors at the
       microbatch's size.
    3. Each pp rank lowers only its stage's ops, one microbatch at a time
       (the GEMM epilogue and layer_norm kernels are differentiable,
       flash_attention takes its autograd form under ctx.autograd), under
       the schedule of parallel.pipeline (GPipe or 1F1B); boundary values
       and their gradients go between pp neighbours by point-to-point
       sends.
    4. The microbatch gradients sum into each parameter's `@GRAD` (a stage
       holds its own parameters' and zeros for the rest); the plan
       (parallel_executor._ParallelPlan) sums them over pp and averages
       them over dp, then the optimizer section runs. Every rank keeps
       every parameter, updated alike, so a checkpoint needs no gather.

    The last stage's scalar fetches (the loss first) are microbatch means
    (exact for batch-mean losses), sent to every pp rank. Raised as in the
    JAX package: a parameter read by two stages, a fetch not computed in
    the last stage, a non-scalar loss, no loss (ValueError), a forward op
    that writes state (NotImplementedError)."""

    def __init__(self, block, feed_names, fetch_names, scope, mesh, loss_name=None,
                 n_micro=None, schedule="gpipe"):
        from .framework import OpRole

        if schedule not in ("gpipe", "1f1b"):
            raise ValueError("pipeline schedule must be 'gpipe' or '1f1b', got %r" % (schedule,))
        if mesh.axis_size("pp") < 2:
            raise ValueError("_PipelinedBlock needs a mesh with pp >= 2")
        super().__init__(block, feed_names, fetch_names, scope, mesh=mesh)
        self.schedule = schedule
        self._n_micro = n_micro
        self.pp = mesh.axis_size("pp")
        self.stage = mesh.index("pp")

        def role(op):
            return int(op.attrs.get(OpRole.OP_ROLE_KEY, 0) or 0)

        skip = OpRole.Backward | OpRole.Optimize | OpRole.LRSched
        self.fwd_ops = [op for op in self.ops if not role(op) & skip]
        self.opt_ops = [op for op in self.ops if role(op) & (OpRole.Optimize | OpRole.LRSched)]
        self.opt_runs = list(registry.op_runs(self.opt_ops))
        if not self.fwd_ops:
            raise RuntimeError("pipeline lowering: block has no forward ops")
        state = set(self.ro_names) | set(self.mut_names)
        self.params = sorted({n for op in self.opt_ops for n in op.inputs.get("Param", ())}
                             & state)
        written = sorted({n for op in self.fwd_ops for n in op.output_arg_names} & state)
        if written:
            raise NotImplementedError(
                "pipeline-parallel lowering cannot thread forward-op state updates (%s) "
                "through the microbatch schedule; run these on a non-pp mesh" % (written,))
        if loss_name is None:
            for op in self.fwd_ops:
                if role(op) & OpRole.Loss:
                    outs = [n for n in op.output_arg_names if n != EMPTY_VAR_NAME]
                    if outs:
                        loss_name = outs[0]
                        break
        if loss_name is None:
            raise ValueError("pipeline parallelism needs the loss: pass loss_name= to "
                             "ParallelExecutor (no op in the block carries the Loss role)")
        self.loss_name = loss_name
        self.stage_plan = None
        self._plan_key = None

    # ------------------------------------------------------------ the cut
    def _prepare(self, feeds, state):
        """The stage plan for these feed shapes (once a block)."""
        from .parallel import partition

        batch = {n: v for n, v in feeds.items() if v.dim() > 0}
        if not batch:
            raise ValueError("pipeline lowering needs at least one batch-major feed")
        b = next(iter(batch.values())).shape[0]
        for n, v in batch.items():
            if v.shape[0] != b:
                raise ValueError("batch feeds disagree on batch size: %r has %d, expected %d"
                                 % (n, v.shape[0], b))
        m = int(self._n_micro or self.pp)
        if b % m:
            raise ValueError("dp-local batch %d not divisible into %d microbatches (set "
                             "ExecutionStrategy.num_microbatches)" % (b, m))
        mb = b // m
        env = {n: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
               for n, t in state.items()}
        for n, v in feeds.items():
            shape = (mb,) + tuple(v.shape[1:]) if n in batch else tuple(v.shape)
            env[n] = torch.empty(shape, dtype=v.dtype, device="meta")
        ctx = registry.LowerCtx("meta")
        recs = []
        for op in self.fwd_ops:
            registry._lower_one(ctx, op, env)
            recs.append({n: env[n] for n in op.output_arg_names
                         if n != EMPTY_VAR_NAME and n in env})
        producers = {}
        for i, rec in enumerate(recs):
            for n, t in rec.items():
                producers.setdefault(n, []).append((i, t))
        if self.loss_name not in producers:
            raise ValueError("loss %r is not produced by the forward ops" % self.loss_name)
        loss_idx = producers[self.loss_name][-1][0]
        n_ops = len(self.fwd_ops)
        crossing = [dict() for _ in range(max(n_ops - 1, 0))]
        for j, op in enumerate(self.fwd_ops):
            for n in op.input_arg_names:
                plist = [(i, t) for i, t in producers.get(n, []) if i < j]
                if not plist:
                    continue
                i, t = plist[-1]
                for k in range(i, min(j, n_ops - 1)):
                    crossing[k][n] = t

        def packable(t):
            return t.dim() >= 1 and t.shape[0] == mb

        legal = [k for k in range(n_ops - 1)
                 if k < loss_idx and all(packable(t) for t in crossing[k].values())]
        stages = partition.stages_from_attrs(self.fwd_ops, self.pp)
        if stages is None:
            weights = []
            for j, op in enumerate(self.fwd_ops):
                ins = {slot: [_aval(self._meta_of(n, j, producers, env))
                              for n in names if n != EMPTY_VAR_NAME]
                       for slot, names in op.inputs.items()}
                outs = {slot: [_aval(recs[j].get(n)) for n in names]
                        for slot, names in op.outputs.items()}
                weights.append(partition.analytic_op_time_us(op.type, ins, outs))
            seen = set()
            for j, op in enumerate(self.fwd_ops):
                for n in op.input_arg_names:
                    if n in self.params and n not in seen:
                        seen.add(n)
                        t = state[n]
                        weights[j] += t.numel() * t.element_size() / partition._PEAK_BW_BYTES_PER_US
            stages = partition.balanced_partition(weights, legal, self.pp)
        else:
            legal_set = set(legal)
            for k in range(n_ops - 1):
                if stages[k + 1] != stages[k] and k not in legal_set:
                    bad = {n: tuple(t.shape) for n, t in crossing[k].items() if not packable(t)}
                    raise ValueError(
                        "device_guard cut after op %d (%s) is illegal: values crossing it are "
                        "not microbatch-major or the loss would leave the last stage: %s"
                        % (k, self.fwd_ops[k].type, bad or {"loss": self.loss_name}))
        if sorted(set(stages)) != list(range(self.pp)):
            raise ValueError(
                "pipeline partition produced stages %s for pp=%d; every pp rank needs a "
                "non-empty stage (annotate with device_guard('pp:k') or lower pp)"
                % (sorted(set(stages)), self.pp))
        param_stage = {}
        for j, op in enumerate(self.fwd_ops):
            for n in op.input_arg_names:
                if n in self.params:
                    s0 = param_stage.setdefault(n, stages[j])
                    if s0 != stages[j]:
                        raise ValueError(
                            "parameter %r is read by pipeline stages %d and %d; pin its "
                            "consumers to one stage with device_guard" % (n, s0, stages[j]))
        stage_ops = [[] for _ in range(self.pp)]
        for op, s in zip(self.fwd_ops, stages):
            stage_ops[s].append(op)
        cuts = []
        for s in range(self.pp - 1):
            k = max(j for j in range(n_ops) if stages[j] == s)
            cuts.append([(n, tuple(crossing[k][n].shape), crossing[k][n].dtype)
                         for n in sorted(crossing[k])])
        ext = set(feeds) | set(state)
        scal = [self.loss_name] + [n for n in self.fetch_names if n != self.loss_name
                                   and n in producers and n not in ext]
        scal_entries = []
        for n in scal:
            i, t = producers[n][-1]
            if stages[i] != self.pp - 1:
                raise ValueError(
                    "the pp lowering can only fetch values computed in the LAST pipeline "
                    "stage; %r is computed in stage %d — pin its ops with device_guard or drop "
                    "the fetch" % (n, stages[i]))
            scal_entries.append((n, tuple(t.shape), t.dtype))
        if int(np.prod(scal_entries[0][1])) != 1:
            raise ValueError("loss %r must be scalar, got shape %s"
                             % (self.loss_name, scal_entries[0][1]))
        opt_out = {n for op in self.opt_ops for n in op.output_arg_names}
        grads = {n + "@GRAD" for n in self.params}
        for n in self.fetch_names:
            if n in ext or n in scal or n in opt_out or n in grads:
                continue
            raise ValueError(
                "fetch %r is a non-last-stage intermediate; under pp the block returns only "
                "last-stage scalars, state, feeds and optimizer outputs" % n)
        stage_params = [[] for _ in range(self.pp)]
        for j, op in enumerate(self.fwd_ops):
            for n in op.input_arg_names:
                if n in self.params and n not in stage_params[stages[j]]:
                    stage_params[stages[j]].append(n)
        self._cuts, self._scal, self._stage_ops = cuts, scal_entries, stage_ops
        self._batch, self._m, self._mb = set(batch), m, mb
        self._stage_params = stage_params
        self.stage_plan = {
            "schedule": self.schedule, "n_micro": m, "microbatch": mb,
            "op_stage": [int(s) for s in stages],
            "stages": [[op.type for op in ops] for ops in stage_ops],
            "stage_params": [list(ns) for ns in stage_params],
            "boundaries": [[e[0] for e in ents] for ents in cuts],
        }

    def _meta_of(self, name, j, producers, env):
        plist = [t for i, t in producers.get(name, []) if i < j]
        return plist[-1] if plist else env.get(name)

    # ------------------------------------------------------------ a run
    def fn(self, feeds, ro_state, mut_state, ctx, per_op=False, scope=None):
        from .parallel import pipeline
        from .parallel.collectives import _sum

        state = dict(ro_state)
        state.update(mut_state)
        key = tuple((n, tuple(v.shape), v.dtype) for n, v in sorted(feeds.items()))
        if self._plan_key != key:
            self._prepare(feeds, state)
            self._plan_key = key
        stage = _Stage(self, feeds, state, ctx)
        with torch.enable_grad():
            pipeline.SCHEDULES[self.schedule](stage, self._m, self.pp, self.stage)
        env = dict(state)
        env.update(feeds)
        for n in self.params:
            leaf = stage.leaves.get(n)
            g = leaf.grad if leaf is not None else None
            env[n + "@GRAD"] = (torch.zeros_like(state[n]) if g is None
                                else g.detach().to(state[n].dtype))
        last = self.stage == self.pp - 1
        for (n, shape, dtype), acc in zip(self._scal, stage.scalars or [None] * len(self._scal)):
            val = acc / self._m if last else torch.zeros(shape, dtype=torch.float32,
                                                         device=ctx.device)
            env[n] = _sum(val, "pp", self.mesh, "broadcast").to(dtype)
        plan = self.plan
        for i, run in enumerate(self.opt_runs):
            if plan is not None and i == plan.sync_at:
                with _prof.RecordEvent("pp/grad_sync"):
                    plan.sync(env, None)
            if plan is not None and i in plan.zero1_units:
                plan.lower(ctx, run, env, scope)
            else:
                registry.lower_run(ctx, run, env)
        fetches = [env[n] for n in self.fetch_names]
        new_mut = {n: env[n] for n in self.mut_names}
        return fetches, new_mut, {}


def _aval(t):
    """A meta tensor as the (shape, numpy dtype) record partition counts
    (bfloat16 as float16: numpy has no bfloat16, and only the width
    counts)."""
    if t is None:
        return None
    dtype = str(t.dtype).replace("torch.", "").replace("bfloat16", "float16")
    return types.SimpleNamespace(shape=tuple(t.shape), dtype=np.dtype(dtype))


class _Stage:
    """One rank's stage of a pipelined step: the eight steps the schedules
    of parallel.pipeline call. Parameters enter as leaves that accumulate
    their gradient over the microbatches; a received boundary value is a
    leaf whose gradient goes back to the previous stage."""

    def __init__(self, block, feeds, state, ctx):
        import torch.distributed as dist

        self.b = block
        self.ctx = ctx
        self.device = ctx.device
        s = block.stage
        self.leaves = {}
        base = {n: t for n, t in state.items()}
        for n in block._stage_params[s]:
            leaf = state[n].detach().requires_grad_(True)
            self.leaves[n] = leaf
            base[n] = leaf
        self.base = base
        self.feeds = feeds
        self.saved = {}
        self.scalars = None
        group = block.mesh.group("pp")
        self.prev = dist.get_global_rank(group, s - 1) if s > 0 else None
        self.next = dist.get_global_rank(group, s + 1) if s < block.pp - 1 else None
        self.cut_in = block._cuts[s - 1] if s > 0 else []
        self.cut_out = block._cuts[s] if s < block.pp - 1 else []
        self.lower_ctx = registry.LowerCtx(
            ctx.device, generator=ctx.generator, device_generator=ctx.device_generator,
            cache=ctx.cache, host_random=False, mesh=None, autograd=True)

    @staticmethod
    def _floating(entries):
        return [e for e in entries if e[2].is_floating_point]

    def _recv(self, entries, peer):
        from .parallel.collectives import send_recv

        if peer is None:
            return None
        return send_recv(recvs=[(shape, dtype, self.device, peer) for _, shape, dtype in entries])

    def _send(self, tensors, peer):
        from .parallel.collectives import send_recv

        if peer is not None:
            send_recv(sends=[(t, peer) for t in tensors])

    def recv_fwd(self, i):
        return self._recv(self.cut_in, self.prev)

    def send_fwd(self, y):
        self._send(y or [], self.next)

    def recv_bwd(self, i):
        return self._recv(self._floating(self.cut_out), self.next)

    def send_bwd(self, gx):
        self._send(gx or [], self.prev)

    def send_fwd_recv_bwd(self, y, i):
        from .parallel.collectives import send_recv

        if self.next is None:
            return None
        return send_recv(sends=[(t, self.next) for t in y],
                         recvs=[(shape, dtype, self.device, self.next)
                                for _, shape, dtype in self._floating(self.cut_out)])

    def send_bwd_recv_fwd(self, gx, i):
        from .parallel.collectives import send_recv

        if self.prev is None:
            return None
        return send_recv(sends=[(t, self.prev) for t in gx],
                         recvs=[(shape, dtype, self.device, self.prev)
                                for _, shape, dtype in self.cut_in])

    def fwd(self, i, x):
        """Microbatch i's forward: its boundary values for the next stage
        (the last stage keeps the scalars instead)."""
        b = self.b
        env = dict(self.base)
        mb = b._mb
        for n, v in self.feeds.items():
            env[n] = v.narrow(0, i * mb, mb) if n in b._batch else v
        inputs = []
        for (n, _, dtype), t in zip(self.cut_in, x or []):
            if dtype.is_floating_point:
                t.requires_grad_(True)
                inputs.append(t)
            env[n] = t
        registry.lower_ops(self.lower_ctx, b._stage_ops[b.stage], env)
        outs = [env[n] for n, _, _ in self.cut_out]
        if b.stage == b.pp - 1:
            vals = [env[n].reshape(shape).float() for n, shape, _ in b._scal]
            self.saved[i] = (vals[0], inputs)
            vals = [v.detach() for v in vals]
            self.scalars = vals if self.scalars is None else [
                a + v for a, v in zip(self.scalars, vals)]
            return None
        self.saved[i] = (outs, inputs)
        return [t.detach() for t in outs]

    def bwd(self, i, g):
        """Microbatch i's backward: the gradients of its received values."""
        b = self.b
        roots, inputs = self.saved.pop(i)
        if b.stage == b.pp - 1:
            roots, grads = [roots], [torch.full_like(roots, 1.0 / b._m)]
        else:
            flo = [t for (_, _, dtype), t in zip(self.cut_out, roots) if dtype.is_floating_point]
            pairs = [(t, gt) for t, gt in zip(flo, g) if t.requires_grad]
            roots, grads = [p[0] for p in pairs], [p[1] for p in pairs]
        want = list(self.leaves.values()) + inputs
        if roots and want:
            torch.autograd.backward(roots, grads, inputs=want)
        return [t.grad if t.grad is not None else torch.zeros_like(t) for t in inputs]


class _SegmentedBlock:
    """A block that holds host ops (save / load, detection_map: ops that
    run on the host) or device ops with a host effect (print), run as
    alternating device segments and host calls (the JAX package's
    _SegmentedBlock, paddle_tpu/executor.py:1587).

    The block is split at those ops into maximal runs of device ops. Each
    run is a block of its own (_PerOpProfiledBlock over its ops), built at
    its first execution so that what an earlier host op wrote is in the
    scope by then; on the card it is a _CompiledBlock, captured as a CUDA
    graph at its second call and replayed after, every segment into the
    executor's one pool. The segments replay in their capture order, one at
    a time, so a later segment's intermediates may reuse an earlier one's;
    what a segment exports (the names a later segment, a host op or a fetch
    reads) are its graph's own output tensors, which stay allocated, and
    the scope holds them across the host calls. A host op runs between
    replays on the scope; a print lowers eagerly there, so it prints on
    every run. Feeds a device segment reads reach it through its own feed
    buffers; feeds a host op or a print reads enter the scope."""

    def __init__(self, block, feed_names, fetch_names, pool, capture, is_test=False):
        self.block = block
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.pool = pool
        self.capture = capture  # on the card: segments capture
        self.is_test = is_test
        self.ops = _exec_ops(block)
        self.feed_dtypes = {n: _var_dtype(block, n) for n in self.feed_names}
        # [("device", [ops]) | ("host", op)]
        self.segments = []
        cur = []
        for op in self.ops:
            if registry.get(op.type).splits_graph:
                if cur:
                    self.segments.append(("device", cur))
                    cur = []
                self.segments.append(("host", op))
            else:
                cur.append(op)
        if cur:
            self.segments.append(("device", cur))
        # each device segment's exports: what it produces that a later
        # segment, a host op or a fetch reads; and the feeds it reads
        later = set(self.fetch_names)
        fed = set(self.feed_names)
        self._exports = [None] * len(self.segments)
        self._feeds = [None] * len(self.segments)
        self.scope_feeds = set()
        for i in range(len(self.segments) - 1, -1, -1):
            kind, payload = self.segments[i]
            ops = payload if kind == "device" else [payload]
            reads = {n for op in ops for n in op.input_arg_names}
            if kind == "device":
                produced = {n for op in ops for n in op.output_arg_names}
                self._exports[i] = sorted((produced & later) - {EMPTY_VAR_NAME})
                self._feeds[i] = sorted(reads & fed)
            else:
                self.scope_feeds |= reads & fed
            later |= reads
        self.scope_feeds |= fed & set(self.fetch_names)
        self._compiled = [None] * len(self.segments)
        # the persistables any op writes: FLAGS_check_nan_inf scans them
        self.mut_names = sorted(
            {n for op in self.ops for n in op.output_arg_names
             if n != EMPTY_VAR_NAME and block.has_var_recursive(n)
             and block._var_recursive(n).persistable})

    def _segment(self, i, scope):
        compiled = self._compiled[i]
        if compiled is None:
            compiled = _PerOpProfiledBlock(self.block, self._feeds[i], self._exports[i], scope,
                                           ops=self.segments[i][1])
            if self.capture:
                compiled = _CompiledBlock(compiled, self.pool, self.is_test)
            self._compiled[i] = compiled
        return compiled

    def captures(self):
        """How many of its device segments are captured."""
        return sum(getattr(c, "graph", None) is not None for c in self._compiled)

    def __call__(self, scope, feeds):
        for n in self.scope_feeds:
            scope.set_var(n, to_tensor(feeds[n], scope.device, self.feed_dtypes.get(n)))
        ctx = None
        for i, (kind, payload) in enumerate(self.segments):
            if kind == "host":
                opdef = registry.get(payload.type)
                if opdef.is_host:
                    _call_host(payload, scope)
                    continue
                # a device op with a host effect, lowered eagerly between
                # the segments
                if ctx is None:
                    ctx = registry.LowerCtx(
                        scope.device, generator=scope.generator, is_test=self.is_test,
                        device_generator=scope.device_generator, host_random=False)
                env = {n: scope.vars[n] for n in payload.input_arg_names
                       if n != EMPTY_VAR_NAME}
                with _prof.RecordEvent("inline_op/%s" % payload.type):
                    registry.lower_run(ctx, [payload], env)
                for n in payload.output_arg_names:
                    if n in env:
                        scope.set_var(n, env[n])
                fused.note_segment("inline")
                continue
            with _prof.RecordEvent("device_segment_%d" % i):
                vals = self._segment(i, scope)(scope, {n: feeds[n] for n in self._feeds[i]})
            for name, val in zip(self._exports[i], vals):
                scope.set_var(name, val)
            fused.note_segment("device")
        return [scope.find_var(n) for n in self.fetch_names]


def _splits(block):
    """Whether `block` holds a host op or a print at its top level."""
    return any(registry.is_registered(op.type) and registry.get(op.type).splits_graph
               for op in block.ops)


def _prepared(compiled):
    """The _PerOpProfiledBlock or _SegmentedBlock behind a block form."""
    return compiled.block if isinstance(compiled, _CompiledBlock) else compiled


def _run_ops(compiled):
    """The op list behind any block form, for the check_nan_inf report."""
    return _prepared(compiled).ops


def _written_persistables(compiled):
    inner = _prepared(compiled)
    return list(inner.mut_names) + list(getattr(inner, "created_persistables", ()))


def _last_writer(compiled, name):
    """Display name of the last op in program order that writes `name`, or
    None: the suspect the check_nan_inf report names."""
    found = None
    for op in _run_ops(compiled):
        if name in op.output_arg_names:
            found = op_display_name(op)
    return found


def _mutated(compiled):
    """The persistables a run of `compiled` updates: the guard's snapshot
    set (empty for a startup program, which only creates)."""
    inner = compiled.block if isinstance(compiled, (_CompiledBlock, _MultiStepBlock)) \
        else compiled
    return list(getattr(inner, "mut_names", ()) or ())


def _elastic_heartbeat():
    from .resilience.elastic import heartbeat

    heartbeat()


def _floating(v):
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.asarray(v).dtype.kind == "f"


def _poison_nan(feed):
    """The `nan_grad` fault's payload: the first floating feed (by name)
    filled with NaN, which reaches the loss, the gradients and every updated
    parameter. Returns (feed, poison_after): poison_after means no feed is
    floating (an integer-only model), and the caller poisons the updated
    state after the run instead."""
    out = dict(feed)
    for name in sorted(out):
        v = out[name]
        if not _floating(v):
            continue
        if isinstance(v, torch.Tensor):
            out[name] = torch.full_like(v, float("nan"))
        else:
            out[name] = np.full_like(np.asarray(v), np.nan)
        return out, False
    return out, True


def _poison_scope_state(scope, names):
    """The fallback payload: the first floating updated persistable NaN."""
    for name in sorted(names):
        v = scope.vars.get(name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            scope.vars[name] = torch.full_like(v, float("nan"))
            return


def _all_finite(values):
    """True iff every floating tensor of `values` is finite, with one host
    sync: the max-abs norms of all of them in one multi-tensor call (a NaN
    or an Inf element makes its norm NaN or Inf, and a finite tensor's is
    finite), then one reduction."""
    floats = [v for v in values
              if isinstance(v, torch.Tensor) and v.is_floating_point() and v.numel()]
    if not floats:
        return True
    norms = torch._foreach_norm(floats, float("inf"), dtype=torch.float32)
    return bool(torch.isfinite(torch.stack(norms)).all())


def _check_nan_inf(compiled, scope, fetch_names, fetches, step, provenance=None):
    """FLAGS_check_nan_inf (the reference's operator.cc:778; the JAX
    package's Executor._finish_run): the fetches and the persistables the
    block writes reduce to one flag on the device, read with one host
    sync; only when it trips are they rescanned one by one to name the
    variable, and its last writer, in the FloatingPointError."""
    watched = list(zip(fetch_names, fetches)) + [
        (n, scope.vars[n]) for n in _written_persistables(compiled)
        if scope.vars.get(n) is not None]
    if _all_finite([v for _, v in watched]):
        return
    for name, val in watched:
        if not (isinstance(val, torch.Tensor) and val.is_floating_point()):
            continue
        if not bool(torch.isfinite(val).all()):
            msg = "check_nan_inf: variable %r contains NaN/Inf" % name
            writer = _last_writer(compiled, name)
            if writer is not None:
                msg += ", last written by op %s" % writer
            msg += " (run step %d)" % step
            # FLAGS_nan_provenance: the step replayed op by op (from the
            # state it left: right for a feed or activation NaN,
            # approximate for one born inside the update)
            prov = provenance() if provenance is not None else None
            if prov is not None:
                msg += "; first non-finite output at op #%s %s" % (
                    prov.get("op_index"), prov.get("op"))
            raise FloatingPointError(msg)


def _generator_states(scope):
    """(host, device) generator states of the scope, as a step starts."""
    return (scope.generator.get_state(), scope.device_generator.get_state())


def _localize_nan(compiled, scope, feed, gen_states, reason, step=None, mut_override=None):
    """FLAGS_nan_provenance: replay the failed step's feed through
    opprof.localize_nonfinite over the block's op list, op by op, against
    the step's PRE-state (`mut_override` = the guard's pre-step copies when
    it has them, else the scope as it is) and the generator states it
    started from (`gen_states`, else the scope's as they are). Returns the
    written provenance record or None; never raises (diagnosis must not
    mask the original failure)."""
    if isinstance(compiled, _MultiStepBlock):
        # a k-step call's feed is stacked [k, ...]; replaying it as one
        # step would walk the wrong shapes: provenance needs steps_per_run=1
        if not getattr(_localize_nan, "_warned_multi", False):
            _localize_nan._warned_multi = True
            print("[nan_provenance] skipped: steps_per_run>1 runs cannot be replayed per-op "
                  "(rerun the failing step with steps_per_run=1)", file=sys.stderr)
        return None
    from .observability import opprof

    try:
        block = _prepared(compiled)
        env = {n: v for n, v in scope.vars.items() if isinstance(v, torch.Tensor)}
        if mut_override:
            env.update(mut_override)
        dtypes = getattr(block, "feed_dtypes", {})
        for n, v in (feed or {}).items():
            env[n] = to_tensor(v, scope.device, dtypes.get(n))
        host = torch.Generator()
        dev = torch.Generator(device=scope.device)
        if gen_states is None:
            gen_states = _generator_states(scope)
        host.set_state(gen_states[0])
        dev.set_state(gen_states[1])
        ctx = registry.LowerCtx(
            scope.device, generator=host, device_generator=dev, cache={},
            host_random=bool(getattr(block, "created_persistables", ())),
            mesh=getattr(block, "mesh", None))
        prov = opprof.localize_nonfinite(_run_ops(compiled), env, ctx, step=step)
        if prov is None:
            return None
        return opprof.write_provenance(prov, reason=reason)
    except Exception as e:
        if not getattr(_localize_nan, "_warned", False):
            _localize_nan._warned = True
            print("[nan_provenance] replay failed: %r" % e, file=sys.stderr)
        return None


def _record_tensor_stats(compiled):
    """FLAGS_tensor_stats: the run's [n, 4] statistics to the host (the
    leg's one sync a run) and into opprof's record, gauges and telemetry.
    A failure is reported once and never fails the step."""
    src = compiled.tensor_stats() if isinstance(compiled, _CompiledBlock) \
        else getattr(compiled, "tstat", None)
    if src is None:
        return
    from .observability import opprof

    try:
        names, t = src
        opprof.record_tensor_stats(names, t.detach().cpu().numpy())
    except Exception as e:
        if not getattr(_record_tensor_stats, "_warned", False):
            _record_tensor_stats._warned = True
            print("tensor_stats record failed (disabled for this message): %r" % e,
                  file=sys.stderr)


def _telemetry_begin():
    """(collector, t0) when telemetry is active, else (None, None): the
    disabled path costs one flags lookup a run (observability.stepstats)."""
    from .observability import stepstats

    if not stepstats.active():
        return None, None
    return stepstats.collector(), time.perf_counter()


def _telemetry_record(obs, t0, compiled, cache_hit, nan_trip, n_steps, result, return_numpy,
                      pp=None, n_micro=None, schedule=None):
    """The Executor / ParallelExecutor step record. The loss is read from
    the first fetch ONLY when it is already on the host (return_numpy):
    telemetry adds no device sync of its own. A telemetry failure (say,
    export-dir IO) is reported once and never fails the step."""
    wall_ms = (time.perf_counter() - t0) * 1e3
    loss = None
    if return_numpy and result:
        try:
            a = np.asarray(result[0])
            if a.size >= 1 and a.dtype.kind == "f":
                # multi-step fetches come back [k, ...]: report the last step
                loss = float(a.reshape(-1)[-1])
        except (TypeError, ValueError):
            pass
    try:
        obs.record_step(
            wall_ms, n_steps=n_steps, cache_hit=cache_hit, nan_trip=nan_trip,
            pp=pp, n_micro=n_micro, schedule=schedule, loss=loss,
            training=bool(_mutated(compiled)),
        )
    except Exception as e:
        if not getattr(_telemetry_record, "_warned", False):
            _telemetry_record._warned = True
            print("telemetry record failed (disabled for this message): %r" % e,
                  file=sys.stderr)


class _ServeBlock:
    """serve(feeds, ro, mut) -> (fetches, new_mut) of a prepared inference
    block: on the card through a _CompiledBlock for each value of the
    lowering flags, all capturing into `pool`; on the CPU op by op; while
    the profiler is on with FLAGS_profile_ops, op by op with per-op events.
    The pools are updated in place and come back as new_mut."""

    def __init__(self, block, scope, pool=None):
        self.block = block
        self.scope = scope
        self.pool = pool
        self.compiled = {}  # _lowering_flags() -> _CompiledBlock

    def captures(self):
        """How many of its graphs are captured."""
        return sum(c.graph is not None for c in self.compiled.values())

    def state_copies(self):
        """State tensors its replays copied into the captured ones."""
        return sum(c.graph.state_copies for c in self.compiled.values() if c.graph is not None)

    def eager(self, feeds, ro, mut, per_op=False):
        return self.block.run(self.scope, feeds, ro, mut, True, per_op)[:2]

    def __call__(self, feeds, ro, mut):
        if _profile_ops():
            return self.eager(feeds, ro, mut, per_op=True)
        if self.scope.device.type != "cuda":
            return self.eager(feeds, ro, mut)
        key = _lowering_flags()
        compiled = self.compiled.get(key)
        if compiled is None:
            compiled = self.compiled[key] = _CompiledBlock(self.block, self.pool, is_test=True)
        return compiled.run(self.scope, feeds, ro, mut)[:2]


class _ServeFetches:
    """The fetch-only serve callable of aot_serve_lowering: `fn(feeds, ro,
    mut) -> [fetches]` through its _ServeBlock (CUDA graphs on the card,
    the fetches the graph's own tensors until the next replay of its pool),
    `fn.eager(...)` op by op, asked for explicitly (never a fallback)."""

    def __init__(self, serve):
        self.serve = serve

    def __call__(self, feeds, ro, mut):
        return self.serve(feeds, ro, mut)[0]

    def eager(self, feeds, ro, mut):
        return self.serve.eager(feeds, ro, mut)[0]

    def captures(self):
        return self.serve.captures()

    def state_copies(self):
        return self.serve.state_copies()


def aot_serve_lowering(program, feed_names, fetch_names, scope,
                       pass_pipeline=None, return_state=False, graph_pool=None):
    """Forward lowering for serving: returns (serve, ro, mut) where
    `serve(feeds, ro, mut) -> [fetches]` runs the block over the scope's
    read-only / block-written persistables, passed as ARGUMENTS so one
    callable serves any parameter values of the same shapes. Feeds may be
    numpy arrays or tensors; they are cast to the declared dtypes on the
    scope's device. On the card it runs as CUDA graphs (a _ServeBlock: op
    by op at its first call, captured at its second, replayed after;
    `serve.captures()` counts them, `serve.eager(...)` runs op by op), on
    the CPU op by op. The graphs capture into `graph_pool`, a torch graph
    pool handle that graphs replayed one at a time may share (None: a pool
    each), so their fetches are valid until the next replay of any graph of
    that pool.

    `return_state=True` is the decode-state mode: `serve(...) ->
    ([fetches], new_mut)`. kv_cache_write updates the pools in place, so
    new_mut holds the same tensors the caller passed in.

    With FLAGS_static_verify on, the program is linted in serving mode
    first (analysis/verify.py) and an error finding raises.

    The JAX package runs its "inference" pass preset here; the port lowers
    the Program verbatim for None/""/"off"/"inference" (the preset's
    fold/DCE/fusion tagging do not change the math). A program another
    pipeline already rewrote is served with "off": the int8 ServingEngine
    applies inference_int8 itself (calibration needs its feeds), then
    lowers the rewritten program here, whose tagged gemm_int8 chains run
    through the quant GEMM kernel (ops/fused.py). Any other pipeline
    raises: run it with passes.PassManager first."""
    if pass_pipeline not in (None, "", "off", "inference"):
        raise ValueError(
            "aot_serve_lowering: pass pipeline %r; apply it with "
            "passes.PassManager and serve the result with 'off'" % (pass_pipeline,)
        )
    from .analysis import maybe_static_verify

    maybe_static_verify(program, list(feed_names), list(fetch_names), scope=scope,
                        mode="serving", where="aot_serve")
    block = _PerOpProfiledBlock(
        program.global_block(), list(feed_names), list(fetch_names), scope
    )
    ro, mut = block.state(scope)
    # inference programs are pruned of stochastic ops, so the generators
    # are never drawn from here
    serve = _ServeBlock(block, scope, graph_pool)
    if return_state:
        return serve, ro, mut
    return _ServeFetches(serve), ro, mut


# ---------------------------------------------------------------------------
# compiled artifacts: a prepared block as a torch.export program
# (inference.py, train_export.py)
# ---------------------------------------------------------------------------


def _sorted(d):
    return {k: d[k] for k in sorted(d)}


class _BlockStep(torch.nn.Module):
    """forward(feeds, ro, mut) -> (fetches, new_mut) over a traced step:
    the dict signature torch.export keeps, around `gm`, the flat graph of
    one run of a block (export_block)."""

    def __init__(self, gm, names, n_fetches):
        super().__init__()
        self.gm, self.names, self.n_fetches = gm, names, n_fetches

    def forward(self, feeds, ro, mut):
        outs = self.gm(*(d[n] for d, group in zip((feeds, ro, mut), self.names)
                         for n in group))
        return list(outs[:self.n_fetches]), dict(zip(self.names[2], outs[self.n_fetches:]))


def export_block(block, feeds, ro, mut, device, is_test=False):
    """torch.export of one op-by-op run of a prepared block
    (_PerOpProfiledBlock) over `feeds` (tensors on `device` in their
    declared dtypes) and the state `ro` / `mut`, which stay arguments of
    the program: its graph holds the hand kernels as the paddle_tpu_torch
    ops, and the in-place updates of `mut` (the fused Adam's) as input
    mutations. The run's random ops draw from the device's default
    generator (a torch.Generator inside an exported graph does not survive
    torch.export.load), whose state the exported runners set and read
    around each call.

    The run is first traced over fake tensors into a flat aten graph
    (make_fx: it records the generic grads' torch.func.vjp op by op, which
    torch.export's own tracer does not), its dead ops dropped, and that
    graph is exported.
    Raises for a block no graph can hold: one that creates persistables
    (run the startup program first), holds host ops or an open-ended while,
    or an op that pins a random seed (its own generator would be a constant
    of the graph)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if block.created_persistables:
        raise RuntimeError(
            "block creates persistables %s: run the startup program before exporting"
            % block.created_persistables)
    if block.host_ops or block.open_ended_while:
        raise RuntimeError("block holds %s, which an exported graph cannot run" % (
            "host ops" if block.host_ops else "an open-ended while"))
    names = tuple(tuple(sorted(d)) for d in (feeds, ro, mut))
    cache = {}  # the lowerings' constants, made for this trace alone

    def run(*flat):
        parts, i = [], 0
        for group in names:
            parts.append(dict(zip(group, flat[i:i + len(group)])))
            i += len(group)
        ctx = registry.LowerCtx(device, is_test=is_test, cache=cache, host_random=False)
        fetches, new_mut, _ = block.fn(*parts, ctx)
        return tuple(fetches) + tuple(new_mut[n] for n in names[2])

    flat = [d[n] for d, group in zip((feeds, ro, mut), names) for n in group]
    # a frame summary a node is much of a trace's time: off, where this
    # torch has the switch
    emit = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
    if emit is not None:
        torch.fx.config.do_not_emit_stack_traces = True
    try:
        gm = make_fx(run, tracing_mode="fake")(*flat)
        if registry.seeded_generators(cache):
            raise RuntimeError("an op of the block pins a random seed: its generator cannot "
                               "be carried by an exported graph")
        _drop_dead(gm)
        step = _BlockStep(gm, names, len(block.fetch_names))
        exported = torch.export.export(step, tuple(_sorted(d) for d in (feeds, ro, mut)),
                                       strict=False)
        # the state goes beside the program (compile_cache.write_artifact),
        # not a second time inside it as the trace's example inputs
        exported.example_inputs = None
        return exported
    finally:
        if emit is not None:
            torch.fx.config.do_not_emit_stack_traces = emit


def _drop_dead(gm):
    """Erase the traced ops no result reads (the generic grads' replayed
    forwards whose values their vjp does not need), keeping every op that
    mutates (the fused Adam) or draws random numbers (so the generator's
    offsets advance as Executor.run's do)."""
    for node in reversed(list(gm.graph.nodes)):
        if node.op != "call_function" or node.users:
            continue
        target = node.target
        if isinstance(target, torch._ops.OpOverload) and (
                target._schema.is_mutable or torch.Tag.nondeterministic_seeded in target.tags):
            continue
        if node.is_impure():
            continue
        gm.graph.erase_node(node)
    gm.recompile()


class _ExportedRun:
    """An exported block's module (torch.export.load(...).module()) run as
    _CompiledBlock runs a block: on the CPU op by op every call; on the card
    call 1 op by op on the capture stream, call 2 captured as a CUDA graph
    (the default generator registered, as every capture registers it) and
    replayed, later calls replay. The state tensors it is given keep their
    addresses: a written value the module returns as a new tensor is copied
    into the held one (inside the graph on the card). Launch counters
    count as on _CudaGraph (_counted_capture)."""

    def __init__(self, module, feed_dtypes, device):
        self.module = module
        self.feed_dtypes = dict(feed_dtypes)
        self.device = torch.device(device)
        self._warm = False
        self.graph = None

    def _call(self, feeds, ro, mut):
        fetches, new_mut = self.module(_sorted(feeds), _sorted(ro), _sorted(mut))
        for n, t in new_mut.items():
            if t.data_ptr() != mut[n].data_ptr():
                mut[n].copy_(t)
        return fetches

    def __call__(self, feeds, ro, mut):
        """The fetches of one call over `feeds` (host or device values) and
        the held state `ro` / `mut`, which a call updates in place."""
        if self.device.type != "cuda" or not self._warm:
            feeds = {n: to_tensor(v, self.device, self.feed_dtypes.get(n))
                     for n, v in feeds.items()}
            if self.device.type != "cuda":
                return self._call(feeds, ro, mut)
            with _on_capture_stream(self.device):
                fetches = self._call(feeds, ro, mut)
            self._warm = True
            return fetches
        if self.graph is None:
            torch.cuda.empty_cache()
            self.stage = _FeedStage(sorted(feeds), self.feed_dtypes, feeds, self.device)
            self.stage.fill(feeds)
            self.graph = torch.cuda.CUDAGraph()
            with _counted_capture() as self.counts, _on_capture_stream(self.device) as stream:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.fetches = self._call(self.stage.bufs, ro, mut)
        else:
            self.stage.fill(feeds)
        self.graph.replay()
        _add_counts(self.counts)
        return self.fetches


def _pull_reader_steps(readers, steps_per_run, adapters=None):
    """Pull up to k staged batches from started py_readers and stack them.
    If the epoch ends mid-pull, the completed steps are NOT discarded: the
    call proceeds as a shorter multi-step run (the sequential path would
    have trained on them before raising EOF) and EOFException surfaces on
    the NEXT run, once nothing is left. Returns (stacked_feed, k_actual);
    the feed is ALWAYS stacked [k, ...] — even a 1-batch tail keeps the
    multi-step fetch contract (fetches come back [k, ...]). `adapters`:
    each reader's (_reader_adapters), none by default."""
    from .py_reader import EOFException

    adapters = adapters or [None] * len(readers)
    step_feeds = []
    pulled = None
    try:
        for _ in range(steps_per_run):
            d = {}
            pulled = []  # (reader, batch) of this incomplete step
            for rd, adapt in zip(readers, adapters):
                b = rd.next_batch()
                pulled.append((rd, b))
                d.update(adapt(b) if adapt is not None else b)
            pulled = None  # step completed
            step_feeds.append(d)
    except EOFException:
        # one reader of the group ended mid-step: the sibling batches
        # already pulled for the INCOMPLETE step go back to their readers
        # (they were never trained on), and the whole group defers the EOF
        if pulled:
            for rd, b in pulled:
                rd.push_back(b)
        if not step_feeds:
            raise
        # tail consumed now; surface the EOF on the NEXT run
        for rd in readers:
            rd._eof_deferred = True
    return _stack_feed_steps(step_feeds), len(step_feeds)


def _started_readers(program):
    """Started py_readers of the program; raises the EOFException a previous
    partial multi-step pull deferred (its tail batches were trained on, so
    the epoch end belongs to THIS call). The program's readers are treated
    as a UNIT: a deferred EOF on any of them ends the epoch for the group —
    proceeding with the remaining readers would silently feed steps missing
    the exhausted reader's slots."""
    from .py_reader import EOFException

    readers, deferred = [], False
    for rd in getattr(program, "_py_readers", []):
        if getattr(rd, "_eof_deferred", False):
            rd._eof_deferred = False
            deferred = True
        elif rd.started:
            readers.append(rd)
    if deferred:
        raise EOFException(
            "reader exhausted (tail consumed by the previous multi-step run)"
        )
    return readers


def _place_readers(program, device):
    """The executor that runs a program, or its startup program, sets the
    device its program readers (layers.py_reader, ctr_reader) stage on from
    their next start(), as the reference's reader takes the place of the
    executor that runs its startup program. A PyReader made with a place
    keeps it."""
    for rd in (list(getattr(program, "_py_readers", ()))
               + list(getattr(program, "_startup_readers", ()))):
        take = getattr(rd, "_take_place", None)
        if take is not None:
            take(device)


def _reader_adapters(readers, device, placement=None, localize=None):
    """What a puller on `device` does with each started reader's batches,
    from the (device, placement) its epoch is staged by (staged_on): None
    where they are already the puller's, `localize` (the ParallelExecutor's
    split of a global batch into this rank's rows) where a reader stages
    whole batches and the puller has a placement. A batch staged on another
    device, or by another placement, raises: the reader keeps its epoch's
    staging until reset() and start()."""
    out = []
    for rd in readers:
        on = getattr(rd, "staged_on", None)
        dev, rows = on if on is not None else (None, None)
        if dev is not None and dev != device:
            raise RuntimeError(
                "reader %r stages this epoch on %s but is pulled by an executor on %s: "
                "reset() and start() it after running its program (or startup program) on "
                "that executor" % (getattr(rd, "name", rd), dev, device))
        if rows == placement:
            out.append(None)
        elif rows is None and localize is not None:
            out.append(localize)
        else:
            raise RuntimeError(
                "reader %r stages this epoch by another placement than its puller's: "
                "reset() and start() it after building the ParallelExecutor that pulls it"
                % (getattr(rd, "name", rd),))
    return out


def _resolve_reader_feed(program, steps_per_run, device, placement=None, localize=None):
    """Shared Executor/ParallelExecutor path for feed=None: pull from the
    program's started py_readers — k batches stacked for a multi-step run
    (force_multi keeps the [k, ...] fetch contract even for a 1-batch epoch
    tail), one batch otherwise — as the puller on `device` with `placement`
    wants them (_reader_adapters). Returns (feed, steps_per_run,
    force_multi)."""
    readers = _started_readers(program)
    adapters = _reader_adapters(readers, device, placement, localize)
    if steps_per_run > 1 and readers:
        feed, k = _pull_reader_steps(readers, steps_per_run, adapters)
        return feed, k, True
    feed = {}
    for rd, adapt in zip(readers, adapters):
        b = rd.next_batch()
        feed.update(adapt(b) if adapt is not None else b)
    return feed, steps_per_run, False


def _stack_feed_steps(feed_list):
    """List of k per-step feed dicts -> one dict of stacked values (leading
    axis k). Values staged on a device stack there, on the current stream
    (which the pull made wait on their copies)."""
    if not feed_list:
        raise ValueError("empty feed list")
    names = set(feed_list[0])
    for d in feed_list[1:]:
        if set(d) != names:
            raise ValueError(
                "per-step feeds must share the same names; got %s vs %s"
                % (sorted(names), sorted(d))
            )
    out = {}
    for name in names:
        vals = [d[name] for d in feed_list]
        tensors = [v for v in vals if isinstance(v, torch.Tensor)]
        if tensors:
            device = tensors[0].device
            out[name] = torch.stack([v if isinstance(v, torch.Tensor) else
                                     to_tensor(v, device) for v in vals])
        else:
            out[name] = np.stack([np.asarray(v) for v in vals])
    return out


class Executor:
    """Drop-in for fluid.Executor (reference python/paddle/fluid/executor.py:256)
    on one torch device: `place` None means CUDAPlace(0)."""

    def __init__(self, place=None):
        self.place = place
        self.device = to_device(place)
        self._cache = {}
        self._pool = None
        # counts run() calls: the step the check_nan_inf report cites
        self._run_seq = 0
        # name -> the NaN guard's pre-step copy, reused run to run
        self._guard_bufs = {}

    def _graph_pool(self):
        """The graph pool every block of this executor captures into: one
        step's intermediates, whatever the number of feed shapes. Graphs
        may share it since they replay one at a time on one stream and each
        call's fetches are copied or cloned before the next."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def close(self):
        """Drop the prepared blocks and the guard's buffers, then tell every
        pserver this process talked to that it is done (the reference's
        Executor::Close, executor.cc:111-119: SendComplete lets their sync
        loops exit)."""
        self._cache.clear()
        self._guard_bufs.clear()
        from .distributed.rpc import RPCClient

        client = RPCClient._instance
        if client is not None:
            for ep in list(client._socks):
                client.send_complete(ep)
            client.close()

    def run(
        self,
        program=None,
        feed=None,
        fetch_list=None,
        feed_var_name="feed",
        fetch_var_name="fetch",
        scope=None,
        return_numpy=True,
        use_program_cache=True,
        steps_per_run=1,
    ):
        """Run `program` once: on the CPU op by op; on the card as a CUDA
        graph from its second call on a cache key (the program, its version,
        the feeds' names, shapes and dtypes, the fetches, the scope and the
        lowering flags). With return_numpy=False a replayed graph's fetches
        are cloned, so the next replay does not overwrite them.

        steps_per_run > 1 runs k steps in one call (_MultiStepBlock): `feed`
        is a list of k per-step dicts or a dict of arrays stacked on a
        leading k axis, and each fetch comes back stacked [k, ...]; on the
        card the k steps replay the single step's graph with no host
        synchronization between them.

        With no feed, the batches come from the program's started readers
        (layers.py_reader, contrib.reader.ctr_reader, a PyReader in
        program._py_readers): one batch, or with steps_per_run > 1 up to k
        batches stacked on the device. An epoch's tail of fewer than k
        batches still runs as a multi-step call (fetches [tail, ...]), and
        the next call raises EOFException. A pulled batch reaches the block
        the same batch fed as a dict of arrays reaches. The run sets the
        device of the program's readers for their next start()
        (_place_readers), and a pull from a reader whose epoch is staged
        on another device raises (_reader_adapters)."""
        if program is None:
            program = framework.default_main_program()
        if steps_per_run < 1:
            raise ValueError("steps_per_run must be >= 1")
        # every run entry is a progress beat of the elastic watchdog (one
        # list probe when no Supervisor watches)
        _elastic_heartbeat()
        obs, t0 = _telemetry_begin()
        force_multi = False
        _place_readers(program, self.device)
        if not feed:
            feed, steps_per_run, force_multi = _resolve_reader_feed(program, steps_per_run,
                                                                    self.device)
        if isinstance(feed, (list, tuple)):
            if steps_per_run == 1:
                steps_per_run = len(feed)
            if len(feed) != steps_per_run:
                raise ValueError("feed list has %d entries but steps_per_run=%d"
                                 % (len(feed), steps_per_run))
            if steps_per_run == 1:
                feed = dict(feed[0])  # single step: no stacking
            else:
                feed = {n: np.stack([np.asarray(d[n]) for d in feed]) for n in feed[0]}
        feed = dict(feed or {})
        multi = steps_per_run > 1 or force_multi
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        if scope.bind(self.device) != self.device:
            raise ValueError(
                "scope lives on %s but the executor runs on %s"
                % (scope.device, self.device)
            )
        # an explicit program.random_seed reseeds the scope's generators
        # once, like the JAX package's rng key
        if program.random_seed and not getattr(scope, "_seeded", False):
            scope.reseed(program.random_seed)
            scope._seeded = True
        fetch_names = [
            f.name if isinstance(f, Variable) else str(f) for f in fetch_list
        ]
        # graph-pass choke point: FLAGS_pass_pipeline rewrites the program
        # here, before the block below is prepared; the cache keys on the
        # (memoized) rewritten program
        program = _apply_pass_pipeline(program, scope, list(feed), fetch_names)
        block = program.global_block()
        step_feed = {n: np.asarray(v)[0] if not isinstance(v, torch.Tensor) else v[0]
                     for n, v in feed.items()} if multi else feed
        opf = _flags_opprof()
        self._cache_hit = False
        if _profile_ops() and not multi:
            # per-op attribution mode: never cached (diagnosis path), and
            # no step record, as in the JAX package
            obs = None
            compiled = _PerOpProfiledBlock(block, list(feed), fetch_names, scope,
                                           tensor_stats=opf["tensor_stats"])
            feed, guard = self._guard_begin(compiled, scope, feed)
            with _prof.RecordEvent("run/block0"):
                fetches = compiled(scope, feed, per_op=True)
        else:
            compiled = self._prepare(program, block, step_feed, fetch_names, scope,
                                     use_program_cache, opf["tensor_stats"])
            if multi:
                if isinstance(compiled, _SegmentedBlock):
                    raise RuntimeError(
                        "steps_per_run>1 cannot span host ops (save / load, prints): the k "
                        "steps run as one call with no host re-entry")
                key = ("multi", steps_per_run, id(compiled))
                multi_block = self._cache.get(key)
                if multi_block is None:
                    multi_block = _MultiStepBlock(compiled, steps_per_run)
                    if use_program_cache or self.device.type == "cuda":
                        self._cache[key] = multi_block
                compiled = multi_block
            feed, guard = self._guard_begin(compiled, scope, feed)
            with _prof.RecordEvent("run/block0"):
                fetches = compiled(scope, feed)
        if _flags.get_flags("benchmark")["benchmark"] and self.device.type == "cuda":
            # FLAGS_benchmark (the reference's operator.cc:769): the run's
            # device work is done when run returns, so a host clock around
            # it brackets the step
            torch.cuda.synchronize(self.device)
        self._run_seq += 1
        nan_ok = self._guard_end(guard, scope, fetches, feed, compiled)
        if not nan_ok and _flags.get_flags("check_nan_inf")["check_nan_inf"]:
            pre = guard[3] if guard is not None else None
            _check_nan_inf(
                compiled.inner if multi else compiled, scope, fetch_names, fetches,
                self._run_seq,
                provenance=lambda: _localize_nan(compiled, scope, feed, pre, "check_nan_inf",
                                                 step=self._run_seq)
                if opf["nan_provenance"] else None)
        if not multi and opf["tensor_stats"]:
            _record_tensor_stats(compiled)
        if multi:
            result = _MultiStepBlock.to_host(fetches) if return_numpy else fetches
        else:
            # a replayed graph's fetches are its own tensors
            replayed = (getattr(compiled, "graph", None) is not None
                        or isinstance(compiled, _SegmentedBlock) and compiled.captures() > 0)
            if return_numpy:
                # copies: a fetched CPU tensor may be state that a later step
                # updates in place (the fused Adam does). numpy has no
                # bfloat16 (the JAX package hands out ml_dtypes' type): a
                # bf16 fetch is widened to float32, which is exact
                result = [(f.float() if f.dtype == torch.bfloat16 else f).detach()
                          .to("cpu", copy=True).numpy() for f in fetches]
            elif replayed:
                result = [f.clone() for f in fetches]
            else:
                result = fetches
        if obs is not None:
            _telemetry_record(obs, t0, compiled, self._cache_hit, nan_ok,
                              steps_per_run if multi else 1, result, return_numpy)
        return result

    def _guard_begin(self, compiled, scope, feed):
        """(feed, guard) of a run about to start: a run that updates
        persistables draws the `nan_grad` fault (poisoning its feed), and
        under FLAGS_resilience_nan_guard copies each of them into the
        executor's snapshot buffer on its device. A startup program or an
        eval run passes untouched."""
        names = _mutated(compiled)
        if not names:
            return feed, None
        from .resilience import faults

        # FLAGS_nan_provenance replays a tripped step from the generator
        # state it started from (a replayed graph advances the device
        # generator's Philox offset as an eager run does)
        pre_gen = _generator_states(scope) if _flags_opprof()["nan_provenance"] else None
        poison_after = False
        if faults.fires("nan_grad"):
            feed, poison_after = _poison_nan(feed)
        snapshot = None
        if _flags.get_flags("resilience_nan_guard")["resilience_nan_guard"]:
            snapshot = {}
            for n in names:
                v = scope.vars.get(n)
                if not isinstance(v, torch.Tensor):
                    continue
                buf = self._guard_bufs.get(n)
                if (buf is None or buf.shape != v.shape or buf.dtype != v.dtype
                        or buf.device != v.device):
                    buf = self._guard_bufs[n] = torch.empty_like(v)
                snapshot[n] = buf
            if snapshot:  # one multi-tensor copy of the whole state
                with torch.no_grad():
                    torch._foreach_copy_(list(snapshot.values()),
                                         [scope.vars[n] for n in snapshot])
        return feed, (names, poison_after, snapshot, pre_gen)

    def _guard_end(self, guard, scope, fetches, feed, compiled):
        """After the run: the fallback poisoning, then the guard's check and
        rollback. True when the guard handled this run's NaNs (so
        FLAGS_check_nan_inf does not raise over them). Under
        FLAGS_nan_provenance a trip first replays the step op by op from its
        pre-step state to name the first op with a non-finite output."""
        if guard is None:
            return False
        names, poison_after, snapshot, pre_gen = guard
        if poison_after:
            _poison_scope_state(scope, names)
        if snapshot is None:
            return False
        watched = list(fetches) + [scope.vars[n] for n in names if scope.vars.get(n) is not None]
        if _all_finite(watched):
            return False
        from .observability import flightrec

        flightrec.trigger("nan_guard", step=self._run_seq)
        if pre_gen is not None:
            _localize_nan(compiled, scope, feed, pre_gen, "resilience_nan_guard",
                          step=self._run_seq, mut_override=snapshot)
        return self._skip_nan_step(scope, snapshot)

    def _skip_nan_step(self, scope, snapshot):
        """The NaN/Inf step guard tripped: roll the updated persistables back
        to their pre-step values, multiply every learning-rate and
        loss-scale var by FLAGS_resilience_lr_decay (repeated NaNs usually
        mean the scale or the rate is too hot), and count the event. The run
        returns its poisoned fetches, but the model's state is as if the
        step never ran. A rolled-back name is rebound to its snapshot buffer
        (the buffer leaves the executor's set), so on the card a captured
        graph copies it into its own tensor at its next replay."""
        from .resilience import health

        for name, saved in snapshot.items():
            scope.vars[name] = saved
            self._guard_bufs.pop(name, None)
        decay = float(_flags.get_flags("resilience_lr_decay")["resilience_lr_decay"])
        decayed = 0
        for name, val in list(scope.vars.items()):
            base = name.rsplit("/", 1)[-1]
            if isinstance(val, torch.Tensor) and (
                    base.startswith("learning_rate") or "loss_scaling" in base):
                scope.vars[name] = val * decay
                decayed += 1
        if decayed:
            health.incr("lr_decays", decayed)
        health.incr("nan_steps_skipped")
        return True

    def _prepare(self, program, block, feed, fetch_names, scope, use_program_cache,
                 tensor_stats=""):
        """The block form of one step under its cache key (the program, its
        version, the feeds' names, shapes and dtypes, the fetches, the scope,
        the lowering flags and FLAGS_tensor_stats: toggling it prepares and
        captures anew, never replays a graph of the other form), prepared at
        its first call."""
        key = (
            program._uid,
            program._version,
            _feed_signature(feed),
            tuple(fetch_names),
            scope._uid,
            _lowering_flags(),
            tensor_stats,
        )
        # the card keeps every block it prepares: a graph is captured at
        # its key's second call, so use_program_cache=False is taken on
        # the CPU only
        cached = use_program_cache or self.device.type == "cuda"
        compiled = self._cache.get(key) if cached else None
        self._cache_hit = compiled is not None
        if compiled is None:
            # FLAGS_static_verify: prove the program against the
            # fluidlint checkers before its block is prepared
            from .analysis import maybe_static_verify

            maybe_static_verify(
                program, list(feed), fetch_names, scope=scope,
                mode="inference" if program._is_test else "training",
                where="executor",
            )
            card = self.device.type == "cuda"
            if _splits(block):
                compiled = _SegmentedBlock(block, list(feed), fetch_names,
                                           self._graph_pool() if card else None, card)
            else:
                compiled = _PerOpProfiledBlock(block, list(feed), fetch_names, scope,
                                               tensor_stats=tensor_stats)
                if card:
                    compiled = _CompiledBlock(compiled, self._graph_pool())
            if cached:
                self._cache[key] = compiled
        return compiled

    @staticmethod
    def stats():
        """Kernel counters of the training path: `dispatches`, the runs each
        fused family took (ops/fused.py, the JAX package's
        KERNEL_DISPATCHES), and `launches`, the hand-written kernels each
        wrapper launched on the card (a CPU run takes the plain versions
        and launches none). A replayed graph counts what its capture
        counted, every replay. `op_by_op`: the runs on the card of blocks
        that were not captured, by reason ("creates_persistables",
        "open_ended_while", "host_op"). `segments`: what runs
        of blocks split at host ops ran, "device" segments, "host" op calls
        and "inline" prints between segments. `graphs`: the CUDA graphs
        blocks and segments "captures" and "replays". `collectives`: what
        layouts and pipelines sent, by kind and axes (a ParallelExecutor's
        "all_reduce_fwd:tp", "all_gather:fsdp", "send"). ops.fused.
        reset_stats() clears them all."""
        return dict(fused.stats(), op_by_op=dict(fused.OP_BY_OP),
                    segments=dict(fused.SEGMENTS), graphs=dict(fused.GRAPHS),
                    collectives=dict(fused.COLLECTIVES))
