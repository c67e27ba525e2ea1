"""ParallelExecutor: the fluid multi-device data-parallel API on
torch.distributed (the counterpart of paddle_tpu/parallel_executor.py).

Reference analog: python/paddle/fluid/parallel_executor.py:32 +
framework/parallel_executor.cc:92 + framework/details/ (SURVEY.md §2.2): a
per-device program plus all-reduce op handles. The JAX package jits ONE
program over a mesh of local devices and lets its partitioner insert the
collectives. The port is the reference's design again: one process per
device (NCCL on the cards, gloo on the CPU), each running the program over
its rows of the batch, with the collectives written out:

- at construction every persistable is broadcast from rank 0 (the
  reference's BCastParamsToDevices): each rank ran the startup program with
  its own randomness, and the broadcast, not equal seeds, makes the
  replicas equal;
- `run` takes the GLOBAL batch; each rank keeps its contiguous rows
  [r*B/dp, (r+1)*B/dp) (the JAX feed's P('dp') split);
- after the backward and before the first optimizer op the gradients are
  averaged over dp in a few coalesced buckets (`_DataParallelPlan`), inside
  the step's CUDA graph on the card; a SelectedRows pair (rows, values) is
  all-gathered over dp instead, as GSPMD made it global in the JAX package;
- batch_norm in training all-reduces its per-channel sums over dp, forward
  and backward (ops/core_ops.py), so its statistics are the global batch's;
- a fetched variable whose block shape leads with the batch dimension is
  all-gathered over dp along dimension 0; any other (a mean loss, a metric)
  is averaged over dp, which equals the JAX package's global value for the
  batch-mean losses the reference uses.

So the ParallelExecutor computes what the JAX one computes: the
single-device program over the global batch. At a dp of 1 the block is the
Executor's, bit for bit.

ReduceStrategy.Reduce is ZeRO-1: the gradients of the params whose leading
dim divides dp are reduce-scattered over dp, each rank updates its rows of
the param with its rows of the optimizer state (the moments stored sharded,
`Scope.row_shards`), and the params are all-gathered. The multi-tensor Adam
kernel declines there, as in the JAX package (its flattened update would
not keep the per-param shards). io.save_persistables writes whole variables
(gathered, written by rank 0) and load_persistables reshards them.

Sharding rules (BuildStrategy.sharding_rules merged after the program's
own, parallel/sharding_rules.py) place parameters over fsdp and tp: each
rank stores its piece of a placed parameter and of its optimizer
accumulators, the ops run on pieces where they know the layout (the
Megatron pair over tp) and gather them where they do not (FSDP), and each
placed gradient is brought back to its parameter's piece before the
optimizer. The batch is split over dp and fsdp together, and the gradients
averaged over both. A parameter a rule places leaves the ZeRO-1 tier.

pp > 1 (MeshConfig(pp=...) or BuildStrategy.pipeline_stages) runs the
block as a pipeline (executor._PipelinedBlock, GPipe or 1F1B by
ExecutionStrategy.pipeline_schedule over num_microbatches), each pp rank
its stage; the gradients are summed over pp and averaged over dp.

`run(..., steps_per_run=k)` runs k steps in one call (executor.
_MultiStepBlock) over a dict of feeds stacked on a leading k axis, and
returns each fetch stacked [k, ...]; it raises under pp, as the JAX
package does.

On the card the ParallelExecutor runs on its process's device with NCCL; a
CUDA place whose process group is not NCCL raises, and so does the CPU under
NCCL. Without a process group it runs on the one local device.
"""

import numpy as np
import torch
import torch.distributed as dist

from . import framework
from .executor import (
    _CompiledBlock,
    _MultiStepBlock,
    _PerOpProfiledBlock,
    _PipelinedBlock,
    _apply_pass_pipeline,
    _feed_signature,
    _lowering_flags,
    _splits,
    global_scope,
)
from .framework import OpRole, Variable, grad_var_name
from .ops import registry
from .parallel import collectives
from .parallel.mesh import MeshConfig, make_mesh
from .parallel.sharding_rules import (ZERO1_STATE_SLOTS, Resolver, ShardingRules,
                                      program_rules, storage_specs)
from .transpiler.gradient_merge import OPTIMIZER_OP_TYPES

__all__ = ["ParallelExecutor", "BuildStrategy", "ExecutionStrategy"]

# the largest gradient bucket (bytes): a few collectives a step, each big
# enough to run near the link's rate
BUCKET_BYTES = 32 << 20

# the axes the batch is split over (fsdp is data parallelism with sharded
# storage)
BATCH_AXES = ("dp", "fsdp")


class ReduceStrategy:
    """reference details/build_strategy.h ReduceStrategy"""

    AllReduce = 0
    Reduce = 1


class BuildStrategy:
    """Knobs from reference details/build_strategy.h (pybind.cc:746-833).
    reduce_strategy: AllReduce averages every gradient over dp with the
    optimizer state replicated; Reduce is the ZeRO-1 tier (module
    docstring). pass_pipeline / fuse_kernels choose the graph passes, as in
    the JAX package. sharding_rules (a ShardingRules or (pattern, spec)
    pairs) place parameters over fsdp / tp, after the program's own rules;
    pipeline_stages > 1 builds a dp x pp mesh when no mesh_config is given.
    The rest do nothing here: gradient_scale_strategy
    (the gradients are always averaged over dp, the reference's
    CoeffNumDevice), debug_graphviz_path, enable_data_balance, the fusion
    knobs (the passes fuse), enable_sequential_execution (a rank runs its
    ops in program order), memory_optimize (a block frees each intermediate
    after its last reader), and num_trainers / trainer_id (the process
    group says them)."""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        self.debug_graphviz_path = ""
        self.enable_data_balance = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_broadcast_op = False
        self.enable_sequential_execution = False
        self.memory_optimize = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.pipeline_stages = 1
        # graph-pass pipeline applied before lowering (paddle_tpu_torch/passes):
        # a manager.PRESETS name or comma-separated pass list; "" disables.
        # None (default) defers to FLAGS_pass_pipeline.
        self.pass_pipeline = None
        # True -> the "training_fused" preset (the hand-written kernels),
        # consulted only when pass_pipeline is None
        self.fuse_kernels = False
        self.sharding_rules = None

    def resolved_pass_pipeline(self):
        """The pipeline the executor should apply: pass_pipeline verbatim
        when set (even ""), else "training_fused" when fuse_kernels, else
        None (defer to FLAGS_pass_pipeline)."""
        if self.pass_pipeline is not None:
            return self.pass_pipeline
        if self.fuse_kernels:
            return "training_fused"
        return None


class ExecutionStrategy:
    """reference ExecutionStrategy (pybind.cc:746). pipeline_schedule
    ("gpipe": all forwards, then all backwards; "1f1b": one forward and
    one backward in turn after the warm-up) and num_microbatches (None: pp)
    drive the pipeline. The rest do nothing here: num_threads (a rank runs
    its ops on one stream), use_cuda (the place comes from the scope and
    the process group), allow_op_delay, num_iteration_per_drop_scope (a
    step's intermediates are freed as it runs)."""

    def __init__(self):
        self.num_threads = 0
        self.use_cuda = False
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1
        self.pipeline_schedule = "gpipe"
        self.num_microbatches = None


def _role(op):
    return int(op.attrs.get(OpRole.OP_ROLE_KEY, 0) or 0)


def _is_optimizer_op(op):
    return op.type in OPTIMIZER_OP_TYPES and bool(_role(op) & OpRole.Optimize)


def _buckets(names, env):
    """names grouped by dtype into buckets of at most BUCKET_BYTES (a
    larger tensor takes a bucket of its own)."""
    out, open_ = [], {}
    for n in names:
        t = env[n]
        size = t.numel() * t.element_size()
        b = open_.get(t.dtype)
        if b is None or b[0] and b[1] + size > BUCKET_BYTES:
            b = open_[t.dtype] = [[], 0]
            out.append(b[0])
        b[0].append(n)
        b[1] += size
    return out


class _ParallelPlan:
    """What a prepared block adds past one rank or under sharding rules
    (executor._PerOpProfiledBlock calls it): `sync(env, layout)` before
    unit `sync_at` (the first unit holding an Optimize-role op) brings the
    parameter gradients the backward produced to their parameters' layouts
    and averages them over the batch axes (dp and fsdp; summed over pp
    too, where each stage holds only its own parameters' gradients): the
    whole dense ones in coalesced all-reduce buckets, a placed one
    reduce-scattered onto the parameter's piece where it is whole and the
    parameter split, ZeRO-1 ones whose only readers are their optimizer ops
    reduce-scattered over dp (this rank's rows), SelectedRows pairs
    all-gathered. `lower` runs the units that hold ZeRO-1 optimizer ops,
    op by op, each such op over this rank's rows of its param, gradient
    and state, then all-gathers the param."""

    def __init__(self, prepared, block, mesh, zero1_params, stored=None, runs=None):
        from .embedding.selected_rows import is_selected_rows

        self.mesh = mesh
        self.dp = mesh.axis_size("dp")
        self.batch_axes = tuple(a for a in BATCH_AXES if mesh.axis_size(a) > 1)
        self.sum_axes = self.batch_axes + (("pp",) if mesh.axis_size("pp") > 1 else ())
        self.n_batch = mesh.axis_size(BATCH_AXES)
        self.stored = stored or {}
        runs = prepared.runs if runs is None else runs
        self.sync_at = next((i for i, run in enumerate(runs)
                             if any(_role(op) & OpRole.Optimize for op in run)), None)
        self.zero1_units, self.zero1_ops = set(), set()
        self.dense, self.placed, self.scattered, self.sparse = [], [], [], []
        if self.sync_at is None:
            return
        params = {p.name for p in block.all_parameters()}
        produced = {n for run in runs[:self.sync_at] for op in run for n in op.output_arg_names}
        if mesh.axis_size("pp") > 1:
            # the pipeline binds every parameter's gradient itself
            produced |= {grad_var_name(p) for p in params}
        readers = {}
        for i, run in enumerate(runs[self.sync_at:], self.sync_at):
            for op in run:
                if _is_optimizer_op(op) and op.input("Param")[0] in zero1_params:
                    self.zero1_units.add(i)
                    self.zero1_ops.add(id(op))
                for n in op.input_arg_names:
                    readers.setdefault(n, []).append(op)
        for p in sorted(params):
            g = grad_var_name(p)
            if g not in produced or g not in readers:
                continue
            var = block._var_recursive(g) if block.has_var_recursive(g) else None
            if var is not None and is_selected_rows(var):
                self.sparse.append((g, var.selected_rows_rows))
            elif p in self.stored:
                self.placed.append((g, self.stored[p]))
            elif p in zero1_params and all(id(op) in self.zero1_ops for op in readers[g]):
                self.scattered.append(g)
            else:
                self.dense.append(g)

    def sync(self, env, layout=None):
        from .parallel.collectives import _gather, _scatter_sum, _sum

        mesh = self.mesh
        group = mesh.group(self.sum_axes) if self.sum_axes else None
        if layout is not None:
            for n in self.dense:
                env[n] = layout.whole(n, env[n])
                layout.lay.pop(n, None)
        for names in _buckets(self.dense, env) if group is not None else ():
            flat = torch.cat([env[n].reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            collectives.note("all_reduce", self.sum_axes)
            flat = flat / self.n_batch
            off = 0
            for n in names:
                t = env[n]
                env[n] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
        for g, spec in self.placed:
            t = env[g]
            have = (layout.spec(g, t) if layout is not None else None) or (None,) * t.dim()
            summed = set()
            for d, (h, w) in enumerate(zip(have, spec)):
                if h == w:
                    continue
                if h is not None:
                    t = _gather(t, h, d, mesh)
                if w is not None:
                    t = _scatter_sum(t, w, d, mesh)
                    summed.update((w,) if isinstance(w, str) else w)
            rest = tuple(a for a in self.sum_axes if a not in summed)
            if rest:
                t = _sum(t, rest, mesh)
            div = int(np.prod([mesh.axis_size(a) for a in summed.union(rest) if a != "pp"]))
            env[g] = t / div if div > 1 else t
            if layout is not None:
                layout.lay[g] = spec
        pre = tuple(a for a in ("fsdp", "pp") if mesh.axis_size(a) > 1)
        for names in _buckets(self.scattered, env):
            grads = [env[n] if not pre else _sum(env[n], pre, mesh) for n in names]
            rows = [g.shape[0] // self.dp for g in grads]
            src = torch.cat([g.narrow(0, j * r, r).reshape(-1)
                             for j in range(self.dp) for g, r in zip(grads, rows)])
            out = collectives.reduce_scatter(src, "dp", mesh=mesh) / (
                self.dp * mesh.axis_size("fsdp"))
            off = 0
            for n, g, r in zip(names, grads, rows):
                shape = (r,) + tuple(g.shape[1:])
                numel = g.numel() // self.dp
                env[n] = out[off:off + numel].view(shape)
                off += numel
        if self.batch_axes:
            for vals, rows in self.sparse:
                env[vals] = collectives.all_gather(env[vals], self.batch_axes,
                                                   mesh=mesh) / self.n_batch
                env[rows] = collectives.all_gather(env[rows], self.batch_axes, mesh=mesh)

    def lower(self, ctx, run, env, scope):
        for op in run:
            if id(op) in self.zero1_ops:
                self._lower_zero1(ctx, op, env)
            else:
                # op by op: a fused family (multi_adam) declines a run of one
                registry.lower_run(ctx, [op], env)

    def _lower_zero1(self, ctx, op, env):
        full = env[op.input("Param")[0]]
        shape = tuple(full.shape)
        rows = shape[0] // self.dp
        lo = self.mesh.index("dp") * rows
        outs = set(op.output_arg_names)
        whole = {}
        for name in op.input_arg_names:
            t = env.get(name)
            if (name not in whole and isinstance(t, torch.Tensor) and tuple(t.shape) == shape
                    and t.is_floating_point()):
                whole[name] = t
                env[name] = t.narrow(0, lo, rows)
        registry.lower_run(ctx, [op], env)
        for name, t in whole.items():
            if name not in outs:
                env[name] = t
        for name in op.output("ParamOut"):
            env[name] = collectives.all_gather(env[name], "dp", mesh=self.mesh)


class ParallelExecutor:
    """Drop-in for fluid.ParallelExecutor (reference parallel_executor.py:32).

    The device is the scope's (where the startup program ran), else this
    process's card; under a process group it must match the backend (NCCL
    on a card, gloo on the CPU). The mesh spans the process group's ranks,
    pure dp by default or the axes of `mesh_config` (parallel.MeshConfig);
    without a process group it is the one local device."""

    def __init__(
        self,
        use_cuda=False,
        loss_name=None,
        main_program=None,
        share_vars_from=None,
        exec_strategy=None,
        build_strategy=None,
        num_trainers=1,
        trainer_id=0,
        scope=None,
        devices=None,
        mesh_config=None,
    ):
        self._program = main_program or framework.default_main_program()
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._scope = scope or global_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        device = self._device()
        if mesh_config is None and self._build_strategy.pipeline_stages > 1:
            mesh_config = MeshConfig(dp=-1, pp=self._build_strategy.pipeline_stages)
        self._mesh = make_mesh(mesh_config or MeshConfig(), device)
        self._scope.bind(device)
        self._resolver = self._bind_rules()
        self._broadcast_state()
        self._zero1_params, self._stored = self._shard_state()
        if self._stored and self._mesh.axis_size("pp") > 1:
            raise NotImplementedError(
                "sharding rules that place parameters over fsdp / tp (%s) under pp > 1: a "
                "pipeline stage runs on whole parameters" % sorted(self._stored)[:4])
        self._cache = {}
        self._pool = None

    # ------------------------------------------------------------ set-up
    def _rules(self):
        """The program's rules (program_rules: the embedding engine's ep
        layout, user layers) followed by BuildStrategy.sharding_rules, which
        win ties under last-match."""
        bs = self._build_strategy.sharding_rules
        if bs is not None and not isinstance(bs, ShardingRules):
            bs = ShardingRules(bs)
        merged = ShardingRules()
        merged.extend(getattr(self._program, "_sharding_rules", None))
        merged.extend(bs)
        return merged

    def _bind_rules(self):
        """The Resolver over this mesh: the merged rules, the legacy
        `sharding_spec` attribute (parallel.shard_parameter) and the
        optimizer accumulators aliased to their parameters."""
        block = self._program.global_block()
        resolver = Resolver(
            self._mesh, self._rules(),
            var_lookup=lambda n: block._var_recursive(n) if block.has_var_recursive(n) else None)
        resolver.add_aliases(block.ops)
        return resolver

    def _device(self):
        """The scope's device where the startup ran; else the CPU under a
        gloo group, this process's card under NCCL or without a group."""
        pg = dist.is_available() and dist.is_initialized()
        backend = dist.get_backend() if pg else None
        if self._scope._device is not None:
            device = self._scope.device
        elif backend == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        elif pg:
            device = torch.device("cpu")
        else:
            from .place import to_device

            device = to_device(None)
        if backend is not None and (device.type == "cuda") != (backend == "nccl"):
            raise RuntimeError(
                "ParallelExecutor on %s under a %r process group: the cards take NCCL, "
                "the CPU gloo" % (device, backend))
        return device

    def _persistables(self):
        block = self._program.global_block()
        used = set()
        for op in block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        return sorted(n for n in used if block.has_var(n) and block.var(n).persistable
                      and isinstance(self._scope.find_var(n), torch.Tensor))

    def _broadcast_state(self):
        """Every persistable the program uses, from rank 0 (its whole value:
        a name already sharded in this scope is left as it is)."""
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        for n in self._persistables():
            if n in self._scope.row_shards:
                continue
            t = self._scope.vars[n].contiguous()
            dist.broadcast(t, src=0)
            self._scope.vars[n] = t

    def _shard_state(self):
        """Shard the state this rank holds in pieces: the ep tables (a row
        spec over an axis of extent > 1, the EmbeddingEngine's), the
        parameters and accumulators a rule places over fsdp / tp (their
        layouts, returned), and, under ReduceStrategy.Reduce at dp > 1, the
        ZeRO-1 optimizer state of the parameters no rule places. Returns
        (the ZeRO-1 params, {name: stored layout})."""
        block = self._program.global_block()
        scope, mesh, resolver = self._scope, self._mesh, self._resolver
        names = self._persistables()
        shapes = {n: tuple(scope.vars[n].shape) for n in names}
        stored = storage_specs(resolver, [n for n in names if n not in scope.row_shards], shapes)
        for n in names:
            spec = resolver.rule_spec(n, shapes[n])
            if n in stored or spec is None or n in scope.row_shards:
                continue
            if len([e for e in spec if e is not None]) != 1 or spec[0] is None \
                    or not isinstance(spec[0], str):
                raise NotImplementedError("%s: spec %s; a variable over %s is split by its rows"
                                          % (n, spec, spec[0]))
            collectives.shard_state(scope, n, mesh, spec[0])
        for n, spec in stored.items():
            collectives.shard_state(scope, n, mesh, spec)
        zero1 = set()
        if (self._build_strategy.reduce_strategy != ReduceStrategy.Reduce
                or mesh.axis_size("dp") == 1):
            return zero1, stored
        for op in block.ops:
            if not _is_optimizer_op(op):
                continue
            p = op.input("Param")[0]
            pval = scope.find_var(p)
            if (p in scope.row_shards or pval is None
                    or resolver.rule_spec(p, tuple(pval.shape)) is not None
                    or not collectives.zero1_shardable(tuple(pval.shape), mesh, "dp")):
                continue
            zero1.add(p)
            for slot in ZERO1_STATE_SLOTS.get(op.type, ()):
                for n in op.inputs.get(slot, ()):
                    if tuple(scope.vars[n].shape) == tuple(pval.shape):
                        collectives.shard_state(scope, n, mesh, "dp")
        resolver.set_zero1("dp", [n for n, e in scope.row_shards.items() if e[1] == "dp"])
        return zero1, stored

    # ------------------------------------------------------------ surface
    @property
    def device_count(self):
        """Number of ways the batch is split: dp × fsdp."""
        return self._mesh.axis_size("dp") * self._mesh.axis_size("fsdp")

    @property
    def topology(self):
        """Mesh axis extents + host count (what an elastic checkpoint
        manifest records)."""
        from .parallel.multihost import host_count

        out = dict(self._mesh.shape)
        out["num_hosts"] = host_count()
        return out

    @property
    def mesh(self):
        return self._mesh

    def _split_feed(self, feed, batch_dim=0):
        """This rank's rows of the global batch: split over dp x fsdp along
        `batch_dim` (1 for feeds stacked on a leading steps axis)."""
        n = self.device_count
        me = self._mesh.index(BATCH_AXES)
        out = {}
        for name, value in feed.items():
            arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
            if arr.ndim > batch_dim:
                if arr.shape[batch_dim] % n:
                    raise ValueError(
                        "batch dim %d of feed %r not divisible by device count %d "
                        "(the reference PE splits the batch across devices the same way)"
                        % (arr.shape[batch_dim], name, n))
                rows = arr.shape[batch_dim] // n
                arr = arr[(slice(None),) * batch_dim + (slice(me * rows, (me + 1) * rows),)]
            out[name] = arr
        return out

    def _cache_key(self, program, feed, fetch_names, steps_per_run):
        pp = self._mesh.axis_size("pp")
        rules = self._rules()
        return (program._uid, program._version, _feed_signature(feed), tuple(fetch_names),
                self._scope._uid, _lowering_flags(), steps_per_run,
                (self._exec_strategy.pipeline_schedule, self._exec_strategy.num_microbatches)
                if pp > 1 else None,
                rules.fingerprint())

    def _block(self, program, feed, fetch_names, steps_per_run=1, feed_signature=None):
        block = program.global_block()
        key = self._cache_key(program, feed_signature or feed, fetch_names, steps_per_run)
        compiled = self._cache.get(key)
        if compiled is not None:
            return compiled
        if _splits(block):
            raise NotImplementedError(
                "a program holding host ops or prints at its top level under the "
                "ParallelExecutor (run it with Executor)")
        from .analysis import maybe_static_verify

        maybe_static_verify(program, list(feed), fetch_names, scope=self._scope,
                            mode="inference" if program._is_test else "training",
                            where="parallel_executor", mesh=self._mesh,
                            rules=self._build_strategy.sharding_rules)
        if self._mesh.axis_size("pp") > 1:
            prepared = _PipelinedBlock(
                block, list(feed), fetch_names, self._scope, self._mesh,
                loss_name=self._loss_name, n_micro=self._exec_strategy.num_microbatches,
                schedule=self._exec_strategy.pipeline_schedule)
            prepared.plan = _ParallelPlan(prepared, block, self._mesh, self._zero1_params,
                                          runs=prepared.opt_runs)
        else:
            prepared = _PerOpProfiledBlock(block, list(feed), fetch_names, self._scope,
                                           mesh=self._mesh)
            prepared.sharding = self._resolver if len(self._resolver.rules or ()) else None
            prepared.stored = {n: s for n, s in self._stored.items()
                               if n in prepared.ro_names or n in prepared.mut_names}
            parallel = self._mesh.axis_size(BATCH_AXES) > 1 or self._stored
            if parallel and not prepared.created_persistables:
                prepared.plan = _ParallelPlan(prepared, block, self._mesh, self._zero1_params,
                                              self._stored)
        compiled = prepared
        if self._scope.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            compiled = _CompiledBlock(prepared, self._pool)
        if steps_per_run > 1:
            compiled = _MultiStepBlock(compiled, steps_per_run)
        self._cache[key] = compiled
        return compiled

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True, steps_per_run=1):
        """One step over the GLOBAL batch `feed` (a dict, or the reference's
        list of per-device dicts, concatenated): this rank runs its rows,
        and the fetches are the global batch's (module docstring).
        steps_per_run > 1 runs k steps in one call over a dict of feeds
        stacked on a leading k axis (a feed list keeps its meaning of
        per-device dicts, so it is refused there), and each fetch comes
        back stacked [k, ...]."""
        if steps_per_run < 1:
            raise ValueError("steps_per_run must be >= 1")
        feed = feed if feed is not None else (feed_dict or {})
        if isinstance(feed, (list, tuple)):
            if steps_per_run > 1:
                raise TypeError(
                    "with steps_per_run>1 feed must be a dict of stacked arrays (leading "
                    "axis k); a feed list means per-device dicts (reference "
                    "parallel_executor.py:183-213)")
            merged = {}
            for d in feed:
                if not isinstance(d, dict):
                    raise TypeError("feed must be a dict or a list of per-device dicts; got "
                                    "list of %r" % type(d).__name__)
                for k, v in d.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(vs, axis=0) for k, vs in merged.items()}
        if steps_per_run > 1 and self._mesh.axis_size("pp") > 1:
            raise NotImplementedError(
                "steps_per_run > 1 is not supported with pipeline parallelism yet; run one "
                "step per call on a pp mesh")
        fetch_names = [f.name if isinstance(f, Variable) else str(f) for f in fetch_list]
        program = _apply_pass_pipeline(
            self._program, self._scope, list(feed), fetch_names,
            pipeline=self._build_strategy.resolved_pass_pipeline())
        block = program.global_block()
        if steps_per_run > 1:
            local = self._split_feed(feed, batch_dim=1)
            one = {n: (v[0] if np.ndim(v) else v) for n, v in local.items()}
            compiled = self._block(program, one, fetch_names, steps_per_run,
                                   feed_signature=local)
            fetches = compiled(self._scope, local)
            fetches = [torch.stack([self._global_fetch(block, n, f[i]) for i in range(len(f))])
                       for n, f in zip(fetch_names, fetches)]
            if return_numpy:
                return _MultiStepBlock.to_host(fetches)
        else:
            local = self._split_feed(feed)
            fetches = self._block(program, local, fetch_names)(self._scope, local)
            fetches = [self._global_fetch(block, n, f) for n, f in zip(fetch_names, fetches)]
        if return_numpy:
            return [(f.float() if f.dtype == torch.bfloat16 else f).detach()
                    .to("cpu", copy=True).numpy() for f in fetches]
        return [f.clone() for f in fetches]

    def _global_fetch(self, block, name, val):
        """The global batch's value of a fetched var: rows all-gathered over
        the batch axes (dp x fsdp) where the var's block shape leads with the
        batch dim, a floating value averaged over them otherwise."""
        n = self._mesh.axis_size(BATCH_AXES)
        if n == 1 or not isinstance(val, torch.Tensor):
            return val
        var = block._var_recursive(name) if block.has_var_recursive(name) else None
        shape = tuple(var.shape) if var is not None and var.shape is not None else ()
        if shape and shape[0] == -1 and val.dim() >= 1:
            return collectives.all_gather(val, BATCH_AXES, mesh=self._mesh)
        if val.is_floating_point():
            return collectives.all_reduce(val, BATCH_AXES, op="mean", mesh=self._mesh)
        return val

    def drop_local_exe_scopes(self):  # compat no-op: no per-device scopes
        pass
