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

On the card the ParallelExecutor runs on its process's device with NCCL; a
CUDA place whose process group is not NCCL raises, and so does the CPU under
NCCL. Without a process group it runs on the one local device. fsdp, tp and
pp (BuildStrategy.sharding_rules, pipeline_stages, a spec naming tp or fsdp)
and steps_per_run > 1 raise, naming their ROADMAP queue.
"""

import numpy as np
import torch
import torch.distributed as dist

from . import framework
from .executor import (
    _CompiledBlock,
    _PerOpProfiledBlock,
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
from .transpiler.gradient_merge import OPTIMIZER_OP_TYPES

__all__ = ["ParallelExecutor", "BuildStrategy", "ExecutionStrategy"]

# optimizer state slots that ZeRO-1 stores sharded (the JAX package's
# core_ops.ZERO1_STATE_SLOTS)
ZERO1_STATE_SLOTS = {
    "momentum": ("Velocity",),
    "lars_momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"),
    "adagrad": ("Moment",),
    "decayed_adagrad": ("Moment",),
    "rmsprop": ("MeanSquare", "Moment", "MeanGrad"),
    "adadelta": ("AvgSquaredGrad", "AvgSquaredUpdate"),
    "adamax": ("Moment", "InfNorm"),
    "ftrl": ("SquaredAccumulator", "LinearAccumulator"),
}

# the largest gradient bucket (bytes): a few collectives a step, each big
# enough to run near the link's rate
BUCKET_BYTES = 32 << 20

_A6B = "ROADMAP A6b"


class ReduceStrategy:
    """reference details/build_strategy.h ReduceStrategy"""

    AllReduce = 0
    Reduce = 1


class BuildStrategy:
    """Knobs from reference details/build_strategy.h (pybind.cc:746-833).
    reduce_strategy: AllReduce averages every gradient over dp with the
    optimizer state replicated; Reduce is the ZeRO-1 tier (module
    docstring). pass_pipeline / fuse_kernels choose the graph passes, as in
    the JAX package. sharding_rules (tp / fsdp) and pipeline_stages > 1
    raise (ROADMAP A6b). The rest do nothing here: gradient_scale_strategy
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
    """reference ExecutionStrategy (pybind.cc:746). Every field does nothing
    here: num_threads (a rank runs its ops on one stream), use_cuda (the
    place comes from the scope and the process group), allow_op_delay,
    num_iteration_per_drop_scope (a step's intermediates are freed as it
    runs), and the pp knobs pipeline_schedule / num_microbatches (the
    pipeline comes with ROADMAP A6b)."""

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


class _DataParallelPlan:
    """What a prepared block adds under dp > 1 (executor._PerOpProfiledBlock
    calls it): `sync(env)` before unit `sync_at` (the first unit holding an
    Optimize-role op) averages the parameter gradients the backward produced
    over dp: dense ones in coalesced all-reduce buckets, ZeRO-1 ones whose
    only readers are their optimizer ops in reduce-scatter buckets (this
    rank's rows), SelectedRows pairs all-gathered. `lower` runs the units
    that hold ZeRO-1 optimizer ops, op by op, each such op over this rank's
    rows of its param, gradient and state, then all-gathers the param."""

    def __init__(self, prepared, block, mesh, zero1_params):
        from .embedding.selected_rows import is_selected_rows

        self.mesh = mesh
        self.dp = mesh.axis_size("dp")
        runs = prepared.runs
        self.sync_at = next((i for i, run in enumerate(runs)
                             if any(_role(op) & OpRole.Optimize for op in run)), None)
        self.zero1_units, self.zero1_ops = set(), set()
        self.dense, self.scattered, self.sparse = [], [], []
        if self.sync_at is None:
            return
        params = {p.name for p in block.all_parameters()}
        produced = {n for run in runs[:self.sync_at] for op in run for n in op.output_arg_names}
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
            elif p in zero1_params and all(id(op) in self.zero1_ops for op in readers[g]):
                self.scattered.append(g)
            else:
                self.dense.append(g)

    def sync(self, env):
        group = self.mesh.group("dp")
        for names in _buckets(self.dense, env):
            flat = torch.cat([env[n].reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            flat = flat / self.dp
            off = 0
            for n in names:
                t = env[n]
                env[n] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
        for names in _buckets(self.scattered, env):
            grads = [env[n] for n in names]
            rows = [g.shape[0] // self.dp for g in grads]
            src = torch.cat([g.narrow(0, j * r, r).reshape(-1)
                             for j in range(self.dp) for g, r in zip(grads, rows)])
            out = collectives.reduce_scatter(src, "dp", mesh=self.mesh) / self.dp
            off = 0
            for n, g, r in zip(names, grads, rows):
                shape = (r,) + tuple(g.shape[1:])
                numel = g.numel() // self.dp
                env[n] = out[off:off + numel].view(shape)
                off += numel
        for vals, rows in self.sparse:
            env[vals] = collectives.all_gather(env[vals], "dp", mesh=self.mesh) / self.dp
            env[rows] = collectives.all_gather(env[rows], "dp", mesh=self.mesh)

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
        if self._build_strategy.sharding_rules is not None:
            raise NotImplementedError(
                "BuildStrategy.sharding_rules (tp / fsdp layouts) are ported with %s" % _A6B)
        if self._build_strategy.pipeline_stages > 1:
            raise NotImplementedError(
                "BuildStrategy.pipeline_stages > 1: the pipeline is ported with %s" % _A6B)
        device = self._device()
        self._mesh = make_mesh(mesh_config or MeshConfig(), device)
        self._scope.bind(device)
        self._check_specs()
        self._broadcast_state()
        self._zero1_params = self._shard_state()
        self._cache = {}
        self._pool = None

    # ------------------------------------------------------------ set-up
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

    def _check_specs(self):
        for var in self._program.global_block().vars.values():
            spec = getattr(var, "sharding_spec", None)
            if not spec:
                continue
            named = [a for a in spec if a is not None]
            if any(a in ("tp", "fsdp", "pp") for a in named) or any(
                    a is not None for a in spec[1:]):
                raise NotImplementedError(
                    "%s: sharding spec %s (tp / fsdp layouts) is ported with %s"
                    % (var.name, tuple(spec), _A6B))

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
        a name already row-sharded in this scope is left as it is)."""
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        for n in self._persistables():
            if n in self._scope.row_shards:
                continue
            t = self._scope.vars[n].contiguous()
            dist.broadcast(t, src=0)
            self._scope.vars[n] = t

    def _shard_state(self):
        """Row-shard the ep tables (a (axis, None) spec over an axis of
        extent > 1) and, under ReduceStrategy.Reduce at dp > 1, the ZeRO-1
        optimizer state. Returns the ZeRO-1 params."""
        block = self._program.global_block()
        scope, mesh = self._scope, self._mesh
        for n in self._persistables():
            spec = getattr(block.var(n), "sharding_spec", None)
            if spec and mesh.axis_size(spec[0]) > 1:
                if scope.vars[n].shape[0] % mesh.axis_size(spec[0]):
                    raise ValueError("%s: %d rows do not split over %s=%d" % (
                        n, scope.vars[n].shape[0], spec[0], mesh.axis_size(spec[0])))
                collectives.shard_state(scope, n, mesh, spec[0])
        zero1 = set()
        if (self._build_strategy.reduce_strategy != ReduceStrategy.Reduce
                or mesh.axis_size("dp") == 1):
            return zero1
        for op in block.ops:
            if not _is_optimizer_op(op):
                continue
            p = op.input("Param")[0]
            pval = scope.find_var(p)
            if (getattr(block._var_recursive(p), "sharding_spec", None) or pval is None
                    or not collectives.zero1_shardable(tuple(pval.shape), mesh, "dp")):
                continue
            zero1.add(p)
            for slot in ZERO1_STATE_SLOTS.get(op.type, ()):
                for n in op.inputs.get(slot, ()):
                    if tuple(scope.vars[n].shape) == tuple(pval.shape):
                        collectives.shard_state(scope, n, mesh, "dp")
        return zero1

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

    def _split_feed(self, feed, block):
        dp = self.device_count
        me = self._mesh.index("dp")
        out = {}
        for name, value in feed.items():
            arr = value if isinstance(value, torch.Tensor) else np.asarray(value)
            if arr.ndim >= 1:
                if arr.shape[0] % dp:
                    raise ValueError(
                        "batch dim %d of feed %r not divisible by device count %d "
                        "(the reference PE splits the batch across devices the same way)"
                        % (arr.shape[0], name, dp))
                rows = arr.shape[0] // dp
                arr = arr[me * rows:(me + 1) * rows]
            out[name] = arr
        return out

    def _block(self, program, feed, fetch_names):
        block = program.global_block()
        key = (program._uid, program._version, _feed_signature(feed), tuple(fetch_names),
               self._scope._uid, _lowering_flags())
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
                            where="parallel_executor")
        prepared = _PerOpProfiledBlock(block, list(feed), fetch_names, self._scope,
                                       mesh=self._mesh)
        if self._mesh.axis_size("dp") > 1 and not prepared.created_persistables:
            prepared.plan = _DataParallelPlan(prepared, block, self._mesh, self._zero1_params)
        compiled = prepared
        if self._scope.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            compiled = _CompiledBlock(prepared, self._pool)
        self._cache[key] = compiled
        return compiled

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True, steps_per_run=1):
        """One step over the GLOBAL batch `feed` (a dict, or the reference's
        list of per-device dicts, concatenated): this rank runs its rows,
        and the fetches are the global batch's (module docstring)."""
        if steps_per_run > 1:
            raise NotImplementedError(
                "steps_per_run > 1: the port's Executor has no multi-step block yet (%s)"
                % _A6B)
        feed = feed if feed is not None else (feed_dict or {})
        if isinstance(feed, (list, tuple)):
            merged = {}
            for d in feed:
                if not isinstance(d, dict):
                    raise TypeError("feed must be a dict or a list of per-device dicts; got "
                                    "list of %r" % type(d).__name__)
                for k, v in d.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(vs, axis=0) for k, vs in merged.items()}
        fetch_names = [f.name if isinstance(f, Variable) else str(f) for f in fetch_list]
        program = _apply_pass_pipeline(
            self._program, self._scope, list(feed), fetch_names,
            pipeline=self._build_strategy.resolved_pass_pipeline())
        block = program.global_block()
        local = self._split_feed(feed, block)
        fetches = self._block(program, local, fetch_names)(self._scope, local)
        fetches = [self._global_fetch(block, n, f) for n, f in zip(fetch_names, fetches)]
        if return_numpy:
            return [(f.float() if f.dtype == torch.bfloat16 else f).detach()
                    .to("cpu", copy=True).numpy() for f in fetches]
        return [f.clone() for f in fetches]

    def _global_fetch(self, block, name, val):
        """The global batch's value of a fetched var: rows all-gathered over
        dp where the var's block shape leads with the batch dim, a floating
        value averaged over dp otherwise."""
        if self._mesh.axis_size("dp") == 1 or not isinstance(val, torch.Tensor):
            return val
        var = block._var_recursive(name) if block.has_var_recursive(name) else None
        shape = tuple(var.shape) if var is not None and var.shape is not None else ()
        if shape and shape[0] == -1 and val.dim() >= 1:
            return collectives.all_gather(val, "dp", mesh=self._mesh)
        if val.is_floating_point():
            return collectives.all_reduce(val, "dp", op="mean", mesh=self._mesh)
        return val

    def drop_local_exe_scopes(self):  # compat no-op: no per-device scopes
        pass
