"""DistributeTranspiler: rewrite a single-process program into trainer and
parameter-shard ("pserver") programs for multi-node training (the JAX
package's transpiler/distribute_transpiler.py: the same rewrite, op for op,
so both packages emit the same programs).

Reference analog: python/paddle/fluid/transpiler/distribute_transpiler.py:148
(algorithm described at :16-31): slice each param/grad into blocks
(`slice_var_up`), dispatch blocks to pserver endpoints (ps_dispatcher), insert
split → send → send_barrier → recv → fetch_barrier → concat into the trainer
program, and emit per-pserver programs whose listen_and_serv op runs that
shard's optimizer sub-blocks (reference get_pserver_program:646,
get_trainer_program:527).

Redesign notes:
- A "pserver" is a host-side parameter-shard owner process speaking the
  framework's socket RPC (distributed/rpc.py, the grpc_serde.cc analog);
  its optimize blocks run through the same executor block forms as
  everything else, so on the card the shard update itself runs on the
  device, as a captured CUDA graph.
- `config.mode == "collective"` is the reference's NCCL2 mode
  (gen_nccl_id_op.cc:31-110): no program rewriting at all — the program is
  annotated with (num_trainers, trainer_id) and gradients are all-reduced
  over torch.distributed by the ParallelExecutor (parallel/multihost.py
  init_distributed makes the group), the preferred path; pserver mode
  exists for parity and for host-side parameter sharding of giant
  embeddings.
- Per-param Optimize-role ops that are NOT optimizer updates (gradient clip,
  weight decay) stay on the trainer before the send, instead of moving to the
  pserver: behaviorally identical for per-param transforms and required for
  global-norm clipping, which needs all grads in one place.
- Distributed lookup tables (`lookup_table` with is_distributed=True) are
  rewritten to the mesh-sharded `distributed_lookup_table` op
  (ops/parallel_ops.py, row-sharded over the mesh's ep axis) rather than RPC
  prefetch (distributed/parameter_prefetch.cc:26).

For embedding-scale models, prefer `paddle_tpu_torch.embedding` /
`fluid.layers.distributed_embedding` over pserver mode: the tables are
row-sharded over the mesh `ep` axis with SelectedRows-style sparse gradients
and per-row optimizer updates inside the step, with no pserver processes and
no RPC. Pserver mode remains for reference parity and host-side sharding of
tables too large for the cards' aggregate memory.
"""

from .. import framework
from ..framework import OpRole
from .ps_dispatcher import RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]

# the 12 optimizer update ops (reference operators/optimizers/, SURVEY.md §2.5)
OPTIMIZER_OP_TYPES = frozenset(
    [
        "sgd",
        "momentum",
        "lars_momentum",
        "adam",
        "adamax",
        "adagrad",
        "decayed_adagrad",
        "proximal_adagrad",
        "adadelta",
        "rmsprop",
        "ftrl",
        "proximal_gd",
    ]
)

RPC_OP_ROLE_ATTR = OpRole.RPC


class DistributeTranspilerConfig:
    """Reference distribute_transpiler.py:126-139.

    slice_var_up: split large params into blocks balanced across endpoints.
    split_method: a PSDispatcher subclass.
    min_block_size: do not produce blocks smaller than this many elements
      (reference uses 8192 to keep splits worthwhile).
    mode: "pserver" (default) or "collective" (reference NCCL2 mode).
    """

    slice_var_up = True
    split_method = RoundRobin
    min_block_size = 8192
    mode = "pserver"
    # pserver-side gradient merge (sync mode): accumulate k rounds of
    # trainer-summed grads, apply the optimizer every k-th round on the
    # (averaged, if gradient_merge_avg) accumulator — the reference's
    # multi_batch_merge_pass composed with pserver sharding
    # (test_dist_mnist_batch_merge.py semantics).
    gradient_merge_k = 0
    gradient_merge_avg = True


class VarBlock:
    """One dim-0 slice of a variable: rows [begin, begin+rows)."""

    def __init__(self, varname, block_id, begin, rows, orig_shape, dtype, sliced):
        self.varname = varname
        self.block_id = block_id
        self.begin = begin
        self.rows = rows
        self.orig_shape = tuple(orig_shape)
        self.dtype = dtype
        self.sliced = sliced

    def name(self):
        if not self.sliced:
            return self.varname
        return "%s.block%d" % (self.varname, self.block_id)

    @property
    def shape(self):
        if not self.sliced:
            return self.orig_shape
        return (self.rows,) + self.orig_shape[1:]

    def __repr__(self):
        return "VarBlock(%s, shape=%s)" % (self.name(), self.shape)


def slice_variable(var, slice_count, min_block_size):
    """Split `var` along dim 0 into at most slice_count whole-row blocks, each
    of at least min_block_size elements (reference slice_variable/
    distribute_transpiler.py:1073 `_slice_var_up` semantics: block count
    bounded by both endpoint count and min block size)."""
    shape = tuple(var.shape)
    if not shape or shape[0] <= 1:
        return [VarBlock(var.name, 0, 0, shape[0] if shape else 1, shape, var.dtype, False)]
    numel = 1
    for d in shape:
        numel *= d
    row_elems = numel // shape[0]
    max_by_size = max(1, numel // max(min_block_size, 1))
    n = min(slice_count, max_by_size, shape[0])
    if n <= 1:
        return [VarBlock(var.name, 0, 0, shape[0], shape, var.dtype, False)]
    base, rem = divmod(shape[0], n)
    blocks, begin = [], 0
    for i in range(n):
        rows = base + (1 if i < rem else 0)
        blocks.append(VarBlock(var.name, i, begin, rows, shape, var.dtype, True))
        begin += rows
    return blocks


class DistributeTranspiler:
    """Reference distribute_transpiler.py:148. Usage:

        t = DistributeTranspiler(config)
        t.transpile(trainer_id, program=main, pservers="h1:6174,h2:6174",
                    trainers=2, sync_mode=True)
        trainer_prog = t.get_trainer_program()
        pserver_prog = t.get_pserver_program("h1:6174")
        pserver_startup = t.get_startup_program("h1:6174", pserver_prog)
    """

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    # ------------------------------------------------------------------ #
    def transpile(
        self,
        trainer_id,
        program=None,
        pservers="127.0.0.1:6174",
        trainers=1,
        sync_mode=True,
        startup_program=None,
        current_endpoint="",
    ):
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        if int(getattr(self.config, "gradient_merge_k", 0) or 0) > 1 and not sync_mode:
            raise ValueError(
                "gradient_merge_k > 1 requires sync_mode=True: the merge "
                "window is defined by sync rounds (async applies each grad "
                "as it arrives, so a silent no-merge would train at the "
                "wrong effective batch size)"
            )
        self.origin_program = program or framework.default_main_program()
        self.startup_program = (
            startup_program or framework.default_startup_program()
        )
        self.pserver_endpoints = [e.strip() for e in pservers.split(",") if e.strip()]

        self._rewrite_dist_lookup_tables(self.origin_program)

        if self.config.mode in ("collective", "nccl2"):
            # NCCL2-analog: gradients all-reduce over the multi-host mesh; the
            # program itself is untouched (SURVEY.md §5.8).
            self.origin_program._num_trainers = trainers
            self.origin_program._trainer_id = trainer_id
            self.trainer_program = self.origin_program
            return

        main = self.origin_program
        block = main.global_block()

        # 1. collect (param, grad) pairs from optimizer update ops, preserving
        #    op order (the reference keys on op_role_var the same way).
        self.param_grad_pairs = []
        opt_op_indices = []
        self.lr_ops = []
        for i, op in enumerate(block.ops):
            role = op.attrs.get(OpRole.OP_ROLE_KEY, OpRole.Forward)
            if op.type in OPTIMIZER_OP_TYPES and role & OpRole.Optimize:
                pg = op.attrs.get(OpRole.OP_ROLE_VAR_KEY) or []
                if len(pg) < 2:
                    # an update op we can't attribute to a (param, grad) pair
                    # cannot be placed on a pserver shard; keeping it would
                    # misalign the pair<->op zip below and apply the wrong
                    # update rule to every later param
                    raise ValueError(
                        "optimizer op %r lacks the (param, grad) op_role_var "
                        "attr; build it via optimizer.minimize / "
                        "_optimized_guard so the transpiler can place it"
                        % op.type
                    )
                self.param_grad_pairs.append((pg[0], pg[1]))
                opt_op_indices.append(i)
            elif role == OpRole.LRSched:
                self.lr_ops.append(op)
        self.opt_ops = [block.ops[i] for i in opt_op_indices]
        if not self.param_grad_pairs:
            raise ValueError(
                "no optimizer ops with op_role_var found; run "
                "optimizer.minimize(loss) before transpiling"
            )

        # 2. slice params/grads into blocks and dispatch to endpoints
        dispatcher = self.config.split_method(self.pserver_endpoints)
        slice_count = len(self.pserver_endpoints) if self.config.slice_var_up else 1
        self.param_blocks = {}  # param name -> [VarBlock]
        self.grad_blocks = {}  # grad name -> [VarBlock]
        self.ep_of_block = {}  # block name -> endpoint
        # ep -> {"params": [(pblock, gblock, opt_op)], }
        self.param_grad_ep_mapping = {
            ep: {"params": [], "grads": []} for ep in self.pserver_endpoints
        }
        for (pname, gname), opt_op in zip(self.param_grad_pairs, self.opt_ops):
            pvar = block.var(pname)
            pblocks = slice_variable(pvar, slice_count, self.config.min_block_size)
            gblocks = [
                VarBlock(gname, b.block_id, b.begin, b.rows, b.orig_shape, b.dtype, b.sliced)
                for b in pblocks
            ]
            self.param_blocks[pname] = pblocks
            self.grad_blocks[gname] = gblocks
            eps = dispatcher.dispatch(pblocks)
            for pb, gb, ep in zip(pblocks, gblocks, eps):
                self.ep_of_block[pb.name()] = ep
                self.ep_of_block[gb.name()] = ep
                self.param_grad_ep_mapping[ep]["params"].append((pb, gb, opt_op))
                self.param_grad_ep_mapping[ep]["grads"].append(gb)

        # 3. rewrite the trainer program
        self._build_trainer_program(block, opt_op_indices)

    # ------------------------------------------------------------------ #
    def _rewrite_dist_lookup_tables(self, program):
        """lookup_table(is_distributed=True) → mesh-sharded
        distributed_lookup_table (replaces the reference's RPC prefetch path,
        distribute_transpiler.py _update_dist_lookup_table_vars)."""
        from ..parallel import shard_parameter

        for blk in program.blocks:
            for op in blk.ops:
                if op.type == "lookup_table" and op.attrs.get("is_distributed"):
                    op.type = "distributed_lookup_table"
                    op.attrs = {
                        "axis_name": "ep",
                        OpRole.OP_ROLE_KEY: op.attrs.get(
                            OpRole.OP_ROLE_KEY, OpRole.Forward
                        ),
                    }
                    w = blk._var_recursive(op.input("W")[0])
                    shard_parameter(w, ("ep", None))

    def _build_trainer_program(self, block, opt_op_indices):
        """Delete optimizer + LR ops; append split/send/barriers/recv/concat
        (reference get_trainer_program:527 + _insert_split_op/_append_send_op)."""
        drop = set(opt_op_indices) | {
            i
            for i, op in enumerate(block.ops)
            if op.attrs.get(OpRole.OP_ROLE_KEY) == OpRole.LRSched
        }
        block.ops = [op for i, op in enumerate(block.ops) if i not in drop]

        rpc_attrs = {OpRole.OP_ROLE_KEY: RPC_OP_ROLE_ATTR}
        eps = self.pserver_endpoints

        # split each sliced grad, then one send op per grad
        for gname, gblocks in self.grad_blocks.items():
            if gblocks[0].sliced:
                for gb in gblocks:
                    block.create_var(
                        name=gb.name(), shape=gb.shape, dtype=gb.dtype
                    )
                block.append_op(
                    type="split",
                    inputs={"X": [gname]},
                    outputs={"Out": [gb.name() for gb in gblocks]},
                    attrs={
                        "axis": 0,
                        "sections": [gb.rows for gb in gblocks],
                        OpRole.OP_ROLE_KEY: OpRole.Dist,
                    },
                )
            block.append_op(
                type="send",
                inputs={"X": [gb.name() for gb in gblocks]},
                outputs={},
                attrs=dict(
                    rpc_attrs,
                    epmap=[self.ep_of_block[gb.name()] for gb in gblocks],
                    sync_mode=self.sync_mode,
                    trainer_id=self.trainer_id,
                ),
            )
        if self.sync_mode:
            block.append_op(
                type="send_barrier",
                inputs={},
                outputs={},
                attrs=dict(rpc_attrs, endpoints=eps, trainer_id=self.trainer_id),
            )
        # recv updated param blocks, then concat the sliced ones back
        for pname, pblocks in self.param_blocks.items():
            for pb in pblocks:
                if pb.sliced:
                    block.create_var(name=pb.name(), shape=pb.shape, dtype=pb.dtype)
            block.append_op(
                type="recv",
                inputs={},
                outputs={"Out": [pb.name() for pb in pblocks]},
                attrs=dict(
                    rpc_attrs,
                    epmap=[self.ep_of_block[pb.name()] for pb in pblocks],
                    trainer_id=self.trainer_id,
                ),
            )
        if self.sync_mode:
            block.append_op(
                type="fetch_barrier",
                inputs={},
                outputs={},
                attrs=dict(rpc_attrs, endpoints=eps, trainer_id=self.trainer_id),
            )
        for pname, pblocks in self.param_blocks.items():
            if pblocks[0].sliced:
                block.append_op(
                    type="concat",
                    inputs={"X": [pb.name() for pb in pblocks]},
                    outputs={"Out": [pname]},
                    attrs={"axis": 0, OpRole.OP_ROLE_KEY: OpRole.Dist},
                )
        self.trainer_program = self.origin_program

    def get_trainer_program(self):
        return self.trainer_program

    # ------------------------------------------------------------------ #
    def _sliced_state_name(self, state_name, pb):
        return "%s.block%d" % (state_name, pb.block_id) if pb.sliced else state_name

    def get_pserver_program(self, endpoint):
        """Program for one parameter-shard owner: a listen_and_serv op whose
        sub-blocks hold this shard's optimizer updates (reference
        get_pserver_program:646; sync loop listen_and_serv_op.cc:106-176)."""
        assigned = self.param_grad_ep_mapping[endpoint]["params"]
        prog = framework.Program()
        g0 = prog.global_block()
        origin_block = self.origin_program.global_block()

        lr_block_idx = -1
        if self.lr_ops:
            lr_block = prog._create_block(parent_idx=0)
            for op in self.lr_ops:
                for name in op.input_arg_names + op.output_arg_names:
                    if not g0.has_var(name) and origin_block.has_var_recursive(name):
                        ov = origin_block._var_recursive(name)
                        g0.create_var(
                            name=name,
                            shape=ov.shape,
                            dtype=ov.dtype,
                            persistable=True,
                        )
                lr_block.ops.append(
                    framework.Operator(
                        lr_block, op.type, op.inputs, op.outputs, dict(op.attrs)
                    )
                )
            lr_block_idx = lr_block.idx
            prog.current_block_idx = 0

        optimize_blocks = []
        grad_to_block_id = []
        for pb, gb, opt_op in assigned:
            sub = prog._create_block(parent_idx=0)
            prog.current_block_idx = 0
            # remap the opt op's vars to this shard's slices
            pname, gname = pb.varname, gb.varname
            inputs, outputs = {}, {}
            for slot, names in opt_op.inputs.items():
                inputs[slot] = [self._shard_var_name(prog, origin_block, n, pb, pname, gname, gb) for n in names]
            for slot, names in opt_op.outputs.items():
                outputs[slot] = [self._shard_var_name(prog, origin_block, n, pb, pname, gname, gb) for n in names]
            attrs = dict(opt_op.attrs)
            attrs[OpRole.OP_ROLE_KEY] = OpRole.Optimize
            sub.ops.append(
                framework.Operator(sub, opt_op.type, inputs, outputs, attrs)
            )
            optimize_blocks.append(sub)
            grad_to_block_id.append("%s:%d" % (gb.name(), sub.idx))

        g0.append_op(
            type="listen_and_serv",
            inputs={},
            outputs={},
            attrs={
                "endpoint": endpoint,
                "sync_mode": self.sync_mode,
                "Fanin": self.trainer_num,
                "optimize_blocks": [b.idx for b in optimize_blocks],
                "grad_to_block_id": grad_to_block_id,
                "lr_decay_block_id": lr_block_idx,
                "gradient_merge_k": int(
                    getattr(self.config, "gradient_merge_k", 0) or 0
                ),
                "gradient_merge_avg": bool(
                    getattr(self.config, "gradient_merge_avg", True)
                ),
                OpRole.OP_ROLE_KEY: RPC_OP_ROLE_ATTR,
            },
        )
        prog._ps_endpoint = endpoint
        return prog

    def _shard_var_name(self, prog, origin_block, name, pb, pname, gname, gb):
        """Map an optimizer-op var name to its pserver shard var, creating the
        var in the pserver program: param/grad → .blockN slices; same-shaped
        optimizer state (moments) sliced likewise; scalars (lr, beta pows)
        carried whole."""
        g0 = prog.global_block()
        ov = origin_block._var_recursive(name) if origin_block.has_var_recursive(name) else None
        if name == pname:
            new, shape, persistable = pb.name(), pb.shape, True
        elif name == gname:
            new, shape, persistable = gb.name(), gb.shape, False
        elif (
            ov is not None
            and pb.sliced
            and ov.shape == pb.orig_shape
            and ov.persistable
        ):
            new = self._sliced_state_name(name, pb)
            shape, persistable = pb.shape, True
        else:
            new = name
            shape = ov.shape if ov is not None else None
            persistable = ov.persistable if ov is not None else True
        if not g0.has_var(new):
            v = g0.create_var(
                name=new,
                shape=shape,
                dtype=ov.dtype if ov is not None else "float32",
                persistable=persistable,
            )
            if ov is not None and name == pname:
                v.is_parameter_shard = True
        return new

    def get_startup_program(self, endpoint, pserver_program=None):
        """Init ops for this endpoint's shards. Initializers are re-emitted
        with the sliced shape (documented deviation from the reference, which
        slices the initialized full tensor: fan-in-dependent initializers see
        the shard shape; distribution equivalence holds for the constant /
        uniform / normal initializers optimizers actually use on state)."""
        prog = framework.Program()
        blk = prog.global_block()
        origin_startup = self.startup_program.global_block()

        # map: output var name -> its init op in the original startup program
        init_of = {}
        for op in origin_startup.ops:
            for out in op.output_arg_names:
                init_of[out] = op

        if pserver_program is None:
            pserver_program = self.get_pserver_program(endpoint)
        done = set()
        for tname, pv in pserver_program.global_block().vars.items():
            if not pv.persistable or tname in done:
                continue
            done.add(tname)
            base = tname.split(".block")[0]
            src = init_of.get(base)
            if src is None:
                continue  # e.g. recv-only buffers; values arrive via RPC
            shape = tuple(pv.shape) if pv.shape is not None else None
            attrs = dict(src.attrs)
            if "shape" in attrs and shape is not None:
                attrs["shape"] = list(shape)
            blk.create_var(
                name=tname, shape=shape, dtype=pv.dtype, persistable=True
            )
            blk.append_op(
                type=src.type,
                inputs=src.inputs,
                outputs={
                    slot: [tname if n == base else n for n in names]
                    for slot, names in src.outputs.items()
                },
                attrs=attrs,
            )
        return prog
