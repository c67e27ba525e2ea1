"""Forward abstract interpretation and backward liveness over the Graph IR
(the torch counterpart of paddle_tpu/analysis/dataflow.py).

- `analyze_program` walks the blocks in execution order and propagates a
  `VarFact` per variable: shape (ints plus `SymDim` symbols for dynamic
  axes), dtype, LoD level and kind ("tensor" or "opaque"). Each op's
  transfer function is its lowering run on `device="meta"` tensors, the
  machinery of ops/registry.infer_shape, where the JAX package uses
  jax.eval_shape; a dynamic axis rides through as a sentinel extent and
  maps back to its symbol. A control-flow op (one whose attrs hold a
  sub-block) is not lowered: its sub-blocks are walked in line with the
  parent's facts, their ops recorded under their block index, and its
  outputs take their declared metadata (which append_op's shape inference
  wrote); so do the outputs of an op the registry gives a shape function
  of its own (the recurrent ops, whose lowering runs its time loop). A transfer that fails degrades to opaque and is recorded as a
  problem: the analyzer never rejects a program the executor would run.
- `Analysis.live_after` is the backward pass: per-op live-variable sets
  over the graph's def-use edges, which the dead-write and
  write-never-read checkers read (analysis/checkers.py).

Sharding specs need a mesh, which the port does not have yet: `mesh` and
`resolver` are None on every Analysis, and passing a mesh raises (ROADMAP
A6).
"""

import torch

from .. import framework
from ..ops import registry

__all__ = ["SymDim", "VarFact", "OpRecord", "Analysis", "analyze_program"]

# Symbolic-extent sentinels substituted for dynamic (-1) dims: the base
# matches ops/registry._DYN_SENTINEL, and each further symbol steps down by
# a prime stride so arithmetic on one symbol does not land on another's.
_SYM_BASE = 8191
_SYM_STRIDE = 101
_SYM_MAX = 40


class SymDim:
    """One symbolic dynamic extent (a -1 dim). Two facts share a SymDim
    object iff the analyzer proved the extents equal."""

    __slots__ = ("name", "sentinel")

    def __init__(self, name, sentinel):
        self.name = name
        self.sentinel = sentinel

    def __repr__(self):
        return "?%s" % self.name


class VarFact:
    """The abstract value of one variable: kind "tensor" (shape and dtype
    meaningful) or "opaque" (unknown, the bottom of the lattice). shape
    entries are ints or SymDims; spec is the sharding layout (always None
    here: no mesh binds); writer is the producing (block_idx, op_index),
    None for external values."""

    __slots__ = ("shape", "dtype", "lod_level", "kind", "spec", "writer")

    def __init__(self, shape=None, dtype=None, lod_level=0, kind="tensor", spec=None,
                 writer=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lod_level = lod_level
        self.kind = kind
        self.spec = spec  # a sharding layout: None until a mesh binds (A6)
        self.writer = writer

    @property
    def known(self):
        return self.kind == "tensor" and self.shape is not None and self.dtype is not None

    def concrete_shape(self):
        """Shape with SymDims replaced by -1 (the Program metadata idiom)."""
        if self.shape is None:
            return None
        return tuple(-1 if isinstance(d, SymDim) else int(d) for d in self.shape)

    def __repr__(self):
        if self.kind == "opaque":
            return "VarFact(opaque)"
        return "VarFact(%s %s)" % (list(self.shape) if self.shape is not None else "?",
                                   self.dtype)


class OpRecord:
    """One interpreted op: the facts in and out, and a note when the
    transfer degraded ("host", "unregistered", "skip", "no-lowering",
    "opaque-inputs" or "transfer-error: ...")."""

    __slots__ = ("op", "block_idx", "index", "opdef", "ins", "outs", "note")

    def __init__(self, op, block_idx, index, opdef, ins, outs, note=None):
        self.op = op
        self.block_idx = block_idx
        self.index = index
        self.opdef = opdef
        self.ins = ins
        self.outs = outs
        self.note = note

    def display(self):
        from ..executor import op_display_name

        return op_display_name(self.op)


class Analysis:
    """The analyzer's report: final facts of the global block, per-op
    records (every block, in interpretation order), analyzer-level problems
    and the backward-liveness query the checkers read."""

    def __init__(self, program, graph, feed_names, fetch_names, scope, mesh, resolver, mode):
        self.program = program
        self.graph = graph
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.scope = scope
        self.mesh = mesh
        self.resolver = resolver
        self.mode = mode
        self.facts = {}  # block-0 name -> VarFact after the last op
        self.records = []  # [OpRecord] in interpretation order
        self.problems = []  # [(block_idx, op_index, op, message)]
        self.entry_origin = {}  # external name -> "feed" | "scope" | "declared"
        self._live = {}  # block_idx -> [set(name) live AFTER each op]

    def problem(self, block_idx, op_index, op, message):
        self.problems.append((block_idx, op_index, op, message))

    def records_in_block(self, block_idx):
        return [r for r in self.records if r.block_idx == block_idx]

    def live_after(self, block_idx=0):
        """Backward liveness over the block's ops: live_after[i] is the set
        of names read by any LATER op in the block or live out of it
        (fetched, persistable, scope-resident, or referenced below block
        0). Kill-then-gen: a write rebinds the whole value, so a write kills
        even a root, and a read-modify-write op stays live through its own
        input."""
        cached = self._live.get(block_idx)
        if cached is not None:
            return cached
        nodes = self.graph.op_nodes(block_idx)
        roots = set(self.fetch_names)
        sub_names = self.graph.subblock_reachable_names()
        for node in nodes:
            for vn in node.inputs + node.outputs:
                if vn.persistable or vn.name in sub_names:
                    roots.add(vn.name)
                elif self.scope is not None and self.scope.find_var(vn.name) is not None:
                    roots.add(vn.name)
        live = set(roots)
        out = [None] * len(nodes)
        for i in range(len(nodes) - 1, -1, -1):
            node = nodes[i]
            out[i] = set(live)
            live -= {vn.name for vn in node.outputs}
            live |= {vn.name for vn in node.inputs}
        self._live[block_idx] = out
        return out


class _Analyzer:
    def __init__(self, graph, feed_names, fetch_names, scope, mode, program, feed_facts=None):
        self.program = graph.program  # the graph's shadow program
        self.scope = scope
        self.feed_facts = dict(feed_facts or {})
        self.report = Analysis(program, graph, feed_names, fetch_names, scope, None, None, mode)
        self._symbols = {}  # name -> SymDim
        self._by_sentinel = {}  # sentinel -> SymDim

    def _sym(self, name):
        s = self._symbols.get(name)
        if s is None:
            sentinel = _SYM_BASE - _SYM_STRIDE * min(len(self._symbols), _SYM_MAX)
            s = SymDim(name, sentinel)
            self._symbols[name] = s
            self._by_sentinel.setdefault(sentinel, s)
        return s

    def _shape_from_meta(self, name, shape):
        """Program metadata shape -> fact shape; dim 0 of -1 is the shared
        batch symbol, any other -1 its own (name, dim) symbol."""
        if shape is None:
            return None
        return tuple(
            self._sym("batch" if i == 0 else "%s.%d" % (name, i)) if d == -1 else int(d)
            for i, d in enumerate(shape)
        )

    def _fact_from_var(self, name, v):
        if v is None or v.shape is None or v.dtype is None:
            return VarFact(kind="opaque")
        return VarFact(shape=self._shape_from_meta(name, v.shape),
                       dtype=framework.convert_np_dtype(v.dtype),
                       lod_level=getattr(v, "lod_level", 0) or 0)

    def _external_fact(self, name, block):
        """Fact for a name read before any write: feed, scope state, or the
        declared metadata (the executor's classification order)."""
        declared = block._var_recursive(name) if block.has_var_recursive(name) else None
        override = self.feed_facts.get(name)
        if override is not None:
            self.report.entry_origin.setdefault(name, "feed")
            return override
        if name in self.report.feed_names:
            self.report.entry_origin.setdefault(name, "feed")
            return self._fact_from_var(name, declared)
        val = self.scope.find_var(name) if self.scope is not None else None
        if val is not None:
            self.report.entry_origin.setdefault(name, "scope")
            if isinstance(val, torch.Tensor):
                return VarFact(shape=tuple(int(d) for d in val.shape),
                               dtype=registry._FRAMEWORK_DTYPES.get(val.dtype))
            return VarFact(kind="opaque")
        self.report.entry_origin.setdefault(name, "declared")
        return self._fact_from_var(name, declared)

    def _gather(self, op, env, block):
        ins = {}
        for slot, names in op.inputs.items():
            if not names:
                continue
            row = []
            for n in names:
                if n == registry.EMPTY_VAR_NAME:
                    row.append(None)
                    continue
                f = env.get(n)
                if f is None:
                    f = env[n] = self._external_fact(n, block)
                row.append(f)
            ins[slot] = row
        return ins

    def _scatter(self, op, outs, env, site):
        rec_outs = {}
        for slot, names in op.outputs.items():
            vals = (outs or {}).get(slot)
            row = []
            for i, n in enumerate(names):
                f = vals[i] if vals is not None and i < len(vals) else None
                if f is None:
                    f = VarFact(kind="opaque")
                f.writer = site
                if n != registry.EMPTY_VAR_NAME:
                    env[n] = f
                row.append(f)
            rec_outs[slot] = row
        return rec_outs

    def _default_transfer(self, op, opdef, ins):
        """The lowering on meta tensors; SymDims ride through as sentinel
        extents and map back on output."""
        meta_ins = {}
        for slot, facts in ins.items():
            row = []
            for f in facts:
                if f is None:
                    row.append(None)
                    continue
                if not f.known or f.dtype not in registry._TORCH_DTYPES:
                    return None, "opaque-inputs"
                shape = tuple(d.sentinel if isinstance(d, SymDim) else int(d) for d in f.shape)
                row.append(torch.empty(shape, dtype=registry.torch_dtype(f.dtype),
                                       device="meta"))
            meta_ins[slot] = row
        attrs = dict(op.attrs)
        ctx = registry.LowerCtx("meta", is_test=bool(attrs.get("is_test", False)))
        try:
            outs = opdef.lower(ctx, meta_ins, attrs)
        except Exception as e:  # a failed transfer degrades, never raises
            return None, "transfer-error: %s" % (str(e).splitlines() or [""])[0]
        facts = {}
        for slot, vals in outs.items():
            row = []
            for val in vals:
                if not isinstance(val, torch.Tensor):
                    row.append(None)
                    continue
                shape = tuple(self._by_sentinel.get(int(d), int(d)) for d in val.shape)
                row.append(VarFact(shape=shape, dtype=registry._FRAMEWORK_DTYPES.get(val.dtype)))
            facts[slot] = row
        return facts, None

    def _subblock_outs(self, op, env, block):
        """Walk a control-flow op's sub-blocks in line (their records land
        under their own block index) and give its outputs their declared
        metadata, or the sub-block's last fact where none is declared."""
        sub_env = dict(env)
        for v in op.attrs.values():
            if isinstance(v, framework.Block):
                self._run_block(self.program.blocks[v.idx], sub_env)
        return self._declared_outs(op, block, sub_env)

    def _declared_outs(self, op, block, env):
        """Each output's declared metadata (what append_op's shape inference
        wrote), else its fact in `env`, else opaque."""
        outs = {}
        for slot, names in op.outputs.items():
            row = []
            for n in names:
                declared = (block._var_recursive(n) if n != registry.EMPTY_VAR_NAME
                            and block.has_var_recursive(n) else None)
                f = self._fact_from_var(n, declared)
                if not f.known and env.get(n) is not None:
                    last = env[n]
                    f = VarFact(last.shape, last.dtype, last.lod_level, last.kind)
                row.append(f)
            outs[slot] = row
        return outs

    def _run_block(self, block, env):
        for index, op in enumerate(block.ops):
            site = (block.idx, index)
            try:
                opdef = registry.get(op.type)
            except KeyError:
                opdef = None
            ins = self._gather(op, env, block)
            outs = None
            note = None
            if opdef is None:
                note = "unregistered"
            elif opdef.skip_exec:
                note = "skip"
            elif any(isinstance(v, framework.Block) for v in op.attrs.values()):
                outs = self._subblock_outs(op, env, block)
            elif opdef.custom_infer_shape is not None:
                # its registry shape function stands in for a lowering that
                # would run a recurrence step by step (dynamic_lstm's
                # time loop over a sentinel-long sequence)
                outs = self._declared_outs(op, block, {})
            elif opdef.is_host:
                note = "host"
            elif opdef.lower is None:
                note = "no-lowering"
            else:
                outs, note = self._default_transfer(op, opdef, ins)
                if note is not None and note.startswith("transfer-error"):
                    self.report.problem(block.idx, index, op, note)
            rec_outs = self._scatter(op, outs, env, site)
            self.report.records.append(OpRecord(op, block.idx, index, opdef, ins, rec_outs,
                                                note))
        return env

    def run(self):
        block = self.program.global_block()
        env = {}
        # feeds enter up front, so a fed name never falls back to the scope
        for n in self.report.feed_names:
            env[n] = self._external_fact(n, block)
        self._run_block(block, env)
        self.report.facts = env
        return self.report


def analyze_program(program, feed_names=(), fetch_names=(), scope=None, mesh=None,
                    rules=None, mode="training", feed_facts=None):
    """Whole-program forward abstract interpretation; returns an `Analysis`.
    `program` is a Program or a passes.Graph. `feed_facts` (name ->
    VarFact) overrides feed metadata with concrete run shapes. `mode`
    ("training" / "inference" / "serving") is read by the determinism
    checker. `rules` is accepted for the JAX signature; without a mesh the
    sharding-rules checker reads `program._sharding_rules` itself. A mesh
    raises: sharding layouts come with the mesh (ROADMAP A6)."""
    from ..passes.graph import Graph

    if mesh is not None:
        raise NotImplementedError(
            "analyze_program(mesh=...): sharding layouts need the device mesh, which the "
            "port has not ported yet (parallel/, ROADMAP A6)")
    graph = program if isinstance(program, Graph) else Graph(program)
    program = graph.program if isinstance(program, Graph) else program
    return _Analyzer(graph, feed_names, fetch_names, scope, mode, program,
                     feed_facts=feed_facts).run()
