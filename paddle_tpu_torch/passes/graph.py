"""Graph IR over a fluid Program (reference framework/ir/graph.h).

The reference converts a ProgramDesc into an `ir::Graph` of OpNodes and
VarNodes with def-use edges, runs `Pass`es over it, and converts back
(graph_to_program_pass). This module is the same seam here (a copy of
paddle_tpu/passes/graph.py):

- `Graph(program)` deep-copies the Program into a private *shadow* program
  (passes never mutate the caller's object) and indexes every block into
  `OpNode`/`VarNode` structures with producer/consumer edges, including
  sub-block awareness: a control-flow op (while/cond/recurrent) counts as a
  consumer of every parent-block variable its sub-block tree references, so
  reachability passes (dead-op elimination, constant folding) are naturally
  conservative across block boundaries.
- Passes mutate the shadow program through the node API (or directly — the
  shadow's blocks are ordinary framework.Block objects, so transpiler-style
  rewrite code ports verbatim) and call `refresh()` to recompute edges.
- `to_program()` emits an independent Program; `write_to(program)` replaces
  a caller program's blocks in place (the deprecated-transpiler-shim path).

The round-trip `Graph(p).to_program()` is LOSSLESS: bit-identical
`Program.to_dict()`. Losslessness is why the clone below exists instead of
reusing `Program.clone()` — that one drops dynamic annotations such as
`sharding_spec`, which a sharded executor consults after passes ran.
"""

import copy

from .. import framework
from ..framework import Block, Operator, Parameter, Variable

__all__ = ["Graph", "GraphVerifyError", "OpNode", "VarNode", "clone_program"]

# var attributes outside Variable.__init__'s signature that must survive a
# pass pipeline (set with plain attribute assignment elsewhere in the tree)
_DYNAMIC_VAR_ATTRS = ("sharding_spec",)


def _clone_var(block, v):
    if isinstance(v, Parameter):
        nv = Parameter(
            block,
            shape=v.shape,
            dtype=v.dtype,
            name=v.name,
            stop_gradient=v.stop_gradient,  # batch_norm stats: True
            trainable=v.trainable,
            optimize_attr=copy.copy(v.optimize_attr),
            regularizer=v.regularizer,
            gradient_clip_attr=v.gradient_clip_attr,
            do_model_average=v.do_model_average,
        )
    else:
        nv = Variable(
            block,
            name=v.name,
            shape=v.shape,
            dtype=v.dtype,
            type=v.type,
            lod_level=v.lod_level,
            persistable=v.persistable,
            stop_gradient=v.stop_gradient,
            is_data=v.is_data,
        )
    for attr in _DYNAMIC_VAR_ATTRS:
        val = getattr(v, attr, None)
        if val is not None:
            setattr(nv, attr, val)
    return nv


def clone_program(src):
    """Deep copy preserving var insertion order, sub-block links, op attrs
    (Block references remapped), random_seed, _is_test, and the dynamic var
    annotations Program.clone drops."""
    p = framework.Program()
    p.random_seed = src.random_seed
    p._is_test = getattr(src, "_is_test", False)
    p.blocks = [Block(p, blk.idx, blk.parent_idx) for blk in src.blocks]
    for blk, nb in zip(src.blocks, p.blocks):
        for name, v in blk.vars.items():
            nb.vars[name] = _clone_var(nb, v)
        for op in blk.ops:
            attrs = {}
            for k, val in op.attrs.items():
                if isinstance(val, Block):
                    attrs[k] = p.blocks[val.idx]
                else:
                    attrs[k] = copy.copy(val)
            nop = Operator(
                nb, op.type, inputs=op.inputs, outputs=op.outputs, attrs=attrs
            )
            nb.ops.append(nop)
    p._bump_version()
    return p


class VarNode:
    """One variable name within a block: `var` is the declared Variable (None
    for names referenced by ops but declared in no block — they resolve via
    the executor scope at run time), `producers`/`consumers` are OpNodes."""

    __slots__ = ("name", "block_idx", "var", "producers", "consumers")

    def __init__(self, name, block_idx, var):
        self.name = name
        self.block_idx = block_idx
        self.var = var
        self.producers = []
        self.consumers = []

    @property
    def persistable(self):
        return bool(self.var is not None and self.var.persistable)

    def __repr__(self):
        return "VarNode(%s@%d, %d->%d)" % (
            self.name, self.block_idx, len(self.producers), len(self.consumers)
        )


class OpNode:
    """One op within a block. `op` is the shadow program's Operator; edits to
    its inputs/outputs/attrs are picked up by Graph.refresh()."""

    __slots__ = ("op", "block_idx", "index", "inputs", "outputs", "sub_blocks")

    def __init__(self, op, block_idx, index):
        self.op = op
        self.block_idx = block_idx
        self.index = index
        self.inputs = []  # [VarNode] read, flat, deduped, slot order
        self.outputs = []  # [VarNode] written
        self.sub_blocks = [
            v.idx for v in op.attrs.values() if isinstance(v, Block)
        ]

    @property
    def type(self):
        return self.op.type

    @property
    def attrs(self):
        return self.op.attrs

    def __repr__(self):
        return "OpNode(%s@%d[%d])" % (self.type, self.block_idx, self.index)


class GraphVerifyError(RuntimeError):
    """An invariant of the Program/Graph structure was broken by a pass."""


class Graph:
    def __init__(self, program):
        self.program = clone_program(program)
        self._blocks = []  # per block: {"ops": [OpNode], "vars": {name: VarNode}}
        self.refresh()

    # ------------------------------------------------------------------ #
    # index construction
    # ------------------------------------------------------------------ #
    def refresh(self):
        """Recompute node lists and def-use edges from the shadow program.
        Cheap (one walk over ops); call after structural mutation."""
        from ..ops.registry import EMPTY_VAR_NAME

        self._blocks = []
        for blk in self.program.blocks:
            vars_ = {
                name: VarNode(name, blk.idx, v) for name, v in blk.vars.items()
            }
            self._blocks.append({"ops": [], "vars": vars_})

        def resolve(name, block_idx, create_in):
            """VarNode for `name` seen from block `block_idx`: the declaring
            block's node if any ancestor declares it, else a synthetic node
            in `create_in` (scope-resolved names, e.g. grad accumulators)."""
            idx = block_idx
            while idx >= 0:
                node = self._blocks[idx]["vars"].get(name)
                if node is not None:
                    return node
                idx = self.program.blocks[idx].parent_idx
            node = VarNode(name, create_in, None)
            self._blocks[create_in]["vars"][name] = node
            return node

        for blk in self.program.blocks:
            nodes = self._blocks[blk.idx]["ops"]
            for i, op in enumerate(blk.ops):
                node = OpNode(op, blk.idx, i)
                seen_in, seen_out = set(), set()
                for name in op.input_arg_names:
                    if name == EMPTY_VAR_NAME or name in seen_in:
                        continue
                    seen_in.add(name)
                    vn = resolve(name, blk.idx, blk.idx)
                    node.inputs.append(vn)
                    vn.consumers.append(node)
                for name in op.output_arg_names:
                    if name == EMPTY_VAR_NAME or name in seen_out:
                        continue
                    seen_out.add(name)
                    vn = resolve(name, blk.idx, blk.idx)
                    node.outputs.append(vn)
                    vn.producers.append(node)
                nodes.append(node)

        # sub-block awareness: a control-flow op consumes every parent-scope
        # var its sub-block tree touches (reference graph.cc resolves these
        # through the same parent chain)
        for blk_nodes in self._blocks:
            for node in blk_nodes["ops"]:
                for sub_idx in node.sub_blocks:
                    for name in self._names_in_block_tree(sub_idx):
                        vn = self._find_declared(name, node.block_idx)
                        if vn is not None and node not in vn.consumers:
                            vn.consumers.append(node)
                            node.inputs.append(vn)

    def _names_in_block_tree(self, block_idx):
        names = set()
        stack = [block_idx]
        while stack:
            idx = stack.pop()
            for op in self.program.blocks[idx].ops:
                names.update(op.input_arg_names)
                names.update(op.output_arg_names)
                stack.extend(
                    v.idx for v in op.attrs.values() if isinstance(v, Block)
                )
        return names

    def _find_declared(self, name, block_idx):
        idx = block_idx
        while idx >= 0:
            node = self._blocks[idx]["vars"].get(name)
            if node is not None:
                return node
            idx = self.program.blocks[idx].parent_idx
        return None

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def op_nodes(self, block_idx=0):
        return list(self._blocks[block_idx]["ops"])

    def all_op_nodes(self):
        return [n for b in self._blocks for n in b["ops"]]

    def var_node(self, name, block_idx=0):
        return self._find_declared(name, block_idx)

    def num_ops(self):
        return sum(len(blk.ops) for blk in self.program.blocks)

    def subblock_reachable_names(self):
        """Names referenced anywhere below block 0 — off-limits for renaming
        or removal decisions made from block 0's local view."""
        names = set()
        for blk in self.program.blocks[1:]:
            for op in blk.ops:
                names.update(op.input_arg_names)
                names.update(op.output_arg_names)
        return names

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #
    def remove_op(self, op_node):
        blk = self.program.blocks[op_node.block_idx]
        blk.ops.remove(op_node.op)
        self.program._bump_version()

    def insert_op(self, index, op, block_idx=0):
        blk = self.program.blocks[block_idx]
        if op.block is not blk:
            raise GraphVerifyError(
                "op %r belongs to a different block/program" % op.type
            )
        blk.ops.insert(index, op)
        self.program._bump_version()

    # ------------------------------------------------------------------ #
    # verification (per-pass, PassManager re-runs after every pass)
    # ------------------------------------------------------------------ #
    def verify(self):
        """Structural invariants. Raises GraphVerifyError naming the breakage;
        returns a stats dict when sound."""
        from ..ops.registry import EMPTY_VAR_NAME

        prog = self.program
        for blk in prog.blocks:
            if blk.program is not prog:
                raise GraphVerifyError(
                    "block %d is not bound to the graph's program" % blk.idx
                )
            if blk.idx != 0:
                if not (0 <= blk.parent_idx < blk.idx):
                    raise GraphVerifyError(
                        "block %d has invalid parent_idx %d"
                        % (blk.idx, blk.parent_idx)
                    )
            for name, v in blk.vars.items():
                if v.name != name:
                    raise GraphVerifyError(
                        "var registered as %r but named %r in block %d"
                        % (name, v.name, blk.idx)
                    )
            for op in blk.ops:
                if not isinstance(op, Operator):
                    raise GraphVerifyError(
                        "non-Operator %r in block %d ops" % (op, blk.idx)
                    )
                for val in op.attrs.values():
                    if isinstance(val, Block) and val.program is not prog:
                        raise GraphVerifyError(
                            "op %s references a Block of a foreign program"
                            % op.type
                        )

        # def-before-use inside each block: a non-persistable, non-data var
        # whose producers ALL sit strictly after one of its consumers means a
        # pass reordered a producer past its reader — the straight-line
        # lowering would read a value that does not exist yet. Names with no
        # producer at all are fine (they resolve via feed or scope, e.g. the
        # stored outputs of constant folding).
        undeclared = 0
        for blk in prog.blocks:
            writes = {}  # name -> [op indices writing it]
            for i, op in enumerate(blk.ops):
                for name in op.output_arg_names:
                    writes.setdefault(name, []).append(i)
            for i, op in enumerate(blk.ops):
                for name in op.input_arg_names:
                    if name == EMPTY_VAR_NAME:
                        continue
                    vn = self._find_declared(name, blk.idx)
                    if vn is None or vn.var is None:
                        undeclared += 1
                        continue
                    if vn.persistable or vn.var.is_data:
                        continue
                    if self._blocks[blk.idx]["vars"].get(name) is None:
                        # declared in an ancestor block: the value exists at
                        # block entry (loop-carried state written at the tail
                        # of a while body reads its previous iteration), so
                        # intra-block write order proves nothing
                        continue
                    idxs = writes.get(name)
                    if idxs and min(idxs) > i:
                        raise GraphVerifyError(
                            "op %d (%s) in block %d reads %r before its first "
                            "producer (op %d) ran"
                            % (i, op.type, blk.idx, name, min(idxs))
                        )
        return {"ops": self.num_ops(), "undeclared": undeclared}

    # ------------------------------------------------------------------ #
    # emission
    # ------------------------------------------------------------------ #
    def to_program(self):
        """Independent Program snapshot of the graph's current state."""
        return clone_program(self.program)

    def write_to(self, program):
        """Replace `program`'s blocks with this graph's state IN PLACE —
        the compatibility path for the deprecated transpiler entry points
        whose contract is in-place mutation."""
        fresh = clone_program(self.program)
        program.blocks = fresh.blocks
        for blk in program.blocks:
            blk.program = program
        program.current_block_idx = 0
        program._bump_version()
        return program
