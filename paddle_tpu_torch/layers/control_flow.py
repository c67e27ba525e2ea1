"""Control-flow layers: While / Switch / IfElse / ConditionalBlock /
StaticRNN / DynamicRNN, the comparison and logical wrappers, tensor arrays
and the rank-table layers (a copy of paddle_tpu/layers/control_flow.py;
reference python/paddle/fluid/layers/control_flow.py).

Sub-blocks are built as in the reference (program._create_block /
_rollback) and the completed op carries the Block as an attr; the ops run
the sub-block inside their own lowering (ops/control_flow_ops.py). IfElse
computes both branches over the full batch and merges them row by row with
a masked select, as in the JAX package. `Print` appends a print op, which
the executor runs between graph segments so that it prints on every run.
"""

import contextlib

from .. import unique_name
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper
from ..ops.registry import EMPTY_VAR_NAME as _EMPTY

__all__ = [
    "While",
    "Switch",
    "IfElse",
    "ConditionalBlock",
    "StaticRNN",
    "DynamicRNN",
    "less_than",
    "less_equal",
    "greater_than",
    "greater_equal",
    "equal",
    "not_equal",
    "logical_and",
    "logical_or",
    "logical_xor",
    "logical_not",
    "array_read",
    "array_write",
    "array_length",
    "create_array",
    "lod_tensor_to_array",
    "array_to_lod_tensor",
    "lod_rank_table",
    "max_sequence_len",
    "reorder_lod_tensor_by_rank",
    "shrink_memory",
    "Print",
]


# ---------------------------------------------------------------------------
# compare / logical wrappers (reference keeps these in layers/control_flow.py
# and layers/ops.py; lowerings in ops/core_ops.py)
# ---------------------------------------------------------------------------


def _binary_bool(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    helper.append_op(
        type=op_type,
        inputs={"X": [x.name], "Y": [y.name]},
        outputs={"Out": [cond.name]},
    )
    cond.dtype = "bool"
    cond.stop_gradient = True
    return cond


def less_than(x, y, cond=None, force_cpu=None):
    return _binary_bool("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _binary_bool("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _binary_bool("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _binary_bool("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _binary_bool("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _binary_bool("not_equal", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _binary_bool("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _binary_bool("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _binary_bool("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference("bool")
    helper.append_op(
        type="logical_not", inputs={"X": [x.name]}, outputs={"Out": [out.name]}
    )
    out.dtype = "bool"
    out.stop_gradient = True
    return out


# ---------------------------------------------------------------------------
# sub-block analysis shared by While / ConditionalBlock
# ---------------------------------------------------------------------------


def _external_reads_writes(sub):
    """First-occurrence-ordered lists of names the sub-block reads/writes that
    live in an ancestor block (the reference's while_op input/output discovery
    in layers/control_flow.py While.complete)."""
    parent = sub.parent_block
    reads, writes = [], []
    seen_r, seen_w = set(), set()
    for op in sub.ops:
        for n in op.input_arg_names:
            if n != _EMPTY and n not in seen_r:
                seen_r.add(n)
                reads.append(n)
        for n in op.output_arg_names:
            if n != _EMPTY and n not in seen_w:
                seen_w.add(n)
                writes.append(n)
    ext_r = [
        n for n in reads if n not in sub.vars and parent.has_var_recursive(n)
    ]
    ext_w = [
        n for n in writes if n not in sub.vars and parent.has_var_recursive(n)
    ]
    return ext_r, ext_w


class While:
    """fluid.layers.While (reference layers/control_flow.py:655).

    cond must be a scalar bool Variable, updated inside the block (e.g. by
    ``less_than(i, n, cond=cond)``). With ``maximum_iterations`` set the loop
    is a masked loop of that fixed length, differentiable and captured in a
    CUDA graph with its block; without it the condition is read on the host
    every iteration (forward only), and its block runs op by op.
    """

    def __init__(self, cond, is_test=False, name=None, maximum_iterations=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test
        self.maximum_iterations = maximum_iterations
        self._main = default_main_program()
        self._sub = None

    @contextlib.contextmanager
    def block(self):
        self._sub = self._main._create_block()
        try:
            yield
        finally:
            self._main._rollback()
        self._complete()

    def _complete(self):
        sub = self._sub
        parent = sub.parent_block
        ext_r, carried = _external_reads_writes(sub)
        if self.cond_var.name not in carried:
            raise ValueError(
                "While condition %r is never updated inside the block — the "
                "loop would not terminate" % self.cond_var.name
            )
        x_names = carried + [n for n in ext_r if n not in carried]
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var.name], "X": x_names},
            outputs={"Out": list(carried)},
            attrs={
                "sub_block": sub,
                "carried_names": list(carried),
                "cond_name": self.cond_var.name,
                "x_names": list(x_names),
                "maximum_iterations": self.maximum_iterations or 0,
                "is_test": self.is_test,
            },
        )


class ConditionalBlock:
    """Run a block of ops when every scalar condition is true (reference
    layers/control_flow.py:1207 ConditionalBlock / conditional_block_op.cc).
    Vars assigned inside must already hold a value outside the block (the
    false path keeps the prior value)."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        for c in inputs:
            if not isinstance(c, Variable):
                raise TypeError("ConditionalBlock inputs must be Variables")
        self.conds = list(inputs)
        self.helper = LayerHelper("conditional_block", name=name)
        self._main = default_main_program()
        self._sub = None

    @contextlib.contextmanager
    def block(self):
        self._sub = self._main._create_block()
        try:
            yield
        finally:
            self._main._rollback()
        self._complete()

    def _complete(self):
        sub = self._sub
        parent = sub.parent_block
        ext_r, written = _external_reads_writes(sub)
        cond_names = [c.name for c in self.conds]
        x_names = written + [
            n for n in ext_r if n not in written and n not in cond_names
        ]
        parent.append_op(
            type="conditional_block",
            inputs={"Cond": cond_names, "X": x_names},
            outputs={"Out": list(written)},
            attrs={
                "sub_block": sub,
                "written_names": list(written),
                "x_names": list(x_names),
            },
        )


class Switch:
    """switch/case over scalar conditions (reference layers/control_flow.py:1290
    — the learning-rate-schedule workhorse). Each case runs iff its condition
    holds and no earlier case matched; default runs when none matched."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._matched = None  # bool var: any earlier case fired

    @contextlib.contextmanager
    def case(self, condition):
        if self._matched is None:
            eff = condition
            self._matched = condition
        else:
            not_prev = logical_not(self._matched)
            eff = logical_and(condition, not_prev)
            self._matched = logical_or(self._matched, condition)
        cb = ConditionalBlock([eff])
        with cb.block():
            yield

    @contextlib.contextmanager
    def default(self):
        if self._matched is None:
            raise ValueError("Switch.default() requires at least one case first")
        eff = logical_not(self._matched)
        cb = ConditionalBlock([eff])
        with cb.block():
            yield


class IfElse:
    """Batch-wise two-way branch (reference layers/control_flow.py:1066 IfElse
    splits rows by a (batch, 1) bool mask, runs each branch on its subset, and
    merges). Here both branches compute over the full batch and ``()`` merges
    row by row with a masked select (as in the JAX package): static shapes,
    the same numbers for per-row branches (the reference's supported use)."""

    def __init__(self, cond, name=None):
        self.cond = cond
        self._in_true = None
        self._true_outs = []
        self._false_outs = []

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        try:
            yield
        finally:
            self._in_true = None

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        try:
            yield
        finally:
            self._in_true = None

    def input(self, x):
        if self._in_true is None:
            raise ValueError("IfElse.input() must be called inside a branch")
        return x

    def output(self, *outs):
        if self._in_true is None:
            raise ValueError("IfElse.output() must be called inside a branch")
        (self._true_outs if self._in_true else self._false_outs).extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(
                "IfElse branches produced %d vs %d outputs"
                % (len(self._true_outs), len(self._false_outs))
            )
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            helper = LayerHelper("ifelse_merge")
            out = helper.create_variable_for_type_inference(t.dtype)
            helper.append_op(
                type="where",
                inputs={
                    "Condition": [self.cond.name],
                    "X": [t.name],
                    "Y": [f.name],
                },
                outputs={"Out": [out.name]},
            )
            merged.append(out)
        return merged if len(merged) != 1 else merged[0]


# ---------------------------------------------------------------------------
# recurrent networks (ops/control_flow_ops.py "recurrent")
# ---------------------------------------------------------------------------


class _RNNBase:
    def __init__(self, layer_type, time_major, name=None):
        self.helper = LayerHelper(layer_type, name=name)
        self._main = default_main_program()
        self._time_major = time_major
        self._sub = None
        self._seq = []  # (outer var, inner var)
        self._mems = []  # dict(pre=Variable, boot=Variable, new=name|None)
        self._outs = []  # inner Variables
        self._seqlen = None
        self._completed = False
        self._outer_outs = None

    @contextlib.contextmanager
    def _block_ctx(self):
        self._sub = self._main._create_block()
        try:
            yield
        finally:
            self._main._rollback()
        self._complete()

    def _step_input(self, x, inner_shape):
        inner = self._sub.create_var(
            name=unique_name.generate(self.helper.name + "_step_in"),
            shape=list(inner_shape),
            dtype=x.dtype,
        )
        self._seq.append((x, inner))
        return inner

    def _in_parent(self):
        """Context: temporarily emit ops into the parent block (for boot-state
        creation, like the reference's StaticRNN memory boot ops)."""
        main = self._main

        @contextlib.contextmanager
        def ctx():
            saved = main.current_block_idx
            main.current_block_idx = self._sub.parent_idx
            try:
                yield
            finally:
                main.current_block_idx = saved

        return ctx()

    def _memory(self, init, shape, value, batch_ref, ref_batch_dim_idx, dtype):
        from . import tensor as tensor_layers

        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory() needs either init= or (shape= and a prior "
                    "step_input for the batch reference)"
                )
            with self._in_parent():
                boot = tensor_layers.fill_constant_batch_size_like(
                    input=batch_ref,
                    shape=[-1] + list(shape),
                    dtype=dtype,
                    value=value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=0,
                )
        else:
            boot = init
        pre = self._sub.create_var(
            name=unique_name.generate(self.helper.name + "_mem_pre"),
            shape=list(boot.shape),
            dtype=boot.dtype,
        )
        self._mems.append({"pre": pre, "boot": boot, "new": None})
        return pre

    def update_memory(self, mem, new):
        for m in self._mems:
            if m["pre"].name == mem.name:
                m["new"] = new.name
                return
        raise ValueError("update_memory: %r is not a memory of this RNN" % mem.name)

    def _step_output(self, o):
        self._outs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self._step_output(o)

    def _complete(self):
        sub = self._sub
        parent = sub.parent_block
        for m in self._mems:
            if m["new"] is None:
                raise ValueError(
                    "memory %r was never update_memory()'d" % m["pre"].name
                )
        ext_r, _ = _external_reads_writes(sub)
        boot_names = [m["boot"].name for m in self._mems]
        closure = [n for n in ext_r if n not in boot_names]

        outer_outs, final_outs = [], []
        t_extent = None
        if self._seq:
            ov = self._seq[0][0]
            t_extent = ov.shape[0] if self._time_major else ov.shape[1]
        for o in self._outs:
            oshape = list(o.shape or ())
            stacked = (
                [t_extent] + oshape if self._time_major
                else oshape[:1] + [t_extent] + oshape[1:]
            )
            ov = parent.create_var(
                name=unique_name.generate(self.helper.name + "_out"),
                shape=stacked,
                dtype=o.dtype,
            )
            if self._seqlen is not None:
                # padded output keeps the ragged companion (layers/sequence.py
                # seq_len_of convention) so sequence ops chain off RNN outputs
                ov._len_name = self._seqlen.name
            outer_outs.append(ov)
        for m in self._mems:
            final_outs.append(
                parent.create_var(
                    name=unique_name.generate(self.helper.name + "_final"),
                    shape=list(m["boot"].shape or ()),
                    dtype=m["boot"].dtype,
                )
            )

        inputs = {
            "X": [ov.name for ov, _ in self._seq],
            "Boot": boot_names,
            "C": closure,
        }
        if self._seqlen is not None:
            inputs["SeqLen"] = [self._seqlen.name]
        parent.append_op(
            type="recurrent",
            inputs=inputs,
            outputs={
                "Out": [v.name for v in outer_outs],
                "FinalState": [v.name for v in final_outs],
            },
            attrs={
                "sub_block": sub,
                "x_names": [iv.name for _, iv in self._seq],
                "pre_state_names": [m["pre"].name for m in self._mems],
                "new_state_names": [m["new"] for m in self._mems],
                "out_names": [o.name for o in self._outs],
                "closure_names": list(closure),
                "time_major": self._time_major,
                "reverse": False,
            },
        )
        self._outer_outs = outer_outs
        self._final_outs = final_outs
        self._completed = True

    def _result(self):
        if not self._completed:
            raise ValueError("RNN block is not complete yet")
        outs = self._outer_outs
        return outs[0] if len(outs) == 1 else outs


class StaticRNN(_RNNBase):
    """Fixed-length RNN over time-major sequences (reference
    layers/control_flow.py:429; recurrent_op.cc). step_input slices dim 0 of a
    (T, B, ...) tensor; lowered to one loop over time."""

    def __init__(self, name=None):
        super().__init__("static_rnn", time_major=True, name=name)

    def step(self):
        return self._block_ctx()

    def step_input(self, x):
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("StaticRNN.step_input needs a (T, B, ...) tensor")
        return self._step_input(x, x.shape[1:])

    def memory(
        self,
        init=None,
        shape=None,
        batch_ref=None,
        init_value=0.0,
        init_batch_dim_idx=0,
        ref_batch_dim_idx=1,
        dtype="float32",
    ):
        if batch_ref is None and self._seq:
            batch_ref = self._seq[0][0]
        return self._memory(
            init, shape, init_value, batch_ref, ref_batch_dim_idx, dtype
        )

    def step_output(self, o):
        self._step_output(o)

    def __call__(self, *args, **kwargs):
        return self._result()


class DynamicRNN(_RNNBase):
    """Variable-length RNN over padded batch-major sequences (reference
    layers/control_flow.py:1546, which compiles to lod_rank_table +
    lod_tensor_to_array + while_op with shrinking batches). Here one loop
    over (B, T, ...) with a SeqLen vector; finished rows hold their
    state and output zeros — same results, static shapes."""

    def __init__(self, name=None):
        super().__init__("dynamic_rnn", time_major=False, name=name)

    def block(self):
        return self._block_ctx()

    def step_input(self, x, seq_len=None, level=0):
        if seq_len is not None:
            self._seqlen = seq_len
        if self._seqlen is None:
            raise ValueError(
                "DynamicRNN.step_input needs seq_len= on the first sequence "
                "input (padded-dense representation, SURVEY.md §5.7)"
            )
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("DynamicRNN.step_input needs a (B, T, ...) tensor")
        return self._step_input(x, x.shape[:1] + tuple(x.shape[2:]))

    def static_input(self, x):
        # non-sequence input, same every step: plain closure capture
        return x

    def memory(
        self,
        init=None,
        shape=None,
        value=0.0,
        need_reorder=False,
        dtype="float32",
    ):
        batch_ref = self._seq[0][0] if self._seq else None
        return self._memory(init, shape, value, batch_ref, 0, dtype)

    def __call__(self, *args, **kwargs):
        return self._result()


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------


def create_array(dtype="float32", shape=None, name=None):
    """LOD_TENSOR_ARRAY variable (reference layers/control_flow.py:964).
    With shape=(capacity, ...) the buffer is pre-allocated, which is REQUIRED
    for arrays written inside While loops (fixed-shape carries)."""
    helper = LayerHelper("create_array", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    out.type = "lod_tensor_array"
    if shape is not None:
        helper.append_op(
            type="create_array",
            outputs={"Out": [out.name]},
            attrs={"shape": list(shape), "dtype": str(dtype)},
        )
        out.shape = tuple(shape)
    out._array_bound = shape is not None
    out._array_prealloc = shape is not None
    return out


def _static_int_value(v):
    """The build-time value of an integer Variable if it is produced by a
    single fill_constant and never rewritten (e.g. loop-free write indices);
    None otherwise."""
    producer, writes = None, 0
    for op in v.block.program.current_block().ops:
        if v.name in op.output_arg_names:
            writes += 1
            producer = op
    if writes == 1 and producer is not None and producer.type == "fill_constant":
        return int(producer.attrs.get("value", 0))
    return None


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    bound = getattr(array, "_array_bound", False)
    prealloc = getattr(array, "_array_prealloc", False)
    inputs = {"X": [x.name], "I": [i.name]}
    attrs = {}
    if prealloc:
        # fixed-capacity buffer (create_array(shape=...) / lod_tensor_to_array):
        # write in place, never grow — the form While-loop carries require
        inputs["Array"] = [array.name]
    else:
        static_i = _static_int_value(i)
        if static_i is None:
            raise ValueError(
                "array_write with a runtime-computed index needs a "
                "pre-allocated array — pass shape=(capacity, ...) to "
                "create_array (growable buffers track capacity statically)"
            )
        cap = getattr(array, "_array_cap", 0)
        if bound:
            inputs["Array"] = [array.name]
            attrs["grow_slots"] = max(0, static_i + 1 - cap)
        else:
            attrs["init_cap"] = static_i + 1
        array._array_cap = max(cap, static_i + 1)
    helper.append_op(
        type="write_to_array",
        inputs=inputs,
        outputs={"Out": [array.name]},
        attrs=attrs,
    )
    array._array_bound = True
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(
        type="read_from_array",
        inputs={"X": [array.name], "I": [i.name]},
        outputs={"Out": [out.name]},
    )
    if array.shape and len(array.shape) > 1:
        out.shape = tuple(array.shape[1:])
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_array_length",
        inputs={"X": [array.name]},
        outputs={"Out": [out.name]},
    )
    out.shape = (1,)
    out.stop_gradient = True
    return out


def lod_tensor_to_array(x, table=None):
    helper = LayerHelper("lod_tensor_to_array")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.type = "lod_tensor_array"
    helper.append_op(
        type="lod_tensor_to_array",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
    )
    if x.shape and len(x.shape) >= 2:
        out.shape = (x.shape[1], x.shape[0]) + tuple(x.shape[2:])
    out._array_bound = True
    out._array_prealloc = True
    return out


def array_to_lod_tensor(x, table=None):
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="array_to_lod_tensor",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
    )
    if x.shape and len(x.shape) >= 2:
        out.shape = (x.shape[1], x.shape[0]) + tuple(x.shape[2:])
    return out


def lod_rank_table(x, level=0, seq_len=None):
    """Rank table over sequence lengths (reference layers/control_flow.py:742).
    In the padded-dense representation pass the SeqLen companion as seq_len
    (or x itself if x IS the length vector); returns descending-length row
    indices."""
    src = seq_len if seq_len is not None else x
    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_rank_table",
        inputs={"X": [src.name]},
        outputs={"Out": [out.name]},
    )
    out.stop_gradient = True
    # remember the length vector so max_sequence_len(rank_table) can resolve
    # it — the table itself is a row permutation, not lengths
    out._seq_len_source = src
    return out


def max_sequence_len(rank_table=None, seq_len=None):
    if seq_len is not None:
        src = seq_len
    elif rank_table is not None and getattr(rank_table, "_seq_len_source", None) is not None:
        # the rank table is a permutation; max() of it would be B-1, not the
        # max length — resolve back to the length vector it was built from
        src = rank_table._seq_len_source
    elif rank_table is not None:
        raise ValueError(
            "max_sequence_len needs the sequence-length vector: pass seq_len=, "
            "or a rank_table produced by lod_rank_table() in this program"
        )
    else:
        raise ValueError("max_sequence_len requires rank_table or seq_len")
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="max_sequence_len",
        inputs={"X": [src.name]},
        outputs={"Out": [out.name]},
    )
    out.shape = (1,)
    out.stop_gradient = True
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x.name], "RankTable": [rank_table.name]},
        outputs={"Out": [out.name]},
    )
    out.shape = x.shape
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="shrink_rnn_memory",
        inputs={"X": [x.name]},
        outputs={"Out": [out.name]},
    )
    out.shape = x.shape
    return out


def Print(
    input,
    first_n=-1,
    message=None,
    summarize=20,
    print_tensor_name=True,
    print_tensor_type=True,
    print_tensor_shape=True,
    print_tensor_lod=True,
    print_phase="both",
):
    """In-graph tensor printing (reference print_op.cc); forwards its input."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="print",
        inputs={"X": [input.name]},
        outputs={"Out": [out.name]},
        attrs={
            "message": message or input.name,
            "summarize": summarize,
        },
    )
    out.shape = input.shape
    return out
