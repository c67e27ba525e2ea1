"""Core graph IR: Program / Block / Operator / Variable / Parameter.

This is the define-then-run program representation, API-compatible with the
reference's Python frontend (PaddlePaddle python/paddle/fluid/framework.py:
Program:1466, Block:964, Operator:521, Variable:216, Parameter:2060,
program_guard:2212). Unlike the reference — where these objects shadow C++
protobuf `OpDesc`/`VarDesc` (framework.proto) that a C++ per-op executor
interprets — here the Program IS the source of truth, and the executor
interprets a block's ops as torch calls on one device (see executor.py). Ops carry
string-keyed input/output slots and attribute dicts exactly like OpDesc, so
programs serialize to the same structural schema (see Program.to_dict).

Notes:
- shapes are static; -1 is allowed only in the leading (batch) dim of data vars
  and is resolved at feed time (shape-keyed executable cache).
- there is no Scope here: variables are names; values live in executor scopes.
"""

import contextlib
import copy
import itertools

import numpy as np

from . import unique_name

__all__ = [
    "Program",
    "Block",
    "Operator",
    "Variable",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "name_scope",
    "device_guard",
    "grad_var_name",
    "convert_np_dtype",
]

GRAD_VAR_SUFFIX = "@GRAD"
ZERO_VAR_SUFFIX = "@ZERO"


def grad_var_name(var_name):
    """Gradient variable naming convention (reference framework.py:grad_var_name)."""
    return var_name + GRAD_VAR_SUFFIX


class VarType:
    """Variable kinds, mirroring framework.proto VarType (reference
    framework.proto:101-146, 17 kinds). Only the ones this package uses are
    kept; LOD_TENSOR covers dense (ragged handled via explicit seq-len vars)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"  # sparse (rows, values) gradient pairs
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"


class OpRole:
    """Op role attr used by backward/optimizer/multi-device passes (reference
    op_proto_maker.h OpRole). Stored on every op as attr `op_role`."""

    # Bitmask values match reference op_proto_maker.h (kRPC = 0x0004,
    # kDist = 0x0008) so role tests like `role & Optimize` never match
    # RPC/Dist-role ops.
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 4
    Dist = 8
    LRSched = 16
    Loss = 256

    OP_ROLE_KEY = "op_role"
    OP_ROLE_VAR_KEY = "op_role_var"


# Explicit pipeline-stage pin (reference fluid.device_guard("gpu:2") inside
# the pipeline optimizer era). Stored on every op appended under an active
# device_guard; the ParallelExecutor pp partitioner treats it as an override
# of the analytic balanced cut (parallel/partition.py).
PIPELINE_STAGE_ATTR = "__pipeline_stage__"

_device_guard_stack = []


@contextlib.contextmanager
def device_guard(device=None):
    """Pin ops appended inside to a pipeline stage (reference fluid
    device_guard). Accepted spellings: "pp:<k>" / "gpu:<k>" / "stage:<k>"
    (the reference pins pipeline sections to devices; here the mesh owns
    placement, so the integer is a pp STAGE index). device=None/"cpu"
    clears the pin for the region (host-side data ops in the reference)."""
    stage = None
    if device is not None and device != "cpu":
        dev = str(device)
        if ":" not in dev:
            raise ValueError(
                "device_guard expects 'pp:<stage>' (or reference-style "
                "'gpu:<stage>'), got %r" % (device,)
            )
        prefix, _, idx = dev.partition(":")
        if prefix not in ("pp", "gpu", "stage"):
            raise ValueError("unknown device_guard prefix %r" % prefix)
        stage = int(idx)
        if stage < 0:
            raise ValueError("pipeline stage must be >= 0, got %d" % stage)
    _device_guard_stack.append(stage)
    try:
        yield
    finally:
        _device_guard_stack.pop()


def _current_pipeline_stage():
    return _device_guard_stack[-1] if _device_guard_stack else None


# Wide types narrow at the framework boundary (float64 -> float32, int64 ->
# int32), the same canonicalization the JAX package applies, so a Program
# declares identical var dtypes in both packages.
_np_to_canonical = {
    "float64": "float32",
    "float32": "float32",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int64": "int32",
    "int32": "int32",
    "int16": "int16",
    "int8": "int8",
    "uint8": "uint8",
    "bool": "bool",
}

# framework.proto VarType.Type enum values (reference framework.proto:91-100)
# accepted for compatibility with fluid scripts passing core.VarDesc dtypes.
_proto_dtype_to_name = {
    0: "bool",
    1: "int16",
    2: "int32",
    3: "int64",
    4: "float16",
    5: "float32",
    6: "float64",
    8: "int8",
    20: "uint8",
    22: "bfloat16",
}


def convert_np_dtype(dtype):
    """Normalize a dtype spec (np.dtype / str / jnp dtype / proto enum int) to
    a canonical string."""
    if dtype is None:
        return None
    if isinstance(dtype, int):
        dtype = _proto_dtype_to_name[dtype]
    name = getattr(dtype, "name", None)
    if name is None:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name == "bfloat16" or "bfloat16" in str(dtype):
        return "bfloat16"
    if name not in _np_to_canonical:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return _np_to_canonical[name]


def is_float_dtype(dtype):
    return dtype in ("float64", "float32", "float16", "bfloat16")


class Variable:
    """A named tensor in a Block (reference framework.py:216). Holds static
    metadata only — shape, dtype, persistable, stop_gradient, lod_level —
    values live in an executor Scope at run time."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        type=VarType.LOD_TENSOR,
        lod_level=0,
        persistable=False,
        stop_gradient=False,
        is_data=False,
        initializer=None,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype) if dtype is not None else None
        self.type = type
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        # set by layers.io.data for feed vars whose batch dim is -1
        self.desc = self  # compat shim: reference code reaches var.desc

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __str__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name,
            self.shape,
            self.dtype,
            ", persistable" if self.persistable else "",
        )

    __repr__ = __str__

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }

    # --- operator sugar (reference math_op_patch.py monkey-patches these) ---
    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch

        return math_op_patch.binary_op(self, other, op, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from .layers import tensor as tensor_layers

        return tensor_layers.scale(self, scale=-1.0)

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    def __eq__(self, other):  # graph-eq, like the reference's patched Variable
        if isinstance(other, (Variable, int, float)):
            return self._binary(other, "equal")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Variable, int, float)):
            return self._binary(other, "not_equal")
        return NotImplemented

    def __hash__(self):
        return id(self)

    def astype(self, dtype):
        from .layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)


class Parameter(Variable):
    """Trainable persistable variable (reference framework.py:2060). Carries
    optimizer-facing attrs: trainable, optimize_attr (learning_rate scale),
    regularizer, gradient clip attr."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter needs shape and dtype")
        for d in shape:
            if d < 0:
                raise ValueError("Parameter shape must be static, got %s" % (shape,))
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)


class Operator:
    """One op in a block (reference framework.py:521 / C++ OpDesc). Inputs and
    outputs are slot-name -> [variable names]; attrs is a plain dict whose
    values must be JSON-able (bool/int/float/str/lists) or Block references
    (control flow)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.attrs.setdefault(OpRole.OP_ROLE_KEY, _current_role())
        # ops created under _optimized_guard carry their (param, grad) pair —
        # the seam the multi-device pass and DistributeTranspiler key on
        # (reference op_proto_maker.h OpRoleVar)
        role_var = _current_role_var()
        if role_var and OpRole.OP_ROLE_VAR_KEY not in self.attrs:
            self.attrs[OpRole.OP_ROLE_VAR_KEY] = list(role_var)
        stage = _current_pipeline_stage()
        if stage is not None and PIPELINE_STAGE_ATTR not in self.attrs:
            self.attrs[PIPELINE_STAGE_ATTR] = stage

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name):
        return self.attrs[name]

    def has_attr(self, name):
        return name in self.attrs

    def _rename_input(self, old, new):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]

    def _rename_output(self, old, new):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]

    def to_dict(self):
        def _attr(v):
            if isinstance(v, Block):
                return {"__block__": v.idx}
            return v

        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": {k: _attr(v) for k, v in self.attrs.items()},
        }

    def __str__(self):
        ins = ", ".join("%s=%s" % kv for kv in sorted(self.inputs.items()))
        outs = ", ".join("%s=%s" % kv for kv in sorted(self.outputs.items()))
        return "{%s} = %s(%s)" % (outs, self.type, ins)

    __repr__ = __str__


class Block:
    """Ordered op list + var map (reference framework.py:964). Sub-blocks (for
    while/cond) link via parent_idx."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> Variable
        self.ops = []  # [Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError("var %r not in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise KeyError("var %r not found in block %d or ancestors" % (name, self.idx))

    def has_var_recursive(self, name):
        try:
            self._var_recursive(name)
            return True
        except KeyError:
            return False

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs):
        p = Parameter(self, **kwargs)
        # parameters are global: registered on block 0 like the reference
        gblock = self.program.global_block()
        gblock.vars[p.name] = p
        p.block = gblock
        self.program._bump_version()
        return p

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self._infer_shape(op)
        self.program._bump_version()
        return op

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        self._infer_shape(op)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self._infer_shape(op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def _infer_shape(self, op):
        """Run the registered shape/dtype inference so downstream layers see
        concrete metadata at graph-build time (reference: OpDesc InferShape
        called from Operator.__init__, framework.py:667)."""
        from .ops import registry

        registry.infer_shape(op, self)

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def iter_parameters(self):
        return iter(self.all_parameters())

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __str__(self):
        lines = ["block %d (parent %d):" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + str(v))
        for op in self.ops:
            lines.append("  " + str(op))
        return "\n".join(lines)


class Program:
    """A whole trainable program: list of Blocks, block 0 global (reference
    framework.py:1466). `clone()` deep-copies the graph; `_version` increments
    on any mutation and keys the executor's executable cache."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # monotonic uid: executor caches key on this instead of id(self) so a
        # new Program can never alias a GC'd one's cache entries
        self._uid = next(Program._uid_counter)
        self._op_role = OpRole.Forward
        self._op_role_var = []
        self._is_test = False

    # --- structure ---
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent_idx=parent))
        self.current_block_idx = new_idx
        return self.current_block()

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @property
    def num_blocks(self):
        return len(self.blocks)

    # --- op role plumbing (used by backward/optimizer, reference :1504-1563) ---
    @contextlib.contextmanager
    def _optimized_guard(self, param_and_grads):
        old_role, old_var = self._op_role, self._op_role_var
        self._op_role = OpRole.Optimize
        self._op_role_var = [
            v.name if isinstance(v, Variable) else v for v in param_and_grads
        ]
        yield
        self._op_role, self._op_role_var = old_role, old_var

    @contextlib.contextmanager
    def _lr_schedule_guard(self):
        old_role = self._op_role
        self._op_role = OpRole.LRSched
        yield
        self._op_role = old_role

    @contextlib.contextmanager
    def _backward_role_guard(self):
        old_role = self._op_role
        self._op_role = OpRole.Backward
        yield
        self._op_role = old_role

    # --- cloning / pruning ---
    def clone(self, for_test=False):
        """Deep copy. for_test=True flips `is_test` attrs (dropout/batch_norm
        switch to inference behavior), mirroring reference clone(for_test)
        + inference_optimize (framework.py:1616-1700)."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            p.blocks.append(nb)
        for blk, nb in zip(self.blocks, p.blocks):
            for name, v in blk.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(
                        nb,
                        shape=v.shape,
                        dtype=v.dtype,
                        name=v.name,
                        trainable=v.trainable,
                        optimize_attr=copy.copy(v.optimize_attr),
                        regularizer=v.regularizer,
                        gradient_clip_attr=v.gradient_clip_attr,
                    )
                else:
                    nv = Variable(
                        nb,
                        name=v.name,
                        shape=v.shape,
                        dtype=v.dtype,
                        type=v.type,
                        lod_level=v.lod_level,
                        persistable=v.persistable,
                        stop_gradient=v.stop_gradient,
                        is_data=v.is_data,
                    )
                nb.vars[name] = nv
            for op in blk.ops:
                if for_test and (
                    int(op.attrs.get(OpRole.OP_ROLE_KEY, OpRole.Forward))
                    & (OpRole.Backward | OpRole.Optimize | OpRole.LRSched)
                ):
                    # reference clone(for_test) prunes the backward/optimizer/
                    # lr-schedule ops (inference_optimize); without this the
                    # "test" program still trains — an sgd step runs on every
                    # inference call
                    continue
                attrs = {}
                for k, val in op.attrs.items():
                    if isinstance(val, Block):
                        attrs[k] = p.blocks[val.idx]
                    else:
                        attrs[k] = copy.copy(val)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                nop = Operator(
                    nb, op.type, inputs=op.inputs, outputs=op.outputs, attrs=attrs
                )
                nb.ops.append(nop)
        p._is_test = for_test
        p._bump_version()
        return p

    def _prune(self, targets):
        """Keep only ops needed to compute `targets` (names or Variables) —
        used by save_inference_model (reference prune.cc + framework.py:1601)."""
        target_names = set(
            t.name if isinstance(t, Variable) else t for t in targets
        )
        p = self.clone()
        blk = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(blk.ops):
            if any(o in needed for o in op.output_arg_names):
                kept.append(op)
                needed.update(op.input_arg_names)
        blk.ops = list(reversed(kept))
        used = set()
        for op in blk.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        blk.vars = {
            n: v for n, v in blk.vars.items() if n in used or n in target_names
        }
        p._bump_version()
        return p

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd.get("parent_idx", -1))
            p.blocks.append(blk)
        for bd, blk in zip(d["blocks"], p.blocks):
            for vd in bd["vars"]:
                cls_kwargs = dict(
                    name=vd["name"],
                    shape=vd["shape"],
                    dtype=vd["dtype"],
                    type=vd.get("type", VarType.LOD_TENSOR),
                    lod_level=vd.get("lod_level", 0),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    is_data=vd.get("is_data", False),
                )
                if vd.get("is_parameter"):
                    v = Parameter(
                        blk,
                        shape=vd["shape"],
                        dtype=vd["dtype"],
                        name=vd["name"],
                        trainable=vd.get("trainable", True),
                    )
                else:
                    v = Variable(blk, **cls_kwargs)
                blk.vars[v.name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, val in od["attrs"].items():
                    if isinstance(val, dict) and "__block__" in val:
                        attrs[k] = p.blocks[val["__block__"]]
                    else:
                        attrs[k] = val
                op = Operator(
                    blk, od["type"], inputs=od["inputs"], outputs=od["outputs"], attrs=attrs
                )
                blk.ops.append(op)
        p._bump_version()
        return p

    def to_string(self, throw_on_error=False):
        return "\n".join(str(b) for b in self.blocks)

    __str__ = to_string


def _current_role():
    prog = _main_program_
    return prog._op_role if prog is not None else OpRole.Forward


def _current_role_var():
    prog = _main_program_
    return prog._op_role_var if prog is not None else []


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    yield
    switch_main_program(old_main)
    if old_startup is not None:
        switch_startup_program(old_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Cosmetic op-name namespacing (reference framework.py:91)."""
    _name_scope_stack.append(prefix or "")
    yield
    _name_scope_stack.pop()
