"""Bf16Transpiler: convert a program to bfloat16 mixed precision (the torch
port's copy of paddle_tpu/transpiler/bf16_transpiler.py; it rewrites Program
IR only, so both packages give the same op list and var dtypes).

Reference analog: paddle/contrib/float16/float16_transpiler.py, which
rewrites an inference ProgramDesc to fp16: casts weights, inserts cast ops
at feed/fetch boundaries, keeps blacklisted ops in fp32. This one targets
bfloat16 (f32's exponent range: no loss scaling) and has two modes:

**Freeze mode** (no optimizer ops in the program: inference): the
reference's recipe. Var dtypes flip to bf16, scope weights are cast once,
and a blacklist keeps numerically sensitive ops (softmax, cross_entropy,
batch/layer-norm statistics) computing in f32 via cast-in/cast-out.

**Train mode** (optimizer-role ops present): master weights. Persistable
vars (parameters, optimizer moments, BN statistics, learning rate) KEEP
float32; one `w@BF16` cast per step feeds every forward/backward product;
activations and gradients are bf16; optimizer updates read and write the
f32 masters (their lowerings compute in f32 and cast outputs back,
ops/core_ops.py `_opt_f32`). Blacklisted ops AND their `_grad` twins are f32
islands: inputs cast up, flipped outputs cast back down, so e.g.
layer_norm's backward emits a bf16 input gradient instead of pushing f32
into every downstream product.

The executor casts feeds to their var's dtype (a feed the rewrite flips to
bf16 is fed as bf16), and a transpiled step captures as one CUDA graph like
any other.
"""

from ..framework import Operator, OpRole

__all__ = ["Bf16Transpiler", "Float16Transpiler"]

# ops whose math stays f32 (reference float16_transpiler black_list analog)
_DEFAULT_BLACKLIST = frozenset(
    [
        "softmax",
        "softmax_with_cross_entropy",
        "cross_entropy",
        "log_softmax",
        "batch_norm",
        "layer_norm",
        "mean",
        "accuracy",
        "auc",
        "top_k",
    ]
)

# train mode: gather-like ops consume the f32 master table directly (casting
# a whole embedding table to bf16 per step to gather a few rows would be
# pure waste); their outputs cast down like blacklist islands
_TRAIN_ISLANDS = frozenset(["lookup_table"])

# train mode: ops whose lowerings accumulate in f32 internally while keeping
# the big tensors in the input dtype (core_ops.py softmax_with_cross_entropy
# and its closed-form grad): islanding them would only materialize f32
# copies of bf16 [N, vocab] tensors. layer_norm / batch_norm stay islanded.
# exact-type member: lookup_table_grad stays bf16 (its explicit lowering
# scatters in the cotangent dtype and reads the master table for shape
# only) while the lookup_table FORWARD stays an island (it reads the f32
# master rows directly — casting the whole table down per step to gather a
# few rows would be pure waste)
_TRAIN_KEEP_BF16 = frozenset(["softmax_with_cross_entropy", "lookup_table_grad"])


def _role(op):
    try:
        return int(op.attrs.get(OpRole.OP_ROLE_KEY, 0))
    except (TypeError, ValueError):
        return 0


class Bf16Transpiler:
    def __init__(self, blacklist=None):
        self.blacklist = (
            frozenset(blacklist) if blacklist is not None else _DEFAULT_BLACKLIST
        )

    def transpile(self, program, place=None, scope=None):
        """In place. Train mode when the program carries optimizer-role ops,
        else freeze mode (see module docstring). Feeds are auto-cast by the
        executor (feed dtype follows var dtype, executor.py _as_feed_array)."""
        has_opt = any(
            _role(op) & OpRole.Optimize
            for blk in program.blocks
            for op in blk.ops
        )
        if has_opt:
            self._transpile_train(program)
        else:
            self._transpile_freeze(program, scope)
        program._bump_version()
        return program

    # -- shared -----------------------------------------------------------

    def _is_island(self, op_type, extra=frozenset(), keep=frozenset()):
        if op_type in keep:  # exact-type keeps override the base-name rule
            return False
        base = op_type[:-5] if op_type.endswith("_grad") else op_type
        return base not in keep and (base in self.blacklist or base in extra)

    def _wrap_islands(self, block, flipped, extra=frozenset(), keep=frozenset()):
        """Cast-wrap island ops in `block`: flipped inputs cast up to f32,
        flipped outputs routed through an f32 temp then cast back down (so
        downstream ops see the bf16 value their var annotation promises)."""
        new_ops = []
        for op in block.ops:
            if not self._is_island(op.type, extra, keep):
                new_ops.append(op)
                continue
            for slot, names in list(op.inputs.items()):
                cast_names = []
                for n in names:
                    if n in flipped:
                        f32 = n + ".f32"
                        if not block.has_var(f32):
                            # flipped var may live in an ancestor block
                            # (island op inside a while/cond sub-block)
                            v = block._var_recursive(n)
                            block.create_var(
                                name=f32, shape=v.shape, dtype="float32"
                            )
                        new_ops.append(
                            Operator(
                                block,
                                "cast",
                                inputs={"X": [n]},
                                outputs={"Out": [f32]},
                                attrs={
                                    "in_dtype": "bfloat16",
                                    "out_dtype": "float32",
                                    OpRole.OP_ROLE_KEY: _role(op),
                                },
                            )
                        )
                        cast_names.append(f32)
                    else:
                        cast_names.append(n)
                op.inputs[slot] = cast_names
            post_casts = []
            for slot, names in list(op.outputs.items()):
                out_names = []
                for out in names:
                    if out in flipped:
                        f32 = out + ".f32out"
                        if not block.has_var(f32):
                            v = block._var_recursive(out)
                            block.create_var(
                                name=f32, shape=v.shape, dtype="float32"
                            )
                        post_casts.append(
                            Operator(
                                block,
                                "cast",
                                inputs={"X": [f32]},
                                outputs={"Out": [out]},
                                attrs={
                                    "in_dtype": "float32",
                                    "out_dtype": "bfloat16",
                                    OpRole.OP_ROLE_KEY: _role(op),
                                },
                            )
                        )
                        out_names.append(f32)
                    else:
                        out_names.append(out)
                op.outputs[slot] = out_names
            new_ops.append(op)
            new_ops.extend(post_casts)
        block.ops = new_ops

    # -- freeze mode (inference) ------------------------------------------

    def _transpile_freeze(self, program, scope):
        import torch

        from ..executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()

        flipped = set()
        for name, v in block.vars.items():
            if v.dtype == "float32":
                v.dtype = "bfloat16"
                flipped.add(name)
                val = scope.find_var(name)
                if val is not None and v.persistable:
                    scope.set_var(name, torch.as_tensor(val).to(torch.bfloat16))

        self._wrap_islands(block, flipped)

    # -- train mode (master weights) --------------------------------------

    def _transpile_train(self, program):
        # 1. activations + gradients flip to bf16; persistables (params,
        #    moments, BN stats, lr) keep f32 — they are the master state
        flipped = set()
        for blk in program.blocks:
            for name, v in blk.vars.items():
                if v.dtype == "float32" and not v.persistable:
                    v.dtype = "bfloat16"
                    flipped.add(name)
        # Optimize-role helper ops (regularizers, grad clip) appended under
        # _optimized_guard read the f32 masters directly; any output they
        # derive from an f32 operand is f32 at runtime, so its annotation
        # must stay f32 (f32 weight-decay math feeding the update is the
        # numerically-right thing — only the ANNOTATION needs fixing).
        # Fixpoint because their outputs chain (scale → sum).
        all_vars = {}
        for blk in program.blocks:
            for name, v in blk.vars.items():
                all_vars.setdefault(name, v)
        changed = True
        while changed:
            changed = False
            for blk in program.blocks:
                for op in blk.ops:
                    if not _role(op) & OpRole.Optimize:
                        continue
                    has_f32_in = any(
                        n in all_vars
                        and n not in flipped
                        and all_vars[n].dtype == "float32"
                        for ns in op.inputs.values()
                        for n in ns
                    )
                    if not has_f32_in:
                        continue
                    for ns in op.outputs.values():
                        for n in ns:
                            if n in flipped:
                                all_vars[n].dtype = "float32"
                                flipped.discard(n)
                                changed = True

        # attr-driven producers (fill_constant & friends) must emit the
        # flipped dtype too, or the value contradicts its var annotation
        # (e.g. the backward's f32 loss@GRAD seed into a bf16 var)
        for blk in program.blocks:
            for op in blk.ops:
                if str(op.attrs.get("dtype", "")) not in ("float32", "5"):
                    continue
                outs = [n for ns in op.outputs.values() for n in ns]
                if outs and all(n in flipped for n in outs):
                    op.attrs["dtype"] = "bfloat16"

        # 2. one bf16 cast per consumed master param per step: rewrite every
        #    compute op (not optimizer/LR-sched, not islands, not casts) to
        #    read `w@BF16`; the cast ops are prepended to the global block
        gblock = program.global_block()
        masters = {
            name
            for name, v in gblock.vars.items()
            if v.persistable and v.dtype == "float32"
        }
        used = []  # masters consumed by compute ops, in first-use order
        skip_roles = OpRole.Optimize | OpRole.LRSched
        for blk in program.blocks:
            for op in blk.ops:
                if _role(op) & skip_roles or op.type == "cast":
                    continue
                # islands cast masters up themselves; keep-set ops (BN/LN/CE)
                # are f32-native and read master Scale/Bias/stats directly
                if self._is_island(op.type, _TRAIN_ISLANDS | _TRAIN_KEEP_BF16):
                    continue
                for slot, names in list(op.inputs.items()):
                    rewritten = []
                    for n in names:
                        if n in masters:
                            if n not in used:
                                used.append(n)
                            rewritten.append(n + "@BF16")
                        else:
                            rewritten.append(n)
                    op.inputs[slot] = rewritten
        casts = []
        for n in used:
            v = gblock.var(n)
            cast_name = n + "@BF16"
            if not gblock.has_var(cast_name):
                gblock.create_var(name=cast_name, shape=v.shape, dtype="bfloat16")
                flipped.add(cast_name)
            casts.append(
                Operator(
                    gblock,
                    "cast",
                    inputs={"X": [n]},
                    outputs={"Out": [cast_name]},
                    attrs={
                        "in_dtype": "float32",
                        "out_dtype": "bfloat16",
                        OpRole.OP_ROLE_KEY: OpRole.Forward,
                    },
                )
            )
        gblock.ops = casts + gblock.ops

        # 3. islands (blacklist + gather-likes + their _grad twins, minus the
        #    internally-f32-accumulating keep set) compute in f32 and cast
        #    flipped outputs back down
        for blk in program.blocks:
            self._wrap_islands(blk, flipped, _TRAIN_ISLANDS, _TRAIN_KEEP_BF16)


# the reference's class name, kept as an alias targeting bf16 (the JAX
# package's choice; the card's tensor cores run bf16 at the fp16 rate)
Float16Transpiler = Bf16Transpiler
