"""Gradient merging / batch-merge transpile.

Reference analog: framework/ir/multi_batch_merge_pass.cc (repeats the
forward/backward sub-graph k times and averages gradients before one
optimizer step; driven by test_dist_mnist_batch_merge.py to train with an
effective batch k× the device batch).

The port's copy of paddle_tpu/transpiler/gradient_merge.py. Instead of
cloning the fwd/bwd graph k times (k× the ops), the program keeps ONE
fwd/bwd and the optimizer tier is made conditional: every step accumulates
the gradient into a persistent buffer; every k-th step the optimizer ops run
on the averaged accumulator (inside a conditional_block, which selects the
updated values where its condition holds) and the buffers reset.
Numerically identical to the reference pass for linear optimizers over the
k micro-batches, with O(1) program size. Under a ParallelExecutor the
gradients are averaged over dp before the first Optimize-role op, which is
the accumulation here, so each micro-step accumulates the global batch's
gradient.
"""

from ..framework import OpRole
__all__ = ["OPTIMIZER_OP_TYPES", "gradient_merge_transpile"]

# the 12 optimizer update ops (reference operators/optimizers/, SURVEY.md
# §2.5; the JAX package keeps the set in transpiler/distribute_transpiler.py,
# which comes with ROADMAP A6b item 4)
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


def gradient_merge_transpile(main_program, startup_program, k_steps, avg=True):
    """Rewrite main_program in place. Returns the accumulation counter var.

    Must run AFTER optimizer.minimize() (it rewrites the Optimize-role ops).
    """
    if k_steps < 1:
        raise ValueError("k_steps must be >= 1")
    block = main_program.global_block()
    sblock = startup_program.global_block()

    opt_idx = [
        i
        for i, op in enumerate(block.ops)
        if op.type in OPTIMIZER_OP_TYPES
        and int(op.attrs.get(OpRole.OP_ROLE_KEY, 0)) & int(OpRole.Optimize)
    ]
    if not opt_idx:
        raise ValueError("no optimizer ops found; call minimize() first")
    first_opt = opt_idx[0]

    def persistent_zero(name, shape, dtype):
        v = block.create_var(
            name=name, shape=shape, dtype=dtype, persistable=True
        )
        sblock.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        sblock.append_op(
            type="fill_constant",
            inputs={},
            outputs={"Out": [name]},
            attrs={"shape": list(shape), "dtype": dtype, "value": 0.0},
        )
        return v

    # step counter + "apply now" condition, computed before the optimizer tier
    step = persistent_zero("@GRAD_MERGE@.step", [1], "int64")
    cond_name = "@GRAD_MERGE@.cond"
    block.create_var(name=cond_name, shape=[1], dtype="bool")
    new_head = []

    def op_spec(type, inputs, outputs, attrs):
        attrs = dict(attrs)
        attrs[OpRole.OP_ROLE_KEY] = OpRole.Optimize
        return dict(type=type, inputs=inputs, outputs=outputs, attrs=attrs)

    new_head.append(
        op_spec(
            "increment",
            {"X": [step.name]},
            {"Out": [step.name]},
            {"step": 1.0},
        )
    )
    mod_name = "@GRAD_MERGE@.step_mod"
    block.create_var(name=mod_name, shape=[1], dtype="int64")
    kname = "@GRAD_MERGE@.k"
    block.create_var(name=kname, shape=[1], dtype="int64")
    new_head.append(
        op_spec(
            "fill_constant",
            {},
            {"Out": [kname]},
            {"shape": [1], "dtype": "int64", "value": float(k_steps)},
        )
    )
    new_head.append(
        op_spec(
            "elementwise_mod",
            {"X": [step.name], "Y": [kname]},
            {"Out": [mod_name]},
            {},
        )
    )
    zero_name = "@GRAD_MERGE@.zero"
    block.create_var(name=zero_name, shape=[1], dtype="int64")
    new_head.append(
        op_spec(
            "fill_constant",
            {},
            {"Out": [zero_name]},
            {"shape": [1], "dtype": "int64", "value": 0.0},
        )
    )
    new_head.append(
        op_spec(
            "equal",
            {"X": [mod_name], "Y": [zero_name]},
            {"Out": [cond_name]},
            {},
        )
    )

    # Every Optimize-role op from the first optimizer op onward moves into
    # the conditional sub-block — not just OPTIMIZER_OP_TYPES. Adam/Adamax
    # _finish_update emits `scale` ops advancing Beta{1,2}Pow after the
    # optimizer tier; leaving those outside would advance bias-correction
    # state every micro-step (k× too fast).
    moved_idx = [
        i
        for i, op in enumerate(block.ops)
        if i >= first_opt
        and int(op.attrs.get(OpRole.OP_ROLE_KEY, 0)) & int(OpRole.Optimize)
    ]
    moved_set = set(moved_idx)
    moved_ops = [block.ops[i] for i in moved_idx]
    opt_ops = [op for op in moved_ops if op.type in OPTIMIZER_OP_TYPES]
    grads = []
    accum_of = {}
    for op in opt_ops:
        for gname in op.inputs.get("Grad", []):
            if gname in accum_of:
                continue
            gvar = block._var_recursive(gname)
            aname = gname + "@MERGED"
            persistent_zero(aname, [d if d != -1 else 1 for d in (gvar.shape or [1])], gvar.dtype or "float32")
            accum_of[gname] = aname
            grads.append(gname)
            new_head.append(
                op_spec(
                    "sum",
                    {"X": [aname, gname]},
                    {"Out": [aname]},
                    {},
                )
            )

    # build the conditional optimizer sub-block
    sub = main_program._create_block()
    scale = 1.0 / k_steps if avg else 1.0
    written = []
    for op in moved_ops:
        new_inputs = {}
        for slot, names in op.inputs.items():
            if slot == "Grad" and op.type in OPTIMIZER_OP_TYPES:
                scaled = []
                for gname in names:
                    aname = accum_of[gname]
                    s_name = aname + ".scaled"
                    if not sub.has_var(s_name):
                        # one scale per accumulator even when several
                        # optimizer ops consume the same gradient
                        sub.create_var(name=s_name, shape=None, dtype=None)
                        sub.append_op(
                            type="scale",
                            inputs={"X": [aname]},
                            outputs={"Out": [s_name]},
                            attrs={"scale": scale},
                        )
                    scaled.append(s_name)
                new_inputs[slot] = scaled
            else:
                new_inputs[slot] = list(names)
        sub.append_op(
            type=op.type,
            inputs=new_inputs,
            outputs={k: list(v) for k, v in op.outputs.items()},
            attrs={
                k: v
                for k, v in op.attrs.items()
                if k != OpRole.OP_ROLE_KEY
            },
        )
        for names in op.outputs.values():
            written.extend(names)
    # reset accumulators inside the apply branch
    for gname in grads:
        aname = accum_of[gname]
        gvar = block._var_recursive(gname)
        sub.append_op(
            type="fill_zeros_like",
            inputs={"X": [aname]},
            outputs={"Out": [aname]},
            attrs={},
        )
        written.append(aname)
    main_program._rollback()

    written = sorted(set(written))
    # closure of names the sub-block reads from the outer scope; written
    # names must ride in X too — conditional_block takes their prior values
    # from the same env for the not-taken branch
    x_names = sorted(
        {
            n
            for op in sub.ops
            for n in op.input_arg_names
            if not sub.has_var(n)
        }
        | set(written)
    )
    cond_spec = op_spec(
        "conditional_block",
        {"Cond": [cond_name], "X": x_names},
        {"Out": written},
        {
            "sub_block": sub,
            "x_names": x_names,
            "written_names": written,
            "is_scalar_condition": True,
        },
    )

    # splice: [fwd+bwd ops] + new_head + [conditional apply] (+ any trailing
    # non-optimizer ops that followed the optimizer tier)
    # LRSched-role ops (per-param LR scale from _create_param_lr) sit
    # interleaved with the optimizer tier and produce the LearningRate vars
    # the moved optimizer ops read — they must run BEFORE the conditional.
    # Everything else non-Optimize stays after it.
    lr_ops, tail = [], []
    for i, op in enumerate(block.ops):
        if i < first_opt or i in moved_set:
            continue
        role = int(op.attrs.get(OpRole.OP_ROLE_KEY, 0))
        (lr_ops if role & OpRole.LRSched else tail).append(op)
    del block.ops[first_opt:]
    block.ops.extend(lr_ops)
    for spec in new_head:
        block.append_op(**spec)
    block.append_op(**cond_spec)
    block.ops.extend(tail)
    main_program._bump_version()
    return step
