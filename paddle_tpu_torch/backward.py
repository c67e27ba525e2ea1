"""append_backward: reverse-mode autodiff as a program rewrite (a copy of
paddle_tpu/backward.py, pointed at this package's op registry).

Reference analog: python/paddle/fluid/backward.py:469 — walk ops in reverse
from the loss, emit grad ops per forward op, sum-deduplicate repeated-var
gradients (reference _addup_repetitive_outputs_:135), prune branches that
don't need grad, tag ops with OpRole.Backward + op_role_var.

Where gradients come from: the reference calls each op's hand-written C++
GradOpDescMaker; here a forward op `t` gets a generic `t_grad` op whose
lowering is torch.func.vjp over `t`'s forward lowering
(ops/registry.py:_make_generic_grad), unless the op registers a grad maker
or an explicit `t_grad` lowering.

Grad op slot convention (matches reference grad_op_desc_maker.h): inputs are
the forward input slots, forward output slots, and `<slot>@GRAD` cotangents;
outputs are `<in-slot>@GRAD`. Missing entries use the `@EMPTY@` placeholder
(reference core.kEmptyVarName).
"""

from . import framework
from .framework import OpRole, Parameter, grad_var_name
from .ops import registry

__all__ = ["append_backward"]

from .ops.registry import EMPTY_VAR_NAME


def _create_grad_var(block, ref_var, name):
    if block.has_var(name):
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=ref_var.shape,
        dtype=ref_var.dtype,
        persistable=False,
        stop_gradient=False,
    )


def _needs_grad(block, name, no_grad_set):
    if name in no_grad_set:
        return False
    try:
        v = block._var_recursive(name)
    except KeyError:
        return False
    if v.stop_gradient:
        return False
    return framework.is_float_dtype(v.dtype) if v.dtype else False


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None):
    """Append backward ops computing d(loss)/d(param) into loss's program.

    Returns [(param, grad_var)] like the reference (backward.py:469). Grad vars
    are named `<param>@GRAD`.
    """
    block = loss.block
    program = block.program
    no_grad_set = set(no_grad_set or [])
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad_set.add(v.name)

    # locate the op producing loss — ops after it (metrics etc.) are irrelevant
    loss_idx = None
    for i in reversed(range(len(block.ops))):
        if loss.name in block.ops[i].output_arg_names:
            loss_idx = i
            break
    if loss_idx is None:
        raise ValueError("loss %r is not produced by any op in its block" % loss.name)

    with program._backward_role_guard():
        # d(loss)/d(loss) = 1
        loss_grad = _create_grad_var(block, loss, grad_var_name(loss.name))
        block.append_op(
            type="fill_constant",
            outputs={"Out": [loss_grad.name]},
            attrs={
                "shape": list(loss.shape),
                "value": 1.0,
                "dtype": loss.dtype,
                OpRole.OP_ROLE_KEY: OpRole.Backward | OpRole.Loss,
            },
        )

        # pending[var_name] = [contribution grad var names]
        pending = {loss.name: [loss_grad.name]}

        def finalize_grad(name):
            """Collapse pending contributions for `name` into `<name>@GRAD`.
            Multiple consumers contribute separately; a `sum` op merges them
            (reference _addup_repetitive_outputs_)."""
            contribs = pending.get(name)
            if not contribs:
                return None
            canonical = grad_var_name(name)
            if len(contribs) > 1 and any(
                getattr(block.vars.get(c), "is_selected_rows", False)
                for c in contribs
            ):
                # the sparse grad maker (ops/sparse_ops.py) only emits a
                # SelectedRows grad for single-consumer tables, so this is a
                # bug guard, not a reachable path: `sum` over mixed
                # dense/SelectedRows contributions would silently add a
                # (cap, dim) values array to a (rows, dim) gradient
                raise ValueError(
                    "gradient of %r has %d contributions including a "
                    "SelectedRows (sparse) one — sparse grads cannot be "
                    "sum-merged; use is_sparse=False for multiply-consumed "
                    "tables" % (name, len(contribs))
                )
            if len(contribs) == 1:
                if contribs[0] != canonical:
                    # single contribution under a renamed var: alias via assign
                    ref = block._var_recursive(name)
                    _create_grad_var(block, ref, canonical)
                    block.append_op(
                        type="assign",
                        inputs={"X": [contribs[0]]},
                        outputs={"Out": [canonical]},
                    )
                return canonical
            ref = block._var_recursive(name)
            _create_grad_var(block, ref, canonical)
            block.append_op(
                type="sum",
                inputs={"X": list(contribs)},
                outputs={"Out": [canonical]},
            )
            pending[name] = [canonical]
            return canonical

        def add_contribution(name):
            """Allocate a grad var name for a new contribution to d(loss)/d(name)."""
            ref = block._var_recursive(name)
            canonical = grad_var_name(name)
            lst = pending.setdefault(name, [])
            gname = canonical if not lst else "%s@RENAME@%d" % (canonical, len(lst))
            lst.append(gname)
            _create_grad_var(block, ref, gname)
            return gname

        for i in range(loss_idx, -1, -1):
            op = block.ops[i]
            try:
                opdef = registry.get(op.type)
            except KeyError:
                continue
            if opdef.no_grad:
                continue
            out_grads_avail = any(
                pending.get(n) for n in op.output_arg_names
            )
            if not out_grads_avail:
                continue
            diff_inputs = [
                n for n in op.input_arg_names if _needs_grad(block, n, no_grad_set)
            ]
            if not diff_inputs:
                continue

            # finalize cotangents for this op's outputs (all consumers already
            # processed since we walk in reverse program order)
            out_grad_names = {}
            for slot, names in op.outputs.items():
                gs = [finalize_grad(n) for n in names]
                if any(g is not None for g in gs):
                    out_grad_names[slot] = [g or EMPTY_VAR_NAME for g in gs]

            if opdef.grad is not None:
                # custom grad maker (e.g. dropout reusing its Mask)
                grad_map = {}
                for slot, names in op.outputs.items():
                    for n in names:
                        g = pending.get(n)
                        if g:
                            grad_map[n] = g[0] if len(g) == 1 else grad_var_name(n)
                for n in diff_inputs:
                    grad_map[n] = add_contribution(n)
                for spec in opdef.grad(op, block, grad_map):
                    spec.setdefault("attrs", {})[OpRole.OP_ROLE_KEY] = OpRole.Backward
                    block.append_op(**spec)
                continue

            g_inputs = {}
            for slot, names in op.inputs.items():
                if names:
                    g_inputs[slot] = list(names)
            for slot, names in op.outputs.items():
                if names:
                    g_inputs[slot] = list(names)
            for slot, gnames in out_grad_names.items():
                g_inputs[slot + "@GRAD"] = gnames

            g_outputs = {}
            role_vars = []
            for slot, names in op.inputs.items():
                gs = []
                has = False
                for n in names:
                    if _needs_grad(block, n, no_grad_set):
                        gname = add_contribution(n)
                        gs.append(gname)
                        has = True
                        if isinstance(block._var_recursive(n), Parameter):
                            role_vars += [n, gname]
                    else:
                        gs.append(EMPTY_VAR_NAME)
                if has:
                    g_outputs[slot + "@GRAD"] = gs

            attrs = dict(op.attrs)
            attrs[registry.FWD_IN_SLOTS_ATTR] = list(op.inputs.keys())
            attrs[registry.FWD_OUT_SLOTS_ATTR] = list(op.outputs.keys())
            attrs[OpRole.OP_ROLE_KEY] = OpRole.Backward
            if role_vars:
                attrs[OpRole.OP_ROLE_VAR_KEY] = role_vars
            block.append_op(
                type=op.type + "_grad",
                inputs=g_inputs,
                outputs=g_outputs,
                attrs=attrs,
            )

        # finalize any parameter grads never consumed by another grad op
        params = (
            [block._var_recursive(p) if isinstance(p, str) else p for p in parameter_list]
            if parameter_list
            else block.all_parameters()
        )
        params_and_grads = []
        for p in params:
            if not getattr(p, "trainable", True):
                continue
            g = finalize_grad(p.name)
            if g is None:
                continue
            params_and_grads.append((p, block._var_recursive(g)))
    return params_and_grads
