"""The pass battery of the training_fused preset (reference
framework/ir/*_pass.cc equivalents), copied from paddle_tpu/passes/builtin.py:
constant_fold, dead_op_eliminate, fuse_elemwise_act, the kernel-substitution
taggers fuse_gemm_epilogue / fuse_layer_norm / fuse_optimizer, and
inplace_donation_plan. The JAX package's fuse_attention pass waits for the
flash-attention slice.

Every pass here preserves the RNG stream of the block: stochastic ops are
never folded, eliminated, or reordered, because each surviving stochastic op
draws from the run's generator in program order — removing or moving one
would silently change every later op's randomness.
"""

from ..framework import Block
from .pass_base import Pass, register_pass

__all__ = [
    "ConstantFoldPass",
    "DeadOpEliminatePass",
    "FuseElemwiseActPass",
    "FuseGemmEpiloguePass",
    "FuseLayerNormPass",
    "FuseOptimizerPass",
    "InplaceDonationPlanPass",
]


def _prune_orphan_vars(graph, keep):
    """Drop block-0 var declarations no remaining op references (never
    persistables, data vars, or anything in `keep`)."""
    block = graph.program.global_block()
    used = set()
    for blk in graph.program.blocks:
        for op in blk.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
    dropped = 0
    for name in list(block.vars):
        v = block.vars[name]
        if name in used or name in keep or v.persistable or v.is_data:
            continue
        del block.vars[name]
        dropped += 1
    if dropped:
        graph.program._bump_version()
    return dropped


@register_pass("constant_fold")
class ConstantFoldPass(Pass):
    """Evaluate ops whose inputs are all persistable constants and replace
    them with their value, stored into the scope (reference
    constant_folding_pass.cc). "Constant" means: in the scope, never written
    by any op of the program, and not fed. Ops are skipped when they are
    stochastic, host-side, control-flow, write persistable/fetched/fed names,
    names a sub-block reads, names that already hold a scope value, or names
    with more than one writer — every case where baking the value in would
    change observable behavior."""

    def apply(self, graph, ctx):
        import torch

        from ..ops import registry

        result = {"folded": 0, "stored": []}
        ctx.results[self.name] = result
        scope = ctx.scope
        if scope is None:
            return
        block = graph.program.global_block()
        fed = set(ctx.feed_names)
        fetched = set(ctx.fetch_names)
        sub_used = graph.subblock_reachable_names()

        writer_count = {}
        for blk in graph.program.blocks:
            for op in blk.ops:
                for n in op.output_arg_names:
                    writer_count[n] = writer_count.get(n, 0) + 1

        const_vals = {}  # folded-away outputs, usable by later folds

        def const_value(name):
            if name in const_vals:
                return const_vals[name]
            if name in fed or writer_count.get(name, 0) > 0:
                return None
            val = scope.find_var(name)
            if val is None:
                return None
            v = block.vars.get(name)
            if v is not None and not v.persistable:
                return None
            return val.cpu()

        # folds evaluate on the CPU (the JAX package evaluates them eagerly
        # on its default device); the values the surviving ops read are
        # stored on the scope's device
        lower_ctx = registry.LowerCtx("cpu", is_test=True)
        kept = []
        for op in block.ops:
            opdef = (
                registry.get(op.type)
                if registry.is_registered(op.type)
                else None
            )
            out_names = [
                n for n in op.output_arg_names
                if n != registry.EMPTY_VAR_NAME
            ]
            foldable = (
                opdef is not None
                and opdef.lower is not None
                and not opdef.skip_exec
                and not opdef.is_host
                and not opdef.stochastic
                and not any(
                    isinstance(v, Block) for v in op.attrs.values()
                )
                and out_names
                and all(
                    writer_count.get(n, 0) == 1
                    and n not in fetched
                    and n not in fed
                    and n not in sub_used
                    and scope.find_var(n) is None
                    and not (
                        block.vars.get(n) is not None
                        and block.vars[n].persistable
                    )
                    for n in out_names
                )
            )
            env = {}
            if foldable:
                for n in op.input_arg_names:
                    if n == registry.EMPTY_VAR_NAME:
                        continue
                    val = const_value(n)
                    if val is None:
                        foldable = False
                        break
                    env[n] = val
            if not foldable:
                kept.append(op)
                continue
            try:
                registry.lower_ops(lower_ctx, [op], env)
            except Exception:
                kept.append(op)  # lowering refused eager aval — not a constant
                continue
            ok = True
            for n in out_names:
                if env.get(n) is None:
                    ok = False
                    break
            if not ok:
                kept.append(op)
                continue
            for n in out_names:
                const_vals[n] = env[n]
            # decrement so a later op consuming only this (now writer-less)
            # name sees it as a constant
            for n in out_names:
                writer_count[n] -= 1
            result["folded"] += 1
        if not result["folded"]:
            return
        block.ops = kept
        # materialize folded values the surviving ops still read: downstream
        # consumers get them from the scope as read-only state (values of
        # fully folded-through chains never need to exist at run time)
        still_read = set()
        for blk in graph.program.blocks:
            for op in blk.ops:
                still_read.update(op.input_arg_names)
        for n, val in const_vals.items():
            if n not in still_read:
                continue
            scope.set_var(n, val.to(scope.device))
            result["stored"].append(n)
        result["stored"].sort()
        graph.program._bump_version()
        graph.refresh()
        _prune_orphan_vars(graph, keep=set(result["stored"]) | fed | fetched)


@register_pass("dead_op_eliminate")
class DeadOpEliminatePass(Pass):
    """Remove ops whose outputs are unfetched and unconsumed (reference
    graph_to_program 'garbage' ops / Program._prune, but fetch- AND
    persistable-root aware: an op that writes persistable state — an
    optimizer update, a running-stat write — is a root even when nothing
    fetches it, as are host/control-flow/stochastic/unregistered ops)."""

    def apply(self, graph, ctx):
        from ..ops import registry

        block = graph.program.global_block()
        fed = set(ctx.feed_names)
        needed = set(ctx.fetch_names) | graph.subblock_reachable_names()
        kept = []
        for op in reversed(block.ops):
            opdef = (
                registry.get(op.type)
                if registry.is_registered(op.type)
                else None
            )
            keep = (
                opdef is None
                or opdef.skip_exec
                or opdef.is_host
                or opdef.stochastic
                or any(isinstance(v, Block) for v in op.attrs.values())
                or not op.output_arg_names
                or any(n in needed for n in op.output_arg_names)
            )
            if not keep:
                for n in op.output_arg_names:
                    v = block.vars.get(n)
                    if v is not None and v.persistable:
                        keep = True
                        break
            if keep:
                kept.append(op)
                needed.update(
                    n for n in op.input_arg_names
                    if n != registry.EMPTY_VAR_NAME
                )
        removed = len(block.ops) - len(kept)
        ctx.results[self.name] = {"removed": removed}
        if not removed:
            return
        block.ops = list(reversed(kept))
        graph.program._bump_version()
        graph.refresh()
        _prune_orphan_vars(graph, keep=needed | fed)


# producer -> (consumer add) -> activation chains the tagger groups; the
# attr itself is defined in ops/registry.py because lower_ops reads it
_FUSE_PRODUCERS = ("matmul", "mul", "conv2d", "depthwise_conv2d")
_FUSE_ACTS = (
    "relu", "relu6", "gelu", "tanh", "sigmoid", "swish", "leaky_relu",
)


@register_pass("fuse_elemwise_act")
class FuseElemwiseActPass(Pass):
    """Tag contiguous matmul/conv → elementwise_add [→ activation] chains
    with a shared `fusion_group` attr (reference fuse_elewise_add_act_pass).
    The JAX package lowers each tagged run inside one named scope as an XLA
    fusion hint; here the tag is carried as program data and the run lowers
    op by op. Purely additive — op semantics, order, and count are
    untouched."""

    def apply(self, graph, ctx):
        from ..ops.registry import FUSION_GROUP_ATTR

        ops = graph.program.global_block().ops
        groups = 0
        tagged = 0
        i = 0
        while i < len(ops):
            op = ops[i]
            if op.type not in _FUSE_PRODUCERS or FUSION_GROUP_ATTR in op.attrs:
                i += 1
                continue
            chain = self._chain_at(graph, ops, i)
            if chain is None:
                i += 1
                continue
            gid = "fg%d" % groups
            for member in chain:
                member.attrs[FUSION_GROUP_ATTR] = gid
                tagged += 1
            groups += 1
            i += len(chain)
        ctx.results[self.name] = {"groups": groups, "ops_tagged": tagged}
        if groups:
            graph.program._bump_version()

    @staticmethod
    def _chain_at(graph, ops, i):
        def next_consumes(op, j):
            """ops[j+1] iff it directly consumes op's first output. Other
            consumers (grad ops re-reading the forward intermediate) don't
            disqualify: the tag only wraps lowering in a named_scope, it
            never rewrites def-use."""
            if j + 1 >= len(ops):
                return None
            out = op.output_arg_names[0] if op.output_arg_names else None
            if out is None:
                return None
            nxt = ops[j + 1]
            if out not in nxt.input_arg_names:
                return None
            return nxt

        add = next_consumes(ops[i], i)
        if add is None or add.type != "elementwise_add":
            return None
        chain = [ops[i], add]
        act = next_consumes(add, i + 1)
        if act is not None and act.type in _FUSE_ACTS:
            chain.append(act)
        return chain


# chains the kernel-substitution taggers hand to the fused lowerings. These
# passes only TAG: every shape/dtype/attr decision is re-validated at run
# time by the @register_fused lowering (ops/fused.py), which declines back
# to the per-op path — so tagging can be optimistic without risking
# semantics.
_PALLAS_GEMM_PRODUCERS = ("mul", "matmul")
_PALLAS_GEMM_ACTS = ("relu", "gelu", "tanh", "sigmoid")


def _pallas_free(op):
    from ..ops.registry import PALLAS_GROUP_ATTR

    return PALLAS_GROUP_ATTR not in op.attrs


def _tag_run(run, gid, family):
    from ..ops.registry import PALLAS_GROUP_ATTR, PALLAS_KERNEL_ATTR

    for member in run:
        member.attrs[PALLAS_GROUP_ATTR] = gid
        member.attrs[PALLAS_KERNEL_ATTR] = family


@register_pass("fuse_gemm_epilogue")
class FuseGemmEpiloguePass(Pass):
    """Tag mul|matmul → elementwise_add [→ act] chains for the fused GEMM
    epilogue (ops/fused.py `gemm_epilogue`): bias add and activation
    computed on the f32 accumulator with ONE rounding to the output dtype.
    Unlike fuse_elemwise_act (a tag this pass coexists with — kernel tags
    take precedence in lower_ops), the wiring check here is strict slot
    equality, because the fused lowering replaces the ops' math."""

    def apply(self, graph, ctx):
        ops = graph.program.global_block().ops
        groups = 0
        tagged = 0
        i = 0
        while i < len(ops):
            op = ops[i]
            if op.type not in _PALLAS_GEMM_PRODUCERS or not _pallas_free(op):
                i += 1
                continue
            chain = self._chain_at(ops, i)
            if chain is None:
                i += 1
                continue
            _tag_run(chain, "gemm%d" % groups, "gemm_epilogue")
            tagged += len(chain)
            groups += 1
            i += len(chain)
        ctx.results[self.name] = {"groups": groups, "ops_tagged": tagged}
        if groups:
            graph.program._bump_version()

    @staticmethod
    def _chain_at(ops, i):
        prod = ops[i]
        if i + 1 >= len(ops) or not prod.output_arg_names:
            return None
        add = ops[i + 1]
        if (
            add.type != "elementwise_add"
            or not _pallas_free(add)
            or add.input("X") != [prod.output("Out")[0]]
        ):
            return None
        chain = [prod, add]
        if i + 2 < len(ops):
            act = ops[i + 2]
            if (
                act.type in _PALLAS_GEMM_ACTS
                and _pallas_free(act)
                and act.input("X") == [add.output("Out")[0]]
            ):
                chain.append(act)
        return chain


@register_pass("fuse_layer_norm")
class FuseLayerNormPass(Pass):
    """Tag [elementwise_add →] layer_norm chains for the fused
    layer_norm(+residual) forward (`layer_norm` family: residual add in the
    input dtype, one-pass Welford stats and normalization in f32), and every
    layer_norm_grad as a singleton for the explicit backward kernel
    (`layer_norm_grad` family). Grad ops never inherit forward tags —
    backward.py copies attrs at build time, before any pass runs — so the
    backward must be tagged here explicitly."""

    def apply(self, graph, ctx):
        ops = graph.program.global_block().ops
        groups = 0
        tagged = 0
        i = 0
        while i < len(ops):
            op = ops[i]
            if not _pallas_free(op):
                i += 1
                continue
            if op.type == "layer_norm_grad":
                _tag_run([op], "lng%d" % groups, "layer_norm_grad")
                groups += 1
                tagged += 1
                i += 1
                continue
            if (
                op.type == "elementwise_add"
                and i + 1 < len(ops)
                and ops[i + 1].type == "layer_norm"
                and _pallas_free(ops[i + 1])
                and ops[i + 1].input("X") == [op.output("Out")[0]]
            ):
                _tag_run([op, ops[i + 1]], "ln%d" % groups, "layer_norm")
                groups += 1
                tagged += 2
                i += 2
                continue
            if op.type == "layer_norm":
                _tag_run([op], "ln%d" % groups, "layer_norm")
                groups += 1
                tagged += 1
            i += 1
        ctx.results[self.name] = {"groups": groups, "ops_tagged": tagged}
        if groups:
            graph.program._bump_version()


@register_pass("fuse_optimizer")
class FuseOptimizerPass(Pass):
    """Tag maximal contiguous runs (≥ 2) of dense adam ops sharing
    (beta1, beta2, epsilon, LearningRate input) for the fused multi-tensor
    Adam kernel (`multi_adam` family): every param group updated by ONE
    kernel over a table of the tensors, f32 master math rounded to the
    storage dtypes. AdamOptimizer emits exactly this shape — one adam
    per param back to back, beta-pow scale ops appended after the run."""

    def apply(self, graph, ctx):
        ops = graph.program.global_block().ops
        groups = 0
        tagged = 0
        i = 0
        while i < len(ops):
            op = ops[i]
            if op.type != "adam" or not _pallas_free(op):
                i += 1
                continue
            key = self._group_key(op)
            j = i + 1
            while (
                j < len(ops)
                and ops[j].type == "adam"
                and _pallas_free(ops[j])
                and self._group_key(ops[j]) == key
            ):
                j += 1
            run = ops[i:j]
            if len(run) >= 2:
                _tag_run(run, "madam%d" % groups, "multi_adam")
                groups += 1
                tagged += len(run)
            i = j
        ctx.results[self.name] = {"groups": groups, "ops_tagged": tagged}
        if groups:
            graph.program._bump_version()

    @staticmethod
    def _group_key(op):
        return (
            op.attrs.get("beta1", 0.9),
            op.attrs.get("beta2", 0.999),
            op.attrs.get("epsilon", 1e-8),
            op.input("LearningRate")[0],
        )


@register_pass("inplace_donation_plan")
class InplaceDonationPlanPass(Pass):
    """Compute the block's state split — which scope tensors the block
    rewrites (written back to the scope, or updated in place) vs reads only
    — as a pass over the graph (reference memory/inplace_op_pass +
    build_strategy memory planning). The plan rides the emitted program
    (`program._donation_plan`); executor._CompiledBlock cross-checks its own
    classification against it and raises on divergence."""

    def apply(self, graph, ctx):
        from ..ops import registry

        scope = ctx.scope
        fed = set(ctx.feed_names)
        plan = {
            "feed": sorted(fed),
            "fetch": list(ctx.fetch_names),
            "mut": [],
            "ro": [],
            "unknown": [],
            "scope_uid": getattr(scope, "_uid", None),
        }
        ctx.results[self.name] = plan
        block = graph.program.global_block()
        if scope is None or not all(
            registry.is_registered(op.type) for op in block.ops
        ):
            plan["unknown"] = ["<unanalyzable>"]
            return
        ops = [
            op for op in block.ops if not registry.get(op.type).skip_exec
        ]
        produced, state, unknown = set(), set(), set()
        for op in ops:
            for name in op.input_arg_names:
                if (
                    name == registry.EMPTY_VAR_NAME
                    or name in fed
                    or name in produced
                    or name in state
                    or name in unknown
                ):
                    continue
                if scope.find_var(name) is not None:
                    state.add(name)
                else:
                    unknown.add(name)
            produced.update(
                n for n in op.output_arg_names
                if n != registry.EMPTY_VAR_NAME
            )
        for name in ctx.fetch_names:
            if name not in fed and name not in produced and name not in state:
                if scope.find_var(name) is not None:
                    state.add(name)
                else:
                    unknown.add(name)
        written = set()
        for op in ops:
            written.update(
                n for n in op.output_arg_names
                if n != registry.EMPTY_VAR_NAME
            )
        plan["mut"] = sorted(state & written)
        plan["ro"] = sorted(state - written)
        plan["unknown"] = sorted(unknown)
