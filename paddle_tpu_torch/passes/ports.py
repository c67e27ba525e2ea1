"""Transpiler rewrites ported onto the pass framework (a copy of
paddle_tpu/passes/ports.py pointed at the port's framework and scope).

InferenceTranspiler's conv + batch_norm fold, memory_optimize's
liveness-based buffer renaming and the QuantizeTranspiler training rewrite
live here as registered passes; the transpiler entry points are thin shims
over them (transpiler/inference_transpiler.py,
transpiler/memory_optimization_transpiler.py,
transpiler/quantize_transpiler.py).

A pass that rewrites parameters does its math in numpy, as the JAX package
does, and writes each result back as a tensor on the device of the value
it replaces, in the dtype the executor expects (f32 here); it bumps the
program's version, so the executor prepares (and on the card captures) the
rewritten program afresh instead of replaying a graph of the old weights.
"""

import numpy as np
import torch

from ..framework import Operator, OpRole
from .pass_base import Pass, register_pass

__all__ = ["FoldBatchNormPass", "MemoryOptimizePass", "QuantizeTrainingPass"]


@register_pass("fold_batch_norm")
class FoldBatchNormPass(Pass):
    """Fold inference-mode batch_norm into the preceding conv's weights
    (reference inference_transpiler.py fuse_batch_norm):

        W' = W * gamma / sqrt(var + eps)        (per output channel)
        b' = (b - mean) * gamma / sqrt(var + eps) + beta

    Patterns: conv2d → batch_norm and conv2d → elementwise_add → batch_norm.
    Rewrites the conv weights IN THE SCOPE (ctx.scope required — no-op
    without one) and drops the bn op and its four state reads. Not part of
    the default presets exactly because of that scope mutation: it is the
    InferenceTranspiler shim's delegate and an opt-in pipeline member."""

    def apply(self, graph, ctx):
        scope = ctx.scope
        result = {"folded": 0}
        ctx.results[self.name] = result
        if scope is None:
            return
        block = graph.program.global_block()
        i = 0
        while i < len(block.ops):
            trio = self._match(block, i)
            if trio is None:
                i += 1
                continue
            conv_op, add_op, bn_op = trio
            self._fold(block, scope, conv_op, add_op, bn_op)
            result["folded"] += 1
            graph.program._bump_version()
            i = block.ops.index(conv_op) + 1  # indices shifted; rescan
        if result["folded"]:
            graph.refresh()

    @staticmethod
    def _match(block, i):
        """(conv, add_or_None, bn) rooted at op i, else None."""
        ops = block.ops
        op = ops[i]
        if op.type not in ("conv2d", "depthwise_conv2d") or not op.output(
            "Output"
        ):
            return None
        out = op.output("Output")[0]
        users = [o for o in ops if out in o.input_arg_names]
        if len(users) != 1:
            return None
        nxt = users[0]
        add_op = None
        if nxt.type == "elementwise_add" and nxt.input("X") == [out]:
            add_out = nxt.output("Out")[0]
            users2 = [o for o in ops if add_out in o.input_arg_names]
            if len(users2) != 1:
                return None
            add_op, nxt = nxt, users2[0]
        if nxt.type == "batch_norm" and nxt.attrs.get("is_test", False):
            return (op, add_op, nxt)
        return None

    @staticmethod
    def _fold(block, scope, conv_op, add_op, bn_op):
        w_name = conv_op.input("Filter")[0]
        device = scope.find_var(w_name).device

        def read(name):
            return scope.find_var(name).detach().to("cpu").numpy()

        def write(name, arr):
            scope.set_var(name, torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32)).to(device))

        gamma = read(bn_op.input("Scale")[0])
        beta = read(bn_op.input("Bias")[0])
        mean = read(bn_op.input("Mean")[0])
        var = read(bn_op.input("Variance")[0])
        eps = float(bn_op.attrs.get("epsilon", 1e-5))
        std_inv = gamma / np.sqrt(var + eps)

        w = read(w_name).astype(np.float32)
        # conv filter layout (out_c, in_c, kh, kw): scale per out channel
        w = w * std_inv.reshape((-1,) + (1,) * (w.ndim - 1))
        write(w_name, w)

        bn_out = bn_op.output("Y")[0]
        if add_op is not None:
            # existing bias: b' = (b - mean) * std_inv + beta
            b_name = add_op.input("Y")[0]
            b = read(b_name).astype(np.float32)
            write(b_name, (b - mean) * std_inv + beta)
            add_op.outputs["Out"] = [bn_out]
        else:
            # no bias add: introduce one carrying the folded shift
            b_name = w_name + ".bn_bias"
            block.create_var(
                name=b_name,
                shape=(len(beta),),
                dtype="float32",
                persistable=True,
            )
            write(b_name, beta - mean * std_inv)
            conv_out = conv_op.output("Output")[0]
            idx = block.ops.index(bn_op)
            block.ops[idx] = Operator(
                block,
                "elementwise_add",
                inputs={"X": [conv_out], "Y": [b_name]},
                outputs={"Out": [bn_out]},
                attrs={"axis": 1, OpRole.OP_ROLE_KEY: OpRole.Forward},
            )
            return
        # drop the bn op (its output now produced by the add)
        block.ops.remove(bn_op)


# ops whose outputs alias inputs or that the renamer must not touch
# (reference SUB_BLOCK_OPS + skip list)
_SKIP_OP_TYPES = frozenset(
    ["while", "conditional_block", "recurrent", "listen_and_serv"]
)


class _Liveness:
    """Backward liveness over the straight-line op list (the reference's
    ControlFlowGraph restricted to block 0, which is where it applies it)."""

    def __init__(self, block, protected):
        self.block = block
        self.protected = protected
        n = len(block.ops)
        self.live_after = [set() for _ in range(n)]
        live = set(protected)
        for i in range(n - 1, -1, -1):
            op = block.ops[i]
            self.live_after[i] = set(live)
            live -= set(op.output_arg_names)
            live |= set(op.input_arg_names)


@register_pass("memory_optimize")
class MemoryOptimizePass(Pass):
    """Liveness-based buffer renaming (reference
    memory_optimization_transpiler.py ControlFlowGraph :113 / entry :457):
    later intermediates are renamed onto dead earlier vars of identical
    dtype+shape so values materializing at feed/fetch and host-op segment
    boundaries reuse names. Inside a block the executor already drops each
    intermediate after its last reader, and a captured graph's pool reuses
    its memory — see the shim module docstring for why the transform is
    kept. Knobs ride ctx.attrs: `skip_opt_set` (iterable of
    protected names), `print_log` (report the reuse plan). The mapping
    {renamed_var: buffer_it_now_occupies} lands in ctx.results."""

    def apply(self, graph, ctx):
        block = graph.program.global_block()
        skip = set(ctx.attrs.get("skip_opt_set") or ())
        print_log = bool(ctx.attrs.get("print_log", False))
        protected = set(skip) | set(ctx.fetch_names) | set(ctx.feed_names)
        for name, v in block.vars.items():
            if v.persistable or v.is_data or getattr(v, "stop_gradient", False):
                protected.add(name)
        # vars referenced by sub-block ops stay untouched (reference
        # SUB_BLOCK_PAIR handling): renaming across block boundaries is not
        # worth the risk
        protected |= graph.subblock_reachable_names()
        for op in block.ops:
            if op.type in _SKIP_OP_TYPES:
                protected.update(op.input_arg_names)
                protected.update(op.output_arg_names)

        liveness = _Liveness(block, protected)
        free_pool = {}  # (dtype, shape) -> [buffer names free for reuse]
        mapping = {}  # original var name -> buffer name it now occupies
        occupants = {}  # buffer name -> set of original names mapped onto it

        def pool_key(v):
            # Exact dtype+shape match, with a dynamic (-1) dim allowed: two
            # vars whose static shapes are identical occupy equal-size
            # buffers at runtime even when the batch dim is symbolic (the
            # reference compares shapes the same way,
            # memory_optimization_transpiler.py:150-163).
            if v.shape is None:
                return None
            return (v.dtype, tuple(v.shape))

        for i, op in enumerate(block.ops):
            # inputs were defined earlier — apply their renames
            for slot, names in op.inputs.items():
                op.inputs[slot] = [mapping.get(n, n) for n in names]
            # outputs defined here: try to place each onto a free dead buffer
            for out in op.output_arg_names:
                if out in protected or out in mapping or not block.has_var(out):
                    continue
                key = pool_key(block.var(out))
                if key is None:
                    continue
                candidates = free_pool.get(key)
                if candidates:
                    buf = candidates.pop()
                    mapping[out] = buf
                    occupants.setdefault(buf, set()).add(out)
            for slot, names in op.outputs.items():
                op.outputs[slot] = [mapping.get(n, n) for n in names]
            # original vars whose live range ends here free their buffer
            live = liveness.live_after[i]
            for name in set(op.input_arg_names) | set(op.output_arg_names):
                # `name` is a buffer name; free only once every original
                # mapped onto it (and itself) is dead
                originals = occupants.get(name) or (name,)
                if name in live or any(o in live for o in originals):
                    continue
                if name in protected or not block.has_var(name):
                    continue
                key = pool_key(block.var(name))
                if key is None:
                    continue
                lst = free_pool.setdefault(key, [])
                if name not in lst:
                    lst.append(name)

        # drop now-unreferenced vars
        if mapping:
            used = set()
            for op in block.ops:
                used.update(op.input_arg_names)
                used.update(op.output_arg_names)
            for old in list(block.vars):
                if old in mapping and old not in used:
                    del block.vars[old]
            graph.program._bump_version()
            graph.refresh()

        if print_log:
            saved = 0
            for new, old in mapping.items():
                v = block.vars.get(old) or block.vars.get(new)
                if v is None or v.shape is None:
                    continue
                # product of known dims: per-sample bytes when batch dim is -1
                n = 1
                for d in v.shape:
                    n *= d if d and d > 0 else 1
                saved += n * np.dtype(
                    "float32" if v.dtype == "bfloat16" else v.dtype
                ).itemsize
            print(
                "memory_optimize: reused %d buffers (~%.1f KB/sample "
                "host-visible)" % (len(mapping), saved / 1024.0)
            )
        ctx.results[self.name] = {"mapping": mapping, "reused": len(mapping)}


@register_pass("quantize_training")
class QuantizeTrainingPass(Pass):
    """Quantization-aware-training rewrite as a pass: inserts fake
    quant/dequant pairs around every quantizable op (delegates to
    transpiler.quantize_transpiler.QuantizeTranspiler.training_transpile,
    which stays the public API for the freeze/int8-convert stages).
    Constructor knobs ride ctx.attrs["quantize"] (weight_bits,
    activation_bits, *_quantize_type, window_size)."""

    def apply(self, graph, ctx):
        from ..transpiler.quantize_transpiler import QuantizeTranspiler

        before = graph.num_ops()
        qt = QuantizeTranspiler(**dict(ctx.attrs.get("quantize") or {}))
        qt.training_transpile(program=graph.program)
        graph.refresh()
        ctx.results[self.name] = {"ops_inserted": graph.num_ops() - before}
