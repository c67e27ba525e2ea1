"""PassManager: ordered pass pipelines over the Graph IR (reference
framework/ir/pass.cc Pass::Apply + BuildStrategy::Apply). A copy of
paddle_tpu/passes/manager.py.

`PassManager(pipeline).apply(program, ...)` returns a NEW transformed
Program; `apply_cached` memoizes that per (program uid/version, pipeline,
scope, feed/fetch) so the executor's single choke point (executor.py
`_apply_pass_pipeline`) hands the SAME transformed Program object to every
run call — keeping its block cache hot. `apply_inplace` rewrites the
caller's Program.

Per pass, the manager re-verifies graph invariants (Graph.verify —
def-before-use, block linkage, foreign-block attrs) and records wall-time
and op-count telemetry through the observability registry (`passes/*`
gauges and counters). With FLAGS_static_verify on, the structural
fluidlint checkers (analysis/verify.py verify_graph) run over the pristine
graph (stage 0) and again after every pass, so a defect is named at the
pass that made it. With FLAGS_pass_debug_dir set, each pass leaves
"NN_<pass>_before.dot" and "NN_<pass>_after.dot" (graphviz of block 0)
and "NN_<pass>_ops.diff" (a unified diff of every block's op list) there.

Pipeline presets (FLAGS_pass_pipeline):
- training_default: constant_fold, dead_op_eliminate, fuse_elemwise_act,
  inplace_donation_plan — stochastic ops are never touched, so the RNG
  stream is preserved.
- inference: constant_fold, dead_op_eliminate, fuse_elemwise_act.
- training_fused: training_default plus the kernel-substitution taggers
  (fuse_gemm_epilogue, fuse_layer_norm, fuse_optimizer) — tagged chains
  run as hand-written CUDA kernels (ops/fused.py) instead of op by op.
  Fused and unfused runs agree within rounding (one rounding per fused
  chain instead of one per op).
- inference_int8: the calibrated-int8 serving pipeline (passes/quant.py):
  calibrate records activation ranges from representative feeds riding
  ctx.attrs["calibrate"], quantize_serving freezes weights to int8 and
  bakes static activation scales into the scope (so it is opt-in:
  ServingEngine(precision="int8") is the caller), and fuse_quant_gemm tags
  the int8 chains for the quant GEMM kernel (ops/fused.py gemm_int8).
fuse_attention (causal score chains into one flash_attention op) is in no
preset, as in the JAX package.
"""

import difflib
import os
import time

from .graph import Graph
from .pass_base import Pass, PassContext, get_pass

__all__ = [
    "PassManager",
    "PRESETS",
    "apply_cached",
    "apply_inplace",
    "resolve_pipeline",
]

PRESETS = {
    "training_default": (
        "constant_fold",
        "dead_op_eliminate",
        "fuse_elemwise_act",
        "inplace_donation_plan",
    ),
    "inference": (
        "constant_fold",
        "dead_op_eliminate",
        "fuse_elemwise_act",
    ),
    "training_fused": (
        "constant_fold",
        "dead_op_eliminate",
        "fuse_elemwise_act",
        "fuse_gemm_epilogue",
        "fuse_layer_norm",
        "fuse_optimizer",
        "inplace_donation_plan",
    ),
    "inference_int8": (
        "constant_fold",
        "dead_op_eliminate",
        "calibrate",
        "quantize_serving",
        "fuse_quant_gemm",
        "fuse_elemwise_act",
    ),
}

_OFF = ("", "off", "none")


def resolve_pipeline(pipeline):
    """Normalize a pipeline spec to a tuple of pass names. Accepts a preset
    name, a comma-separated string, an iterable of names/Pass instances, or
    an off-spec (None/""/"off"/"none") -> ()."""
    if pipeline is None:
        return ()
    if isinstance(pipeline, str):
        spec = pipeline.strip()
        if spec.lower() in _OFF:
            return ()
        if spec in PRESETS:
            return tuple(PRESETS[spec])
        return tuple(s.strip() for s in spec.split(",") if s.strip())
    out = []
    for item in pipeline:
        if isinstance(item, Pass):
            out.append(item.name or type(item).__name__)
        else:
            out.append(str(item))
    return tuple(out)


def _metrics():
    from ..observability import registry as _registry

    reg = _registry.default_registry()
    return {
        "applied": reg.counter(
            "passes/applied", "pass applications, labeled by pass"
        ),
        "wall_ms": reg.gauge(
            "passes/wall_ms", "last wall time of one pass application (ms)"
        ),
        "ops_before": reg.gauge(
            "passes/ops_before", "program op count entering the pass"
        ),
        "ops_after": reg.gauge(
            "passes/ops_after", "program op count leaving the pass"
        ),
        "ops_removed": reg.counter(
            "passes/ops_removed", "ops eliminated across all applications"
        ),
        "fusion_groups": reg.counter(
            "passes/fusion_groups", "groups formed by the fuse_* passes"
        ),
        "pipelines": reg.counter(
            "passes/pipelines", "full pipeline applications, labeled by name"
        ),
    }


class PassManager:
    """Runs an ordered pipeline of registered passes over a Program."""

    def __init__(self, pipeline):
        self._spec = resolve_pipeline(pipeline)
        self.passes = [
            p if isinstance(p, Pass) else get_pass(p)
            for p in (
                pipeline
                if not isinstance(pipeline, str) and pipeline is not None
                else self._spec
            )
        ]

    @property
    def pass_names(self):
        return tuple(p.name or type(p).__name__ for p in self.passes)

    def apply(self, program, scope=None, feed_names=(), fetch_names=(),
              attrs=None):
        """Run the pipeline; returns a NEW transformed Program carrying a
        `_pass_results` dict (per-pass payloads) and, when the pipeline
        included inplace_donation_plan, a `_donation_plan` the executor
        cross-checks at lowering."""
        graph = Graph(program)
        ctx = PassContext(
            scope=scope, feed_names=feed_names, fetch_names=fetch_names,
            attrs=attrs,
        )
        self.apply_to_graph(graph, ctx)
        out = graph.to_program()
        out._pass_results = dict(ctx.results)
        plan = ctx.results.get("inplace_donation_plan")
        if plan is not None:
            out._donation_plan = plan
        return out

    def apply_to_graph(self, graph, ctx):
        """The core loop: verify → (dump, time, apply, verify, dump, diff,
        telemetry) per pass. Mutates `graph`; returns ctx.results."""
        from .. import flags as _flags
        from ..analysis import verify_graph

        debug_dir = _flags.get_flags("pass_debug_dir")["pass_debug_dir"]
        m = _metrics()
        graph.verify()
        # FLAGS_static_verify stage 0: structural fluidlint over the pristine
        # graph, so pre-existing defects are attributed to the program, not
        # to whichever pass happens to run first
        verify_graph(graph, ctx, stage="0")
        # "+" not "," — snapshot label strings are comma-joined pairs, so a
        # comma inside a value would be ambiguous to every label consumer
        pipeline_label = "+".join(self.pass_names)
        for i, p in enumerate(self.passes):
            name = p.name or type(p).__name__
            ops_before = graph.num_ops()
            before_repr = None
            if debug_dir:
                before_repr = self._dump(graph, debug_dir, i, name, "before")
            t0 = time.perf_counter()
            p.apply(graph, ctx)
            graph.refresh()
            graph.verify()  # per-pass invariant re-verification
            # a failure here names the pass that broke capture/fetch/donation
            verify_graph(graph, ctx, stage=name)
            wall_ms = (time.perf_counter() - t0) * 1000.0
            ops_after = graph.num_ops()
            m["applied"].inc(**{"pass": name})
            m["wall_ms"].set(wall_ms, **{"pass": name})
            m["ops_before"].set(ops_before, **{"pass": name})
            m["ops_after"].set(ops_after, **{"pass": name})
            if ops_before > ops_after:
                m["ops_removed"].inc(ops_before - ops_after, **{"pass": name})
            groups = (ctx.results.get(name) or {}).get("groups")
            if groups:
                m["fusion_groups"].inc(groups)
            if debug_dir:
                after_repr = self._dump(graph, debug_dir, i, name, "after")
                self._dump_diff(debug_dir, i, name, before_repr, after_repr)
        m["pipelines"].inc(pipeline=pipeline_label or "<empty>")
        return ctx.results

    @staticmethod
    def _dump(graph, debug_dir, i, name, stage):
        """Graphviz snapshot of block 0 (op boxes wired through var
        ellipses, the JAX package's debugger.draw_block_graphviz) and the
        op repr list for the textual diff."""
        os.makedirs(debug_dir, exist_ok=True)
        lines = ["digraph G {", "  rankdir=TB;"]
        seen = set()

        def var_node(vn):
            if vn not in seen:
                seen.add(vn)
                lines.append('  "v_%s" [label="%s" shape=ellipse];' % (vn, vn))
            return '"v_%s"' % vn

        for k, op in enumerate(graph.program.global_block().ops):
            op_id = '"op_%d_%s"' % (k, op.type)
            lines.append('  %s [label="%s" shape=box style=filled fillcolor="#d2e5ff"];'
                         % (op_id, op.type))
            for vn in op.input_arg_names:
                lines.append("  %s -> %s;" % (var_node(vn), op_id))
            for vn in op.output_arg_names:
                lines.append("  %s -> %s;" % (op_id, var_node(vn)))
        lines.append("}")
        with open(os.path.join(debug_dir, "%02d_%s_%s.dot" % (i, name, stage)), "w") as f:
            f.write("\n".join(lines))
        return ["[b%d] %s" % (blk.idx, op) for blk in graph.program.blocks for op in blk.ops]

    @staticmethod
    def _dump_diff(debug_dir, i, name, before_repr, after_repr):
        lines = difflib.unified_diff(
            before_repr or [], after_repr or [],
            fromfile="%s/before" % name, tofile="%s/after" % name, lineterm="",
        )
        with open(os.path.join(debug_dir, "%02d_%s_ops.diff" % (i, name)), "w") as f:
            f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# executor-facing entry points
# ---------------------------------------------------------------------------

_APPLIED_CACHE = {}  # memo key -> transformed Program
_APPLIED_CACHE_CAP = 64


def apply_cached(program, pipeline, scope=None, feed_names=(),
                 fetch_names=()):
    """Memoized PassManager.apply: same (program uid+version, pipeline,
    scope, feeds, fetches) → the SAME transformed Program object, so the
    executors' executable caches (keyed on the transformed program's
    uid/version) stay hot across run calls."""
    spec = resolve_pipeline(pipeline)
    if not spec:
        return program
    key = (
        program._uid,
        program._version,
        spec,
        getattr(scope, "_uid", None),
        tuple(sorted(feed_names)),
        tuple(fetch_names),
    )
    hit = _APPLIED_CACHE.get(key)
    if hit is not None:
        return hit
    out = PassManager(spec).apply(
        program, scope=scope, feed_names=feed_names, fetch_names=fetch_names
    )
    if len(_APPLIED_CACHE) >= _APPLIED_CACHE_CAP:
        _APPLIED_CACHE.pop(next(iter(_APPLIED_CACHE)))
    _APPLIED_CACHE[key] = out
    return out


def apply_inplace(program, pipeline, scope=None, feed_names=(),
                  fetch_names=(), attrs=None):
    """Run a pipeline and write the result back into `program` (the
    in-place contract). Returns the ctx.results dict."""
    mgr = PassManager(pipeline)
    graph = Graph(program)
    ctx = PassContext(
        scope=scope, feed_names=feed_names, fetch_names=fetch_names,
        attrs=attrs,
    )
    mgr.apply_to_graph(graph, ctx)
    graph.write_to(program)
    return ctx.results
