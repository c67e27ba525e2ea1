"""PassManager: ordered pass pipelines over the Graph IR (reference
framework/ir/pass.cc Pass::Apply + BuildStrategy::Apply). A copy of
paddle_tpu/passes/manager.py without its static-verify stage and its
graphviz debug dumps (the analysis and debugger modules are not ported).

`PassManager(pipeline).apply(program, ...)` returns a NEW transformed
Program; `apply_cached` memoizes that per (program uid/version, pipeline,
scope, feed/fetch) so the executor's single choke point (executor.py
`_apply_pass_pipeline`) hands the SAME transformed Program object to every
run call — keeping its block cache hot. `apply_inplace` rewrites the
caller's Program.

Per pass, the manager re-verifies graph invariants (Graph.verify —
def-before-use, block linkage, foreign-block attrs) and records wall-time
and op-count telemetry through the observability registry (`passes/*`
gauges and counters).

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
The JAX package's inference_int8 preset (calibration, int8 GEMM) and its
fuse_attention pass wait for their slices of the port.
"""

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
        """The core loop: verify → (time, apply, verify, telemetry) per pass.
        Mutates `graph`; returns ctx.results."""
        m = _metrics()
        graph.verify()
        # "+" not "," — snapshot label strings are comma-joined pairs, so a
        # comma inside a value would be ambiguous to every label consumer
        pipeline_label = "+".join(self.pass_names)
        for p in self.passes:
            name = p.name or type(p).__name__
            ops_before = graph.num_ops()
            t0 = time.perf_counter()
            p.apply(graph, ctx)
            graph.refresh()
            graph.verify()  # per-pass invariant re-verification
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
        m["pipelines"].inc(pipeline=pipeline_label or "<empty>")
        return ctx.results


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
