"""InferenceTranspiler: fold batch-norm into conv weights for serving (a
copy of paddle_tpu/transpiler/inference_transpiler.py).

A shim: the rewrite lives in the pass framework as
passes/ports.py `fold_batch_norm` (run it via
`passes.apply_inplace(program, ["fold_batch_norm"], scope=scope)` or any
pipeline spec); this class is kept as the reference-compatible entry point
(python/paddle/fluid/transpiler/inference_transpiler.py) and delegates.

Reference analog + arithmetic (now in FoldBatchNormPass): conv+bn fusion
    W' = W * gamma / sqrt(var + eps)        (per output channel)
    b' = (b - mean) * gamma / sqrt(var + eps) + beta
for conv2d → batch_norm and conv2d → elementwise_add → batch_norm patterns;
the conv+relu/conv+elementwise_add MKLDNN fusions are not done (documented
no-ops).
"""

__all__ = ["InferenceTranspiler"]


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None):
        """Rewrite `program` in place; `scope` must hold the trained params
        (reference signature transpile(program, place, scope)); delegates to
        the `fold_batch_norm` pass."""
        from ..executor import global_scope
        from ..passes import apply_inplace

        scope = scope or global_scope()
        apply_inplace(program, ["fold_batch_norm"], scope=scope)
