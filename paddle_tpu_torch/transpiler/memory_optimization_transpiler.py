"""memory_optimize: liveness-based in-place variable reuse on a Program (a
copy of paddle_tpu/transpiler/memory_optimization_transpiler.py).

A shim: the transform lives in the pass framework as
passes/ports.py `memory_optimize` (run it via
`passes.apply_inplace(program, ["memory_optimize"], ...)` or any pipeline
spec); these functions are kept as the reference-compatible entry points
(python/paddle/fluid/transpiler/memory_optimization_transpiler.py:457) and
delegate.

On the card a block already drops each intermediate after its last reader
and a captured CUDA graph's pool reuses memory, so renaming may not shrink
device memory further. The transform is kept because (a) it is part of the
public transpiler API, (b) it reduces the number of distinct names the
executor tracks across feed/fetch and host-op segment boundaries, and (c)
its statistics (print_log=True) report the same reuse plan the reference
printed. Semantics are preserved: only non-persistable, non-fetched,
same-dtype same-size vars are merged.
"""

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False, level=0):
    """Rewrite `input_program` in place, renaming dead intermediate vars onto
    compatible earlier ones. Returns the reuse mapping {new_name: old_name};
    delegates to the `memory_optimize` pass."""
    from ..passes import apply_inplace

    results = apply_inplace(
        input_program,
        ["memory_optimize"],
        attrs={"skip_opt_set": skip_opt_set, "print_log": print_log},
    )
    return results["memory_optimize"]["mapping"]


def release_memory(input_program, skip_opt_set=None):
    """Reference release_memory inserts eager `delete_var` ops; the executor
    already drops each intermediate after its last reader, so this is a
    documented no-op kept for API compatibility."""
    return None
