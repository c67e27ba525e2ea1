"""Estimate a program's activation/parameter memory (reference
python/paddle/fluid/contrib/memory_usage_calc.py:46 memory_usage — sums var
bytes with the batch dim substituted). A copy of
paddle_tpu/contrib/memory_usage_calc.py: the estimate bounds a program's
working set before it runs; the card's real footprint differs (the caching
allocator, CUDA graph pools, intermediates dropped after their last
reader), as the reference's estimate did for GPU memory planning."""

__all__ = ["memory_usage"]

_DTYPE_BYTES = {
    "float64": 8,
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int64": 8,
    "int32": 4,
    "int16": 2,
    "int8": 1,
    "uint8": 1,
    "bool": 1,
}


def memory_usage(program, batch_size):
    """Total estimated bytes for one iteration at `batch_size` (sums every
    var across blocks; -1 dims take batch_size, like the reference)."""
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    total = 0.0
    for i in range(program.num_blocks):
        block = program.block(i)
        for var in block.vars.values():
            if var.shape is None or var.dtype is None:
                continue
            n = 1
            for d in var.shape:
                n *= batch_size if d in (-1, None) else d
            total += n * _DTYPE_BYTES.get(str(var.dtype), 4)
    return total
