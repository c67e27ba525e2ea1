"""SelectedRows: the sparse-gradient side structure (the torch counterpart
of paddle_tpu/embedding/selected_rows.py).

Reference analog: paddle/fluid/framework/selected_rows.h, a (rows, value)
pair where `rows` lists the touched table rows and `value` holds one
gradient row per entry; lookup_table_grad emits it when is_sparse=True, and
the sparse optimizer kernels scatter only those rows.

The pair rides through the Program as two ordinary Variables of a static
capacity (the number of id slots in the step's batch), as in the JAX
package, so a step keeps one shape and a CUDA graph can capture it:

- values `<W>@GRAD`      : (capacity, dim), the cotangent rows, in the
                           cotangent's dtype;
- rows   `<W>@GRAD@ROWS` : (capacity,) int32 global row ids, with
                           ROW_SENTINEL (-1) for slots that must not
                           contribute (negative or masked ids, padding_idx).

Duplicate ids are not merged in the grad op; `merge_rows` (MergeAdd) runs
inside the optimizer lowering. The values Variable is flagged in the
Program (`is_selected_rows`, the rows var name and the table height) so
backward.py, clip.py, regularizer.py and optimizer.py can route it.
"""

import torch

ROW_SENTINEL = -1

__all__ = [
    "ROW_SENTINEL",
    "mark_selected_rows",
    "is_selected_rows",
    "rows_var_name",
    "merge_rows",
    "densify",
]


def mark_selected_rows(values_var, rows_name, height):
    """Flag a Program Variable as the values half of a SelectedRows pair."""
    values_var.is_selected_rows = True
    values_var.selected_rows_rows = rows_name
    values_var.selected_rows_height = int(height)
    return values_var


def is_selected_rows(var):
    return bool(getattr(var, "is_selected_rows", False))


def rows_var_name(values_name):
    """Canonical rows-var name for a values var."""
    return values_name + "@ROWS"


def merge_rows(rows, values, height):
    """Deduplicate rows and sum their value rows (MergeAdd) at a static
    capacity: the JAX package's `jnp.unique(size=cap, fill_value=height)`
    built without a host sync, so a CUDA graph can capture it. Returns
    (uniq, summed):

    - uniq   : (capacity,) int32, the sorted unique row ids; sentinel and
               negative slots map to `height` (one past the last row), and
               the unused unique slots hold `height` too;
    - summed : (capacity, dim) f32, each unique row's gradient sum.

    The rows are sorted (stably), the start of each run of equal rows is
    marked, and the marks' running count is the slot's unique index. The
    sums accumulate with index_put_(accumulate=True) into the f32 buffer:
    the dense lookup_table_grad's form, which sums a row's duplicates in the
    same order (slot order) on every run, so sparse and dense SGD give the
    same bits."""
    cap = int(rows.shape[0])
    dev = rows.device
    rows_m = torch.where(rows < 0, torch.full_like(rows, height), rows).long()
    srt, order = torch.sort(rows_m, stable=True)
    start = torch.ones(cap, dtype=torch.bool, device=dev)
    if cap > 1:
        start[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(start.long(), 0) - 1  # the unique index of each sorted slot
    inv = torch.empty_like(seg)
    inv[order] = seg
    uniq = torch.full((cap,), int(height), dtype=torch.long, device=dev)
    uniq[seg] = srt  # a run writes one value to its slot
    summed = torch.zeros((cap, values.shape[1]), dtype=torch.float32, device=dev)
    summed.index_put_((inv,), values.float(), accumulate=True)
    return uniq.int(), summed


def densify(rows, values, height, dtype=None):
    """Scatter a SelectedRows pair into a dense (height, dim) gradient (the
    reference's SelectedRows -> LoDTensor merge, for optimizers without a
    sparse kernel): f32 accumulation, cast once at the end; sentinel slots
    and rows past the table add nothing."""
    dtype = dtype or values.dtype
    valid = (rows >= 0) & (rows < height)
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    vals = torch.where(valid[:, None], values.float(),
                       torch.zeros((), dtype=torch.float32, device=values.device))
    dense = torch.zeros((int(height), values.shape[1]), dtype=torch.float32,
                        device=values.device)
    dense.index_put_((safe,), vals, accumulate=True)
    return dense.to(dtype)
