"""Core and generation ops of the torch port against the JAX package's
lowerings: the same numpy inputs go through
paddle_tpu.ops.registry.get(type).lower and
paddle_tpu_torch.ops.registry.get(type).lower, and every output slot is
compared. Tolerance: atol = rtol = 1e-5 (f32 on both sides; matmul and
softmax sum in a different order in XLA and torch)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as jax_registry
from paddle_tpu_torch.ops import registry as pt_registry

ATOL = RTOL = 1e-5

_rng = np.random.RandomState(0)


def _f(*shape):
    return _rng.randn(*shape).astype("float32")


# name -> (op type, inputs, attrs)
CASES = {
    "fill_constant": ("fill_constant", {}, {"shape": [2, 3], "dtype": "float32", "value": 1.5}),
    "fill_constant_int": ("fill_constant", {}, {"shape": [4], "dtype": "int64", "value": 7.0}),
    "assign_value": ("assign_value", {}, {"shape": [2, 2], "dtype": "float32", "values": [1.0, -2.0, 3.5, 0.0]}),
    "assign_value_int": ("assign_value", {}, {"shape": [1, 3, 1], "dtype": "int32", "values": [0, 1, 2]}),
    "assign": ("assign", {"X": [_f(3, 4)]}, {}),
    "mul": ("mul", {"X": [_f(2, 3, 4)], "Y": [_f(4, 5)]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_flat": ("mul", {"X": [_f(6, 8)], "Y": [_f(8, 3)]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "matmul": ("matmul",
        {"X": [_f(1, 2, 5, 4)], "Y": [_f(1, 2, 5, 4)]},
        {"transpose_X": False, "transpose_Y": True, "alpha": 0.5},
    ),
    "matmul_plain": ("matmul", {"X": [_f(2, 3, 4)], "Y": [_f(2, 4, 6)]}, {}),
    "softmax": ("softmax", {"X": [_f(2, 3, 7)]}, {}),
    "reshape": ("reshape", {"X": [_f(2, 3, 4)]}, {"shape": [0, 12]}),
    "reshape2": ("reshape2", {"X": [_f(2, 3, 4)]}, {"shape": [0, 0, 2, 2]}),
    "transpose": ("transpose", {"X": [_f(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "transpose2": ("transpose2", {"X": [_f(1, 5, 2, 3)]}, {"axis": [0, 2, 1, 3]}),
    "gather": ("gather", {"X": [_f(6, 4)], "Index": [np.array([5, 0, 2], np.int32)]}, {}),
    "lookup_table": ("lookup_table",
        {"W": [_f(10, 4)], "Ids": [np.array([[[1], [9], [-1], [3]]], np.int32)]},
        {"padding_idx": -1},
    ),
    "lookup_table_padding": ("lookup_table",
        {"W": [_f(10, 4)], "Ids": [np.array([[2], [5], [2]], np.int32)]},
        {"padding_idx": 2},
    ),
    "layer_norm": ("layer_norm",
        {"X": [_f(2, 3, 8) * 3 + 1], "Scale": [_f(8)], "Bias": [_f(8)]},
        {"epsilon": 1e-5, "begin_norm_axis": 2},
    ),
    "layer_norm_flat": ("layer_norm", {"X": [_f(4, 6)], "Scale": [_f(6)], "Bias": [_f(6)]}, {"begin_norm_axis": 1}),
    "elementwise_add": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(2, 3, 4)]}, {"axis": -1}),
    "elementwise_add_bias": ("elementwise_add", {"X": [_f(2, 3, 4)], "Y": [_f(4)]}, {"axis": 2}),
    "elementwise_add_int": ("elementwise_add",
        {"X": [np.arange(5, dtype=np.int32)], "Y": [np.array([7], np.int32)]}, {"axis": -1},
    ),
    "elementwise_min": ("elementwise_min",
        {"X": [np.array([3, 9, 15, 20], np.int32)], "Y": [np.array([15], np.int32)]},
        {"axis": -1},
    ),
    "relu": ("relu", {"X": [_f(3, 5)]}, {}),
    "kv_cache_write_decode": ("kv_cache_write",
        {
            "Pool": [_f(5 * 4, 6)],
            "Rows": [_f(3, 6)],
            "BlockTable": [np.array([[1, 2], [3, 4], [0, 0]], np.int32)],
            "Pos": [np.array([[5], [0], [3]], np.int32)],
        },
        {"page_size": 4},
    ),
    "kv_cache_write_prefill": ("kv_cache_write",
        {
            "Pool": [_f(4 * 4, 6)],
            "Rows": [_f(6, 6)],
            "BlockTable": [np.array([2, 3], np.int32)],
            # positions 8 and 9 are past the table's capacity (2 pages of 4):
            # they must land in scratch page 0, not the last real page
            "Pos": [np.array([4, 5, 6, 7, 8, 9], np.int32)],
        },
        {"page_size": 4},
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_lowering(name):
    op_type, ins, attrs = CASES[name]
    jax_ins = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    jctx = jax_registry.LowerCtx(jax.random.key(0))
    want = jax_registry.get(op_type).lower(jctx, jax_ins, dict(attrs))
    pt_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    got = pt_registry.get(op_type).lower(pt_registry.LowerCtx("cpu"), pt_ins, dict(attrs))
    assert sorted(got) == sorted(want)
    for slot in want:
        for w, g in zip(want[slot], got[slot]):
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            assert g.dtype == w.dtype, (slot, g.dtype, w.dtype)
            if slot != "XShape":
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "op_type,attrs,lo,hi",
    [
        ("uniform_random", {"shape": [64, 32], "dtype": "float32", "min": -0.5, "max": 0.5}, -0.5, 0.5),
        ("gaussian_random", {"shape": [64, 32], "dtype": "float32", "mean": 1.0, "std": 0.1}, None, None),
        ("truncated_gaussian_random", {"shape": [64, 32], "dtype": "float32", "mean": 0.0, "std": 2.0}, -4.0, 4.0),
    ],
)
def test_random_op_matches_jax_contract(op_type, attrs, lo, hi):
    """torch.Generator and jax.random draw different bits from one seed, so
    the random ops are held to the JAX lowering's shape, dtype, bounds and
    moments, and to seed determinism."""
    want = np.asarray(
        jax_registry.get(op_type).lower(jax_registry.LowerCtx(jax.random.key(0)), {}, dict(attrs))["Out"][0]
    )
    draw = lambda seed: pt_registry.get(op_type).lower(  # noqa: E731
        pt_registry.LowerCtx("cpu", generator=torch.Generator().manual_seed(seed)), {}, dict(attrs)
    )["Out"][0].numpy()
    got = draw(3)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, draw(3))
    assert not np.array_equal(got, draw(4))
    if lo is not None:
        assert got.min() >= lo and got.max() <= hi
    assert abs(got.mean() - want.mean()) < 0.1 * max(1.0, want.std())
    assert abs(got.std() - want.std()) < 0.1 * want.std()


def test_kv_cache_write_is_in_place():
    """The pool comes back as the op's Out and is the same tensor, updated
    in place (the torch form of the JAX package's donated pool)."""
    _, ins, attrs = CASES["kv_cache_write_decode"]
    pool = torch.from_numpy(np.array(ins["Pool"][0]))
    pt_ins = {k: [torch.from_numpy(np.array(a)) for a in v] for k, v in ins.items()}
    pt_ins["Pool"] = [pool]
    out = pt_registry.get("kv_cache_write").lower(pt_registry.LowerCtx("cpu"), pt_ins, attrs)["Out"][0]
    assert out is pool
    # slot 0: position 5 is offset 1 of its second page, pool page 2
    np.testing.assert_array_equal(pool[2 * 4 + 1].numpy(), ins["Rows"][0][0])
