"""EmbeddingEngine — row-sharded giant embedding tables as one object (the
counterpart of paddle_tpu/embedding/engine.py).

Reference analog: the distributed lookup table stack — lookup_table_op.cc
with is_distributed, distribute_transpiler._split_table_grad_and_add_send_vars
sharding the table across pservers, parameter_prefetch.cc fetching rows by
RPC. The engine collapses that machinery into one object that owns:

- **table creation**: one Parameter whose row layout `(axis, None)` is
  registered as a program sharding rule (parallel.sharding_rules.
  program_rules, as in the JAX package): the anchored pattern covers the
  table and its optimizer accumulators, so a ParallelExecutor keeps the
  table and its moments row-sharded over the mesh's `ep` axis;
- **forward**: the `distributed_lookup_table` op → gather over the local
  shard + one all-reduce (embedding/lookup.py) instead of an RPC prefetch;
- **sparse backward**: `is_sparse=True` routes the grad through the
  SelectedRows pair (selected_rows.py) and per-row optimizer updates
  (ops/sparse_ops.py) whose cost scales with ids-per-batch, not table rows;
- **sharded checkpoints**: save/load the table plus its row-aligned optimizer
  accumulators as N row-range shards with a manifest.

The same program runs on any mesh: the op lowerings take the exact
single-device computation when the mesh gives `axis_name` extent 1
(ops/parallel_ops.py).
"""

import json
import os

import numpy as np
import torch

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..parallel.collectives import gathered_state, reshard_state
from ..parallel.multihost import barrier, host_index

__all__ = ["EmbeddingEngine", "engines_of"]

_MANIFEST = "EMBEDDING_MANIFEST.json"


def engines_of(program):
    """Every EmbeddingEngine built inside `program` (layers.distributed_embedding
    constructs engines internally without returning them; the online trainer
    discovers them here to wire touched-rows bookkeeping)."""
    return list(getattr(program, "_embedding_engines", ()))


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


class EmbeddingEngine:
    """One row-sharded embedding table + its training state.

    Build-time (inside a program_guard): creates the Parameter and appends
    lookup ops. Run-time (with a Scope): sharded checkpoint save/load and
    byte accounting. The same program runs on any mesh — the op lowerings
    fall back to the exact single-device computation when the mesh has no
    `axis_name` extent (ops/parallel_ops.py).
    """

    def __init__(
        self,
        name,
        num_rows,
        dim,
        dtype="float32",
        axis_name="ep",
        padding_idx=None,
        is_sparse=True,
        param_attr=None,
    ):
        import re

        from ..parallel.sharding_rules import program_rules

        self.num_rows = int(num_rows)
        self.dim = int(dim)
        self.dtype = dtype
        self.axis_name = axis_name
        self.is_sparse = bool(is_sparse)
        # normalize like layers.embedding: -1 means "no padding row"
        self.padding_idx = (
            -1
            if padding_idx is None
            else int(padding_idx)
            if padding_idx >= 0
            else self.num_rows + int(padding_idx)
        )
        helper = LayerHelper("embedding_engine")
        attr = param_attr if param_attr is not None else ParamAttr(name=name)
        self.table = helper.create_parameter(
            attr=attr, shape=[self.num_rows, self.dim], dtype=dtype, is_bias=False
        )
        # the row-sharded layout as a program rule: the anchored `(_.*)?`
        # suffix covers the table and its optimizer accumulators
        # (`<table>_<slot>_acc_<k>`), so the moments shard with the rows they
        # update (a shape-[1] accumulator prunes to replicated)
        program_rules(self.table.block.program).add(
            "^%s(_.*)?$" % re.escape(self.table.name), (axis_name, None))
        self.name = name if name is not None else self.table.name
        # last-touched step per row, allocated lazily on the first
        # note_touched (num_rows can be recsys-scale; pay only when the
        # online delta path is in use). -1 = never touched.
        self._last_touched = None
        program = self.table.block.program
        if not hasattr(program, "_embedding_engines"):
            program._embedding_engines = []
        program._embedding_engines.append(self)
        self._emit_static_gauges()

    # ------------------------------------------------------------------ build
    def lookup(self, ids):
        """Append the sharded lookup; returns (ids.shape…, dim) activations.
        ids with a trailing extent-1 dim have it folded away, like the dense
        lookup_table op."""
        helper = LayerHelper("embedding_engine")
        out = helper.create_variable_for_type_inference(self.dtype)
        helper.append_op(
            type="distributed_lookup_table",
            inputs={"W": [self.table.name], "Ids": [ids.name]},
            outputs={"Out": [out.name]},
            attrs={
                "axis_name": self.axis_name,
                "padding_idx": self.padding_idx,
                "is_sparse": self.is_sparse,
            },
        )
        if getattr(ids, "_len_name", None):
            out._len_name = ids._len_name
        return out

    # -------------------------------------------------- touched-row tracking
    def touched_rows_var_name(self):
        """The SelectedRows row-id var the sparse grad maker emits for this
        table (`<table>@GRAD@ROWS`, ops/sparse_ops._lookup_grad_maker) —
        fetch it alongside the loss to feed note_touched."""
        from ..framework import grad_var_name
        from .selected_rows import rows_var_name

        return rows_var_name(grad_var_name(self.table.name))

    def note_touched(self, step, rows):
        """Record that `rows` (the fetched SelectedRows row ids, ROW_SENTINEL
        and out-of-range padding slots tolerated) were updated at training
        step `step`. O(ids) per step; the tracker is one int64 per table
        row."""
        rows = np.asarray(rows).reshape(-1)
        if self._last_touched is None:
            self._last_touched = np.full(self.num_rows, -1, np.int64)
        valid = rows[(rows >= 0) & (rows < self.num_rows)]
        if valid.size:
            self._last_touched[valid] = int(step)

    def touched_rows_since(self, step):
        """Sorted row ids updated AFTER training step `step` (exclusive) —
        the rows an incremental checkpoint delta must ship. Rows never noted
        are never returned; an engine with no bookkeeping yet returns
        empty."""
        if self._last_touched is None:
            return np.empty(0, np.int64)
        return np.nonzero(self._last_touched > int(step))[0].astype(np.int64)

    # ------------------------------------------------------------- accounting
    def state_var_names(self, program=None):
        """The table plus every row-aligned accumulator the optimizer hung off
        it (moment vars share the table's (num_rows, dim) shape and its
        `<table>_<slot>_acc` name prefix — optimizer._add_accumulator). Scalar
        state (beta pows) is excluded: it is replicated, not row-sharded."""
        block = (program or default_main_program()).global_block()
        names = [self.table.name]
        prefix = self.table.name + "_"
        for v in block.vars.values():
            # accumulator names are `<param>_<slot>_acc_<k>` (unique_name)
            if (
                v.name.startswith(prefix)
                and "_acc" in v.name
                and tuple(v.shape or ()) == (self.num_rows, self.dim)
            ):
                names.append(v.name)
        return names

    def table_bytes(self):
        return self.num_rows * self.dim * _dtype_bytes(self.dtype)

    def state_bytes_per_device(self, num_devices, program=None, scope=None):
        """Per-chip HBM bytes for the table + row-aligned accumulators when
        row-sharded over `num_devices` (the engine's placement). Compare with
        num_devices=1 for the dense-resident requirement."""
        total = 0
        block = (program or default_main_program()).global_block()
        for n in self.state_var_names(program):
            v = block.vars[n]
            total += self.num_rows * self.dim * _dtype_bytes(v.dtype)
        return total // max(1, int(num_devices))

    def _emit_static_gauges(self):
        try:
            _registry().gauge(
                "embedding/table_rows",
                help="rows in the sharded embedding table",
            ).set(float(self.num_rows), table=self.name)
            _registry().gauge(
                "embedding/table_bytes",
                help="global HBM bytes of the table (divide by ep for per-shard)",
            ).set(float(self.table_bytes()), table=self.name)
        except Exception:
            pass  # observability must never break model build

    # ------------------------------------------------------------ checkpoints
    def save_sharded(self, scope, dirname, num_shards=1, program=None):
        # (under a ParallelExecutor every rank of the table's axis calls:
        # a row-sharded name is all-gathered first)
        """Write the table and its row-aligned optimizer state as `num_shards`
        row-range .npz shards + a manifest. Shard k holds rows
        [k*rows/N, (k+1)*rows/N) of every array — the layout a future
        multi-host restore reads back per-host without touching other shards
        (the pserver checkpoint sharding, made into plain files). bf16 arrays
        are stored as f32 (lossless widening) and cast back on load."""
        os.makedirs(dirname, exist_ok=True)
        names = self.state_var_names(program)
        num_shards = int(num_shards)
        if self.num_rows % num_shards:
            raise ValueError(
                "num_rows=%d not divisible by num_shards=%d"
                % (self.num_rows, num_shards)
            )
        rows_per = self.num_rows // num_shards
        dtypes = {}
        arrays = {}
        for n in names:
            a, dtypes[n] = _host(gathered_state(scope, n))
            if a.shape != (self.num_rows, self.dim):
                raise ValueError(
                    "scope var %r has shape %s, expected %s"
                    % (n, a.shape, (self.num_rows, self.dim))
                )
            arrays[n] = a
        if host_index() != 0:
            barrier()  # every rank gathers; rank 0 writes
            return None
        for k in range(num_shards):
            lo, hi = k * rows_per, (k + 1) * rows_per
            np.savez(
                os.path.join(dirname, _shard_file(k, num_shards)),
                **{n: arrays[n][lo:hi] for n in names},
            )
        manifest = {
            "name": self.name,
            "table": self.table.name,
            "num_rows": self.num_rows,
            "dim": self.dim,
            "num_shards": num_shards,
            "row_ranges": [
                [k * rows_per, (k + 1) * rows_per] for k in range(num_shards)
            ],
            "arrays": dtypes,
            "version": 1,
        }
        tmp = os.path.join(dirname, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(dirname, _MANIFEST))
        barrier()
        return manifest

    def load_sharded(self, scope, dirname):
        """Reassemble every array from its row-range shards into the scope; a
        name the scope holds row-sharded takes this rank's rows, so the
        on-disk shard count is independent of the run-time ep size."""
        manifest = self.read_manifest(dirname)
        if manifest["num_rows"] != self.num_rows or manifest["dim"] != self.dim:
            raise ValueError(
                "checkpoint table is %dx%d, engine is %dx%d"
                % (
                    manifest["num_rows"],
                    manifest["dim"],
                    self.num_rows,
                    self.dim,
                )
            )
        num_shards = manifest["num_shards"]
        shards = [
            np.load(os.path.join(dirname, _shard_file(k, num_shards)))
            for k in range(num_shards)
        ]
        for n, dt in manifest["arrays"].items():
            full = torch.from_numpy(np.concatenate([s[n] for s in shards], axis=0))
            if "bfloat16" in dt:
                full = full.to(torch.bfloat16)
            if n in scope.row_shards:
                reshard_state(scope, n, full)
            else:
                scope.vars[n] = full.to(scope.device)
        return manifest

    @staticmethod
    def read_manifest(dirname):
        with open(os.path.join(dirname, _MANIFEST)) as f:
            return json.load(f)


def _shard_file(k, n):
    return "embedding-%05d-of-%05d.npz" % (k, n)


def _dtype_bytes(dtype):
    d = str(dtype)
    if "bfloat16" in d or d in ("float16", "f16"):
        return 2
    if d in ("float64", "int64", "f64"):
        return 8
    return 4



def _host(val):
    """(numpy array, dtype name) of a scope value; bfloat16 is widened to
    float32, which is exact, and keeps its name for the manifest."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name
    a = np.asarray(val)
    return a, str(a.dtype)
