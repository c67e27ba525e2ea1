"""Host ops and the ops around them, the port against the JAX package on the
CPU: blocks split at host ops into device segments (an export read after
every segment, the segment and host-call counts), host ops in line on the
op-by-op path, each framework op (ops/frame_ops.py), print by its line's
fields, and FLAGS_check_nan_inf by its message."""

import os
import re

import numpy as np
import pytest
import torch

from torch_rnn_cases import (assert_outs_close, assert_runs_close, build, check_op, exe_scope,
                             grad_one, run_both)

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags as pt_flags
from paddle_tpu_torch import profiler

PACKAGES = ("paddle_tpu", "paddle_tpu_torch")


def _append(blk, op_type, inputs, outputs, attrs=None):
    for names in outputs.values():
        for n in names:
            if not blk.has_var(n):
                blk.create_var(name=n, shape=None, dtype=None)
    blk.append_op(type=op_type, inputs=inputs, outputs=outputs, attrs=attrs or {})


def _segmented_program(path):
    """x -> y = 2x | print(y) | z = y + y | save_combine(z) | w = 3z, with y,
    z and w fetched: three device segments, one print and one host call;
    y is read after every segment."""

    def program_fn(fluid):
        L = fluid.layers
        x = L.data(name="x", shape=[2, 3], dtype="float32", append_batch_size=False)
        y = L.scale(x, scale=2.0)
        L.Print(y, message="y", summarize=4)
        z = L.elementwise_add(y, y)
        blk = fluid.default_main_program().global_block()
        _append(blk, "save_combine", {"X": [z.name]}, {}, {"file_path": path})
        w = L.scale(z, scale=3.0)
        return [y, z, w]

    return program_fn


X = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5


def test_segmented_block_exports(tmp_path):
    """The same fetches as the JAX package's _SegmentedBlock, over two runs;
    the file the host op wrote holds z; Executor.stats() counts 3 device
    segments, 1 print and 1 host call a run."""
    from paddle_tpu_torch.ops import fused

    fused.reset_stats()
    want, got, _, _ = run_both(_segmented_program(str(tmp_path / "z")), {"x": X}, steps=2)
    assert_runs_close(got, want, 0, 0)
    saved = np.load(str(tmp_path / "z.npz"))
    (name,) = [k for k in saved.files if k != "__dtypes__"]
    np.testing.assert_array_equal(saved[name], 4 * X)
    assert pt.Executor.stats()["segments"] == {"device": 6, "inline": 2, "host": 2}


def test_host_ops_in_line_on_the_op_by_op_path(tmp_path):
    """Under the profiler with FLAGS_profile_ops the block runs op by op with
    the host op in line on a scratch view of the scope: the same fetches,
    the same file, an event for each op, and no intermediate left in the
    scope."""
    paths = {m: str(tmp_path / m) for m in ("graph", "per_op")}
    outs = {}
    for mode, path in paths.items():
        main, startup, fetch = build("paddle_tpu_torch", _segmented_program(path))
        exe, scope, guard = exe_scope("paddle_tpu_torch")
        with guard(scope):
            exe.run(startup)
            if mode == "per_op":
                pt_flags.set_flags({"profile_ops": True})
                profiler.start_profiler("All")
            try:
                outs[mode] = exe.run(main, feed={"x": X}, fetch_list=fetch)
            finally:
                if mode == "per_op":
                    pt_flags.set_flags({"profile_ops": False})
                    events = {e[0] for e in profiler._events}
                    profiler.stop_profiler("total", os.devnull)
        if mode == "per_op":
            assert not any(".tmp_" in n for n in scope.vars), sorted(scope.vars)
    for a, b in zip(outs["graph"], outs["per_op"]):
        np.testing.assert_array_equal(a, b)
    assert any("op/save_combine" in e for e in events) and any("op/print" in e for e in events)
    a, b = (np.load(p + ".npz") for p in paths.values())
    assert [np.array_equal(a[k], b[k]) for k in a.files if k != "__dtypes__"] == [True]


def test_a_print_the_block_cannot_split_at_declines_capture():
    """A block that holds a print where the executor cannot split it (here
    a served block) runs op by op on the card, never captured, so the
    print is not fixed into a graph."""
    from paddle_tpu_torch.executor import _PerOpProfiledBlock

    main, _, fetch = build("paddle_tpu_torch", lambda fluid: [fluid.layers.Print(
        fluid.layers.data(name="x", shape=[2, 3], dtype="float32", append_batch_size=False))])
    block = _PerOpProfiledBlock(main.global_block(), ["x"], [fetch[0].name],
                                pt.Scope(place=pt.CPUPlace()))
    assert block.capture_declined == "host_op"


# ---------------------------------------------------------------------------
# the framework ops
# ---------------------------------------------------------------------------


def _run_program(package, program_fn, feed, fetch_names=(), scope_vars=None):
    """Build and run `program_fn(fluid)` once in `package` on a fresh scope
    holding `scope_vars`; (fetches, the scope)."""
    main, startup, _ = build(package, program_fn)
    exe, scope, guard = exe_scope(package)
    with guard(scope):
        exe.run(startup)
        for n, v in (scope_vars or {}).items():
            if package == "paddle_tpu":
                import jax.numpy as jnp

                scope.vars[n] = jnp.asarray(v)
            else:
                scope.vars[n] = torch.from_numpy(np.array(v))
        out = exe.run(main, feed=feed, fetch_list=list(fetch_names))
    return out, scope


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("writer,reader", [("paddle_tpu", "paddle_tpu_torch"),
                                           ("paddle_tpu_torch", "paddle_tpu")])
def test_save_load_across_packages(tmp_path, writer, reader):
    """save / save_combine written by one package, load / load_combine read
    by the other, bit for bit (int64 held as int32 in both)."""
    arrays = {"a": np.random.RandomState(0).randn(3, 4).astype("float32"),
              "b": np.arange(5, dtype=np.int32)}
    single, combined = str(tmp_path / "dir" / "a"), str(tmp_path / "ab")

    def save_fn(fluid):
        blk = fluid.default_main_program().global_block()
        for n, v in arrays.items():
            blk.create_var(name=n, shape=v.shape, dtype=str(v.dtype), persistable=True)
        _append(blk, "save", {"X": ["a"]}, {}, {"file_path": single})
        _append(blk, "save_combine", {"X": ["a", "b"]}, {}, {"file_path": combined})
        return []

    def load_fn(fluid):
        blk = fluid.default_main_program().global_block()
        _append(blk, "load", {}, {"Out": ["a1"]}, {"file_path": single})
        _append(blk, "load_combine", {}, {"Out": ["a", "b"]}, {"file_path": combined})
        return []

    _run_program(writer, save_fn, {}, scope_vars=arrays)
    _, scope = _run_program(reader, load_fn, {})
    np.testing.assert_array_equal(_np(scope.find_var("a1")), arrays["a"])
    for n, v in arrays.items():
        got = _np(scope.find_var(n))
        assert got.dtype == v.dtype and np.array_equal(got, v), n


def test_save_load_bf16_round_trip(tmp_path):
    """A bf16 value saves as f32 with a `.dtype` sidecar and loads as bf16,
    in both forms."""
    val = torch.randn(4, 3).to(torch.bfloat16)
    single, combined = str(tmp_path / "v"), str(tmp_path / "vc")

    def program_fn(fluid):
        blk = fluid.default_main_program().global_block()
        blk.create_var(name="v", shape=(4, 3), dtype="bfloat16", persistable=True)
        _append(blk, "save", {"X": ["v"]}, {}, {"file_path": single})
        _append(blk, "save_combine", {"X": ["v"]}, {}, {"file_path": combined})
        _append(blk, "load", {}, {"Out": ["v1"]}, {"file_path": single})
        _append(blk, "load_combine", {}, {"Out": ["v"]}, {"file_path": combined})
        return []

    main, startup, _ = build("paddle_tpu_torch", program_fn)
    exe, scope, guard = exe_scope("paddle_tpu_torch")
    with guard(scope):
        scope.vars["v"] = val
        exe.run(main)
    assert open(single + ".dtype").read() == "bfloat16"
    for n in ("v1", "v"):
        assert scope.vars[n].dtype == torch.bfloat16 and torch.equal(scope.vars[n], val)


def test_delete_var_and_get_places():
    def program_fn(fluid):
        blk = fluid.default_main_program().global_block()
        blk.create_var(name="gone", shape=(2,), dtype="float32", persistable=True)
        _append(blk, "delete_var", {"X": ["gone"]}, {})
        _append(blk, "get_places", {}, {"Out": ["places"]}, {"device_count": 3})
        return []

    for package in PACKAGES:
        _, scope = _run_program(package, program_fn, {},
                                scope_vars={"gone": np.ones(2, "float32")})
        assert scope.find_var("gone") is None
        np.testing.assert_array_equal(_np(scope.find_var("places")), [0, 1, 2])
    _, scope = _run_program("paddle_tpu_torch", lambda fluid: [
        _append(fluid.default_main_program().global_block(), "get_places", {},
                {"Out": ["places"]})], {})
    np.testing.assert_array_equal(_np(scope.find_var("places")), [0])  # the CPU: one


def test_go_runs_its_sub_block():
    """go runs its sub-block on a thread over the same scope: a persistable
    it writes holds the same value in both packages once the threads are
    joined."""

    def program_fn(fluid):
        prog = fluid.default_main_program()
        blk = prog.global_block()
        blk.create_var(name="acc", shape=(3,), dtype="float32", persistable=True)
        sub = prog._create_block()
        _append(sub, "scale", {"X": ["acc"]}, {"Out": ["acc"]}, {"scale": 3.0, "bias": 1.0})
        prog._rollback()
        _append(blk, "go", {}, {}, {"sub_block": sub})
        return []

    got = []
    for package in PACKAGES:
        _, scope = _run_program(package, program_fn, {},
                                scope_vars={"acc": np.arange(3, dtype="float32")})
        for t in scope.find_var("__go_threads__"):
            t.join(30)
        got.append(_np(scope.find_var("acc")))
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[1], [1, 4, 7])


RNG = np.random.RandomState(11)
MASK = np.array([[1], [0], [1], [0]], np.int32)
ROWS = RNG.randn(4, 3).astype(np.float32)
IDS = np.array([[3], [8], [-5], [6], [1]], np.int32)


@pytest.mark.parametrize("op_type,ins,attrs,grad", [
    ("split_lod_tensor", {"X": [ROWS], "Mask": [MASK]}, {"level": 0}, True),
    ("merge_lod_tensor", {"InTrue": [ROWS], "InFalse": [-ROWS], "Mask": [MASK], "X": [ROWS]},
     {"level": 0}, True),
    ("tensor_array_to_tensor", {"X": [(RNG.randn(3, 2, 4).astype(np.float32),
                                       np.array(2, np.int32))]}, {"axis": 1}, False),
    ("tensor_array_to_tensor", {"X": [(RNG.randn(3, 2, 4).astype(np.float32),
                                       np.array(3, np.int32))]},
     {"axis": 2, "use_stack": True}, False),
    ("rnn_memory_helper", {"X": [ROWS]}, {}, True),
    ("split_ids", {"Ids": [IDS]}, {"num_shards": 3}, False),
    ("merge_ids", {"Ids": [IDS], "X": [RNG.randn(5, 2).astype(np.float32) for _ in range(3)]},
     {}, False),
    ("split_byref", {"X": [RNG.randn(6, 2).astype(np.float32)]}, {"sections": [1, 3, 2]}, True),
], ids=["split_lod_tensor", "merge_lod_tensor", "array_concat", "array_stack",
        "rnn_memory_helper", "split_ids", "merge_ids", "split_byref"])
def test_frame_device_ops(op_type, ins, attrs, grad):
    check_op(op_type, ins, attrs, 0, grad=grad)


def test_frame_op_registry():
    """Every frame op of the JAX package but the parameter-server and NCCL
    ones is registered in the port; the host ones as host ops; print is a
    device op to the passes and splits the graph for the executor."""
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as preg

    host = ("save", "load", "save_combine", "load_combine", "delete_var", "get_places", "go",
            "detection_map")
    for t in host:
        assert preg.get(t).is_host and jreg.get(t).is_host, t
    for t in ("split_lod_tensor", "merge_lod_tensor", "tensor_array_to_tensor",
              "rnn_memory_helper", "split_ids", "merge_ids", "split_byref", "print"):
        assert not preg.get(t).is_host and not jreg.get(t).is_host, t
    assert preg.get("print").splits_graph and not preg.get("split_ids").splits_graph


# ---------------------------------------------------------------------------
# print and FLAGS_check_nan_inf
# ---------------------------------------------------------------------------

LINE = re.compile(r"^(?P<msg>.*) shape=(?P<shape>\([^)]*\)) mean=(?P<mean>\S+) "
                  r"first=\[(?P<first>[^\]]*)\]$")


def _print_fields(text):
    rows = []
    for line in text.splitlines():
        m = LINE.match(line.strip())
        if m:
            rows.append((m["msg"], m["shape"], float(m["mean"]),
                         [float(v) for v in m["first"].split()]))
    return rows


@pytest.mark.parametrize("summarize", [3, -1])
def test_print_fields(capfd, summarize):
    """The same line in both packages: the message, the shape, the mean and
    the first `summarize` values (all for -1); every run prints."""
    x = RNG.randn(2, 3).astype(np.float32)

    def program_fn(fluid):
        v = fluid.layers.data(name="x", shape=[2, 3], dtype="float32", append_batch_size=False)
        out = fluid.layers.Print(v, message="probe", summarize=summarize)
        return [fluid.layers.scale(out, scale=2.0)]

    fields = []
    for package in PACKAGES:
        main, startup, fetch = build(package, program_fn)
        exe, scope, guard = exe_scope(package)
        capfd.readouterr()
        with guard(scope):
            for _ in range(2):
                np.testing.assert_allclose(exe.run(main, feed={"x": x}, fetch_list=fetch)[0],
                                           2 * x, rtol=1e-6)
        fields.append(_print_fields(capfd.readouterr().out))
    want, got = fields
    assert len(got) == len(want) == 2, (want, got)
    for (wm, ws, wmean, wfirst), (gm, gs, gmean, gfirst) in zip(want, got):
        assert (gm, gs) == (wm, ws) == ("probe", "(2, 3)")
        assert abs(gmean - wmean) < 1e-6 and abs(gmean - float(x.mean())) < 1e-6
        np.testing.assert_allclose(gfirst, wfirst, rtol=1e-6)
        assert len(gfirst) == (3 if summarize > 0 else 6)


def test_print_grad_is_the_identity(capfd):
    """The port's explicit print_grad against the JAX package's generic vjp
    of print: the cotangent itself."""
    x = RNG.randn(2, 3).astype(np.float32)
    want, got = [grad_one(p, "print", {"X": [x]}, {"message": "g", "summarize": 2},
                          {"Out": [2 * x]}) for p in PACKAGES]
    assert_outs_close(got, want, 0, "print_grad")
    np.testing.assert_array_equal(got["X@GRAD"][0], 2 * x)


def _nan_program(with_host):
    def program_fn(fluid):
        blk = fluid.default_main_program().global_block()
        blk.create_var(name="nan_x", shape=[2], dtype="float32")
        blk.create_var(name="nan_y", shape=None, dtype=None)
        blk.append_op(type="log", inputs={"X": ["nan_x"]}, outputs={"Out": ["nan_y"]}, attrs={})
        if with_host:
            _append(blk, "get_places", {}, {"Out": ["places"]}, {"device_count": 1})
            _append(blk, "scale", {"X": ["nan_y"]}, {"Out": ["nan_z"]}, {"scale": 1.0})
        return [blk.var("nan_y")]

    return program_fn


@pytest.mark.parametrize("with_host", [False, True], ids=["block", "segmented"])
def test_check_nan_inf_message(with_host):
    """tests/test_framework.py's case: off, the NaN passes; on, the run
    raises FloatingPointError naming the variable, its last writer and the
    run, with the JAX package's message word for word."""
    bad = np.array([-1.0, 1.0], "float32")
    messages = []
    for package in PACKAGES:
        flags = __import__(package + ".flags", fromlist=["flags"])
        main, startup, fetch = build(package, _nan_program(with_host))
        exe, scope, guard = exe_scope(package)
        with guard(scope):
            exe.run(main, feed={"nan_x": bad}, fetch_list=fetch)  # off: fine
            flags.set_flags({"FLAGS_check_nan_inf": True})
            try:
                with pytest.raises(FloatingPointError, match="nan_y") as err:
                    exe.run(main, feed={"nan_x": bad}, fetch_list=fetch)
            finally:
                flags.set_flags({"check_nan_inf": False})
        assert flags.get_flags("check_nan_inf") == {"check_nan_inf": False}
        messages.append(str(err.value))
    assert messages[1] == messages[0], messages
    assert "last written by op log:nan_y" in messages[1]
