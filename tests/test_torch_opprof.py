"""Op-level attribution of the torch port (paddle_tpu_torch/observability/
opprof.py, the device half of profiler.py) against the JAX package's, on
the CPU.

- Names and costs: op_display_name, match_ops, stats_spec and
  program_op_costs equal the JAX package's on the same programs (an fc
  Adam program and a conv SGD program, op for op).
- FLAGS_tensor_stats: the rows of the same step in both packages (weights
  carried by name) within rtol 1e-5, atol 1e-6; the flag is part of the
  block's cache key, so setting it prepares a new block and clearing it
  takes the old one back without a reading.
- FLAGS_nan_provenance: on a program where log of a negative feed makes
  the first NaN, FLAGS_check_nan_inf's error and the provenance record
  name the same first op in both packages; under the NaN guard with the
  nan_grad fault too.
- host_profile: the record has the JAX package's keys and rows plus the
  H100's peaks, and tools/op_profile.py renders it with them.
- device_op_profile: kernels are attributed to the op range whose thread
  launched them (a synthetic torch.profiler trace), a trace with only
  graph launches raises, and xla_trace writes the op-by-op path's op
  ranges into its trace.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as pt
from paddle_tpu import flags as jflags
from paddle_tpu import profiler as jprofiler
from paddle_tpu.observability import opprof as jopprof
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.observability import opprof as topprof
from paddle_tpu_torch.resilience import faults as tfaults

import torch_obs_cases as cases

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(HERE, "..", "tools")
BUILDS = {"fc_adam": (cases.fc_adam, cases.fc_batch), "conv_sgd": (cases.conv_sgd, cases.conv_batch)}


def _both(name):
    """(JAX run, port run) of a program, the port from the JAX startup's
    state."""
    build, _ = BUILDS[name]
    jrun = cases.Run(jfluid, build)
    return jrun, cases.Run(pt, build, init=jrun.state())


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_names_specs_and_costs_match_jax(name):
    build, batch = BUILDS[name]
    jmain, tmain = build(jfluid)[0], build(pt)[0]
    jb, tb = jmain.global_block(), tmain.global_block()
    assert [topprof.op_display_name(op) for op in tb.ops] == \
        [jopprof.op_display_name(op) for op in jb.ops]
    for pattern in ("mul*", "*grad*", "relu:*", "fc_0*", "adam", "nothing"):
        assert [topprof.op_display_name(op) for op in topprof.match_ops(tb, pattern)] == \
            [jopprof.op_display_name(op) for op in jopprof.match_ops(jb, pattern)]
        assert topprof.stats_spec(tb.ops, pattern) == jopprof.stats_spec(jb.ops, pattern)
    avals = {n: np.asarray(v) for n, v in batch(0).items()}
    got = topprof.program_op_costs(list(topprof.iter_block_ops(tb)),
                                   topprof.block_aval_resolver(tb, avals))
    want = jopprof.program_op_costs(list(jopprof.iter_block_ops(jb)),
                                    jopprof.block_aval_resolver(jb, avals))
    assert got == want and any(f for f, _ in got.values())


@pytest.fixture
def opprof_flags():
    saved = (tflags.get_flags(["tensor_stats", "nan_provenance", "check_nan_inf",
                               "resilience_nan_guard"]),
             jflags.get_flags(["tensor_stats", "nan_provenance", "check_nan_inf",
                               "resilience_nan_guard"]))
    yield
    tflags.set_flags(saved[0])
    jflags.set_flags(saved[1])
    tfaults.install(None)
    jfaults.install(None)


@pytest.mark.parametrize("pattern", ["mul*", "*relu*", "*"])
def test_tensor_stats_rows_match_jax(opprof_flags, pattern):
    jrun, trun = _both("fc_adam")
    for flags in (jflags, tflags):
        flags.set_flags({"tensor_stats": pattern})
    jrun.step(cases.fc_batch(0))
    trun.step(cases.fc_batch(0))
    want, got = jopprof.last_tensor_stats(), topprof.last_tensor_stats()
    assert list(got) == list(want) and got
    for name in want:
        for field in topprof.STAT_FIELDS:
            np.testing.assert_allclose(got[name][field], want[name][field], rtol=1e-5, atol=1e-6,
                                       err_msg="%s %s" % (name, field))


def test_tensor_stats_flag_rebuilds_the_block(opprof_flags):
    run = cases.Run(pt, cases.fc_adam)
    run.step(cases.fc_batch(0))
    plain = len(run.exe._cache)
    tflags.set_flags({"tensor_stats": "mul*"})
    run.step(cases.fc_batch(1))
    assert len(run.exe._cache) == plain + 1
    first = topprof.last_tensor_stats()
    tflags.set_flags({"tensor_stats": ""})
    run.step(cases.fc_batch(2))
    assert len(run.exe._cache) == plain + 1  # the plain block again
    assert topprof.last_tensor_stats() == first  # and no reading from it


def _check_nan_inf_provenance(pkg):
    flags, opprof = (tflags, topprof) if cases.is_port(pkg) else (jflags, jopprof)
    flags.set_flags({"check_nan_inf": True, "nan_provenance": True})
    run = cases.Run(pkg, cases.log_net)
    x = np.abs(np.random.RandomState(4).randn(3, 6)).astype("float32")
    x[1, 2] = -1.0
    with pytest.raises(FloatingPointError) as e:
        run.step({"x": x})
    return str(e.value), opprof.last_provenance()


def test_nan_provenance_names_the_first_op_as_jax(opprof_flags):
    tmsg, tprov = _check_nan_inf_provenance(pt)
    jmsg, jprov = _check_nan_inf_provenance(jfluid)
    assert tprov["op"] == jprov["op"] and tprov["op"].startswith("log:")
    assert tprov["op_index"] == jprov["op_index"] and tprov["outputs"] == jprov["outputs"]
    assert tprov["reason"] == jprov["reason"] == "check_nan_inf"
    assert sorted(tprov) == sorted(jprov)
    assert tprov["output_stats"] == jprov["output_stats"]
    tail = "first non-finite output at op #%d %s" % (tprov["op_index"], tprov["op"])
    assert tail in tmsg and tail in jmsg


def _guard_provenance(pkg, init=None):
    flags, opprof, faults = ((tflags, topprof, tfaults) if cases.is_port(pkg)
                             else (jflags, jopprof, jfaults))
    flags.set_flags({"resilience_nan_guard": True, "nan_provenance": True})
    run = cases.Run(pkg, cases.fc_adam, init=init)
    before = run.state()
    faults.install("nan_grad:step=1")
    try:
        run.step(cases.fc_batch(0))
    finally:
        faults.install(None)
    return opprof.last_provenance(), before, run


def test_nan_provenance_under_the_guard_as_jax(opprof_flags):
    jprov, jbefore, _ = _guard_provenance(jfluid)
    tprov, tbefore, trun = _guard_provenance(pt, init=jbefore)
    assert tprov["op"] == jprov["op"] and tprov["reason"] == "resilience_nan_guard"
    assert tprov["op_index"] == jprov["op_index"]
    # the rollback: the state is the pre-step state (the learning rate decayed)
    after = trun.state()
    for n, v in tbefore.items():
        if not n.startswith("learning_rate"):
            np.testing.assert_array_equal(after[n], v)


def _profiled_record(pkg, build, batch):
    flags, profiler, opprof = ((tflags, tprofiler, topprof) if cases.is_port(pkg)
                               else (jflags, jprofiler, jopprof))
    run = cases.Run(pkg, build)
    flags.set_flags({"profile_ops": True})
    try:
        profiler.reset_profiler()
        profiler.start_profiler("All")
        run.step(batch(0))
        table = profiler.stop_profiler(profile_path=None)
    finally:
        flags.set_flags({"profile_ops": False})
    avals = {n: np.asarray(v) for n, v in batch(0).items()}
    return opprof.host_profile(table, block=run.main.global_block(), feed_avals=avals)


def test_host_profile_record_has_the_jax_keys_and_the_h100_peaks(capsys):
    want = _profiled_record(jfluid, cases.conv_sgd, cases.conv_batch)
    got = _profiled_record(pt, cases.conv_sgd, cases.conv_batch)
    capsys.readouterr()
    assert set(got) == set(want) | {"peak_tflops", "peak_bw_gbs"}
    assert (got["peak_tflops"], got["peak_bw_gbs"]) == (67.0, 3350.0)
    assert got["source"] == want["source"] == "host_events"
    rows = {r["op"]: r for r in got["ops"]}
    wrows = {r["op"]: r for r in want["ops"]}
    assert set(rows) == set(wrows)
    for key, r in rows.items():
        assert set(r) == set(wrows[key])
        assert (r["flops"], r["bytes"], r["count"]) == \
            (wrows[key]["flops"], wrows[key]["bytes"], wrows[key]["count"])
    sys.path.insert(0, TOOLS)
    try:
        import op_profile
    finally:
        sys.path.remove(TOOLS)
    text = op_profile.render_table(got)
    assert "Op Profile (host_events)" in text and "conv2d:" in text
    assert text == topprof.render_table(got)
    assert op_profile.render_rollup(got) == topprof.render_rollup(got)


def _trace(events):
    return {"traceEvents": [dict(dict(ph="X", pid=1, tid=7), **e) for e in events]}


def _write(tmp_path, events):
    d = tmp_path / "trace"
    d.mkdir(exist_ok=True)
    (d / "trace-1-0.json").write_text(json.dumps(_trace(events)))
    return str(d)


def test_device_op_profile_attributes_kernels_to_their_op(tmp_path):
    events = [
        {"cat": "user_annotation", "name": "op/mul:fc_0.tmp_0", "ts": 100, "dur": 50},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 5,
         "args": {"correlation": 1}},
        {"cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 120, "dur": 5,
         "args": {"correlation": 2}},
        {"cat": "user_annotation", "name": "op/fused_gemm_epilogue:fc_1.tmp_1", "ts": 200,
         "dur": 50},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 210, "dur": 5,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 300, "dur": 5,
         "args": {"correlation": 4}},
        {"cat": "kernel", "name": "gemm_a", "ts": 400, "dur": 20, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "gemm_b", "ts": 420, "dur": 10, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "gemm_bias_act_kernel", "ts": 440, "dur": 30,
         "args": {"correlation": 3}},
        {"cat": "kernel", "name": "copy_cast", "ts": 480, "dur": 4, "args": {"correlation": 4}},
        # a launch from another thread (autograd's device thread) while the
        # op's range is open, and a kernel whose launch the trace lacks,
        # run inside the op's range
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 230, "dur": 5, "tid": 9,
         "args": {"correlation": 5}},
        {"cat": "kernel", "name": "bwd_gemm", "ts": 500, "dur": 6, "args": {"correlation": 5}},
        {"cat": "kernel", "name": "lib_gemm", "ts": 130, "dur": 8, "args": {"correlation": 6}},
    ]
    table = tprofiler.device_op_profile(_write(tmp_path, events), print_table=False)
    assert table == {"mul:fc_0.tmp_0": [3, 0.038, 0.008, 0.02],
                     "fused_gemm_epilogue:fc_1.tmp_1": [2, 0.036, 0.006, 0.03],
                     "kernel:copy_cast": [1, 0.004, 0.004, 0.004]}
    rec = topprof.device_profile(None, str(tmp_path / "trace"))
    assert rec["source"] == "torch.profiler" and rec["total_device_ms"] == 0.078
    assert rec["peak_tflops"] == topprof.PEAK_MM_TFLOPS


def test_device_op_profile_raises_on_graph_launches_only(tmp_path):
    events = [
        {"cat": "user_annotation", "name": "run/block0", "ts": 100, "dur": 50},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 110, "dur": 5,
         "args": {"correlation": 9}},
        {"cat": "kernel", "name": "gemm_a", "ts": 400, "dur": 20, "args": {"correlation": 9}},
    ]
    with pytest.raises(RuntimeError, match="only CUDA graph launches"):
        tprofiler.device_op_profile(_write(tmp_path, events), print_table=False)


def test_xla_trace_records_the_op_ranges(tmp_path, capsys):
    run = cases.Run(pt, cases.fc_adam)
    tflags.set_flags({"profile_ops": True})
    try:
        with tprofiler.profiler(profile_path=None), tprofiler.xla_trace(str(tmp_path)):
            run.step(cases.fc_batch(0))
    finally:
        tflags.set_flags({"profile_ops": False})
    capsys.readouterr()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    ops = {"op/" + topprof.op_display_name(op)
           for op in run.main.global_block().ops if op.type in ("mul", "adam")}
    assert ops <= ranges
    # a CPU trace has no kernels: an empty table, nothing raised
    assert tprofiler.device_op_profile(str(tmp_path), print_table=False) == {}
