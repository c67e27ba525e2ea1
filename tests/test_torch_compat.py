"""Programs and scripts written for the JAX package run unchanged in the
torch port, on the CPU:

- the reader ops (`read`, the `create_*_reader` ops, `open_files`) are
  markers in both packages: a program holding one fetches what the JAX
  package fetches, on the straight-line path and on the segmented one (a
  block split at a print);
- `set_flags` takes every one of the JAX package's 42 flag names at its
  default; FLAGS_benchmark and the recorded compatibility flags take other
  values; a flag whose module the port has not ported yet raises
  NotImplementedError naming that module for any value but its default;
  an unknown name still raises KeyError.
"""

import importlib

import numpy as np
import pytest

import jax

import paddle_tpu.flags as jflags
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags

jax.config.update("jax_platforms", "cpu")

READER_OPS = ("read", "create_custom_reader", "create_recordio_file_reader",
              "create_shuffle_reader", "create_batch_reader", "create_double_buffer_reader",
              "create_py_reader", "open_files")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved, jsaved = flags.get_flags(), jflags.get_flags()
    yield
    flags._flags.update(saved)
    jflags._flags.update(jsaved)


def _reader_program(name, op_type, with_print):
    """fill_constant([2, 2], 4) -> reduce_sum (16.0), with one reader op
    appended (a reader var in, a batch var out) and, with_print, a print
    between them."""
    fluid = importlib.import_module(name + ".fluid" if name == "paddle_tpu" else name)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.fill_constant(shape=[2, 2], dtype="float32", value=4.0)
        total = fluid.layers.reduce_sum(x)
        if with_print:
            fluid.layers.Print(total, message="total")
        block = main.global_block()
        reader = block.create_var(name="reader_0", shape=[1], dtype="float32")
        batch = block.create_var(name="batch_0", shape=[2, 2], dtype="float32")
        block.append_op(type=op_type, inputs={"Reader": [reader.name]},
                        outputs={"Out": [batch.name]}, attrs={})
    return fluid, main, startup, total


def _fetch(name, op_type, with_print):
    fluid, main, startup, total = _reader_program(name, op_type, with_print)
    if name == "paddle_tpu":
        exe, scope = fluid.Executor(), fluid.Scope()
    else:
        exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope(place=pt.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        return [np.asarray(exe.run(main, fetch_list=[total.name])[0]) for _ in range(2)]


@pytest.mark.parametrize("with_print", [False, True])
@pytest.mark.parametrize("op_type", READER_OPS)
def test_reader_marker_runs_and_fetches_as_jax(op_type, with_print):
    want = _fetch("paddle_tpu", op_type, with_print)
    got = _fetch("paddle_tpu_torch", op_type, with_print)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert float(np.asarray(g).reshape(-1)[0]) == 16.0


def test_reader_markers_are_skipped_by_every_block_form():
    from paddle_tpu_torch.ops import registry

    for t in READER_OPS:
        d = registry.get(t)
        assert d.skip_exec and d.lower is None and not d.splits_graph


@pytest.mark.parametrize("name", sorted(jflags._DEFAULTS))
def test_every_jax_flag_at_its_default(name):
    """Each of the JAX package's flags is known to the port with the same
    default, and setting it to that default succeeds in both packages."""
    default = jflags._DEFAULTS[name]
    assert flags.get_flags(name)[name] == default
    jflags.set_flags({"FLAGS_" + name: default})
    flags.set_flags({"FLAGS_" + name: default})
    assert flags.get_flags(name)[name] == jflags.get_flags(name)[name]


def test_flag_tables_have_the_same_names():
    assert sorted(flags.get_flags()) == sorted(jflags.get_flags())
    assert len(flags.get_flags()) == 42


RECORDED = {"benchmark": True, "cpu_deterministic": True, "eager_delete_tensor_gb": 0.0,
            "fraction_of_gpu_memory_to_use": 0.5, "paddle_num_threads": 4,
            "gemm_double_buffer": "off"}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_compat_flag_takes_other_values(name):
    """FLAGS_benchmark, gemm_double_buffer and the recorded flags take a
    value other than their default, coerced as the JAX package coerces it
    (from a string too)."""
    value = RECORDED[name]
    flags.set_flags({"FLAGS_" + name: str(value)})
    jflags.set_flags({"FLAGS_" + name: str(value)})
    assert flags.get_flags(name)[name] == jflags.get_flags(name)[name] == value


def test_gemm_double_buffer_choices():
    for v in ("auto", "on", "off"):
        flags.set_flags({"gemm_double_buffer": v})
        assert flags.get_flags("gemm_double_buffer")["gemm_double_buffer"] == v
    with pytest.raises(ValueError, match="gemm_double_buffer"):
        flags.set_flags({"gemm_double_buffer": "always"})


def test_benchmark_flag_runs_a_program():
    """With FLAGS_benchmark on, Executor.run returns the same fetches (on
    the card it also waits for the device)."""
    flags.set_flags({"FLAGS_benchmark": True})
    assert [float(v[0]) for v in _fetch("paddle_tpu_torch", "read", False)] == [16.0, 16.0]


# a value other than the default for each flag whose module is missing,
# and a word of the module the error names
PENDING = {
    "telemetry_dir": ("/tmp/t", "export"),
    "telemetry_interval_steps": (10, "export"), "telemetry_log_every": (1, "export"),
    "tensor_stats": ("*", "opprof"), "nan_provenance": (True, "opprof"),
}

# flags whose module is ported: a value other than the default is taken
PORTED = {"flightrec_max_bundles": 4, "flightrec_min_interval_s": 0.5,
          "pass_debug_dir": "pass_dumps", "static_verify": True, "dist_init_max_retry": 1,
          "data_num_workers": 2, "data_ring_slots": 8, "data_prefetch": 4,
          "data_start_method": "spawn", "data_max_worker_restarts": 1,
          "rpc_max_retry": 5, "rpc_deadline": 10.0, "rpc_op_deadline": 1.0,
          "resilience_nan_guard": True, "resilience_lr_decay": 0.25,
          "elastic_step_deadline_s": 5.0, "elastic_nan_budget": 1,
          "elastic_rollback_budget": 1, "elastic_barrier_timeout_s": 5.0}


def test_pending_table_is_the_rest_of_the_flags():
    assert sorted(PENDING) == sorted(flags.PENDING)
    assert len(PENDING) == 5
    assert set(PENDING) | set(RECORDED) | set(PORTED) | {
        "paged_flash", "quantized_gemm", "fp8_matmul", "check_nan_inf", "profile_ops",
        "pass_pipeline", "serving_cache_dir", "trace_dir", "trace_sample", "trace_slow_ms",
        "trace_ring", "flightrec_dir"} == set(jflags._DEFAULTS)


@pytest.mark.parametrize("name", sorted(PENDING))
def test_pending_flag_raises_naming_its_module(name):
    """Set to anything but its default, a flag whose module is still to
    come raises NotImplementedError naming the module and its ROADMAP
    queue (the JAX package takes the value), and the flag keeps its
    default."""
    value, word = PENDING[name]
    jflags.set_flags({name: value})
    with pytest.raises(NotImplementedError, match=word) as e:
        flags.set_flags({"FLAGS_" + name: value})
    assert "ROADMAP A" in str(e.value)
    assert flags.get_flags(name)[name] == jflags._DEFAULTS[name]


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_flag_takes_its_value(name):
    """A flag whose module this package has ported takes any value, as the
    JAX package does, and keeps it until it is set back."""
    try:
        flags.set_flags({"FLAGS_" + name: PORTED[name]})
        assert flags.get_flags(name)[name] == PORTED[name]
    finally:
        flags.set_flags({name: jflags._DEFAULTS[name]})
    assert flags.get_flags(name)[name] == jflags._DEFAULTS[name]


def test_unknown_flag_raises_key_error():
    with pytest.raises(KeyError):
        flags.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError):
        jflags.set_flags({"FLAGS_no_such_flag": 1})
