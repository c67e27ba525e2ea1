"""Runtime flags (reference gflags tier: FLAGS_* environment variables plus
set_flags): the JAX package's 42 names, with its defaults and coercion.

- paged_flash: dispatch tier of the paged_attention op. "auto" (default)
  launches the hand-written CUDA kernel (ops/paged_flash.py) for tensors on
  a CUDA device and runs its plain torch version for tensors on the CPU;
  "off" runs the plain torch version everywhere (the parity tests' switch).
  There is no silent decline: on CUDA a kernel build or launch failure
  raises.
- quantized_gemm: dispatch tier of the gemm_int8 fused family (the
  quant GEMM of ops/quant_gemm.py). "auto" (default) takes the fused path
  wherever the copied path predicate (ops/fused.py quant_gemm_path_taken)
  accepts the shape: the kernel for tensors on a CUDA device, its plain
  version on the CPU; "off" lowers the int8 chains op by op.
- fp8_matmul: when True, the mul / matmul lowerings cast floating operands
  to float8_e4m3fn and contract them with f32 sums, the result in the
  first operand's dtype (ops/quant_gemm.py fp8_matmul: on the card the
  hand-written forward and gradient forms of csrc/fp8_gemm.cu). A dtype
  policy for step-time experiments, not numerics-preserving: off (default)
  keeps the native-dtype product.
- check_nan_inf: after every Executor.run, scan the fetches and the
  persistables the block writes for NaN/Inf (one reduction on the device
  and one host sync a run; a per-variable rescan only when it trips) and
  raise FloatingPointError naming the variable and its last writer (the
  reference's FLAGS_check_nan_inf, operator.cc:778). On the graph path the
  scan follows the replay.
- profile_ops: while the profiler is on (profiler.py), Executor.run and the
  GenerationEngine's variants run blocks op by op, with an event and a
  device sync per op, so the profiler table attributes time per op type,
  the reference's per-op RecordEvent tables (operator.cc:157). On the card
  blocks otherwise run as replayed CUDA graphs; this is the only way to the
  op-by-op path there. A diagnosis mode, never a training mode.
- pass_pipeline: the graph-pass pipeline Executor.run applies before a
  program runs (passes/manager.py PRESETS, e.g. "training_fused", or a
  comma-separated pass list); "" (default) runs the program as built.
- serving_cache_dir: the persistent compile cache's directory
  (serving/compile_cache.py): a ServingEngine or GenerationEngine built
  without cache_dir takes it from here, and stores each variant's prepared
  block and shape facts there; "" (default) keeps no cache.
- trace_dir / trace_sample / trace_slow_ms / trace_ring: the request tracer
  (observability/tracing.py), as in the JAX package.
- flightrec_dir / flightrec_max_bundles / flightrec_min_interval_s: the
  flight recorder (observability/flightrec.py): a bundle directory per
  trigger (the ModelServer's 5xx replies), at most max_bundles kept, one
  per reason per min_interval_s.
- static_verify: the compile gate of analysis/verify.py. On, Executor.run
  (at a block's preparation), aot_serve_lowering, the serving engines at
  load and the pass manager (stage 0 before the first pass and after each
  pass) lint the program with the fluidlint checkers and raise
  StaticVerifyError on an error finding; off (default) costs one flag read.
- pass_debug_dir: the pass manager writes a graphviz .dot of the program
  before and after each pass and a unified diff of its op list there
  ("NN_<pass>_before.dot", "NN_<pass>_after.dot", "NN_<pass>_ops.diff");
  "" (default) writes nothing.
- benchmark: Executor.run synchronizes the run's device before it returns
  the fetches, so a host clock around a run brackets the step's device
  work (the reference's FLAGS_benchmark, operator.cc:769).
- gemm_double_buffer: the JAX package's choice of GEMM tier ("auto" / "on" /
  "off": its double-buffered k loop or the grid-pipelined one). The port
  has one GEMM epilogue kernel (ops/gemm_epilogue.py), which runs whatever
  the value; the value is validated and recorded.
- cpu_deterministic, eager_delete_tensor_gb, fraction_of_gpu_memory_to_use,
  paddle_num_threads: accepted and recorded for API compatibility, as the
  reference documents them; storage lifetime and threading are PyTorch's
  (the caching allocator, torch's own thread pool).
- rpc_max_retry / rpc_deadline / rpc_op_deadline: the RPC client's retry
  policy (distributed/rpc.py: attempts, the overall budget, the reply
  deadline of one attempt), as in the JAX package.
- resilience_nan_guard / resilience_lr_decay: Executor.run's step guard
  (executor.py): a run that updates persistables and yields a NaN or an Inf
  is rolled back to its pre-step state, and the learning-rate and
  loss-scale vars are multiplied by the decay.
- elastic_step_deadline_s / elastic_nan_budget / elastic_rollback_budget /
  elastic_barrier_timeout_s: the elastic Supervisor's watchdog deadline, NaN
  and rollback budgets, and the elastic checkpoint's commit-barrier timeout
  (resilience/elastic.py, async_ckpt.py).
- telemetry_dir / telemetry_interval_steps / telemetry_log_every: step
  telemetry (observability/stepstats.py, export.py): a dir makes every
  Executor / ParallelExecutor run append a step record to
  telemetry-host<rank>.jsonl and, every interval, a snapshot record and the
  Prometheus file; log_every > 0 prints a health line to stderr that often.
- tensor_stats: a glob of op names (observability/opprof.py); the matched
  ops' outputs get [mean, std, absmax, nonfinite] computed on the device
  inside the step (inside the captured graph), read with one host sync a
  run. Part of the block's cache key: a change prepares and captures anew.
- nan_provenance: when the NaN guard or check_nan_inf trips, the step is
  replayed op by op from its pre-step state and generator state, and the
  first op with a non-finite output is recorded (opprof.write_provenance).
- Every flag acts: PENDING, the flags of modules still to port, is empty
  since observability came.
"""

import os

__all__ = ["get_flags", "set_flags"]

_DEFAULTS = {
    "paged_flash": "auto",
    "quantized_gemm": "auto",
    "fp8_matmul": False,
    "check_nan_inf": False,
    "profile_ops": False,
    "pass_pipeline": "",
    "serving_cache_dir": "",
    "trace_dir": "",
    "trace_sample": 1.0,
    "trace_slow_ms": 500.0,
    "trace_ring": 4096,
    "flightrec_dir": "",
    "flightrec_max_bundles": 16,
    "flightrec_min_interval_s": 2.0,
    "pass_debug_dir": "",
    "static_verify": False,
    "benchmark": False,
    "gemm_double_buffer": "auto",
    "cpu_deterministic": False,
    "eager_delete_tensor_gb": -1.0,
    "fraction_of_gpu_memory_to_use": 0.92,
    "paddle_num_threads": 1,
    # the flags of the RPC, resilience, data and telemetry modules, at the
    # JAX package's defaults
    "rpc_max_retry": 3,
    "rpc_deadline": 120.0,
    "rpc_op_deadline": 30.0,
    "resilience_nan_guard": False,
    "resilience_lr_decay": 0.5,
    "dist_init_max_retry": 3,
    "telemetry_dir": "",
    "telemetry_interval_steps": 50,
    "telemetry_log_every": 0,
    "tensor_stats": "",
    "nan_provenance": False,
    "data_num_workers": 0,
    "data_ring_slots": 0,
    "data_prefetch": 2,
    "data_start_method": "fork",
    "data_max_worker_restarts": 4,
    "elastic_step_deadline_s": 0.0,
    "elastic_nan_budget": 3,
    "elastic_rollback_budget": 2,
    "elastic_barrier_timeout_s": 120.0,
}

_CHOICES = {"paged_flash": ("auto", "off"), "quantized_gemm": ("auto", "off"),
            "gemm_double_buffer": ("auto", "on", "off")}

# flag -> the module of the JAX package that reads it and the port has not
# ported yet: none, every flag acts
PENDING = {}

_flags = {}


def _coerce(name, raw):
    if isinstance(_DEFAULTS[name], bool):
        value = str(raw).lower() in ("1", "true", "yes", "on")
    else:
        value = type(_DEFAULTS[name])(raw)
    choices = _CHOICES.get(name)
    if choices is not None and value not in choices:
        raise ValueError("FLAGS_%s must be one of %s, got %r" % (name, choices, raw))
    return value


def _init():
    import warnings

    for name, default in _DEFAULTS.items():
        env = os.environ.get("FLAGS_" + name)
        if env is None:
            _flags[name] = default
            continue
        try:
            _flags[name] = _coerce(name, env)
        except (TypeError, ValueError):
            # a malformed env var must not break `import paddle_tpu_torch`
            warnings.warn(
                "ignoring malformed FLAGS_%s=%r (expected %s)"
                % (name, env, type(default).__name__)
            )
            _flags[name] = default


_init()


def get_flags(names=None):
    if names is None:
        return dict(_flags)
    if isinstance(names, str):
        return {names: _flags[names]}
    return {n: _flags[n] for n in names}


def set_flags(flags):
    for name, value in flags.items():
        name = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
        if name not in _flags:
            raise KeyError("unknown flag %r (known: %s)" % (name, sorted(_flags)))
        _flags[name] = _coerce(name, value)
