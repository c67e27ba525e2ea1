"""Runtime flags (reference gflags tier: FLAGS_* environment variables plus
set_flags), the subset the serving and training slices read.

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
  hand-written cast pass and e4m3 GEMM of csrc/quant_gemm.cu). A dtype
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
- serving_cache_dir: the JAX package's persistent compile-cache directory.
  The port has no compile cache; a GenerationEngine raises when one is set.
- trace_dir / trace_sample / trace_slow_ms / trace_ring / flightrec_dir: the
  request tracer (observability/tracing.py), as in the JAX package.
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
}

_CHOICES = {"paged_flash": ("auto", "off"), "quantized_gemm": ("auto", "off")}

_flags = {}


def _coerce(name, raw):
    if isinstance(_DEFAULTS[name], bool):
        return str(raw).lower() in ("1", "true", "yes", "on")
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
