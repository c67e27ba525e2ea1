"""Test env: force an 8-device virtual CPU mesh BEFORE any computation, so
multi-chip SPMD paths compile and run without TPU hardware (the pattern the
driver's dryrun_multichip also uses). Shared bootstrap logic lives in
paddle_tpu.platform_setup.

PADDLE_OPTEST_PLACE=tpu skips the CPU forcing so the same op-test suite runs
against the real chip (scripts/optest_tpu.py lane — the reference runs every
op test on CPUPlace AND CUDAPlace, reference op_test.py:303-385,427; this env
switch is the TPU analog of that second place).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent XLA compilation cache: the tier-1 lane spends most of its wall
# clock recompiling the same programs every run (and every subprocess-spawning
# test recompiles them again in each child). Env vars rather than
# jax.config.update so spawned children (test_dist_subprocess, test_multihost)
# inherit the cache too. Set BEFORE jax initialises; respect an explicit
# caller-provided dir.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

if os.environ.get("PADDLE_OPTEST_PLACE", "").lower() != "tpu":
    from paddle_tpu.platform_setup import force_virtual_cpu_devices

    force_virtual_cpu_devices(8)


def pytest_configure(config):
    # the tier-1 lane runs with `-m 'not slow'`; anything expected to exceed
    # ~60s wall (long fault-injection soaks etc.) gets @pytest.mark.slow
    config.addinivalue_line(
        "markers", "slow: long-running test, excluded from the tier-1 lane"
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a hand-written kernel); skips without one",
    )
