"""Subprocess trainer for the port's elastic-runtime tests
(tests/test_torch_elastic.py): tests/elastic_runner.py on paddle_tpu_torch,
on the CPU (it imports no JAX). The dp=N -> dp=M resume runs over gloo
ranks instead (tests/torch_parallel_ranks.py sc_elastic_pe).

Modes (argv[1]):

  train       Supervised MLP training as ONE logical host of an elastic
              group: env ELASTIC_HOST_ID / ELASTIC_NUM_HOSTS / CKPT_ROOT /
              TRAIN_STEPS / CKPT_EVERY. Every host of the group runs the
              IDENTICAL seeded replicated computation (the SPMD contract)
              and writes its own shard + neighbor replica of every elastic
              checkpoint. Prints one "STEP <k> <loss.hex()>" line per step
              (hex → bit-exactness survives the text pipe), "RESUMED <k>"
              after resume_or_init, "DONE" at the end.

  ckpt_loop   Saves elastic checkpoints of a fixed synthetic state as fast
              as possible, forever — the parent SIGKILLs this process at
              random points across snapshot/write/commit and then asserts
              every surviving manifest loads (checkpoint-under-SIGKILL soak).

The parent drives everything through env vars + stdout lines; stderr goes
to a file (PIPE deadlock avoidance, same pattern as multihost_runner.py).
"""

import os
import sys

import numpy as np


def _build_mlp(lr=0.1):
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss


def _batch(step, bs=16):
    rng = np.random.RandomState(step)
    x = rng.randn(bs, 8).astype(np.float32)
    return {"x": x, "y": np.abs(x).sum(axis=1, keepdims=True).astype(np.float32)}


def _say(line):
    print(line, flush=True)


def run_train():
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.resilience import Preempted, Supervisor, health

    torch.set_num_threads(1)

    host_id = int(os.environ.get("ELASTIC_HOST_ID", "0"))
    num_hosts = int(os.environ.get("ELASTIC_NUM_HOSTS", "1"))
    root = os.environ["CKPT_ROOT"]
    steps = int(os.environ.get("TRAIN_STEPS", "20"))
    ckpt_every = int(os.environ.get("CKPT_EVERY", "3"))
    # throttle so the parent's SIGKILL lands at a bounded step index
    sleep_ms = float(os.environ.get("STEP_SLEEP_MS", "0"))

    main, startup, loss = _build_mlp()
    scope = Scope(seed=1, place=fluid.CPUPlace())  # every host: the same state
    with scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        sup = Supervisor(
            exe, root, program=main, num_hosts=num_hosts, host_id=host_id,
            ckpt_every=ckpt_every,
            checkpointer=None,
        )
        # cross-host barriers must fail fast when a peer is SIGKILLed
        sup.checkpointer.barrier_timeout = float(
            os.environ.get("BARRIER_TIMEOUT", "15")
        )
        start, _cursor = sup.resume_or_init(startup)
        _say("RESUMED %d" % start)
        with sup:
            try:
                for s in range(start, steps):
                    (lv,) = sup.run_step(
                        program=main, feed=_batch(s), fetch_list=[loss]
                    )
                    _say("STEP %d %s" % (s, float(np.asarray(lv).ravel()[0]).hex()))
                    if sleep_ms:
                        __import__("time").sleep(sleep_ms / 1000.0)
            except Preempted as e:
                _say("PREEMPTED %s" % e)
                return 0
            sup.checkpointer.wait()
    _say("HEALTH %s" % __import__("json").dumps(health.snapshot()))
    _say("DONE")
    return 0


def run_ckpt_loop():
    from paddle_tpu_torch.resilience import async_ckpt

    root = os.environ["CKPT_ROOT"]
    rng = np.random.RandomState(0)
    arrays = {
        "w0": rng.randn(64, 32).astype(np.float32),
        "w1": rng.randn(32, 8).astype(np.float32),
        "lr": np.float32(0.1),
    }
    step = 0
    _say("LOOPING")
    while True:
        step += 1
        arrays["w0"] += 1.0  # every checkpoint differs — torn mixes detectable
        async_ckpt.write_elastic_checkpoint(
            root, arrays, step, num_hosts=1, host_id=0, keep_last=4,
            cursor={"epoch": 0, "batch_index": step, "seed": 0},
        )
        _say("SAVED %d" % step)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "train"
    if mode == "train":
        return run_train()
    if mode == "ckpt_loop":
        return run_ckpt_loop()
    raise SystemExit("unknown mode %r" % mode)


if __name__ == "__main__":
    sys.exit(main())
