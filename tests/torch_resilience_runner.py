"""Master-driven trainer for tests/test_torch_resilience.py's kill/recover
test: tests/resilience_runner.py on the port (it imports no JAX; every entry
point runs on the CPU).

One process = one trainer that pulls RecordIO shard tasks from a Master
(distributed/master.py), trains an MLP step on each shard's records, reports
task_finished, and writes a manifest checkpoint after every finished task.
Start-up goes through resilience.resume_or_init, so a REPLACEMENT process
pointed at the same --ckpt_dir continues from the last committed checkpoint
while the master's task timeout re-queues whatever the dead worker held.

Records are pickled (x[8], y[1]) float32 pairs (see _write_dataset in the
test). Fault hooks honored here:
- worker_die (e.g. worker_die:step=2): os._exit(3) after the Nth get_task,
  BEFORE finishing the task — the simulated preemption the master must heal.

stdout protocol: "RESUMED <n>", "TASK <id>", optional "DYING <id>",
"FINISHED <tasks_done>", "HEALTH <json>".
"""

import argparse
import json
import os
import sys

import numpy as np


def build_model(lr):
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--master", required=True)  # host:port
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--max_tasks", type=int, default=0)  # 0 = until no_more
    args = ap.parse_args()

    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import reader, resilience
    from paddle_tpu_torch.distributed.master import MasterClient
    from paddle_tpu_torch.executor import Scope, scope_guard
    from paddle_tpu_torch.resilience import checkpoint as ckpt
    from paddle_tpu_torch.resilience import faults, health

    torch.set_num_threads(1)

    if args.faults:
        faults.install(args.faults)

    main_prog, startup, loss = build_model(args.lr)
    client = MasterClient(args.master, timeout=30.0, op_timeout=5.0)
    scope = Scope(seed=11, place=fluid.CPUPlace())
    done = 0
    with scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        done = resilience.resume_or_init(
            exe, startup, args.ckpt_dir, scope=scope, program=main_prog
        )
        print("RESUMED %d" % done, flush=True)
        while True:
            task = client.get_task()
            if task is None:
                break
            print("TASK %d" % task["id"], flush=True)
            if faults.fires("worker_die"):
                # simulated preemption: no task_finished, no checkpoint —
                # the task stays pending until the master's timeout requeues
                # it for a surviving/replacement worker
                print("DYING %d" % task["id"], flush=True)
                os._exit(3)
            recs = list(
                reader.creator.recordio(
                    task["path"], task["begin"], task["end"]
                )()
            )
            batch = {
                "x": np.stack([r[0] for r in recs]).astype(np.float32),
                "y": np.stack([r[1] for r in recs]).astype(np.float32),
            }
            exe.run(main_prog, feed=batch, fetch_list=[loss])
            client.task_finished(task["id"])
            done += 1
            # checkpoint AFTER finishing: a crash between the two at worst
            # re-trains one shard (at-least-once, the master's contract)
            ckpt.save_checkpoint(
                args.ckpt_dir,
                ckpt.snapshot_persistables(main_prog, scope),
                step=done,
            )
            if args.max_tasks and done >= args.max_tasks:
                break
    client.close()
    print("FINISHED %d" % done, flush=True)
    print("HEALTH " + json.dumps(health.snapshot()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
