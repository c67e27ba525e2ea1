"""A parameter-server cluster of processes on one machine: the roles, the
models, the shared initialization and the one-process reference.

The program is transpiled by DistributeTranspiler (sync or async mode,
min_block_size 1 as in the JAX package's distributed tests, optionally a
pserver-side gradient merge): each pserver runs its listen_and_serv program
(its optimizer blocks on its device), each trainer its rewritten program
(forward and backward on its device, then split, send, barriers, recv and
concat as host ops between captured segments). The parity math (sync mode):
the pservers sum the trainers' gradients, so T trainers on batches b_1..b_T
step as one process on concat(b_1..b_T) with T x lr under SGD, and with the
same lr under Adam (a gradient scaled by T scales both moments alike).

Models:
- mlp: fc 8 -> 16 relu -> 1, squared error (the JAX tests' dense case);
- word2vec: CBOW over a shared [64, 8] embedding table, row-sliced across
  the pservers (the sparse-model tier, reference dist_word2vec.py);
- deepfm: models/deepfm.py at profile_recsys's RECSYS widths (2^20 x 32,
  16 fields, batch 512, Adam with bf16 moments; the dense form), or any
  profile_recsys configuration given as --deepfm_cfg JSON.

A role runs as `python -m paddle_tpu_torch.tools.pserver_cluster --role
pserver|trainer --endpoints h:p,h:p ...` (the flags of `main`); `Cluster`
launches them. A pserver prints PSERVER_READY once its startup (and
--load_dir restore) ran; a trainer prints "HEALTH <json>" (the
resilience health counters), "READINGS <json>" (per-step walls,
the RPC bytes and the host ops' seconds, the fused families' dispatches and
the kernels' launches) and
"LOSSES <json>". --place cpu runs every role on the CPU; the default is
the card.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

DICT_DIM = 64
EMB_DIM = 8
CTX = 4


def deepfm_cfg(text=None):
    from . import profile_recsys

    return dict(profile_recsys.RECSYS, **json.loads(text)) if text else dict(profile_recsys.RECSYS)


def make_batch(model, trainer_id, step, bs=16, cfg=None):
    """The deterministic batch of (trainer, step), so a parity reference can
    rebuild the cluster's global schedule (the JAX tests' dist_runner)."""
    rng = np.random.RandomState(1000 * (trainer_id + 1) + step)
    if model == "mlp":
        w_true = np.random.RandomState(0).randn(8, 1).astype(np.float32)
        x = rng.randn(bs, 8).astype(np.float32)
        y = (np.abs(x) @ np.abs(w_true)) + 0.01 * rng.randn(bs, 1).astype(np.float32)
        return {"x": x, "y": y}
    if model == "word2vec":
        ctx = rng.randint(0, DICT_DIM, (bs, CTX)).astype("int64")
        tgt = ((ctx.sum(axis=1) + 1) % DICT_DIM).astype("int64")[:, None]
        return {"ctx": ctx, "target": tgt}
    if model == "deepfm":
        from .profile_recsys import recsys_batches

        cfg = cfg or deepfm_cfg()
        return recsys_batches(rng, cfg["rows"], cfg["fields"], cfg["batch"], 1)[0]
    raise ValueError(model)


def build(fluid, model, lr, with_eval=False, cfg=None, loss_scale=1):
    """(main, startup, loss[, eval clone]) of `model` in either package's
    fluid; with_eval adds a for_test clone taken before minimize. With
    loss_scale the optimizer minimizes loss_scale x loss (the fetched loss
    stays unscaled)."""
    eval_prog = None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if model == "mlp":
            x = fluid.layers.data(name="x", shape=[8], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            h = fluid.layers.fc(input=x, size=16, act="relu")
            pred = fluid.layers.fc(input=h, size=1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        elif model == "word2vec":
            ctx = fluid.layers.data(name="ctx", shape=[CTX], dtype="int64")
            target = fluid.layers.data(name="target", shape=[1], dtype="int64")
            emb = fluid.layers.embedding(input=ctx, size=[DICT_DIM, EMB_DIM],
                                         param_attr="shared_emb")
            bow = fluid.layers.reduce_sum(emb, dim=1)
            h = fluid.layers.fc(input=bow, size=EMB_DIM * 2, act="relu")
            logits = fluid.layers.fc(input=h, size=DICT_DIM)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, target))
        elif model == "deepfm":
            import importlib

            cfg = cfg or deepfm_cfg()
            deepfm = importlib.import_module(fluid.__name__.rsplit(".", 1)[0]
                                             + ".models.deepfm").deepfm
            ids = fluid.layers.data(name="ids", shape=[cfg["fields"], 1], dtype="int64")
            label = fluid.layers.data(name="label", shape=[1], dtype="float32")
            loss, _, _ = deepfm(ids, label, num_features=cfg["rows"], num_fields=cfg["fields"],
                                embedding_size=cfg["dim"], layer_sizes=cfg["layer_sizes"],
                                is_sparse=False)
        else:
            raise ValueError(model)
        if with_eval:
            eval_prog = main.clone(for_test=True)
        target = loss if loss_scale == 1 else fluid.layers.scale(loss, scale=float(loss_scale))
        if model == "deepfm" and cfg["optimizer"] == "adam":
            fluid.optimizer.Adam(learning_rate=lr, moment_dtype=cfg.get("moment_dtype")
                                 ).minimize(target)
        else:
            fluid.optimizer.SGD(learning_rate=lr).minimize(target)
    if with_eval:
        return main, startup, loss, eval_prog
    return main, startup, loss


def transpiler(fluid, main, startup, endpoints, trainer_id, trainers, sync_mode=True, gm_k=0,
               min_block_size=1):
    """A DistributeTranspiler of either package run over `main`."""
    transpiler_mod = __import__(fluid.__name__.rsplit(".", 1)[0] + ".transpiler",
                                fromlist=["DistributeTranspiler"])
    config = transpiler_mod.DistributeTranspilerConfig()
    config.min_block_size = min_block_size
    if gm_k:
        config.gradient_merge_k = gm_k
    t = transpiler_mod.DistributeTranspiler(config)
    t.transpile(trainer_id=trainer_id, program=main, pservers=endpoints, trainers=trainers,
                sync_mode=sync_mode, startup_program=startup)
    return t


def init_arrays(fluid, model, lr, n_pservers, place, cfg=None, seed=21):
    """The shared initialization of a parity run: the parameters of a
    seed-`seed` startup (trainers load them by name) plus their
    transpiler-sliced `.blockN` rows (the pservers load their shards). The
    pserver startup draws its initializers at shard shape, so without it
    the cluster and the one-process run start apart."""
    from ..framework import Parameter

    main, startup, _ = build(fluid, model, lr, cfg=cfg)
    scope = fluid.Scope(seed=seed, place=place)
    fluid.Executor(place).run(startup, scope=scope)
    params = {v.name: scope.find_var(v.name).detach().cpu() for v in main.list_vars()
              if isinstance(v, Parameter) and scope.find_var(v.name) is not None}
    eps = ",".join("127.0.0.1:%d" % (1 + i) for i in range(n_pservers))
    t = transpiler(fluid, main, startup, eps, 0, 2)
    arrays = dict(params)
    for pname, pblocks in t.param_blocks.items():
        if pname in params:
            for pb in pblocks:
                if pb.sliced:
                    arrays[pb.name()] = params[pname][pb.begin:pb.begin + pb.rows]
    return arrays


def _restore(scope, saved, shards):
    """Overlay saved arrays on a role's scope: names it holds (and, on a
    pserver, the __gm_* merge state); with `shards`, a trainer's params
    reassembled from their `.blockN` pieces by dim-0 concat."""
    import torch

    from ..executor import to_tensor

    mine = set(scope.var_names())
    groups = {}
    for name, arr in saved.items():
        if name in mine or (not shards and name.startswith("__gm_")):
            scope.set_var(name, to_tensor(arr, scope.device))
        elif shards and ".block" in name:
            base, _, idx = name.rpartition(".block")
            if base in mine:
                groups.setdefault(base, []).append((int(idx), arr))
    for base, parts in groups.items():
        arrs = [a for _, a in sorted(parts, key=lambda p: p[0])]
        scope.set_var(base, to_tensor(torch.cat(arrs, 0), scope.device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["pserver", "trainer"], required=True)
    ap.add_argument("--endpoints", required=True)  # comma-separated pservers
    ap.add_argument("--current_endpoint", default="")
    ap.add_argument("--trainer_id", type=int, default=0)
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--sync_mode", type=int, default=1)
    ap.add_argument("--model", default="mlp", choices=["mlp", "word2vec", "deepfm"])
    ap.add_argument("--deepfm_cfg", default="")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--gm_k", type=int, default=0)
    ap.add_argument("--save_dir", default="")
    ap.add_argument("--save_after", type=int, default=0)
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--start_step", type=int, default=0)
    ap.add_argument("--place", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--pipeline", default="")
    args = ap.parse_args(argv)

    import torch

    from .. import fluid, io
    from ..ops import dist_ops, fused
    from ..resilience import health

    torch.set_num_threads(1)
    place = fluid.CPUPlace() if args.place == "cpu" else fluid.CUDAPlace(0)
    if args.pipeline:
        fluid.set_flags({"pass_pipeline": args.pipeline})
    cfg = deepfm_cfg(args.deepfm_cfg) if args.model == "deepfm" else None
    main_prog, startup, loss = build(fluid, args.model, args.lr, cfg=cfg)
    t = transpiler(fluid, main_prog, startup, args.endpoints, args.trainer_id, args.trainers,
                   bool(args.sync_mode), args.gm_k)

    if args.role == "pserver":
        prog = t.get_pserver_program(args.current_endpoint)
        scope = fluid.Scope(seed=3, place=place)
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place)
            exe.run(t.get_startup_program(args.current_endpoint, prog))
            if args.load_dir:
                _restore(scope, io.load_arrays(args.load_dir), shards=False)
            print("PSERVER_READY", flush=True)
            exe.run(prog)  # blocks until every trainer sent COMPLETE
        return 0

    trainer_prog = t.get_trainer_program()
    losses, walls = [], []
    scope = fluid.Scope(seed=5, place=place)
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place)
        exe.run(startup)
        if args.load_dir:
            _restore(scope, io.load_arrays(args.load_dir), shards=True)
        dist_ops.reset_stats()
        fused.reset_stats()
        sent = received = 0
        for s in range(args.start_step, args.start_step + args.steps):
            feed = make_batch(args.model, args.trainer_id, s, cfg=cfg)
            t0 = time.perf_counter()
            (lv,) = exe.run(trainer_prog, feed=feed, fetch_list=[loss])
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
            if args.save_dir and args.trainer_id == 0 and \
                    s - args.start_step + 1 == args.save_after:
                ck = fluid.Program()
                ck.global_block().append_op(
                    type="checkpoint_notify", inputs={}, outputs={},
                    attrs={"dir": args.save_dir, "epmap": args.endpoints.split(","),
                           "trainer_id": args.trainer_id})
                exe.run(ck)
        from ..distributed.rpc import RPCClient

        client = RPCClient._instance
        if client is not None:
            sent, received = client.bytes_sent, client.bytes_received
        readings = {"walls_ms": walls, "bytes_sent": sent, "bytes_received": received,
                    "host_ops": {k: list(v) for k, v in dist_ops.stats().items()},
                    "launches": {k: v for k, v in fused.stats()["launches"].items() if v},
                    "dispatches": {k: v for k, v in fused.stats()["dispatches"].items() if v}}
        exe.close()  # SendComplete: the pservers exit once every trainer did
    print("HEALTH " + json.dumps(health.snapshot()), flush=True)
    print("READINGS " + json.dumps(readings), flush=True)
    print("LOSSES " + json.dumps(losses), flush=True)
    return 0


class Cluster:
    """Popen a pserver per endpoint and n trainers of this module's roles;
    collect the trainers' losses, readings and health; assert a clean
    teardown. `common` holds flags every role gets."""

    def __init__(self, endpoints, n_trainers=2, env=None, cwd=None, **common):
        self.eps = list(endpoints)
        self.endpoints = ",".join(self.eps)
        self.n_trainers = n_trainers
        self.common = common
        self.env = dict(os.environ if env is None else env)
        self.cwd = cwd
        self.procs = []
        self.stderr_files = {}

    def spawn(self, role, **kw):
        cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.pserver_cluster", "--role", role,
               "--endpoints", self.endpoints, "--trainers", str(self.n_trainers)]
        for k, v in dict(self.common, **kw).items():
            cmd += ["--%s" % k, str(v)]
        # stderr to a file: an undrained pipe would block a chatty child
        ef = tempfile.NamedTemporaryFile(mode="w+", prefix="ps_%s_" % role, suffix=".err",
                                         delete=False)
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=ef, text=True, env=self.env,
                             cwd=self.cwd)
        self.stderr_files[p] = ef
        self.procs.append(p)
        return p

    def child_stderr(self, p):
        ef = self.stderr_files[p]
        ef.flush()
        ef.seek(0)
        return ef.read()

    def start_pservers(self, timeout=120, **kw):
        """Spawn the pservers and wait (bounded) until each printed
        PSERVER_READY."""
        pservers = [self.spawn("pserver", current_endpoint=ep, **kw) for ep in self.eps]
        ready = {}

        def wait_ready(p):
            line = ""
            while "PSERVER_READY" not in line:
                line = p.stdout.readline()
                if not line and p.poll() is not None:
                    return
            ready[p] = True

        waiters = [threading.Thread(target=wait_ready, args=(p,), daemon=True)
                   for p in pservers]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join(timeout=timeout)
        for p in pservers:
            if not ready.get(p):
                raise AssertionError("pserver not ready:\n%s" % self.child_stderr(p)[-4000:])
        return pservers

    @staticmethod
    def parse(out, key):
        lines = [ln for ln in out.splitlines() if ln.startswith(key + " ")]
        return json.loads(lines[0][len(key) + 1:]) if lines else None

    def run(self, pserver_args=None, trainer_args=None, timeout=240):
        """The whole life of the cluster: [{"losses", "readings", "health",
        "out"} of each trainer]; every process exits 0."""
        pservers = self.start_pservers(**(pserver_args or {}))
        trainers = [self.spawn("trainer", trainer_id=i, **(trainer_args or {}))
                    for i in range(self.n_trainers)]
        results = []
        for tr in trainers:
            out, _ = tr.communicate(timeout=timeout)
            if tr.returncode != 0:
                raise AssertionError("trainer failed:\n%s\n%s" % (
                    self.child_stderr(tr)[-6000:],
                    "\n".join("pserver %d:\n%s" % (i, self.child_stderr(p)[-4000:])
                              for i, p in enumerate(pservers))))
            losses = self.parse(out, "LOSSES")
            if losses is None:
                raise AssertionError("no losses in trainer output:\n%s\n%s"
                                     % (out, self.child_stderr(tr)[-4000:]))
            results.append({"losses": losses, "readings": self.parse(out, "READINGS"),
                            "health": self.parse(out, "HEALTH"), "out": out})
        for p in pservers:
            p.wait(timeout=60)
            if p.returncode != 0:
                raise AssertionError("pserver exited %s:\n%s"
                                     % (p.returncode, self.child_stderr(p)[-6000:]))
        return results

    def cleanup(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for ef in self.stderr_files.values():
            name = ef.name
            ef.close()
            if os.path.exists(name):
                os.unlink(name)


def freeze_beta_pows(main):
    """Drop the `scale` ops that advance Adam's beta1^t / beta2^t
    accumulators: what a transpiled pserver computes. DistributeTranspiler
    moves only the update ops to the pservers (the JAX package's rule for
    Optimize-role ops that are not updates), so a pserver's Adam keeps its
    beta pows at their initial values while the trainer advances copies no
    update reads. Returns the number of ops dropped."""
    block = main.global_block()
    keep = [op for op in block.ops if not (
        op.type == "scale" and any("_beta1_pow_acc" in n or "_beta2_pow_acc" in n
                                   for n in op.output_arg_names))]
    dropped = len(block.ops) - len(keep)
    block.ops = keep
    main._bump_version()
    return dropped


def local_losses(fluid, model, lr, n_trainers, steps, place, gm_k=1, init=None, cfg=None,
                 seed=21, summed=False):
    """The parity reference: one process on the concatenated batch schedule
    (with `init` overlaid on its startup state). Returns (per-round losses
    on the concatenated batch, the scope): the mean over trainers of a
    cluster's per-trainer losses. By default it steps at n_trainers x lr
    (SGD's form of the pservers' summed gradients). `summed` instead
    minimizes n_trainers x the loss, whose gradient is the trainers' sum
    for any optimizer, and runs Adam as the pservers do
    (freeze_beta_pows)."""
    from ..resilience.checkpoint import overlay

    main, startup, loss, eval_prog = build(fluid, model, lr if summed else lr * n_trainers,
                                           with_eval=True, cfg=cfg,
                                           loss_scale=n_trainers if summed else 1)
    if summed:
        freeze_beta_pows(main)
    exe = fluid.Executor(place)
    scope = fluid.Scope(seed=seed, place=place)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        overlay(scope, init or {}, main)  # copies: the updates run in place
        window = []
        for s in range(steps):
            batches = [make_batch(model, t, s, cfg=cfg) for t in range(n_trainers)]
            concat = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            window.append(concat)
            if gm_k > 1:
                (lv,) = exe.run(eval_prog, feed=concat, fetch_list=[loss.name])
            if len(window) == gm_k:
                apply_feed = {k: np.concatenate([w[k] for w in window]) for k in window[0]}
                (out,) = exe.run(main, feed=apply_feed, fetch_list=[loss.name])
                if gm_k <= 1:
                    lv = out
                window = []
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
    return losses, scope


def local_grouped(fluid, model, lr, n_trainers, steps, place, init=None, cfg=None, seed=21):
    """The cluster's sync rounds in one process, grouped as the pservers
    group them: each step runs forward and backward on each trainer's batch
    (the trainer's shapes, so its kernels), sums the gradients, and runs
    the update ops alone on the sums (Adam with the beta pows frozen, as on
    the pservers). Returns (per-round mean of the per-batch losses, the
    scope)."""
    from ..framework import OpRole
    from ..resilience.checkpoint import overlay

    main, startup, loss = build(fluid, model, lr, cfg=cfg)
    freeze_beta_pows(main)
    is_opt = [bool(int(op.attrs.get(OpRole.OP_ROLE_KEY, 0)) & int(OpRole.Optimize))
              for op in main.global_block().ops]
    pairs = [tuple(op.attrs[OpRole.OP_ROLE_VAR_KEY][:2]) for op, o in
             zip(main.global_block().ops, is_opt) if o and op.attrs.get(OpRole.OP_ROLE_VAR_KEY)]
    grads = [g for _, g in pairs]
    grad_prog, apply_prog = main.clone(), main.clone()
    for prog, keep in ((grad_prog, False), (apply_prog, True)):
        blk = prog.global_block()
        blk.ops = [op for op, o in zip(blk.ops, is_opt) if o == keep]
        prog._bump_version()
    exe = fluid.Executor(place)
    scope = fluid.Scope(seed=seed, place=place)
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        overlay(scope, init or {}, main)  # copies: the updates run in place
        for s in range(steps):
            summed, step_losses = None, []
            for t in range(n_trainers):
                out = exe.run(grad_prog, feed=make_batch(model, t, s, cfg=cfg),
                              fetch_list=[loss.name] + grads, return_numpy=False)
                step_losses.append(float(out[0].reshape(-1)[0]))
                summed = [g.clone() for g in out[1:]] if summed is None else \
                    [a + b for a, b in zip(summed, out[1:])]
            exe.run(apply_prog, feed=dict(zip(grads, summed)))
            losses.append(float(np.mean(step_losses)))
    return losses, scope


if __name__ == "__main__":
    sys.exit(main())
