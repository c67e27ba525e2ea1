"""Elastic training supervision: watchdog, NaN escalation, preemption drain,
and topology-changing resume (the JAX package's resilience/elastic.py on
torch).

Reference analog: the Go master's trainer elasticity — tasks lease-timeout
back into a todo queue when a trainer dies (go/master/service.go), etcd
snapshots make the master itself restartable, and the fault-tolerant mode's
trainers could join/leave freely. Here the same survival contract wraps the
SPMD training loop:

- `Supervisor.run_step` brackets `Executor.run` with a step-deadline
  watchdog (hang → health counter → emergency checkpoint → FatalError),
  escalates NaN storms past the executor's single-step guard by rolling
  back to the last committed elastic checkpoint under a bounded retry
  budget, and turns SIGTERM (or `PADDLE_TPU_FAULTS=preempt`) into an
  emergency snapshot + clean data drain + typed `Preempted` exit.
- `resume_or_init` restores from the newest recoverable checkpoint in
  EITHER format (elastic eckpt-* preferred, the manifest ckpt-* as fallback) and
  returns the manifest's data cursor, so the loop resumes exactly-once on
  data as well as state.
- The restore is topology-blind: `async_ckpt.load_elastic` reassembles full
  arrays from shards + replicas, the overlay lands them in the scope as
  tensors on its device, and the next executor run places them on whatever
  mesh is live: a dp=N/ep=K checkpoint resumes on dp=M/ep=J. On the card a
  name whose tensor a captured graph holds is rebound, and the graph's next
  replay copies the value into its own tensor.
  `derive_data_shards` re-derives the matching data assignment for the new
  host count from the cursor's (seed, epoch) via data/sharding's pure
  functions.

See docs/resilience.md for the drain semantics and topology-resume matrix.
"""

import signal
import threading
import time

import numpy as np
import torch

from . import async_ckpt, checkpoint, faults, health
from .retry import FatalError

__all__ = [
    "Supervisor",
    "Preempted",
    "resume_or_init",
    "derive_data_shards",
    "heartbeat",
]


class Preempted(Exception):
    """Raised by Supervisor after a CLEAN preemption exit: the emergency
    checkpoint committed and the data runtime drained. Exiting 0 on this is
    correct — the next incarnation resumes from the manifest."""


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


def _flag(name):
    from .. import flags as _flags

    return _flags.get_flags(name)[name]


# ----------------------------------------------------------- heartbeat bus

_watchers = []
_watchers_lock = threading.Lock()


def heartbeat():
    """Progress beat consulted by the step-deadline watchdog. Executor.run
    calls this at every entry — module-level so the executor never needs a
    Supervisor reference, and a no-op (one list probe) when no watchdog is
    installed."""
    if _watchers:
        now = time.monotonic()
        with _watchers_lock:
            for w in _watchers:
                w.beat(now)


class _Watchdog:
    """Step-deadline monitor: while a supervised step is in flight, a daemon
    thread checks that a heartbeat arrived within `deadline_s`. Detection is
    a flag the Supervisor acts on when (if) the step returns — the watchdog
    itself never mutates training state from its thread; it only counts and,
    for a truly wedged process, leaves the operator a health record."""

    def __init__(self, deadline_s):
        self.deadline = float(deadline_s)
        self._beat = time.monotonic()
        self._in_step = False
        self._stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="elastic-watchdog"
        )

    def start(self):
        with _watchers_lock:
            _watchers.append(self)
        self._thread.start()

    def stop(self):
        self._stop.set()
        with _watchers_lock:
            if self in _watchers:
                _watchers.remove(self)

    def beat(self, now=None):
        self._beat = now if now is not None else time.monotonic()

    def begin_step(self):
        self._stalled = False
        self.beat()
        self._in_step = True

    def end_step(self):
        self._in_step = False
        return self._stalled

    def _loop(self):
        poll = max(0.01, self.deadline / 4.0)
        while not self._stop.wait(poll):
            if not self._in_step or self._stalled:
                continue
            if time.monotonic() - self._beat > self.deadline:
                self._stalled = True
                health.incr("watchdog_stalls")
                from ..observability import flightrec as _flightrec

                _flightrec.trigger("watchdog_stall", deadline_s=self.deadline)
                try:
                    _registry().counter(
                        "resilience/watchdog_stalls",
                        help="steps that exceeded the elastic step deadline",
                    ).inc()
                except Exception:
                    pass


# ------------------------------------------------------------- supervision


class Supervisor:
    """Wraps a trainer loop's `Executor.run` calls with the elastic survival
    contract. Typical use:

        sup = Supervisor(exe, ckpt_root, program=main_prog,
                         num_hosts=H, host_id=h, ckpt_every=10)
        step, cursor = sup.resume_or_init(startup_prog)
        with sup:                       # installs SIGTERM handler + watchdog
            for step in range(step, total):
                loss, = sup.run_step(program=main_prog, feed=batch(step),
                                     fetch_list=[loss_var])

    `ckpt_every=0` disables periodic saves (the caller drives `save()`).
    Deadlines/budgets default from FLAGS_elastic_* (flags.py).
    """

    def __init__(
        self,
        exe,
        root,
        program=None,
        scope=None,
        num_hosts=1,
        host_id=0,
        topology=None,
        ckpt_every=0,
        keep_last=3,
        reader=None,
        step_deadline_s=None,
        nan_budget=None,
        rollback_budget=None,
        checkpointer=None,
    ):
        self.exe = exe
        self.root = root
        self.program = program
        self.scope = scope
        self.num_hosts = int(num_hosts)
        self.host_id = int(host_id)
        self.ckpt_every = int(ckpt_every)
        self.reader = reader
        self.step_deadline_s = (
            float(step_deadline_s) if step_deadline_s is not None
            else float(_flag("elastic_step_deadline_s"))
        )
        self.nan_budget = (
            int(nan_budget) if nan_budget is not None
            else int(_flag("elastic_nan_budget"))
        )
        self.rollback_budget = (
            int(rollback_budget) if rollback_budget is not None
            else int(_flag("elastic_rollback_budget"))
        )
        if topology is None and hasattr(exe, "topology"):
            topology = exe.topology
        self.topology = dict(topology or {})
        self.checkpointer = checkpointer or async_ckpt.AsyncCheckpointer(
            root, num_hosts=self.num_hosts, host_id=self.host_id,
            keep_last=keep_last, topology=self.topology,
        )
        self.step = 0
        self.cursor = {"epoch": 0, "batch_index": 0, "seed": 0}
        self._preempt = False
        self._bad_steps = 0
        self._rollbacks = 0
        self._watchdog = None
        self._prev_sigterm = None
        self._nan_base = health.get("nan_steps_skipped")

    # ---------------------------------------------------------- lifecycle
    def __enter__(self):
        if self.step_deadline_s > 0:
            self._watchdog = _Watchdog(self.step_deadline_s)
            self._watchdog.start()
        # SIGTERM is the cloud's preemption notice (and the `preempt` fault
        # kind's delivery vehicle); only the main thread may install
        try:
            self._prev_sigterm = signal.signal(
                signal.SIGTERM, self._on_sigterm
            )
        except ValueError:
            self._prev_sigterm = None
        return self

    def __exit__(self, *exc):
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self.checkpointer.close()
        return False

    def _on_sigterm(self, signum, frame):
        self._preempt = True
        health.incr("preempt_signals")

    # ------------------------------------------------------------- state
    def _state(self):
        """name -> live scope value for every checkpointable var of the
        supervised program (persistables minus gradient staging, the
        save_persistables set). Values stay device tensors here: the host
        copy happens inside AsyncCheckpointer.save, where it is the measured
        stall."""
        from ..executor import global_scope

        if self.program is None:
            raise ValueError("Supervisor needs `program=` to checkpoint")
        return checkpoint.checkpointable(self.program, self.scope or global_scope())

    def save(self, block=False):
        """Checkpoint now (async unless block). Records step + data cursor
        in the manifest; returns the step-visible stall in seconds."""
        return self.checkpointer.save(
            self._state(), self.step, cursor=dict(self.cursor), block=block
        )

    def resume_or_init(self, startup_program, program=None):
        """Run startup, then overlay the newest recoverable checkpoint (any
        format, any topology). Returns (step, cursor) and primes the
        supervisor's own step/cursor."""
        step, cursor = resume_or_init(
            self.exe, startup_program, self.root,
            scope=self.scope, program=program or self.program,
        )
        self.step = step
        if cursor:
            self.cursor = dict(cursor)
        return step, self.cursor

    # ---------------------------------------------------------- stepping
    def run_step(self, advance_cursor=True, **run_kwargs):
        """One supervised training step: preemption check → injectable
        hang → watched Executor.run → watchdog/NaN/preemption escalation →
        cursor advance → periodic checkpoint. Returns Executor.run's result."""
        self._check_preempt()
        faults.preempt_self()  # PADDLE_TPU_FAULTS=preempt → SIGTERM to self
        self._check_preempt()
        wd = self._watchdog
        if wd is not None:
            wd.begin_step()
        try:
            faults.hang()  # PADDLE_TPU_FAULTS=hang:ms=... sleeps in-window
            fetches = self.exe.run(**run_kwargs)
        finally:
            stalled = wd.end_step() if wd is not None else False
        if stalled:
            self._emergency("step exceeded deadline %.3fs"
                            % self.step_deadline_s)
        bad = self._nan_this_step(fetches)
        if bad:
            self._escalate_nan()
        else:
            self._bad_steps = 0
            self.step += 1
            if advance_cursor:
                self.cursor["batch_index"] = (
                    int(self.cursor.get("batch_index", 0)) + 1
                )
            if self.ckpt_every and self.step % self.ckpt_every == 0:
                self.save()
        self._check_preempt()
        return fetches

    def next_epoch(self, epoch=None):
        """Advance the data cursor to a new epoch (batch index rewinds)."""
        self.cursor["epoch"] = (
            int(epoch) if epoch is not None
            else int(self.cursor.get("epoch", 0)) + 1
        )
        self.cursor["batch_index"] = 0

    # --------------------------------------------------------- escalation
    def _nan_this_step(self, fetches):
        """Did this step go bad? Either the executor's NaN guard skipped it
        (health counter advanced) or — guard off — a fetched loss is
        non-finite."""
        skipped = health.get("nan_steps_skipped")
        if skipped > self._nan_base:
            self._nan_base = skipped
            return True
        try:
            for f in fetches or ():
                if isinstance(f, torch.Tensor):
                    if f.is_floating_point() and not bool(torch.isfinite(f).all()):
                        return True
                    continue
                a = np.asarray(f)
                if a.dtype.kind == "f" and not np.isfinite(a).all():
                    return True
        except Exception:
            pass
        return False

    def _escalate_nan(self):
        self._bad_steps += 1
        if self._bad_steps <= self.nan_budget:
            return  # the executor guard's skip-and-decay may still recover
        self._rollbacks += 1
        try:
            _registry().counter(
                "resilience/rollbacks",
                help="NaN-storm rollbacks to the last committed checkpoint",
            ).inc()
        except Exception:
            pass
        health.incr("elastic_rollbacks")
        if self._rollbacks > self.rollback_budget:
            raise FatalError(
                "NaN storm persisted through %d rollback(s) — training "
                "cannot make progress from this state" % self.rollback_budget
            )
        self.rollback()
        self._bad_steps = 0

    def rollback(self):
        """Restore scope + step + data cursor from the newest recoverable
        checkpoint. The poisoned optimizer state is discarded wholesale —
        the executor guard's per-step snapshot cannot help once several
        consecutive steps landed bad updates."""
        self.checkpointer.wait()
        found = async_ckpt.latest_valid_elastic(self.root)
        if found is None:
            raise FatalError(
                "rollback requested but no recoverable checkpoint under %r"
                % self.root
            )
        _step, ckpt_dir = found
        step, arrays, manifest = async_ckpt.load_elastic(ckpt_dir)
        self._overlay(arrays)
        self.step = step
        if manifest.get("cursor"):
            self.cursor = dict(manifest["cursor"])
        self._nan_base = health.get("nan_steps_skipped")

    def _overlay(self, arrays):
        from ..executor import global_scope

        checkpoint.overlay(self.scope or global_scope(), arrays, self.program)

    def _emergency(self, why):
        """Hang/deadline path: persist what we have, then surface a typed
        fatal error for the job scheduler to restart us."""
        health.incr("emergency_checkpoints")
        try:
            self.save(block=True)
        except Exception:
            health.incr("emergency_checkpoint_failed")
        raise FatalError("elastic supervisor: %s" % why)

    # --------------------------------------------------------- preemption
    def _check_preempt(self):
        if not self._preempt:
            return
        try:
            _registry().counter(
                "resilience/preemptions",
                help="SIGTERM/preempt-fault drains handled",
            ).inc()
        except Exception:
            pass
        health.incr("preemptions")
        self.save(block=True)  # emergency commit BEFORE touching the reader
        self.drain()
        raise Preempted(
            "preemption notice honored: checkpoint committed at step %d, "
            "data runtime drained" % self.step
        )

    def drain(self):
        """Stop data producers and discard in-flight batches — the clean
        half-close a preemption grace period allows. Prefers the runtime's
        first-class drain(), falls back to reset(), always best-effort:
        a wedged reader must not block the exit path."""
        r = self.reader
        if r is None:
            return
        for meth in ("drain", "reset"):
            fn = getattr(r, meth, None)
            if fn is None:
                continue
            try:
                fn()
                break
            except Exception:
                continue
        closer = getattr(r, "close", None)
        if closer is not None:
            try:
                closer()
            except Exception:
                pass


# ------------------------------------------------------- elastic resume


def resume_or_init(exe, startup_program, root, scope=None, program=None):
    """Topology-aware trainer-loop entry: run the startup program, then
    overlay the newest recoverable checkpoint under `root` — elastic
    (eckpt-*, shards + replicas, any saved topology) preferred over the
    manifest format (checkpoint.py, ckpt-*) when both exist at different steps.
    Returns (completed steps, data cursor dict) — (0, {}) for a fresh start.

    Re-sharding is implicit: the overlay lands FULL arrays in the scope and
    the next executor run places them on the live mesh, so the checkpoint's
    dp/ep and the resume's dp/ep are independent."""
    from ..executor import global_scope

    exe.run(startup_program)
    scope = scope or global_scope()
    elastic = async_ckpt.latest_valid_elastic(root)
    classic = checkpoint.latest_valid_dir(root)
    e_step = elastic[0] if elastic else -1
    c_step = classic[0] if classic else -1
    if e_step < 0 and c_step < 0:
        return 0, {}
    if e_step >= c_step:
        step, arrays, manifest = async_ckpt.load_elastic(elastic[1])
        cursor = dict(manifest.get("cursor") or {})
    else:
        from .. import io as fluid_io

        step, arrays = c_step, fluid_io.load_arrays(classic[1])
        cursor = {}
    checkpoint.overlay(scope, arrays, program)
    health.incr("resumed_from_checkpoint")
    try:
        _registry().counter(
            "resilience/recoveries",
            help="successful restore-from-checkpoint resumes",
        ).inc()
    except Exception:
        pass
    return step, cursor


def derive_data_shards(cursor, num_hosts, host_id, num_shards):
    """Re-derive this host's data-shard assignment for the cursor's epoch on
    a NEW topology. Pure function of (seed, epoch, num_shards, num_hosts) —
    the same data/sharding.py permutation every host computes independently,
    so after an elastic resize the union over hosts still covers every shard
    exactly once per epoch."""
    from ..data import sharding as dsh

    order = dsh.epoch_shard_order(
        int(num_shards),
        int((cursor or {}).get("seed", 0)),
        int((cursor or {}).get("epoch", 0)),
    )
    return dsh.host_shards(order, int(num_hosts), int(host_id))
