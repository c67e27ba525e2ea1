"""Deterministic fault injection (the JAX package's resilience/faults.py,
copied: the same spec syntax and seeded firing).

A FaultPlan is parsed from the PADDLE_TPU_FAULTS env var (or installed
programmatically) and consulted at named hook points in the runtime:

    PADDLE_TPU_FAULTS="rpc_drop:0.1@seed=7,nan_grad:step=12,ckpt_crash:step=20"

Spec grammar (comma-separated `kind:args`, args joined with `@`):
  0.1        probability per hook invocation (seeded RNG; deterministic)
  seed=7     RNG seed for probability draws (default: crc32 of the kind, so
             every kind is deterministic even without an explicit seed)
  step=12    fire exactly on the 12th invocation of the hook (1-based)
  every=5    fire on every 5th invocation
  after=20   invocations <= 20 never fire (offsets step=/every=/prob)
  ms=50      payload for delay-style hooks (milliseconds)
A bare `kind` with no args always fires.

Hook points wired in this package:
  rpc_drop / rpc_delay      distributed/rpc.py   RPCClient._rpc, pre-send
  master_conn_drop          distributed/master.py  server conn handler
  snapshot_crash            distributed/master.py  between tmp write + rename
  ckpt_crash                io.py save_arrays      between tmp write + rename
  manifest_crash            resilience/checkpoint.py  before MANIFEST commit
  nan_grad                  executor.py            poisons a training step
  worker_die                trainer loops          hard-exits
  eckpt_commit_crash        resilience/async_ckpt.py  before the commit marker
  preempt                   resilience/elastic.py  SIGTERM to self (the cloud
                            preemption notice, injectable)
  hang                      resilience/elastic.py  sleeps spec.ms inside the
                            supervised step window (trips the watchdog)
  replica_kill              serving/server.py      SIGKILLs the serving
                            process before it answers (a replica dying
                            mid-request)
  conn_reset                serving/server.py      closes the client socket
                            without replying (a half-open connection: the
                            client sees a reset/empty response, the server
                            never processed the request)
  slow_response             serving/server.py      sleeps spec.ms before
                            handling (a browned-out replica)

Every decision is made from per-kind invocation counters plus a per-kind
seeded RNG, so the same plan + the same call sequence replays the same
faults — the property the resilience tests assert against.
"""

import os
import threading
import time
import zlib
from random import Random

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "active",
    "crash",
    "delay",
    "fires",
    "hang",
    "install",
    "kill_self",
    "preempt_self",
    "reset",
]

ENV_VAR = "PADDLE_TPU_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by crash-style hooks; never raised unless a plan says so."""


class _Spec:
    def __init__(self, kind):
        self.kind = kind
        self.prob = None
        self.step = None
        self.every = None
        self.after = 0
        self.ms = 50.0
        self.seed = None

    def __repr__(self):
        return "_Spec(%s)" % ", ".join(
            "%s=%r" % (k, v) for k, v in sorted(vars(self).items()) if v is not None
        )


def _parse_spec(text):
    kind, _, args = text.strip().partition(":")
    if not kind:
        raise ValueError("empty fault kind in %r" % text)
    spec = _Spec(kind)
    bare = True
    for part in filter(None, (p.strip() for p in args.split("@"))):
        key, eq, val = part.partition("=")
        if not eq:
            spec.prob = float(part)  # "rpc_drop:0.1"
            bare = False
            continue
        if key == "seed":
            spec.seed = int(val)
            continue  # seed alone doesn't make the spec non-bare
        if key in ("step", "every", "after"):
            setattr(spec, key, int(val))
        elif key == "ms":
            spec.ms = float(val)
        else:
            raise ValueError("unknown fault arg %r in %r" % (key, text))
        if key != "ms":
            bare = False
    if bare and spec.prob is None:
        spec.prob = 1.0  # bare kind: always fire
    return spec


class FaultPlan:
    """Parsed fault specs + per-kind counters and RNGs. Thread-safe: hook
    points are hit concurrently from RPC pool workers and server threads."""

    def __init__(self, specs=()):
        self._specs = {s.kind: s for s in specs}
        self._counts = {}
        self._rngs = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, text):
        text = (text or "").strip()
        if not text:
            return cls()
        return cls(_parse_spec(p) for p in text.split(",") if p.strip())

    @classmethod
    def from_env(cls, environ=None):
        return cls.parse((environ or os.environ).get(ENV_VAR, ""))

    def __bool__(self):
        return bool(self._specs)

    def kinds(self):
        return sorted(self._specs)

    def spec(self, kind):
        return self._specs.get(kind)

    def count(self, kind):
        """Invocations of the hook so far (for tests/diagnostics)."""
        with self._lock:
            return self._counts.get(kind, 0)

    def fires(self, kind):
        """One hook invocation: advance the counter, decide deterministically."""
        spec = self._specs.get(kind)
        if spec is None:
            return False
        with self._lock:
            n = self._counts.get(kind, 0) + 1
            self._counts[kind] = n
            if n <= spec.after:
                return False
            if spec.step is not None:
                return n - spec.after == spec.step
            if spec.every is not None:
                return (n - spec.after) % spec.every == 0
            rng = self._rngs.get(kind)
            if rng is None:
                seed = spec.seed if spec.seed is not None else zlib.crc32(
                    kind.encode()
                )
                rng = self._rngs[kind] = Random(seed)
            return rng.random() < spec.prob


# --------------------------- process-wide plan ----------------------------

_lock = threading.Lock()
_plan = None
_loaded = False


def active():
    """The installed plan, lazily parsed from PADDLE_TPU_FAULTS on first use.
    Returns None when no faults are configured (the common case: one dict
    probe per hook, no RNG, no lock)."""
    global _plan, _loaded
    if not _loaded:
        with _lock:
            if not _loaded:
                plan = FaultPlan.from_env()
                _plan = plan if plan else None
                _loaded = True
    return _plan


def install(plan):
    """Install a FaultPlan (or a spec string, or None to disable). Tests use
    this for in-process injection; subprocesses inherit the env var instead."""
    global _plan, _loaded
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    with _lock:
        _plan = plan if plan else None
        _loaded = True
    return _plan


def reset():
    """Forget the installed plan; the next hook re-reads the env var."""
    global _plan, _loaded
    with _lock:
        _plan = None
        _loaded = False


def fires(kind):
    plan = active()
    return plan.fires(kind) if plan is not None else False


def crash(kind, detail=""):
    """Crash-style hook: raise InjectedFault when the plan says so. Placed
    between a temp-file write and its rename, this simulates a process dying
    mid-commit — the torn state a recovery path must tolerate."""
    if fires(kind):
        raise InjectedFault(
            "injected fault %r%s" % (kind, (": " + detail) if detail else "")
        )


def delay(kind):
    """Delay-style hook: sleep spec.ms when the plan says so."""
    plan = active()
    if plan is not None and plan.fires(kind):
        spec = plan.spec(kind)
        time.sleep((spec.ms if spec else 50.0) / 1000.0)
        return True
    return False


def preempt_self(kind="preempt"):
    """Preemption-style hook: deliver SIGTERM to this process when the plan
    says so — the injectable stand-in for a cloud preemption notice, so the
    drain path (elastic.Supervisor) soaks under PADDLE_TPU_FAULTS like every
    other failure mode. The signal is delivered synchronously: when this
    returns True the handler has already run."""
    if fires(kind):
        import signal as _signal

        os.kill(os.getpid(), _signal.SIGTERM)
        return True
    return False


def kill_self(kind="replica_kill"):
    """Hard-death hook: deliver SIGKILL to this process when the plan says
    so — no handlers, no drain, no atexit; the closest injectable stand-in
    for an OOM kill or a host loss. Unlike preempt_self there is nothing to
    observe afterwards in-process: the return value only matters when the
    plan did NOT fire."""
    if fires(kind):
        import signal as _signal

        os.kill(os.getpid(), _signal.SIGKILL)
        return True  # pragma: no cover - unreachable after SIGKILL
    return False


def hang(kind="hang"):
    """Hang-style hook: sleep spec.ms when the plan says so. Placed inside
    the supervised step window, a `hang:ms=...` spec past the step deadline
    trips the elastic watchdog exactly like a wedged collective would."""
    return delay(kind)
