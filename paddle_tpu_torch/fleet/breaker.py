"""Per-replica circuit breaker: closed -> open -> half-open -> closed (a
copy of paddle_tpu/fleet/breaker.py).

The router's passive defense against a replica that is up but wrong — a
browned-out process answering every request with a timeout still costs each
client a full attempt deadline unless something stops sending traffic at it.
The breaker is that something:

- **closed** (normal): every request flows. Failures are counted two ways —
  a consecutive-failure streak (`failure_threshold`) for hard crashes, and a
  sliding-window error rate (`error_rate_threshold` over the last `window`
  outcomes, armed only past `min_requests`) for brown-outs that still answer
  sometimes. Either trips the breaker open.
- **open**: requests are refused locally (allow() == False) — the caller
  fails over to another replica without paying this one's timeout. After
  `open_for_s` the breaker lets PROBE traffic through (half-open).
- **half-open**: at most `half_open_probes` outstanding requests are let
  through as probes. `success_threshold` consecutive probe successes close
  the breaker (streaks and window reset); any probe failure reopens it with
  the open interval DOUBLED (capped at `max_open_s`) — a replica that keeps
  failing its probes gets exponentially less probe traffic, the same
  backoff-shape argument as retry.py.

`clock` is injectable (monotonic seconds) so the state machine unit-tests
run at zero wall time; `on_transition(name, old, new)` is the metrics hook
the router uses to count breaker flips.

Thread-safe: the router's handler threads record outcomes concurrently.
"""

import threading
import time

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, name="", failure_threshold=5, error_rate_threshold=0.5,
                 window=20, min_requests=10, open_for_s=2.0, max_open_s=30.0,
                 half_open_probes=1, success_threshold=2,
                 clock=time.monotonic, on_transition=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if not 0.0 < error_rate_threshold <= 1.0:
            raise ValueError("error_rate_threshold must be in (0, 1]")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.error_rate_threshold = float(error_rate_threshold)
        self.window = int(window)
        self.min_requests = int(min_requests)
        self.open_for_s = float(open_for_s)
        self.max_open_s = float(max_open_s)
        self.half_open_probes = int(half_open_probes)
        self.success_threshold = int(success_threshold)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes = []  # sliding window of 0/1 (1 = failure)
        self._consecutive_failures = 0
        self._probe_successes = 0
        self._probes_outstanding = 0
        self._opened_at = None
        self._open_interval = self.open_for_s
        self.opens = 0  # lifetime trips, for stats/tests

    # ------------------------------------------------------------ internals
    def _transition_locked(self, new):
        old, self._state = self._state, new
        if new == OPEN:
            self.opens += 1
            self._opened_at = self._clock()
        if new == CLOSED:
            self._outcomes = []
            self._consecutive_failures = 0
            self._open_interval = self.open_for_s
        if new in (CLOSED, HALF_OPEN):
            self._probe_successes = 0
            self._probes_outstanding = 0
        if self._on_transition is not None and old != new:
            self._on_transition(self.name, old, new)

    def _maybe_half_open_locked(self):
        if self._state == OPEN and (
            self._clock() - self._opened_at >= self._open_interval
        ):
            self._transition_locked(HALF_OPEN)

    # ------------------------------------------------------------------ api
    @property
    def state(self):
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def allow(self):
        """May a request be sent to this replica right now? In half-open
        this CLAIMS a probe slot — callers that get True must report the
        outcome via record_success/record_failure."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes_outstanding < self.half_open_probes:
                    self._probes_outstanding += 1
                    return True
            return False

    def record_success(self):
        with self._lock:
            self._consecutive_failures = 0
            self._push_outcome_locked(0)
            if self._state == HALF_OPEN:
                self._probes_outstanding = max(self._probes_outstanding - 1, 0)
                self._probe_successes += 1
                if self._probe_successes >= self.success_threshold:
                    self._transition_locked(CLOSED)

    def record_failure(self):
        with self._lock:
            self._consecutive_failures += 1
            self._push_outcome_locked(1)
            if self._state == HALF_OPEN:
                # a failed probe: back off harder before the next one
                self._open_interval = min(
                    self._open_interval * 2.0, self.max_open_s
                )
                self._transition_locked(OPEN)
                return
            if self._state != CLOSED:
                return
            if self._consecutive_failures >= self.failure_threshold:
                self._transition_locked(OPEN)
                return
            n = len(self._outcomes)
            if n >= self.min_requests:
                rate = sum(self._outcomes) / float(n)
                if rate >= self.error_rate_threshold:
                    self._transition_locked(OPEN)

    def _push_outcome_locked(self, failed):
        self._outcomes.append(failed)
        if len(self._outcomes) > self.window:
            self._outcomes.pop(0)

    def stats(self):
        with self._lock:
            self._maybe_half_open_locked()
            n = len(self._outcomes)
            return {
                "state": self._state,
                "opens": self.opens,
                "consecutive_failures": self._consecutive_failures,
                "window_error_rate": (
                    round(sum(self._outcomes) / float(n), 3) if n else 0.0
                ),
                "open_interval_s": self._open_interval,
            }
