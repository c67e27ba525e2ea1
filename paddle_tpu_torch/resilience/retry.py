"""Unified retry policy: bounded attempts, exponential backoff with jitter,
an overall deadline, and typed retryable-vs-fatal errors.

Reference analog: grpc_client.cc retried every RPC FLAGS_max_retry times
under FLAGS_rpc_deadline; the master client and the NCCL-id rendezvous each
had their own ad-hoc loops. Here one policy object expresses all of them:

    policy = RetryPolicy(max_attempts=4, base_delay=0.1, deadline=120.0)
    reply = policy.call(send_once)

Error typing contract:
- FatalError (or anything in `fatal`) aborts immediately — e.g. an RPC whose
  bytes may already have reached the server must not be resent.
- DeadlineExceeded is a TimeoutError: a hung peer surfaces as a typed,
  catchable error instead of an indefinite block.
- anything in `retryable` is retried until attempts or the deadline run out,
  then the LAST error is re-raised (types survive: callers still catch
  ConnectionError/TimeoutError exactly as before).
"""

import time
from random import Random

__all__ = ["RetryPolicy", "DeadlineExceeded", "FatalError"]


class FatalError(Exception):
    """Never retried. Wrap a cause with `FatalError(str(e))` + `from e`, or
    list domain exception types in RetryPolicy(fatal=...)."""


class DeadlineExceeded(TimeoutError):
    """A connect/read deadline or an overall retry deadline expired.
    TimeoutError => also an OSError, so pre-existing `except OSError`
    cleanup paths keep working.

    When raised by RetryPolicy.call the instance carries ``attempts`` — a
    list of ``(attempt_index, repr(error))`` pairs for every try made before
    the budget ran out — so the caller's error report (and the fleet
    router's 504 body) can show WHAT kept failing, not just that time ran
    out."""

    def __init__(self, *args):
        super().__init__(*args)
        self.attempts = []


class RetryPolicy:
    """One retryable call: `policy.call(fn)` runs fn up to max_attempts
    times, sleeping base_delay * multiplier**i (capped at max_delay, +/- a
    jitter fraction) between attempts, never past `deadline` seconds total.

    jitter="decorrelated" switches to decorrelated jitter: each pause is
    uniform(base_delay, 3 * previous pause), capped at max_delay. Unlike the
    +/-fraction form — where N processes sharing attempt counts stay packed
    in a narrow band around the same exponential schedule — successive draws
    diverge, so a fleet of hosts that failed together (every worker retrying
    `torch.distributed.init_process_group` against a store that isn't up
    yet)
    spreads out instead of thundering back in lockstep.

    `seed` makes the jitter sequence deterministic (resilience tests);
    `sleep` is injectable for zero-wall-clock unit tests.
    """

    def __init__(
        self,
        max_attempts=4,
        base_delay=0.1,
        max_delay=2.0,
        multiplier=2.0,
        jitter=0.25,
        deadline=None,
        retryable=(ConnectionError, TimeoutError, OSError, EOFError),
        fatal=(FatalError,),
        seed=None,
        sleep=time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.retryable = tuple(retryable)
        self.fatal = tuple(fatal)
        self._seed = seed
        self._rng = Random(seed)
        self._sleep = sleep
        self._prev = None  # decorrelated mode: last pause issued

    def with_deadline(self, budget_s):
        """A copy of this policy whose total time budget is `budget_s`
        seconds — the caller's REMAINING deadline, not a fresh one. The copy
        stops retrying the moment the next backoff pause would overrun the
        budget, raising DeadlineExceeded with the attempt history attached
        (``.attempts``). A zero/negative budget still allows exactly one
        attempt: the budget gates retries, never the first try.

        The copy has fresh jitter state (same seed), so handing one template
        policy to many concurrent requests stays race-free — each request
        derives its own."""
        return RetryPolicy(
            max_attempts=self.max_attempts,
            base_delay=self.base_delay,
            max_delay=self.max_delay,
            multiplier=self.multiplier,
            jitter=self.jitter,
            deadline=max(float(budget_s), 0.0),
            retryable=self.retryable,
            fatal=self.fatal,
            seed=self._seed,
            sleep=self._sleep,
        )

    def backoff(self, attempt):
        """Delay before retrying after 0-based `attempt` (jittered)."""
        if self.jitter == "decorrelated":
            prev = self._prev if self._prev is not None else self.base_delay
            d = self._rng.uniform(self.base_delay, max(prev * 3.0,
                                                       self.base_delay))
            d = min(d, self.max_delay)
            self._prev = d
            return max(d, 0.0)
        d = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(d, 0.0)

    def call(self, fn, *args, on_retry=None, **kwargs):
        """Run fn(*args, **kwargs) under this policy. `on_retry(attempt, err)`
        is invoked before each backoff sleep (logging/metrics hook)."""
        start = time.monotonic()
        last = None
        history = []
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.fatal:
                raise
            except self.retryable as e:
                last = e
                history.append((attempt, repr(e)))
                if attempt + 1 >= self.max_attempts:
                    break
                pause = self.backoff(attempt)
                if self.deadline is not None:
                    remaining = self.deadline - (time.monotonic() - start)
                    if remaining <= pause:
                        err = DeadlineExceeded(
                            "retry deadline %.1fs exhausted after %d attempts"
                            % (self.deadline, attempt + 1)
                        )
                        err.attempts = history
                        raise err from e
                if on_retry is not None:
                    on_retry(attempt, e)
                self._sleep(pause)
        raise last
