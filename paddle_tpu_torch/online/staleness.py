"""The staleness contract between an online trainer and its serving fleet
(the torch port of paddle_tpu/online/staleness.py: the same files, byte for
byte).

Reference analog: Downpour-style async training bounds how far a worker's
view may trail the parameter server; in the inverted (train→serve) direction
the bound is on the SERVER — how far the fleet may fall behind the stream.
The contract has three legs (docs/online.md):

- the publisher stamps every published version with the training step and
  wall time it was cut at (``stamp()``; the stamp rides the repository's
  LATEST.json pointer and each delta manifest);
- every consumer acknowledges the version it is actually serving by writing
  an atomic ``ack-<consumer>.json`` into the model repository
  (``write_ack``), and exposes ``online/serving_staleness_steps`` /
  ``online/serving_staleness_seconds`` gauges (set by the HotReloader);
- the trainer consults ``behind_steps`` before publishing and THROTTLES —
  skips the publish — once the slowest consumer trails by more than
  ``max_staleness_steps`` (StalenessContract.should_publish). Backpressure,
  not buffering: an unbounded publish backlog would only grow the delta
  chain a wedged server must eventually replay.

Everything here is pure bookkeeping over small JSON files; the atomic-write
ladder is borrowed from resilience.async_ckpt so a torn ack can never be
read back.
"""

import json
import os
import time

from ..resilience.async_ckpt import _atomic_write

__all__ = [
    "StalenessContract",
    "stamp",
    "write_ack",
    "read_acks",
    "behind_steps",
]

_ACK_PREFIX = "ack-"


def stamp(train_step, wall_time=None):
    """The publisher's version stamp: which training step cut this version,
    and when."""
    return {
        "train_step": int(train_step),
        "wall_time": float(time.time() if wall_time is None else wall_time),
    }


def write_ack(repo, consumer, version, stamp_dict):
    """Atomically record that `consumer` is now serving `version` (the
    version's publisher stamp rides along, so the trainer can compute
    step/second lag without reading any checkpoint)."""
    doc = {
        "consumer": str(consumer),
        "version": int(version),
        "train_step": int((stamp_dict or {}).get("train_step", version)),
        "stamp_wall_time": float((stamp_dict or {}).get("wall_time", 0.0)),
        "ack_wall_time": time.time(),
    }
    _atomic_write(
        os.path.join(repo, "%s%s.json" % (_ACK_PREFIX, consumer)),
        json.dumps(doc),
    )
    return doc


def read_acks(repo):
    """{consumer: ack dict} for every readable ack file; torn/unparseable
    acks are skipped (the writer is atomic, but a foreign file must not wedge
    the trainer)."""
    out = {}
    try:
        names = os.listdir(repo)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_ACK_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(repo, name)) as f:
                doc = json.load(f)
            out[doc.get("consumer", name[len(_ACK_PREFIX):-5])] = doc
        except (OSError, ValueError):
            continue
    return out


def behind_steps(repo, latest_train_step):
    """How many training steps the SLOWEST acknowledged consumer trails the
    given (about-to-be or just-published) version. No acks yet -> 0: a fleet
    that has not come up must not block the first publishes."""
    acks = read_acks(repo)
    if not acks:
        return 0
    slowest = min(int(a.get("train_step", 0)) for a in acks.values())
    return max(0, int(latest_train_step) - slowest)


class StalenessContract:
    """The trainer-side policy knobs, as one value object.

    max_staleness_steps bounds consumer lag in TRAINING steps (the publish
    throttle's trigger); max_staleness_seconds is the serving-side alerting
    bound the gauges are judged against (the reloader exports it as
    ``online/max_staleness_seconds`` so dashboards render the budget next to
    the measurement).
    """

    def __init__(self, max_staleness_steps=200, max_staleness_seconds=300.0):
        self.max_staleness_steps = int(max_staleness_steps)
        self.max_staleness_seconds = float(max_staleness_seconds)

    def should_publish(self, repo, train_step):
        """False iff publishing now would leave the slowest consumer more
        than max_staleness_steps behind `train_step` — the trainer then
        skips (throttles) and retries at the next interval."""
        return behind_steps(repo, train_step) <= self.max_staleness_steps

    def as_dict(self):
        return {
            "max_staleness_steps": self.max_staleness_steps,
            "max_staleness_seconds": self.max_staleness_seconds,
        }
