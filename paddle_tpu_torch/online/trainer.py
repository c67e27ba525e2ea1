"""OnlineTrainer — streaming training that feeds the serving fleet (the
torch port of paddle_tpu/online/trainer.py).

Composition, not a new runtime: the resilience.Supervisor still owns
every step (watchdog, NaN escalation, preemption, periodic FULL-state
checkpoints for trainer resume), and this class adds the publishing loop on
top — every ``publish_interval`` successful steps it snapshots the SERVE
set (the inference-visible params, typically save_inference_model's
persistables) out of the scope and hands it to a ModelPublisher, which cuts
a base or a delta into the model repository.

Two checkpoint streams, two directories, on purpose (docs/online.md):

- ``<repo>``             — serve-only versions (base + deltas + LATEST.json),
                           consumed by HotReloaders; never used for resume;
- ``<repo>/trainer``     — the Supervisor's full-state eckpts (params AND
                           optimizer moments AND data cursor), used only by
                           ``resume()``. Publishing a serve-only base into
                           the same root would become the "newest
                           recoverable checkpoint" and silently drop the
                           optimizer state on the next resume.

Embedding deltas ride the SelectedRows gradient rows: each step fetches
every engine's ``<table>@GRAD@ROWS`` var and feeds it to
``EmbeddingEngine.note_touched``; at publish time ``touched_rows_since``
yields exactly the rows written since the last publish. Dense params ship
only when their values changed (the publisher's snapshot diff). The serve
set handed to the publisher is the scope's own tensors, on the card when
the trainer runs there; the publisher gathers touched rows on the device.
"""

import os

import numpy as np

from ..resilience import elastic as _elastic
from . import publisher as _publisher
from . import staleness as _staleness

__all__ = ["OnlineTrainer"]


def _registry():
    from ..observability.registry import default_registry

    return default_registry()


class OnlineTrainer:
    """Supervised streaming trainer publishing into a model repository."""

    def __init__(self, exe, program, repo, serve_names, publisher=None,
                 publish_interval=20, embeddings=None, scope=None,
                 trainer_root=None, ckpt_every=0, contract=None,
                 num_hosts=1, host_id=0):
        from ..embedding import engines_of

        self.exe = exe
        self.program = program
        self.repo = repo
        self.serve_names = list(serve_names)
        self.publish_interval = int(publish_interval)
        self.scope = scope
        self.embeddings = (
            list(embeddings) if embeddings is not None
            else engines_of(program)
        )
        self.publisher = publisher or _publisher.ModelPublisher(
            repo, num_hosts=num_hosts, host_id=host_id,
            contract=contract or _staleness.StalenessContract(),
        )
        self.sup = _elastic.Supervisor(
            exe, trainer_root or os.path.join(repo, "trainer"),
            program=program, scope=scope,
            num_hosts=num_hosts, host_id=host_id, ckpt_every=int(ckpt_every),
        )
        # rows vars exist only for engines whose grad actually flows as
        # SelectedRows in this program; fetch what's there, skip the rest
        block = program.global_block()
        self._rows_fetch = [
            e.touched_rows_var_name()
            for e in self.embeddings
            if e.touched_rows_var_name() in block.vars
        ]
        self._last_pub_step = 0
        self.steps = 0
        reg = _registry()
        self._m_steps = reg.counter(
            "online/train_steps", "stream batches trained"
        )
        self._m_rows = reg.counter(
            "online/rows_trained", "samples consumed off the stream"
        )

    # -------------------------------------------------------------- resume
    def resume(self, startup_program):
        """Run startup then overlay the newest full-state trainer
        checkpoint; primes step + data cursor. Returns (step, cursor)."""
        return self.sup.resume_or_init(startup_program)

    # ----------------------------------------------------------------- run
    def run(self, stream, fetch_list=None, max_steps=None):
        """Consume `stream` (an iterator of feed dicts — see
        async_executor.stream_batches — or any generator) until it drains or
        `max_steps` land. Publishes every `publish_interval` successful
        steps, subject to the staleness throttle. Returns the list of first-
        fetch means per publish interval (the online loss curve)."""
        fetch_list = list(fetch_list or [])
        curve = []
        window = []
        with self.sup:
            for feed in stream:
                fetches = self.sup.run_step(
                    program=self.program, feed=feed,
                    fetch_list=fetch_list + self._rows_fetch,
                    scope=self.scope,
                )
                user = fetches[: len(fetch_list)]
                rows_vals = fetches[len(fetch_list):]
                self._note_touched(rows_vals)
                self.steps += 1
                self._m_steps.inc()
                if feed:
                    first = next(iter(feed.values()))
                    self._m_rows.inc(int(np.asarray(first).shape[0]))
                if user:
                    window.append(float(np.asarray(user[0]).reshape(-1)[0]))
                if self.publish_interval and \
                        self.sup.step % self.publish_interval == 0:
                    self.maybe_publish()
                    if window:
                        curve.append(float(np.mean(window)))
                        window.clear()
                if max_steps is not None and self.steps >= int(max_steps):
                    break
        if window:
            curve.append(float(np.mean(window)))
        return curve

    def _note_touched(self, rows_vals):
        by_name = dict(zip(self._rows_fetch, rows_vals))
        for e in self.embeddings:
            val = by_name.get(e.touched_rows_var_name())
            if val is not None:
                e.note_touched(self.sup.step, np.asarray(val))

    # ------------------------------------------------------------- publish
    def maybe_publish(self, force_base=False):
        """Publish the serve set now unless the staleness throttle says the
        fleet is too far behind. Returns the committed pointer or None."""
        if not force_base and not self.publisher.should_publish(self.sup.step):
            from ..observability import flightrec as _flightrec

            _flightrec.trigger("staleness_throttle", step=self.sup.step)
            return None
        return self.publish(force_base=force_base)

    def publish(self, force_base=False):
        """Unconditionally cut a version from the live scope."""
        from ..executor import global_scope

        scope = self.scope or global_scope()
        arrays = {}
        for name in self.serve_names:
            val = scope.find_var(name)
            if val is None:
                raise KeyError("serve var %r absent from scope" % name)
            arrays[name] = val
        touched = {
            e.table.name: e.touched_rows_since(self._last_pub_step)
            for e in self.embeddings
            if e.table.name in arrays
        }
        rec = self.publisher.publish(
            arrays, self.sup.step, touched=touched,
            cursor=dict(self.sup.cursor), force_base=force_base,
        )
        if rec is not None:
            self._last_pub_step = self.sup.step
        return rec

    def stats(self):
        out = {
            "steps": self.steps,
            "sup_step": self.sup.step,
            "last_publish_step": self._last_pub_step,
        }
        out.update(self.publisher.stats())
        return out
