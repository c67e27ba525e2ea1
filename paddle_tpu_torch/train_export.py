"""Artifact-only training: export a training step and run it with no Program
or front end in the loop (the torch counterpart of
paddle_tpu/train_export.py).

Reference analog: paddle/fluid/train/demo/demo_trainer.cc, a C++ driver
that loads saved program artifacts (startup / main ProgramDesc and
persistables) and trains without the Python front end. Here the WHOLE
optimizer-bearing step (forward, backward and update, the same prepared
block under the same pass pipeline that Executor.run runs) is exported
with torch.export, its hand kernels recorded as the paddle_tpu_torch ops
and the in-place updates of its state (the fused Adam's) as input
mutations, and written with the state into one `.npz`
(serving/compile_cache.py write_artifact). `TrainStepRunner` loads it and
loops feed -> step -> state: the training loop touches no Program, no ops,
no layers, only tensors in, fetches out, state carried.

The step is `(feeds, ro, mut) -> (fetches, new_mut)` over the read-only and
the written persistables; the runner keeps `mut` (parameters, optimizer
accumulators, running stats) and updates it in place. Random state: the
exported step's stochastic ops draw from the device's default generator
(a torch.Generator inside the graph would not survive torch.export.load),
and the runner carries that generator's state as a tensor (`__rng__`,
starting from the scope's device generator, where Executor.run draws), sets
it before each step and reads it after, restoring the process's own state
around the step; save_state / load_state carry it, so a restored runner
continues the same trajectory. On the card the runner runs its first step
op by op and replays the step as a CUDA graph from its second.

The artifact records the stack it was made on (torch, CUDA, the device's
name, the kernels' build); loading it on another stack raises.
"""

import numpy as np
import torch

from . import io as _io

__all__ = ["export_train_step", "TrainStepRunner", "load_train_step"]


def _npz(path):
    return path if path.endswith(".npz") else path + ".npz"


def _rng_state(device):
    return torch.cuda.get_rng_state(device) if device.type == "cuda" else torch.get_rng_state()


def _set_rng_state(state, device):
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def export_train_step(out_path, feed_example, fetch_list, program=None, scope=None):
    """Export the training block for the example feed's shapes and write
    the artifact: the exported step, its read-only and mutable state and
    the generator state. Run the startup program first (the block must
    create no new persistables: accumulators are startup-initialized).
    The block is the one Executor.run prepares: FLAGS_pass_pipeline
    rewrites the program first.

    feed_example: dict name -> numpy array (shapes and dtypes fix the
    artifact). fetch_list: Variables or names fetched each step (the
    loss). Returns the path written."""
    from . import framework
    from .executor import (
        _PerOpProfiledBlock,
        _apply_pass_pipeline,
        export_block,
        global_scope,
        to_tensor,
    )
    from .serving import compile_cache as _cc

    program = program or framework.default_main_program()
    scope = scope or global_scope()
    feed = {k: np.asarray(v) for k, v in feed_example.items()}
    fetch_names = [f.name if isinstance(f, framework.Variable) else str(f) for f in fetch_list]
    # an explicit program.random_seed reseeds the scope's generators once,
    # as Executor.run does
    if program.random_seed and not getattr(scope, "_seeded", False):
        scope.reseed(program.random_seed)
        scope._seeded = True
    prepared = _apply_pass_pipeline(program, scope, list(feed), fetch_names)
    block = _PerOpProfiledBlock(prepared.global_block(), list(feed), fetch_names, scope)
    if block.created_persistables:
        raise RuntimeError(
            "train block creates persistables %s: run the startup program before exporting"
            % block.created_persistables)
    device = scope.device
    ro, mut = block.state(scope)
    feeds = {n: to_tensor(v, device, block.feed_dtypes.get(n)) for n, v in feed.items()}
    exported = export_block(block, feeds, ro, mut, device)
    rng = scope.device_generator.get_state()
    return _cc.write_artifact(out_path, exported, sorted(feed), fetch_names, ro, mut,
                              {n: t.dtype for n, t in feeds.items()}, device,
                              extra={"__rng__": rng.numpy()})


class TrainStepRunner:
    """Program-free training loop over an export_train_step artifact (the
    demo_trainer.cc role). The state (parameters, accumulators, the
    generator's state) is carried inside the runner; run() takes a feed
    dict and returns the fetches as numpy arrays."""

    def __init__(self, program, feed_names, fetch_names, ro, mut, rng, feed_dtypes, device):
        from .executor import _ExportedRun

        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.device = device
        self._ro = ro
        self._mut = mut
        self._rng = torch.as_tensor(np.asarray(rng, dtype=np.uint8)).clone()
        self._run = _ExportedRun(program.module(), feed_dtypes, device)

    @classmethod
    def load(cls, path):
        from .serving import compile_cache as _cc

        d = _cc.read_artifact(path)
        return cls(d["program"], d["feed_names"], d["fetch_names"], d["ro"], d["mut"],
                   d["extra"]["__rng__"], d["feed_dtypes"], d["device"])

    def run(self, feed):
        """One training step: feed dict name -> array; returns numpy fetches
        (the loss etc.). The mutable state is updated in place."""
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %s" % missing)
        own = _rng_state(self.device)
        _set_rng_state(self._rng, self.device)
        try:
            fetches = self._run({n: feed[n] for n in self.feed_names}, self._ro, self._mut)
            self._rng = _rng_state(self.device)
        finally:
            _set_rng_state(own, self.device)
        return [_io._host_copy(f) for f in fetches]

    def state(self):
        """Snapshot of the mutable state (params, accumulators) as numpy,
        bf16 widened to float32 (exact): feed it into io-style
        checkpointing or back into a Scope."""
        return {n: _io._host_copy(v) for n, v in self._mut.items()}

    def save_state(self, path):
        """Write the mutable state and the generator's state (`__rng__`);
        returns the path written."""
        path = _npz(path)
        with open(path, "wb") as f:
            np.savez(f, __rng__=self._rng.numpy(), **self.state())
        return path

    def load_state(self, path):
        """Restore a save_state checkpoint into the runner's tensors (in
        place, so a captured step keeps its addresses)."""
        data = np.load(_npz(path))
        names = set(data.files) - {"__rng__"}
        if names != set(self._mut) or "__rng__" not in data.files:
            raise ValueError(
                "checkpoint does not match this artifact's state: missing %s,"
                " unexpected %s"
                % (sorted(set(self._mut) - names) + ([] if "__rng__" in data.files
                                                      else ["__rng__"]),
                   sorted(names - set(self._mut)))
            )
        with torch.no_grad():
            for n, t in self._mut.items():
                t.copy_(torch.from_numpy(np.array(data[n])).to(t.device, t.dtype))
        self._rng = torch.from_numpy(np.array(data["__rng__"], dtype=np.uint8))


def load_train_step(path):
    return TrainStepRunner.load(path)
