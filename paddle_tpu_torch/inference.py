"""Inference deployment: the Predictor API and the compiled export (the torch
counterpart of paddle_tpu/inference.py).

Reference analog: paddle/fluid/inference/ (SURVEY.md section 2.9):
`PaddlePredictor` / `AnalysisPredictor` load a saved inference program and
serve Run() through the NaiveExecutor, capturing subgraphs into faster
engines.

- `Predictor` = io.load_inference_model into a scope of its own, then
  Executor.run on a shape key: on the card a CUDA graph from a key's
  second call.
- `export_compiled` / `load_compiled` = a torch.export round trip of the
  served block: the op-by-op serve call of executor.aot_serve_lowering,
  exported over the example feed's shapes with the hand kernels recorded as
  the paddle_tpu_torch ops, written with the parameters into one `.npz`
  (serving/compile_cache.py write_artifact). The serving side needs no
  model code and no Program, only the artifact; on the card the loaded
  program runs op by op at its first call, is captured as a CUDA graph at
  its second and replayed after (executor._ExportedRun).
"""

import numpy as np

from .executor import Executor, Scope, _ExportedRun, export_block, scope_guard, to_tensor
from . import io

__all__ = ["Predictor", "export_compiled", "load_compiled"]


def _feed_dict(names, feed):
    return dict(zip(names, feed)) if isinstance(feed, (list, tuple)) else dict(feed)


class Predictor:
    """Load-and-serve (reference CreatePaddlePredictor -> Run). Feeds are a
    dict name -> array (or a list in the model's feed order); returns numpy
    arrays for the model's fetch targets. `place` None is the card."""

    def __init__(self, model_dir, place=None, params_filename=None):
        self.scope = Scope()
        self.exe = Executor(place)
        with scope_guard(self.scope):
            program, feed_names, fetch_vars = io.load_inference_model(
                model_dir, self.exe, params_filename=params_filename
            )
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [v.name for v in fetch_vars]

    def run(self, feed):
        feed = _feed_dict(self.feed_names, feed)
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %s" % missing)
        unknown = sorted(set(feed) - set(self.feed_names))
        if unknown:
            # a typo'd feed name silently dropped into exe.run would serve
            # garbage from the default-initialized var instead
            raise ValueError(
                "unknown feeds: %s (model takes %s)" % (unknown, self.feed_names)
            )
        with scope_guard(self.scope):
            outs = self.exe.run(self.program, feed=feed, fetch_list=self.fetch_names)
        return [np.asarray(o) for o in outs]

    # reference PaddlePredictor names
    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)


def export_compiled(model_dir, example_feed, out_path, place=None, params_filename=None):
    """Export the inference program's serve call for the example feed's
    shapes (torch.export) and write it with the parameters into one
    artifact, deployable without the model-building code. Returns the path
    ACTUALLY written (`.npz` appended when out_path lacks it).

    The lowering is executor.aot_serve_lowering's block and the artifact
    format serving/compile_cache.py's, the pieces the ServingEngine builds
    its variants from; this is the single-shape offline flavor."""
    from .executor import aot_serve_lowering
    from .serving import compile_cache as _cc

    pred = Predictor(model_dir, place, params_filename=params_filename)
    feed = {k: np.asarray(v) for k, v in _feed_dict(pred.feed_names, example_feed).items()}
    with scope_guard(pred.scope):
        serve, ro, mut = aot_serve_lowering(pred.program, list(feed), pred.fetch_names,
                                            pred.scope)
    block = serve.serve.block
    device = pred.scope.device
    feeds = {n: to_tensor(v, device, block.feed_dtypes.get(n)) for n, v in feed.items()}
    program = export_block(block, feeds, ro, mut, device, is_test=True)
    return _cc.write_artifact(out_path, program, list(feed), pred.fetch_names, ro, mut,
                              {n: t.dtype for n, t in feeds.items()}, device)


class _CompiledPredictor:
    """A loaded export_compiled artifact: run(feed) -> numpy fetches, the
    exported program run by executor._ExportedRun over the artifact's
    parameters (CUDA graphs on the card from the second call)."""

    def __init__(self, program, feed_names, fetch_names, ro, mut, feed_dtypes, device):
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self._ro = ro
        self._mut = mut
        self._run = _ExportedRun(program.module(), feed_dtypes, device)

    def run(self, feed):
        feed = _feed_dict(self.feed_names, feed)
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds: %s" % missing)
        outs = self._run({k: feed[k] for k in self.feed_names}, self._ro, self._mut)
        return [io._host_copy(o) for o in outs]


def load_compiled(path):
    """Deserialize an export_compiled artifact; serving needs only this file
    (the reference's fluid_lib_dist / TRT-engine deployment analog)."""
    from .serving import compile_cache as _cc

    d = _cc.read_artifact(path)
    return _CompiledPredictor(d["program"], d["feed_names"], d["fetch_names"], d["ro"],
                              d["mut"], d["feed_dtypes"], d["device"])
