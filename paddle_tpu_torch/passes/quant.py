"""Calibrated int8 serving as a pass pipeline (the "inference_int8" preset;
the torch counterpart of paddle_tpu/passes/quant.py).

- ``calibrate`` runs representative feeds through the program op by op on
  the scope's device (registry.lower_ops, the executor's own machinery) and
  records each float tensor's observed absmax (or a percentile of |x|)
  across all feeds. The static facts of analysis/dataflow.py gate what is
  recorded: only vars the analyzer proves to be floating-point tensors get
  a range. Feeds ride ``ctx.attrs["calibrate"]``.
- ``quantize_serving`` bakes the ranges in: weights freeze to int8 levels
  in the scope with a ``.scale.frozen`` const, calibrated activations gain
  a static-scale ``quantize_static`` op, ``mul`` becomes ``int8_mul``, and
  a chained ``fake_dequantize_max_abs`` pair restores f32 with per-tensor
  scales.
- ``fuse_quant_gemm`` tags the resulting int8_mul -> dequant x2 [-> add
  [-> act]] chains for the fused ``gemm_int8`` lowering (ops/fused.py): the
  dequant multiplies collapse into the quant GEMM kernel's epilogue scale,
  so a calibrated layer runs as one kernel with one rounding.

Only ``mul`` (the fc producer) quantizes, as in the JAX package.
"""

import numpy as np
import torch

from ..framework import Operator, OpRole
from .pass_base import Pass, register_pass

__all__ = ["CalibratePass", "QuantizeServingPass", "FuseQuantGemmPass", "percentile"]


def percentile(a, q):
    """The q-th percentile of a 1-D f32 tensor with linear interpolation
    between the two nearest order statistics, as jnp.percentile and
    np.percentile compute it, for any length (torch.quantile refuses inputs
    above 2^24 elements)."""
    n = a.numel()
    s = torch.sort(a.reshape(-1)).values
    pos = float(q) / 100.0 * (n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(s[lo]) * (1.0 - frac) + float(s[hi]) * frac


@register_pass("calibrate")
class CalibratePass(Pass):
    """Record per-var activation ranges from representative feeds.

    ctx.attrs["calibrate"] = {
        "feeds": [ {feed name: array}, ... ],   # required to do anything
        "percentile": 99.9,                     # optional; default absmax
    }

    The result, {"ranges": {var name: float}, "feeds_run": n, "skipped":
    [...]}, lands in ctx.results["calibrate"] and on the program as
    ``_calibration_ranges``. Without feeds or a scope it does nothing."""

    def apply(self, graph, ctx):
        from ..analysis import analyze_program
        from ..executor import to_tensor
        from ..ops import registry

        result = {"ranges": {}, "feeds_run": 0, "skipped": []}
        ctx.results[self.name] = result
        spec = dict(ctx.attrs.get("calibrate") or {})
        feeds = spec.get("feeds") or ()
        scope = ctx.scope
        if not feeds or scope is None:
            return

        report = analyze_program(
            graph, feed_names=ctx.feed_names, fetch_names=ctx.fetch_names,
            scope=scope, mode="inference",
        )
        floaty = {
            name for name, fact in report.facts.items()
            if fact.kind == "tensor" and fact.dtype in ("float16", "bfloat16", "float32",
                                                        "float64")
        }
        pct = spec.get("percentile")
        block = graph.program.global_block()
        device = scope.device
        ranges = {}
        for feed in feeds:
            env = {}
            for n, v in dict(feed).items():
                v = block._var_recursive(n) if block.has_var_recursive(n) else None
                dt = registry.torch_dtype(v.dtype) if v is not None and v.dtype else None
                env[n] = to_tensor(feed[n], device, dt)
            lower_ctx = registry.LowerCtx(device, generator=scope.generator, is_test=True)
            for op in block.ops:
                opdef = registry.get(op.type) if registry.is_registered(op.type) else None
                if opdef is None or opdef.skip_exec or opdef.is_host:
                    continue
                ready = True
                for n in op.input_arg_names:
                    if n == registry.EMPTY_VAR_NAME or n in env:
                        continue
                    val = scope.find_var(n)
                    if val is None:
                        ready = False
                        break
                    env[n] = val
                if not ready:
                    result["skipped"].append(op.type)
                    continue
                try:
                    registry.lower_ops(lower_ctx, [op], env)
                except Exception:  # an op calibration cannot run is skipped, as in JAX
                    result["skipped"].append(op.type)
                    continue
            for name, val in env.items():
                if name not in floaty or not isinstance(val, torch.Tensor):
                    continue
                a = val.detach().float().abs()
                obs = percentile(a, pct) if pct is not None else float(a.max())
                if obs > ranges.get(name, 0.0):
                    ranges[name] = obs
            result["feeds_run"] += 1
        result["ranges"] = ranges
        result["skipped"] = sorted(set(result["skipped"]))
        graph.program._calibration_ranges = dict(ranges)


@register_pass("quantize_serving")
class QuantizeServingPass(Pass):
    """Bake calibrated scales into an int8 serving program: per mul op
    whose weight lives in the scope and whose activation carries a
    calibrated range,

        x -> quantize_static(x, x.calib.scale) -> int8_mul(xq, Wq)
          -> fake_dequantize(s_act) -> fake_dequantize(W.scale.frozen) -> out

    The weight becomes torch.int8 levels IN THE SCOPE and its block var's
    dtype "int8" (the pass mutates parameter values, so only the opt-in
    inference_int8 preset runs it). Ranges come from
    ctx.results["calibrate"] or ctx.attrs["quant_ranges"]; without a scope
    or ranges it does nothing."""

    def apply(self, graph, ctx):
        from ..ops.quant_ops import _quant_levels

        result = {"quantized": 0, "weights_frozen": []}
        ctx.results[self.name] = result
        scope = ctx.scope
        ranges = dict(
            (ctx.results.get("calibrate") or {}).get("ranges")
            or ctx.attrs.get("quant_ranges")
            or {}
        )
        if scope is None or not ranges:
            return
        bits = int(dict(ctx.attrs.get("quantize") or {}).get("activation_bits", 8))
        levels = _quant_levels(bits)
        block = graph.program.global_block()
        device = scope.device
        frozen = {}  # weight name -> scale const name
        quantized_acts = {}  # activation name -> (q var, scale const name)
        new_ops = []
        for op in block.ops:
            if op.type != "mul" or not op.output("Out"):
                new_ops.append(op)
                continue
            x_name = op.input("X")[0]
            w_name = op.input("Y")[0]
            w_val = scope.find_var(w_name)
            x_range = ranges.get(x_name)
            wv = block.vars.get(w_name)
            if (
                w_val is None
                or not x_range
                or wv is None
                or not wv.persistable
                or str(wv.dtype) not in ("float32", "float64", "bfloat16")
            ):
                new_ops.append(op)
                continue
            if w_name not in frozen:
                # numpy, as in the JAX package: the same f32 arithmetic
                # gives the same levels and scale bit for bit
                w = w_val.detach().float().to("cpu").numpy()
                w_scale = float(np.max(np.abs(w))) or 1.0
                qw = np.clip(np.round(w / w_scale * levels), -levels, levels).astype(np.int8)
                scope.set_var(w_name, torch.from_numpy(qw).to(device))
                wv.dtype = "int8"
                sname = w_name + ".scale.frozen"
                block.create_var(name=sname, shape=(1,), dtype="float32", persistable=True)
                scope.set_var(sname, torch.tensor([w_scale], dtype=torch.float32, device=device))
                frozen[w_name] = sname
                result["weights_frozen"].append(w_name)
            if x_name not in quantized_acts:
                a_sname = x_name + ".calib.scale"
                block.create_var(name=a_sname, shape=(1,), dtype="float32", persistable=True)
                scope.set_var(a_sname, torch.tensor([float(x_range) or 1.0],
                                                    dtype=torch.float32, device=device))
                xv = block._var_recursive(x_name)
                q = block.create_var(name=x_name + ".q", shape=xv.shape, dtype="int8")
                new_ops.append(Operator(
                    block, "quantize_static",
                    inputs={"X": [x_name], "Scale": [a_sname]},
                    outputs={"Out": [q.name]},
                    attrs={"bit_length": bits, OpRole.OP_ROLE_KEY: OpRole.Forward},
                ))
                quantized_acts[x_name] = (q.name, a_sname)
            q_name, a_sname = quantized_acts[x_name]
            op.type = "int8_mul"
            op.inputs["X"] = [q_name]
            out = op.output("Out")[0]
            out_shape = block._var_recursive(out).shape
            lvl = block.create_var(name=out + ".lvl", shape=out_shape, dtype="float32")
            op.outputs["Out"] = [lvl.name]
            new_ops.append(op)
            # chained per-tensor dequant: out = lvl * (s_act/levels) * (s_w/levels)
            src = lvl.name
            for i, s in enumerate((a_sname, frozen[w_name])):
                dst = out if i == 1 else block.create_var(
                    name="%s.deq0" % out, shape=out_shape, dtype="float32").name
                new_ops.append(Operator(
                    block, "fake_dequantize_max_abs",
                    inputs={"X": [src], "Scale": [s]},
                    outputs={"Out": [dst]},
                    attrs={"max_range": levels, OpRole.OP_ROLE_KEY: OpRole.Forward},
                ))
                src = dst
            result["quantized"] += 1
        if result["quantized"]:
            block.ops = new_ops
            graph.program._bump_version()
            graph.refresh()


@register_pass("fuse_quant_gemm")
class FuseQuantGemmPass(Pass):
    """Tag int8_mul -> fake_dequantize x2 [-> elementwise_add [-> act]]
    chains for the fused quant GEMM (ops/fused.py ``gemm_int8``). Strict
    slot equality like fuse_gemm_epilogue; every shape and dtype decision
    is made again at lowering time (a decline lowers op by op)."""

    def apply(self, graph, ctx):
        from .builtin import _pallas_free, _tag_run

        ops = graph.program.global_block().ops
        groups = tagged = i = 0
        while i < len(ops):
            op = ops[i]
            if op.type != "int8_mul" or not _pallas_free(op):
                i += 1
                continue
            chain = self._chain_at(ops, i)
            if chain is None:
                i += 1
                continue
            _tag_run(chain, "qgemm%d" % groups, "gemm_int8")
            tagged += len(chain)
            groups += 1
            i += len(chain)
        ctx.results[self.name] = {"groups": groups, "ops_tagged": tagged}
        if groups:
            graph.program._bump_version()

    @staticmethod
    def _chain_at(ops, i):
        from .builtin import _PALLAS_GEMM_ACTS, _pallas_free

        prod = ops[i]
        if i + 2 >= len(ops) or not prod.output_arg_names:
            return None
        d1, d2 = ops[i + 1], ops[i + 2]
        if (
            d1.type != "fake_dequantize_max_abs"
            or d2.type != "fake_dequantize_max_abs"
            or not _pallas_free(d1)
            or not _pallas_free(d2)
            or d1.input("X") != [prod.output("Out")[0]]
            or d2.input("X") != [d1.output("Out")[0]]
        ):
            return None
        chain = [prod, d1, d2]
        if i + 3 < len(ops):
            add = ops[i + 3]
            if (
                add.type == "elementwise_add"
                and _pallas_free(add)
                and add.input("X") == [d2.output("Out")[0]]
            ):
                chain.append(add)
                if i + 4 < len(ops):
                    act = ops[i + 4]
                    if (
                        act.type in _PALLAS_GEMM_ACTS
                        and _pallas_free(act)
                        and act.input("X") == [add.output("Out")[0]]
                    ):
                        chain.append(act)
        return chain
