"""QuantizeTranspiler: quantization-aware training + int8 freeze (a copy of
paddle_tpu/transpiler/quantize_transpiler.py pointed at the port's
framework, scope and ops).

Reference analog: python/paddle/fluid/contrib/quantize/quantize_transpiler.py:81
— training_transpile inserts fake_quantize ops on the inputs of quantizable
ops (mul, conv2d, depthwise_conv2d) and fake_dequantize after them;
freeze_program converts weights to real int8 for serving. Gradient flow is
straight-through (quant_ops.py registers identity grads), matching the
reference's backward rewrite.

Simulated-quant values stay float on the device, so QAT is about matching
serving-time rounding; freeze_program and convert_to_int8 do their math in
numpy and write each weight back on its device (f32 levels after the
freeze, int8 after the conversion), bumping the program's version so that
the executor prepares and captures the rewritten program afresh.
"""

import numpy as np
import torch

from .. import framework
from ..framework import Operator, OpRole
from ..ops.quant_ops import _quant_levels

__all__ = ["QuantizeTranspiler"]

_QUANTIZABLE = ("mul", "conv2d", "depthwise_conv2d")
_QUANT_SLOTS = {"mul": ("X", "Y"), "conv2d": ("Input", "Filter"),
                "depthwise_conv2d": ("Input", "Filter")}


class QuantizeTranspiler:
    def __init__(
        self,
        weight_bits=8,
        activation_bits=8,
        activation_quantize_type="abs_max",
        weight_quantize_type="abs_max",
        window_size=10000,
    ):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.window_size = window_size

    # ------------------------------------------------------------------ #
    def training_transpile(self, program=None, startup_program=None):
        """Insert fake quant/dequant around every quantizable op, in place."""
        program = program or framework.default_main_program()
        block = program.global_block()
        quantized = {}  # var name -> (quantized var, scale var)
        new_ops = []
        for op in block.ops:
            role = op.attrs.get(OpRole.OP_ROLE_KEY, OpRole.Forward)
            if op.type in _QUANTIZABLE and not (role & OpRole.Backward):
                scales = []
                for slot in _QUANT_SLOTS[op.type]:
                    names = op.input(slot)
                    if not names:
                        continue
                    name = names[0]
                    if name not in quantized:
                        q, s, qops = self._insert_quant(block, name)
                        quantized[name] = (q, s)
                        new_ops.extend(qops)
                    q, s = quantized[name]
                    op.inputs[slot] = [q]
                    scales.append(s)
                new_ops.append(op)
                # dequantize the output with the product of input scales
                out_slot = "Out" if op.type == "mul" else "Output"
                out = op.output(out_slot)[0]
                deq, dops = self._insert_dequant(block, out, scales)
                op.outputs[out_slot] = [out + ".quantized"]
                new_ops.extend(dops)
            else:
                new_ops.append(op)
        block.ops = new_ops
        program._bump_version()

    def _insert_quant(self, block, name):
        v = block._var_recursive(name)
        q = block.create_var(
            name=name + ".quantized", shape=v.shape, dtype=v.dtype
        )
        s = block.create_var(name=name + ".scale", shape=(1,), dtype="float32")
        op = Operator(
            block,
            "fake_quantize_abs_max",
            inputs={"X": [name]},
            outputs={"Out": [q.name], "OutScale": [s.name]},
            attrs={"bit_length": self.activation_bits,
                   OpRole.OP_ROLE_KEY: OpRole.Forward},
        )
        return q.name, s.name, [op]

    def _insert_dequant(self, block, out, scale_names):
        v = block._var_recursive(out)
        qout = block.create_var(
            name=out + ".quantized", shape=v.shape, dtype=v.dtype
        )
        ops = []
        src = qout.name
        # chain a dequant per input scale: x * (s1/r) * (s2/r) — the
        # reference folds the product the same way for mul/conv
        max_range = _quant_levels(self.activation_bits)
        for i, s in enumerate(scale_names):
            dst = out if i == len(scale_names) - 1 else block.create_var(
                name="%s.deq%d" % (out, i), shape=v.shape, dtype=v.dtype
            ).name
            ops.append(
                Operator(
                    block,
                    "fake_dequantize_max_abs",
                    inputs={"X": [src], "Scale": [s]},
                    outputs={"Out": [dst]},
                    attrs={"max_range": max_range,
                           OpRole.OP_ROLE_KEY: OpRole.Forward},
                )
            )
            src = dst
        return out, ops

    # ------------------------------------------------------------------ #
    def freeze_program(self, program, scope=None):
        """For serving: bake weight quantization into int8 arrays stored on
        the weight vars (reference freeze_program). The program keeps
        dequantize ops fed by constant per-weight scales."""
        from ..executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        levels = _quant_levels(self.weight_bits)
        frozen = {}
        keep_ops = []
        rename = {}  # old input name -> replacement
        for op in block.ops:
            if op.type == "fake_quantize_abs_max":
                src = op.input("X")[0]
                v = block.vars.get(src)
                if v is not None and isinstance(v, framework.Parameter):
                    held = scope.find_var(src)
                    device = held.device
                    w = held.detach().to("cpu").numpy().astype(np.float32)
                    scale = float(np.max(np.abs(w))) or 1.0
                    qw = np.clip(
                        np.round(w / scale * levels), -levels, levels
                    ).astype(np.int8)
                    frozen[src] = (qw, scale)
                    # weight now holds the quantized levels as float (serving
                    # math identical to int8 × scale); scale becomes a frozen
                    # persistable const the dequant op reads
                    scope.set_var(src, torch.from_numpy(qw.astype(np.float32)).to(device))
                    sname = src + ".scale.frozen"
                    block.create_var(
                        name=sname, shape=(1,), dtype="float32", persistable=True
                    )
                    scope.set_var(sname, torch.tensor([scale], dtype=torch.float32,
                                                      device=device))
                    rename[op.output("Out")[0]] = src
                    rename[op.output("OutScale")[0]] = sname
                    continue  # drop the quantize op
            keep_ops.append(op)
        for op in keep_ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
        block.ops = keep_ops
        program._bump_version()
        program._quantized_weights = frozen  # int8 payloads for export
        return frozen

    # ------------------------------------------------------------------ #
    def convert_to_int8(self, program, scope=None):
        """Serving on real int8: after freeze_program, re-type the frozen
        weights to int8 in scope, swap activation quantize ops to the
        int8-emitting `quantize_abs_max`, and swap mul/conv2d over quantized
        operands to `int8_mul`/`int8_conv2d` (int8 x int8 with exact sums:
        int8_conv2d takes the quant GEMM kernel on the card). The reference's
        convert_to_int8 (contrib quantize_transpiler.py:236) stops at weight
        re-typing because its int8 kernels live in MKL-DNN; here the program
        itself carries the int8 compute. The fake_dequantize chain is
        unchanged: int8 ops emit f32 level-products with identical numerics.

        On a CNN the per-layer activation quantize / dequantize passes add
        elementwise memory traffic beside every convolution, which may
        outweigh what the int8 products save."""
        from ..executor import global_scope

        scope = scope or global_scope()
        block = program.global_block()
        frozen = getattr(program, "_quantized_weights", None)
        if not frozen:
            raise ValueError("convert_to_int8 requires freeze_program first")

        for name, (qw, _scale) in frozen.items():
            # the int8 payload on the device of the value it replaces
            device = scope.find_var(name).device
            scope.set_var(name, torch.from_numpy(qw).to(device))
            v = block.vars.get(name)
            if v is not None:
                v.dtype = "int8"

        _INT8 = {"mul": "int8_mul", "conv2d": "int8_conv2d",
                 "depthwise_conv2d": "int8_conv2d"}
        quantized_outs = set()
        for op in block.ops:
            if op.type == "fake_quantize_abs_max":
                op.type = "quantize_abs_max"
                quantized_outs.update(op.output("Out"))
                ov = block.vars.get(op.output("Out")[0])
                if ov is not None:
                    ov.dtype = "int8"
            elif op.type in _INT8:
                ins = [n for names in op.inputs.values() for n in names]
                if any(n in quantized_outs or n in frozen for n in ins):
                    op.type = _INT8[op.type]
        program._bump_version()
        return program
