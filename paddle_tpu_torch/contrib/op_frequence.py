"""Op-frequency statistics over a Program.

Reference analog: contrib/op_frequence.py op_freq_statistic — counts single-op
frequencies and adjacent (producer→consumer) op-pair frequencies, the input
signal its authors used to pick fusion-pass candidates. A copy of
paddle_tpu/contrib/op_frequence.py: pairs that dominate are what to check
the fused pass pipelines merge (profiler.device_op_profile splits a run by
op) or what deserves a hand-written kernel.
"""

from collections import OrderedDict

from ..framework import Program

__all__ = ["op_freq_statistic"]


def op_freq_statistic(program):
    """Returns (uni_op_freq, adj_2_op_freq): op-type counts and
    "producer,consumer" adjacent-pair counts, both sorted descending."""
    if not isinstance(program, Program):
        raise TypeError(
            "The input type should be Program, got %s" % type(program)
        )

    uni_op_freq = OrderedDict()
    adj_2_op_freq = OrderedDict()
    parameters = {p.name for p in program.global_block().all_parameters()}

    for op in program.global_block().ops:
        recorded = False
        for var_name in op.output_arg_names:
            if var_name in parameters or recorded:
                continue
            uni_op_freq[op.type] = uni_op_freq.get(op.type, 0) + 1
            recorded = True

    var_gen_op = {}
    for op in program.global_block().ops:
        for var_name in op.input_arg_names:
            if var_name in parameters:
                continue
            gens = var_gen_op.get(var_name)
            if gens:
                key = "%s,%s" % (gens[-1], op.type)
                adj_2_op_freq[key] = adj_2_op_freq.get(key, 0) + 1
        for var_name in op.output_arg_names:
            if var_name in parameters:
                continue
            var_gen_op.setdefault(var_name, []).append(op.type)

    uni = OrderedDict(
        sorted(uni_op_freq.items(), key=lambda kv: kv[1], reverse=True)
    )
    adj = OrderedDict(
        sorted(adj_2_op_freq.items(), key=lambda kv: kv[1], reverse=True)
    )
    return uni, adj
