"""Operator lowerings; importing this package registers them: the core
ops, the mesh-aware ops (ops/parallel_ops.py: ring attention and the
row-sharded lookup), the sparse (SelectedRows) ops, which attach the
lookup_table grad maker after core_ops and parallel_ops registered the
forwards, the sequence, control-flow,
decode, loss, framework (ops/frame_ops.py) and detection ops
(ops/detection_ops.py), the flash attention ops (ops/flash_attention.py), the
quantization ops (ops/quant_ops.py), the secondary NN ops
(ops/nn_extra_ops.py), the fused and composite ops (ops/compose_ops.py, after
sequence_ops: its lstm / gru aliases read dynamic_lstm / dynamic_gru), and the
fused lowerings of the kernel-substitution tier (ops/fused.py)."""

from . import core_ops  # noqa: F401  (first: sparse_ops attaches to its lookup_table)
from . import parallel_ops  # noqa: F401  (before sparse_ops: its distributed_lookup_table)
from . import sparse_ops  # noqa: F401
from . import sequence_ops  # noqa: F401  (before compose_ops)
from . import (  # noqa: F401
    compose_ops,
    control_flow_ops,
    decode_ops,
    detection_ops,
    flash_attention,
    frame_ops,
    fused,
    generation_ops,
    loss_ops,
    nn_extra_ops,
    quant_ops,
)
from .registry import OPS, get, is_registered, register  # noqa: F401
