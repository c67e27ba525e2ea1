"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu, slice by slice.

Serving: the fluid-style front end (framework, layers) builds the
GPTDecoder's Programs, the executor runs their ops as torch calls on one
device, and the GenerationEngine/GenerationScheduler serve requests over a
paged KV pool read by a hand-written CUDA paged flash-attention kernel
(ops/paged_flash.py).

Training: a Program built by `layers`, differentiated by `append_backward`
(backward.py) and updated by `optimizer.Adam` runs through `Executor.run`,
which applies the FLAGS_pass_pipeline preset (passes/); under
"training_fused" the GEMM epilogue, layer_norm forward and backward, and
Adam run as hand-written CUDA kernels (ops/fused.py).

Int8 serving: a GenerationEngine over a model with kv_dtype="int8" keeps
int8 KV pools read by the int8 forms of the paged kernel, and
serving.ServingEngine(model_dir, precision="int8", calibration_feeds=...)
runs the inference_int8 pass pipeline (passes/quant.py) over a saved model
(io.py), its calibrated int8 layers through a hand-written quant GEMM
kernel (ops/quant_gemm.py).

On the card a block runs as a CUDA graph: Executor.run captures a step at
its second call on a cache key and replays it after, and a
GenerationEngine captures its decode step and prefill buckets at warmup()
(executor.py). The op-by-op path runs there only under the profiler with
FLAGS_profile_ops (profiler.py), as in the JAX package.

CNN training: `import paddle_tpu_torch.fluid as fluid` is the fluid user
script's surface: LeNet-5 and the ResNets (models/) from conv2d, pool2d and
batch_norm, the optimizers from SGD through Ftrl, batch(reader.shuffle(
dataset.mnist.train())) into a DataFeeder, and checkpoints by
io.save_persistables / load_persistables.

Sequence and recurrent models: ragged inputs are padded dense with a
`<name>@LEN` companion (layers.data(lod_level=1)); the sequence, control-
flow, loss, decode and learning-rate layers build the stacked dynamic LSTM
and the GRU attention NMT model (models/). Their loops run over static
lengths on the device and capture with their step; a While without
maximum_iterations reads its condition on the host, so its block runs op
by op (Executor.stats()["op_by_op"]).

DeepFM and bf16: models/deepfm.py trains with SelectedRows sparse
embedding gradients (embedding/, ops/sparse_ops.py) when is_sparse=True,
and transpiler.Bf16Transpiler rewrites a training Program to bf16 mixed
precision (f32 masters); FLAGS_fp8_matmul routes its products through
e4m3 (ops/quant_gemm.py fp8_matmul).

Data parallelism: `ParallelExecutor` runs one process per device on
torch.distributed (NCCL on the cards, gloo on the CPU): the global batch
split over dp, gradients averaged in coalesced buckets or the ZeRO-1 tier,
synchronized batch_norm, ring attention over sp and row-sharded embedding
tables over ep (parallel/, embedding/).

Entry points run on the card (CUDAPlace(0)) unless the caller passes
CPUPlace(). The package imports torch and never jax, and nothing of
paddle_tpu.
"""

from . import (  # noqa: F401
    average,
    backward,
    clip,
    dataset,
    embedding,
    evaluator,
    flags,
    framework,
    initializer,
    io,
    layers,
    lod_tensor,
    metrics,
    nets,
    observability,
    ops,
    optimizer,
    parallel,
    param_attr,
    passes,
    profiler,
    reader,
    regularizer,
    serving,
    transpiler,
    unique_name,
)
from .backward import append_backward  # noqa: F401
from .batch import batch  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .framework import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    device_guard,
    name_scope,
    program_guard,
)
from .lod_tensor import create_lod_tensor, create_random_int_lodtensor  # noqa: F401
from .parallel_executor import BuildStrategy, ExecutionStrategy, ParallelExecutor  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from .place import CPUPlace, CUDAPlace, is_compiled_with_cuda  # noqa: F401
