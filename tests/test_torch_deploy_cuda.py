"""The CNN deployment path on the card (tools/profile_deploy.py at the CPU
tests' size: resnet_cifar10, depth 8, 3 x 32 x 32, 10 classes). Every test
here is marked `cuda` and skips without a card; on the card they run with
`python -m pytest --noconftest tests/test_torch_deploy_cuda.py -m cuda`
(this file imports no JAX).

- Quantization-aware training 3 steps, then the five inference legs ((a)
  the f32 test clone, (b) folded, (c) folded and renamed, (d) frozen, (e)
  int8): each leg's graph path (call 1 op by op, call 2 captured, call 3
  replayed) gives the op-by-op path's logits bit for bit; (b) within the
  JAX package's fold bar of (a) (rtol 1e-4, atol 1e-5), (c) bit for bit
  with (b), (e) within rtol = atol = 1e-4 of (d).
- int8_conv2d's kernel form (im2col through the quant GEMM kernel) equals
  its plain form on the CPU bit for bit, and each call moves the kernel's
  launch counter by one; a grouped one takes the float64 convolution,
  also bit for bit, and launches nothing.
- A CUDA graph captured before fold_batch_norm is not replayed after it:
  the fold bumps the program's version, the executor captures afresh and
  fetches the folded program's result (a stale graph would apply
  batch_norm to the folded weights).
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch.ops import fused, quant_gemm, registry
from paddle_tpu_torch.tools import profile_deploy as dep

FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-5
INT8_TOL = 1e-4
QAT_STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN and the hand-written kernels")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _op_by_op():
    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler(profile_path=None):
                yield
    finally:
        flags.set_flags({"profile_ops": False})


def _trained_state(device):
    """The quantization-trained parameters after QAT_STEPS graph-path steps,
    and the two models."""
    cfg = dep.SMALL
    plain, qat = dep.build(cfg, qat=False), dep.build(cfg, qat=True)
    scope, exe = pt.Scope(seed=0, place=device), pt.Executor(device)
    batches = dep.feeds(cfg, device, cfg["train_batch"], n=QAT_STEPS)
    with pt.scope_guard(scope):
        exe.run(qat["startup"])
        losses = [float(exe.run(qat["main"], feed=b, fetch_list=[qat["loss"].name])[0]
                        .reshape(-1)[0]) for b in batches]
    assert np.isfinite(losses).all()
    names = [n for n, v in qat["main"].global_block().vars.items() if v.persistable
             and scope.find_var(n) is not None]
    return plain, qat, {n: scope.find_var(n) for n in names}


@pytest.mark.cuda
def test_five_legs_graph_equals_op_by_op(cuda_device):
    cfg = dep.SMALL
    plain, qat, state = _trained_state(cuda_device)
    feed = dep.feeds(cfg, cuda_device, cfg["infer_batch"], n=1, seed=3)[0]
    fetch = [plain["logits"].name]
    logits = {}
    for leg, (prog, scope) in dep.inference_legs(plain, qat, state, cuda_device).items():
        exe = pt.Executor(cuda_device)
        with pt.scope_guard(scope):
            fused.reset_stats()
            graph = [exe.run(prog, feed=feed, fetch_list=fetch)[0] for _ in range(3)]
            assert pt.Executor.stats()["graphs"] == {"captures": 1, "replays": 2}, leg
            with _op_by_op():
                eager = exe.run(prog, feed=feed, fetch_list=fetch)[0]
        for g in graph[1:]:
            assert g.tobytes() == eager.tobytes(), leg
        logits[leg] = eager
    np.testing.assert_allclose(logits["b"], logits["a"], rtol=FOLD_RTOL, atol=FOLD_ATOL)
    assert logits["c"].tobytes() == logits["b"].tobytes()
    np.testing.assert_allclose(logits["e"], logits["d"], rtol=INT8_TOL, atol=INT8_TOL)


def _levels(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(-127, 128, shape)
                            .astype("int8"))


INT8_CONV_CASES = {
    "stem_k147_s2": ((2, 3, 20, 20), (16, 3, 7, 7), {"strides": [2, 2], "paddings": [3, 3]}),
    "k3x3_dilation2": ((2, 5, 9, 9), (8, 5, 3, 3),
                       {"paddings": [2, 2], "dilations": [2, 2]}),
    "k1x1_s2_n20": ((1, 24, 6, 6), (20, 24, 1, 1), {"strides": [2, 2]}),
    "k3x3_k4608": ((2, 512, 7, 7), (512, 512, 3, 3), {"paddings": [1, 1]}),
    "groups4": ((2, 8, 7, 7), (12, 2, 3, 3), {"paddings": [1, 1], "groups": 4}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INT8_CONV_CASES))
def test_int8_conv2d_kernel_equals_plain(cuda_device, case):
    xs, ws, attrs = INT8_CONV_CASES[case]
    x, w = _levels(xs, 1), _levels(ws, 2)
    lower = registry.get("int8_conv2d").lower
    cpu = registry.LowerCtx("cpu")
    want = lower(cpu, {"Input": [x], "Filter": [w]}, attrs)["Output"][0]
    before = quant_gemm.kernel_launches()["quant_gemm_int8"]
    got = lower(registry.LowerCtx(cuda_device),
                {"Input": [x.to(cuda_device)], "Filter": [w.to(cuda_device)]}, attrs)["Output"][0]
    torch.cuda.synchronize()
    moved = quant_gemm.kernel_launches()["quant_gemm_int8"] - before
    assert moved == (0 if attrs.get("groups", 1) > 1 else 1)
    assert got.dtype == torch.float32
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


def _conv_bn_program():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = pt.layers.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
        out = pt.layers.relu(pt.layers.batch_norm(conv))
    return main.clone(for_test=True), startup, out


@pytest.mark.cuda
def test_replay_after_fold_fetches_the_folded_result(cuda_device):
    infer, startup, out = _conv_bn_program()
    rng = np.random.RandomState(2)
    xb = rng.randn(2, 3, 8, 8).astype(np.float32)
    scope, exe = pt.Scope(seed=9, place=cuda_device), pt.Executor(cuda_device)
    bn_op = next(o for o in infer.global_block().ops if o.type == "batch_norm")
    with pt.scope_guard(scope):
        exe.run(startup)
        for slot, lo, hi in (("Mean", -0.5, 0.5), ("Variance", 0.5, 2.0), ("Scale", 0.5, 1.5),
                             ("Bias", -0.3, 0.3)):
            name = bn_op.input(slot)[0]
            scope.set_var(name, torch.from_numpy(rng.uniform(lo, hi, (4,)).astype(np.float32))
                          .to(cuda_device))
        fused.reset_stats()
        before = [exe.run(infer, feed={"img": xb}, fetch_list=[out])[0] for _ in range(3)]
        pt.transpiler.InferenceTranspiler().transpile(infer, scope=scope)
        assert "batch_norm" not in [o.type for o in infer.global_block().ops]
        after = [exe.run(infer, feed={"img": xb}, fetch_list=[out])[0] for _ in range(3)]
        with _op_by_op():
            eager = exe.run(infer, feed={"img": xb}, fetch_list=[out])[0]
    assert pt.Executor.stats()["graphs"] == {"captures": 2, "replays": 4}
    for a in after:
        np.testing.assert_allclose(a, before[-1], rtol=FOLD_RTOL, atol=FOLD_ATOL)
    assert after[-1].tobytes() == eager.tobytes()
