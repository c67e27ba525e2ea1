"""Observability and eager mode on the card (every test is marked `cuda`
and skips without a CUDA device; the file imports no JAX, so on the card it
runs with `python -m pytest --noconftest tests/test_torch_observability_cuda.py
-m cuda`):

- FLAGS_tensor_stats inside a captured CUDA graph: the flag change
  captures a new graph, and a replay's rows equal the statistics of the
  same outputs fetched on the op-by-op path from the same state (rtol 1e-5,
  atol 1e-5 of absmax; nonfinite counts exactly);
- the eager tape on CUDA tensors: a small network's output and every
  gradient against the CPU's from the same weights (rtol 1e-4), and
  Layer.jit() (inductor) against the plain forward;
- device_op_profile over one op-by-op step covers the trace's kernel time
  within 5 %, and a replayed step's trace raises.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, flags, imperative, profiler
from paddle_tpu_torch.imperative import nn
from paddle_tpu_torch.observability import opprof
from paddle_tpu_torch.tools.profile_generation import op_by_op

import torch_obs_cases as cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and CUDA kernels")
    saved = flags.get_flags(["tensor_stats", "pass_pipeline"])
    yield pt.CUDAPlace(0)
    flags.set_flags(saved)


def _rows(tensors):
    out = []
    for t in tensors:
        x = t.detach().float()
        out.append([float(x.mean()), float(x.std(correction=0)), float(x.abs().amax()),
                    float((~torch.isfinite(x)).sum())])
    return np.asarray(out)


def test_tensor_stats_under_capture_against_op_by_op(card):
    run = cases.Run(pt, cases.fc_adam, place=card)
    for s in range(3):
        run.step(cases.fc_batch(s))  # warmup, capture, replay
    captures = pt.Executor.stats()["graphs"].get("captures", 0)
    flags.set_flags({"tensor_stats": "*"})
    run.step(cases.fc_batch(0))
    run.step(cases.fc_batch(1))
    assert pt.Executor.stats()["graphs"].get("captures", 0) == captures + 1
    state = {n: run.scope.vars[n].clone() for n in run.names}
    run.step(cases.fc_batch(2))
    got = opprof.last_tensor_stats()
    for n, t in state.items():
        run.scope.vars[n].copy_(t)
    flags.set_flags({"tensor_stats": ""})
    names = list(got)
    with op_by_op():
        fetched = run.step(cases.fc_batch(2), [run.loss.name] + [n.split(":", 1)[1]
                                                                  for n in names],
                           return_numpy=False)
    want = _rows(fetched[1:])
    have = np.asarray([[got[n][f] for f in opprof.STAT_FIELDS] for n in names])
    np.testing.assert_array_equal(have[:, 3], want[:, 3])
    for h, w in zip(have, want):
        np.testing.assert_allclose(h[:3], w[:3], rtol=1e-5, atol=1e-5 * max(w[2], 1e-30))


class _Net(imperative.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = self.add_sublayer(nn.FC(size=64, input_dim=32, act="relu"))
        self.ln = self.add_sublayer(nn.LayerNorm(64))
        self.fc2 = self.add_sublayer(nn.FC(size=8, input_dim=64))

    def __call__(self, x):
        return self.fc2(self.ln(self.fc1(x)))


def _grads(net, place, x):
    with imperative.guard(place):
        y = net(x)

        class Sum(imperative.Layer):
            def forward(self, t):
                return (t * t).sum()

        Sum()(y).backward()
        return y.numpy(), [p.gradient() for p in net.parameters()]


def test_eager_tape_on_cuda_tensors(card):
    x = np.random.RandomState(0).randn(16, 32).astype(np.float32)
    np.random.seed(1)
    with imperative.guard(pt.CPUPlace()):
        ref = _Net()
    with imperative.guard(card):
        net = convert.load_imperative(_Net(), [p.numpy() for p in ref.parameters()])
    assert net.parameters()[0].value.is_cuda
    (y, g), (wy, wg) = _grads(net, card, x), _grads(ref, pt.CPUPlace(), x)
    np.testing.assert_allclose(y, wy, rtol=1e-4, atol=1e-5)
    for a, b in zip(g, wg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(b).max()))
    with imperative.guard(card):
        plain = net.fc1(x).numpy()
        net.fc1.jit()
        np.testing.assert_allclose(net.fc1(x).numpy(), plain, rtol=1e-5, atol=1e-6)


def test_device_op_profile_of_an_op_by_op_step(card, tmp_path):
    run = cases.Run(pt, cases.conv_sgd, place=card)
    for s in range(3):
        run.step(cases.conv_batch(s))
    with op_by_op(), profiler.xla_trace(str(tmp_path / "ops")):
        run.step(cases.conv_batch(0))
    table = profiler.device_op_profile(str(tmp_path / "ops"), print_table=False)
    total = sum(r[1] for r in table.values())
    per_op = sum(r[1] for k, r in table.items() if not k.startswith("kernel:"))
    assert total > 0 and per_op / total >= 0.95, table
    assert any(k.startswith("conv2d:") for k in table)
    with profiler.xla_trace(str(tmp_path / "graph")):
        run.step(cases.conv_batch(1))
    with pytest.raises(RuntimeError, match="only CUDA graph launches"):
        profiler.device_op_profile(str(tmp_path / "graph"), print_table=False)
