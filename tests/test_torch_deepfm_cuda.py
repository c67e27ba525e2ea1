"""DeepFM's sparse path on the card (every test is marked `cuda` and skips
without a CUDA device; the file imports no JAX, so on the card it runs with
`python -m pytest --noconftest tests/test_torch_deepfm_cuda.py -m cuda`):

- merge_rows on the card: the CPU's unique rows, and each row's sum bit
  for bit the dense grad's accumulation on the card;
- the sparse DeepFM step (SelectedRows grads, lazy Adam with bf16 moments)
  captured as one CUDA graph: 3 steps on the graph path against 3 op by op
  from the same seed, losses and the table bit for bit, the same launches
  and dispatches a step (3 GEMM epilogue, 1 multi_adam), and no block run
  op by op on the graph path;
- sparse against dense SGD at the benchmark's parity shape (2048 rows, 4
  fields, dim 8, batch 64, 6 batches), losses and the table bit for bit,
  on replayed graphs;
- lazy Adam on the card: rows a step does not touch keep their bits.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import flags
from paddle_tpu_torch.embedding import merge_rows
from paddle_tpu_torch.ops import fused
from paddle_tpu_torch.tools import profile_recsys as recsys

SMALL = dict(recsys.RECSYS, rows=4096, fields=6, dim=16, batch=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def op_by_op():
    from paddle_tpu_torch import profiler

    flags.set_flags({"profile_ops": True})
    try:
        with contextlib.redirect_stdout(io.StringIO()), profiler.profiler(profile_path=None):
            yield
    finally:
        flags.set_flags({"profile_ops": False})


def _run(model, feeds, per_op=False, pipeline="training_fused", state=("fm_emb",)):
    flags.set_flags({"pass_pipeline": pipeline})
    fused.reset_stats()
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope(seed=0, place=pt.CUDAPlace(0))
    losses, deltas = [], []
    try:
        with pt.scope_guard(scope), (op_by_op() if per_op else contextlib.nullcontext()):
            exe.run(model["startup"])
            for f in feeds:
                before = fused.stats()
                (lv,) = exe.run(model["main"], feed=f, fetch_list=[model["loss"].name])
                after = fused.stats()
                losses.append(lv.reshape(-1)[0])
                deltas.append({(kind, k): after[kind][k] - before[kind].get(k, 0)
                               for kind in ("launches", "dispatches") for k in after[kind]
                               if after[kind][k] != before[kind].get(k, 0)})
        tables = {n: scope.vars[n].cpu().numpy() for n in state}
        op_by_op_runs = dict(pt.Executor.stats()["op_by_op"])
    finally:
        flags.set_flags({"pass_pipeline": ""})
    return np.asarray(losses), deltas, tables, op_by_op_runs


@pytest.mark.cuda
def test_merge_rows_on_card_sums_as_the_dense_grad(cuda_device):
    """On the card merge_rows' unique rows equal the CPU's, and each row's
    sum equals, bit for bit, what the dense lookup_table_grad's
    accumulation (index_put_ into the table-shaped buffer) gives that row
    on the card: the two sum a row's duplicates in the same order. (The
    CPU's index_put_ sums them in another order than the card's.)"""
    rng = np.random.RandomState(0)
    rows = rng.randint(-3, 50, 4096).astype(np.int32)
    rows[::7] = 11
    vals = rng.randn(4096, 32).astype(np.float32)
    cu, _ = merge_rows(torch.from_numpy(rows), torch.from_numpy(vals), 64)
    r, v = torch.from_numpy(rows).cuda(), torch.from_numpy(vals).cuda()
    gu, gs = merge_rows(r, v, 64)
    np.testing.assert_array_equal(gu.cpu().numpy(), cu.numpy())
    valid = r >= 0
    dense = torch.zeros((64, 32), dtype=torch.float32, device="cuda")
    dense.index_put_((torch.where(valid, r, torch.zeros_like(r)).long(),),
                     torch.where(valid[:, None], v, torch.zeros_like(v)), accumulate=True)
    live = gu < 64
    assert torch.equal(gs[live], dense[gu[live].long()])


@pytest.mark.cuda
def test_sparse_step_graph_equals_op_by_op(cuda_device):
    model = recsys.build_deepfm(SMALL, is_sparse=True)
    feeds = recsys.recsys_batches(np.random.RandomState(0), SMALL["rows"], SMALL["fields"],
                                  SMALL["batch"], 4)
    g_l, g_d, g_t, g_runs = _run(model, feeds)
    e_l, e_d, e_t, _ = _run(model, feeds, per_op=True)
    assert g_l.tobytes() == e_l.tobytes(), (g_l, e_l)
    assert g_t["fm_emb"].tobytes() == e_t["fm_emb"].tobytes()
    assert g_d == e_d
    for d in g_d:
        assert d[("launches", "gemm_epilogue")] == 3 and d[("launches", "multi_adam")] == 1, d
    # the startup program creates the persistables; the main step captures
    assert g_runs == {"creates_persistables": 1}, g_runs


@pytest.mark.cuda
def test_sparse_matches_dense_sgd_on_card(cuda_device):
    cfg = recsys.PARITY
    feeds = recsys.recsys_batches(np.random.RandomState(cfg["seed"]), cfg["rows"],
                                  cfg["fields"], cfg["batch"], cfg["steps"])
    runs = [_run(recsys.build_deepfm(cfg, is_sparse=s), feeds, pipeline="",
                 state=("fm_emb", "fm_first")) for s in (False, True)]
    (dl, _, dt, _), (sl, _, st, _) = runs
    assert dl.tobytes() == sl.tobytes(), (dl, sl)
    for n in dt:
        assert dt[n].tobytes() == st[n].tobytes(), n


@pytest.mark.cuda
def test_lazy_adam_keeps_untouched_rows_on_card(cuda_device):
    """Step 1 touches rows 0..63 (their moments become nonzero), step 2
    only rows 3 and 7: every other row of the table keeps its step-1 bits,
    where dense Adam would move it by its decayed moments."""
    model = recsys.build_deepfm(SMALL, is_sparse=True)
    rng = np.random.RandomState(1)
    first = recsys.recsys_batches(rng, 64, SMALL["fields"], SMALL["batch"], 1)[0]
    second = dict(first, ids=np.where(np.arange(SMALL["fields"])[None, :, None] % 2,
                                      3, 7).repeat(SMALL["batch"], 0).astype("int64"))
    _, _, one, _ = _run(model, [first])
    _, _, two, _ = _run(model, [first, second])
    keep = np.ones(SMALL["rows"], bool)
    keep[[3, 7]] = False
    np.testing.assert_array_equal(two["fm_emb"][keep], one["fm_emb"][keep])
    assert not np.array_equal(two["fm_emb"][[3, 7]], one["fm_emb"][[3, 7]])
