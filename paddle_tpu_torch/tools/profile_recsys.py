"""The DeepFM CTR model's configurations, programs and feeds, as
chip_smoke.py's train-deepfm phase and the tests use them, and the bf16
builds of the other BASELINE models for its train-bf16 phase:

- RECSYS: models/deepfm.py at the JAX package's recsys benchmark widths
  (bench.py:1533-1557, 1613-1616): 2^20 feature rows, dim 32, 16 fields,
  batch 512, layer_sizes (32, 16), Adam(1e-3) with bf16 moments
  (moment_dtype="bfloat16"), dense or is_sparse=True (SelectedRows grads,
  lazy Adam on the touched rows); batches from `recsys_batches` (uniform
  ids over the table, labels at p = 0.5; bench.py:1559-1565);
- PARITY: the benchmark's parity leg (bench.py:1690-1717): 2048 rows, 4
  fields, dim 8, batch 64, 6 batches from seed 7, layer_sizes (16,),
  SGD(0.1): sparse and dense SGD give the same bits;
- CONVERGE: tests/test_deepfm.py's training test (2000 features, 6 fields,
  dim 8, layer_sizes (64, 32), Adam(5e-3), batch 64, 200 steps, the clicks
  correlated with field 0's ids) with its gates: the last 5 losses under
  0.9x the first 5, the AUC of a fresh batch of 512 above 0.65.

`bf16_transpiled` applies transpiler.Bf16Transpiler to a built training
program after its startup program ran, as the JAX bench does
(bench.py:77-84, 295-297, 488-490).
"""

import numpy as np

RECSYS = dict(rows=1 << 20, fields=16, dim=32, batch=512, layer_sizes=(32, 16),
              optimizer="adam", lr=1e-3, moment_dtype="bfloat16")
PARITY = dict(rows=2048, fields=4, dim=8, batch=64, layer_sizes=(16,), optimizer="sgd",
              lr=0.1, steps=6, seed=7)
CONVERGE = dict(rows=2000, fields=6, dim=8, batch=64, layer_sizes=(64, 32), optimizer="adam",
                lr=5e-3, steps=200, eval_batch=512, seed=0)


def build_deepfm(cfg, is_sparse, use_distributed=False):
    """The DeepFM training program of `cfg`: a dict of the programs and the
    variables a script touches. use_distributed builds the EmbeddingEngine's
    row-sharded tables (a ParallelExecutor with an ep axis shards them)."""
    from .. import fluid
    from ..models.deepfm import deepfm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[cfg["fields"], 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, pred, _ = deepfm(ids, label, num_features=cfg["rows"], num_fields=cfg["fields"],
                               embedding_size=cfg["dim"], layer_sizes=cfg["layer_sizes"],
                               is_sparse=is_sparse, use_distributed=use_distributed)
        if cfg["optimizer"] == "adam":
            fluid.optimizer.Adam(learning_rate=cfg["lr"],
                                 moment_dtype=cfg.get("moment_dtype")).minimize(loss)
        else:
            fluid.optimizer.SGD(learning_rate=cfg["lr"]).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, pred=pred)


def recsys_batches(rng, rows, fields, batch, n):
    """bench.py's _recsys_batches: uniform ids over the table, labels at
    p = 0.5."""
    out = []
    for _ in range(n):
        ids = rng.randint(0, rows, (batch, fields, 1)).astype("int64")
        label = (rng.rand(batch, 1) < 0.5).astype("float32")
        out.append({"ids": ids, "label": label})
    return out


def converge_batch(rng, cfg=CONVERGE, n=None):
    """tests/test_deepfm.py's make_batch: clicks more likely on low ids of
    field 0."""
    n = n or cfg["batch"]
    rows = cfg["rows"]
    ids = rng.randint(0, rows, (n, cfg["fields"], 1)).astype("int64")
    p = 1.0 / (1.0 + np.exp((ids[:, 0, 0] - rows / 2) / (rows / 6)))
    label = (rng.rand(n) < p).astype("float32").reshape(n, 1)
    return {"ids": ids, "label": label}


def auc(pred, label):
    """The pairwise AUC of tests/test_deepfm.py."""
    pos = pred[label[:, 0] == 1, 0]
    neg = pred[label[:, 0] == 0, 0]
    return float((pos[:, None] > neg[None, :]).mean())


def embedding_rows_per_step(cfg):
    """Table rows gathered and updated a step: every id slot in both tables
    (bench.py's rows_per_step)."""
    return cfg["batch"] * cfg["fields"] * 2


def bf16_transpiled(main):
    """`main` rewritten to bf16 mixed precision in place (train mode: f32
    masters), as the JAX bench does after its startup program ran."""
    from ..transpiler import Bf16Transpiler

    return Bf16Transpiler().transpile(main)
