"""The recurrent models' configurations, feeds and device-time split, as
chip_smoke.py's train-lstm and train-nmt phases and the tests use them:

- LSTM: the stacked dynamic-LSTM text model (models/stacked_lstm.py) at the
  JAX package's benchmark shape (bench.py:265-290,
  benchmark/fluid_benchmark.py:109-126): dict 30000, emb 512, hid 512,
  stacked_num 2, 2 classes, batch 64 of 100 words (`words` a lod_level=1
  feed with its `words@LEN` companion), Adam(2e-3), f32 (chip_smoke.py's
  train-bf16 phase runs it through Bf16Transpiler first, as the JAX bench
  does).
- NMT: the GRU attention model (models/machine_translation.py) at emb = hid
  = 512, dict 30000, 16 source words (benchmark/fluid_benchmark.py:129),
  batch 64, Adam(1e-3); beam search with beam 4 and max_out_len 16.
- COPY: the copy task of tests/test_machine_translation.py (vocab 12, 5
  words, batch 8, Adam(1e-2), 150 steps, beam 3).

rnn_device_split divides the op-by-op path's device time into the
recurrent products, the gates' elementwise work, the generic grad's
replayed forward (measured in its own profiler range inside the grad op),
the rest of the recurrent grad, the embedding and the optimizer.
"""

import numpy as np
import torch

from .profile_training import _OpRanges, op_device_split

LSTM = dict(dict_dim=30000, emb_dim=512, hid_dim=512, stacked_num=2, class_num=2, batch=64,
            seq_len=100, lr=2e-3)
NMT = dict(dict_size=30000, emb_dim=512, hid_dim=512, seq_len=16, batch=64, lr=1e-3,
           beam_size=4, max_out_len=16)
COPY = dict(dict_size=12, emb_dim=32, hid_dim=32, seq_len=5, batch=8, lr=1e-2, beam_size=3,
            max_out_len=6, steps=150)
START, END = 0, 1

RECURRENT = ("dynamic_lstm", "dynamic_gru", "recurrent")
REPLAY = "replay:"  # the range of a generic grad's replayed forward
# the split's categories: op types whose device time each sums
RNN_SPLIT = (
    ("recurrent_forward", RECURRENT),
    ("recurrent_grad", tuple(t + "_grad" for t in RECURRENT)
     + tuple(REPLAY + t for t in RECURRENT)),
    ("embedding", ("lookup_table", "lookup_table_grad")),
    ("optimizer", ("adam", "fused:multi_adam", "scale")),
    ("fc", ("mul", "mul_grad", "fused:gemm_epilogue", "elementwise_add",
            "elementwise_add_grad", "sum")),
    ("pool_and_loss", ("sequence_pool", "sequence_pool_grad", "softmax_with_cross_entropy",
                       "softmax_with_cross_entropy_grad", "mean", "mean_grad")),
)
# kernel names of the library matrix products (cuBLAS, CUTLASS)
_GEMM_MARKS = ("gemm", "xmma", "cutlass", "Kernel2")


def build_lstm(cfg=LSTM):
    """The stacked LSTM's training program: a dict of the programs and the
    variables a script touches."""
    from .. import fluid
    from ..models import stacked_lstm_net

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc, logits = stacked_lstm_net(
            words, label, cfg["dict_dim"], emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
            stacked_num=cfg["stacked_num"], class_num=cfg["class_num"])
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return dict(main=main, startup=startup, loss=loss, acc=acc, words=words, label=label)


def lstm_feed(cfg, seed, ragged=False):
    """One batch: words from the seed, every row seq_len long, or with
    ragged its lengths drawn from 1..seq_len (1 and seq_len among them),
    the padding zero."""
    rng = np.random.RandomState(seed)
    b, t = cfg["batch"], cfg["seq_len"]
    lens = np.full(b, t, np.int32)
    if ragged:
        lens = rng.randint(1, t + 1, size=b).astype(np.int32)
        lens[0], lens[1] = 1, t
    words = rng.randint(0, cfg["dict_dim"], (b, t, 1)).astype("int64")
    words[np.arange(t)[None, :] >= lens[:, None]] = 0
    return {"words": words, "words@LEN": lens,
            "label": rng.randint(0, cfg["class_num"], (b, 1)).astype("int64")}


def nmt_batch(cfg, rng):
    """A copy-task batch (tests/test_machine_translation.py): trg = <s> src,
    label = src </s>, source lengths from 2 to seq_len."""
    b, t, vocab = cfg["batch"], cfg["seq_len"], cfg["dict_size"]
    lens = rng.randint(2, t + 1, (b,))
    src = np.zeros((b, t, 1), np.int64)
    trg = np.zeros((b, t + 1, 1), np.int64)
    lab = np.zeros((b, t + 1, 1), np.int64)
    for i in range(b):
        toks = rng.randint(2, vocab, (lens[i],))
        src[i, :lens[i], 0] = toks
        trg[i, 0, 0] = START
        trg[i, 1:lens[i] + 1, 0] = toks
        lab[i, :lens[i], 0] = toks
        lab[i, lens[i], 0] = END
    return {"src": src, "trg": trg, "lab": lab, "src_len": lens.astype(np.int64),
            "trg_len": (lens + 1).astype(np.int64)}


def _src(fluid, main, b, t):
    src = fluid.layers.data(name="src", shape=[b, t, 1], dtype="int64",
                            append_batch_size=False)
    main.global_block().create_var(name="src_len", shape=(b,), dtype="int64")
    src._len_name = "src_len"
    return src


def build_nmt_train(cfg):
    """The NMT model's training program (teacher forcing, the length-masked
    mean cross entropy), as tests/test_machine_translation.py builds it."""
    from .. import fluid
    from ..models import machine_translation as mt

    b, t = cfg["batch"], cfg["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = _src(fluid, main, b, t)
        trg = fluid.layers.data(name="trg", shape=[b, t + 1, 1], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[b, t + 1, 1], dtype="int64",
                                append_batch_size=False)
        trg_len = fluid.layers.data(name="trg_len", shape=[b], dtype="int64",
                                    append_batch_size=False)
        loss = mt.train_model(src, trg, lab, trg_len, cfg["dict_size"],
                              emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"])
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return dict(main=main, startup=startup, loss=loss)


def build_nmt_infer(cfg):
    """The beam-search program sharing the training program's parameters
    (an open-ended While over max_out_len steps)."""
    from .. import fluid
    from ..models import machine_translation as mt

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = _src(fluid, main, cfg["batch"], cfg["seq_len"])
        ids, scores = mt.infer_model(
            src, cfg["dict_size"], emb_dim=cfg["emb_dim"], hid_dim=cfg["hid_dim"],
            beam_size=cfg["beam_size"], max_out_len=cfg["max_out_len"], start_id=START,
            end_id=END)
    return dict(main=main, ids=ids, scores=scores, hyp_len=ids._hyp_len)


def copied(src, src_len, ids, hyp_len):
    """How many sources the top hypothesis reproduces exactly, with the end
    token (the gate of tests/test_machine_translation.py)."""
    n = 0
    for i in range(src.shape[0]):
        want = list(src[i, :src_len[i], 0]) + [END]
        n += list(ids[i, 0, :hyp_len[i, 0]]) == want
    return n


class _ReplayRanges(_OpRanges):
    """_OpRanges, and inside a recurrent op's generic grad the replayed
    forward in a range of its own, "op::replay:<type>", with a device sync
    on each side so that its kernels start and end inside it; a marker
    range of the grad's own name after it gives the vjp's backward kernels
    back to the grad (op_device_split gives a kernel to the last range
    begun before it)."""

    def nested(self, name, call):
        if name not in RECURRENT or self.outer != name + "_grad":
            return call()
        torch.cuda.synchronize()
        with torch.profiler.record_function("op::" + REPLAY + name):
            out = call()
            torch.cuda.synchronize()
        with torch.profiler.record_function("op::" + self.outer):
            pass
        return out


def rnn_device_split(step, batches, registry):
    """op_device_split over RNN_SPLIT, and the recurrent ops' time further
    split: the forward's library products (kernels named as cuBLAS's and
    CUTLASS's GEMMs) and its gates' elementwise work (the rest); the
    generic grad's replayed forward, measured in its own range, and the
    rest of the grad (the vjp's backward)."""
    split = op_device_split(step, batches, registry, RNN_SPLIT, ranges=_ReplayRanges)
    fwd = {}
    for op in RECURRENT:
        for name, ms in split["kernels_by_op"].get(op, {}).items():
            fwd[name] = fwd.get(name, 0.0) + ms
    products = sum(ms for name, ms in fwd.items() if any(m in name for m in _GEMM_MARKS))
    forward = split["by_category"]["recurrent_forward"]
    replayed = sum(split["by_op"].get(REPLAY + t, 0.0) for t in RECURRENT)
    split["recurrent"] = {
        "forward_products_ms": products,
        "forward_gates_elementwise_ms": forward - products,
        "grad_replayed_forward_ms": replayed,
        "grad_backward_ms": sum(split["by_op"].get(t + "_grad", 0.0) for t in RECURRENT),
        "replayed_forward_share_of_step": replayed / split["device_ms_per_step"],
    }
    return split
