"""The Transformer training program of the parity tests, built the same way
in the JAX package and in the torch port (tests/test_torch_training.py,
tests/test_torch_passes.py). Feeds are numpy arrays from
paddle_tpu_torch.tools.profile_training.make_batch, which makes them from a
seed as the reference's data pipeline does, for both packages."""

from paddle_tpu_torch.tools.profile_training import FEED_NAMES, make_batch  # noqa: F401

# small enough for the CPU suite, large enough that every fused family's
# path predicate holds: rows = b * t = 128, widths multiples of 128
SMALL = dict(n_layer=1, n_head=2, d_model=128, d_inner=256, d_key=64, d_value=64,
             vocab=96, batch=4, t=32, dropout=0.0)


def build(pkg, transformer, cfg, lr=1e-3):
    """(main, startup, loss) of one training step: the model of
    models/transformer.py under Adam, built with `pkg` (paddle_tpu.fluid or
    paddle_tpu_torch) and its `transformer` module."""
    t, h = cfg["t"], cfg["n_head"]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        v = {}
        for name in FEED_NAMES:
            if name.endswith("bias"):
                v[name] = L.data(name=name, shape=[h, t, t], dtype="float32")
            elif name == "lbl_weight":
                v[name] = L.data(name=name, shape=[t, 1], dtype="float32")
            else:
                v[name] = L.data(name=name, shape=[t, 1], dtype="int64")
        loss, _ = transformer.transformer(
            *(v[n] for n in FEED_NAMES),
            src_vocab_size=cfg["vocab"], trg_vocab_size=cfg["vocab"],
            n_layer=cfg["n_layer"], n_head=h, d_model=cfg["d_model"],
            d_inner=cfg["d_inner"], d_key=cfg["d_key"], d_value=cfg["d_value"],
            dropout=cfg["dropout"], max_length=t,
        )
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss
