"""The Transformer training program of the parity tests, built the same way
in the JAX package and in the torch port (tests/test_torch_training.py,
tests/test_torch_passes.py, tests/test_torch_flash_attention.py), and the
runs that train it in each package. Feeds are numpy arrays from
paddle_tpu_torch.tools.profile_training.make_batch, which makes them from a
seed as the reference's data pipeline does, for both packages. The JAX
package is imported inside jax_run only."""

import collections

import numpy as np

from paddle_tpu_torch.tools.profile_training import FEED_NAMES, make_batch  # noqa: F401

# small enough for the CPU suite, large enough that every fused family's
# path predicate holds: rows = b * t = 128, widths multiples of 128
SMALL = dict(n_layer=1, n_head=2, d_model=128, d_inner=256, d_key=64, d_value=64,
             vocab=96, batch=4, t=32, dropout=0.0)
# the flash recipe at the same widths: unpadded batches, no bias feeds
SMALL_FLASH = dict(SMALL, use_flash=True, padded=False)


def build(pkg, transformer, cfg, lr=1e-3):
    """(main, startup, loss) of one training step: the model of
    models/transformer.py under Adam, built with `pkg` (paddle_tpu.fluid or
    paddle_tpu_torch) and its `transformer` module; under use_flash with no
    bias data vars."""
    t, h = cfg["t"], cfg["n_head"]
    flash = cfg.get("use_flash", False)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        v = {}
        for name in FEED_NAMES:
            if name.endswith("bias"):
                v[name] = None if flash else L.data(name=name, shape=[h, t, t],
                                                    dtype="float32")
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
            use_flash=flash, padded=cfg.get("padded"),
        )
        pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss


def jax_run(cfg, pipeline, steps):
    """`steps` Adam steps of the JAX package under `pipeline` from seed 7:
    losses, the step-1 @GRADs, the state before and after, the op counts
    and the fused families' dispatches."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu import flags as jflags
    from paddle_tpu.executor import Scope, scope_guard
    from paddle_tpu.models import transformer
    from paddle_tpu.ops import pallas_kernels as jpk

    from paddle_tpu_torch import convert

    jflags.set_flags({"pass_pipeline": pipeline})
    jpk.KERNEL_DISPATCHES.clear()
    try:
        main, startup, loss = build(jfluid, transformer, cfg)
        grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
                 if p.trainable]
        names = convert.persistable_names(main)
        scope = Scope(seed=7)
        exe = jfluid.Executor()
        losses, step1 = [], None
        with scope_guard(scope):
            exe.run(startup)
            init = {n: np.array(np.asarray(scope.vars[n])) for n in names}
            for s in range(steps):
                out = exe.run(main, feed=make_batch(cfg, s),
                              fetch_list=[loss.name] + grads)
                losses.append(np.asarray(out[0]).copy())
                if s == 0:
                    step1 = {g: np.asarray(v).copy() for g, v in zip(grads, out[1:])}
            final = {n: np.array(np.asarray(scope.vars[n])) for n in names}
        ops = collections.Counter(op.type for op in main.global_block().ops)
        return dict(losses=np.stack(losses), step1=step1, init=init, final=final,
                    grads=grads, names=names, dispatches=dict(jpk.KERNEL_DISPATCHES),
                    ops=ops)
    finally:
        jflags.set_flags({"pass_pipeline": ""})


def port_run(cfg, pipeline, init, steps):
    """The same `steps` steps through the torch port on the CPU, from the
    JAX package's initial state `init` (carried in by name)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import fused

    pt.flags.set_flags({"pass_pipeline": pipeline})
    fused.reset_stats()
    try:
        main, startup, loss = build(pt, transformer, cfg)
        grads = [p.name + "@GRAD" for p in main.global_block().all_parameters()
                 if p.trainable]
        names = convert.persistable_names(main)
        scope = pt.Scope(seed=0, place=pt.CPUPlace())
        exe = pt.Executor(pt.CPUPlace())
        losses, step1 = [], None
        with pt.scope_guard(scope):
            exe.run(startup)
            convert.load_into_scope(scope, init, names)
            for s in range(steps):
                out = exe.run(main, feed=make_batch(cfg, s),
                              fetch_list=[loss.name] + grads)
                losses.append(out[0])
                if s == 0:
                    step1 = dict(zip(grads, out[1:]))
            final = convert.scope_to_numpy(scope, names)
        return dict(losses=np.stack(losses), step1=step1, final=final, grads=grads,
                    names=names, stats=fused.stats(), program=main)
    finally:
        pt.flags.set_flags({"pass_pipeline": ""})
