"""Rank bodies of the ParallelExecutor tests: each test spawns 2 or 4
processes that join a gloo group through a FileStore under the test's
tmp_path and run one scenario of this module. It imports torch and the
port only (a child never imports JAX); the model builders take a fluid
module, so the JAX side of a test builds the same programs from
paddle_tpu.fluid.

`spawn(world, scenario, payload, tmp_path)` runs `scenario(rank, world,
payload)` on every rank (one thread each, a 60 s gloo timeout, a time limit
on the join) and returns each rank's result."""

import datetime
import os
import pickle
import traceback

import numpy as np

JOIN_TIMEOUT_S = 150

# ---------------------------------------------------------------------------
# models (either package's fluid)
# ---------------------------------------------------------------------------


def build_mlp(fluid, optimizer="sgd", moment_dtype=None):
    """The JAX PE tests' MLP: fc 16 -> 32 relu -> 4, softmax cross entropy."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        if optimizer == "adam":
            kw = {"moment_dtype": moment_dtype} if moment_dtype else {}
            fluid.optimizer.Adam(learning_rate=0.01, **kw).minimize(loss)
        else:
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def mlp_batches(n_steps, seed, batch=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        x = rng.randn(batch, 16).astype("float32")
        y = np.abs(x[:, :4]).argmax(1).astype("int64").reshape(batch, 1)
        out.append({"x": x, "y": y})
    return out


def build_se_resnext(fluid, models):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        net = models.se_resnext.SE_ResNeXt(depth_override=[1, 1, 1, 1],
                                           filters_override=[32, 32, 32, 32])
        logits = net.net(img, class_dim=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    # dropout 0: the two packages' masks differ (the JAX PE Transformer
    # test's choice)
    for op in main.global_block().ops:
        if op.type == "dropout":
            op.attrs["dropout_prob"] = 0.0
    return main, startup, loss


def se_resnext_batches():
    rng = np.random.RandomState(1)
    return [{"img": rng.randn(8, 3, 32, 32).astype("float32"),
             "label": rng.randint(0, 4, (8, 1)).astype("int64")} for _ in range(3)]


TRANSFORMER_T, TRANSFORMER_VOCAB = 8, 32
TRANSFORMER_FEEDS = ("src_word", "src_pos", "trg_word", "trg_pos", "lbl", "lbl_w")


def build_transformer(fluid, models):
    t, vocab = TRANSFORMER_T, TRANSFORMER_VOCAB
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds = {}
        for name, shape, dtype in [("src_word", [t], "int64"), ("src_pos", [t], "int64"),
                                   ("trg_word", [t], "int64"), ("trg_pos", [t], "int64"),
                                   ("lbl", [t], "int64"), ("lbl_w", [t, 1], "float32")]:
            feeds[name] = fluid.layers.data(name=name, shape=shape, dtype=dtype)
        loss, _ = models.transformer.transformer(
            feeds["src_word"], feeds["src_pos"], feeds["trg_word"], feeds["trg_pos"],
            None, None, None, feeds["lbl"], feeds["lbl_w"],
            src_vocab_size=vocab, trg_vocab_size=vocab, n_layer=1, n_head=2, d_model=16,
            d_inner=32, d_key=8, d_value=8, dropout=0.0, max_length=t + 1)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def build_transformer_flash(fluid, models, n_layer=2, n_head=4):
    """A small flash Transformer (use_flash, unpadded batches, dropout 0):
    2 layers of 4 heads of 8, d_model 32, the tp test's model."""
    t, vocab = TRANSFORMER_T, TRANSFORMER_VOCAB
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds = {}
        for name, shape, dtype in [("src_word", [t], "int64"), ("src_pos", [t], "int64"),
                                   ("trg_word", [t], "int64"), ("trg_pos", [t], "int64"),
                                   ("lbl", [t], "int64"), ("lbl_w", [t, 1], "float32")]:
            feeds[name] = fluid.layers.data(name=name, shape=shape, dtype=dtype)
        loss, _ = models.transformer.transformer(
            feeds["src_word"], feeds["src_pos"], feeds["trg_word"], feeds["trg_pos"],
            None, None, None, feeds["lbl"], feeds["lbl_w"],
            src_vocab_size=vocab, trg_vocab_size=vocab, n_layer=n_layer, n_head=n_head,
            d_model=32, d_inner=64, d_key=8, d_value=8, dropout=0.0, max_length=t + 1,
            use_flash=True, padded=False)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def transformer_batches():
    t, vocab = TRANSFORMER_T, TRANSFORMER_VOCAB
    rng = np.random.RandomState(2)
    pos = np.tile(np.arange(t), (8, 1)).astype("int64")
    out = []
    for _ in range(5):
        vals = (rng.randint(0, vocab, (8, t)).astype("int64"), pos,
                rng.randint(0, vocab, (8, t)).astype("int64"), pos,
                rng.randint(0, vocab, (8, t)).astype("int64"), np.ones((8, t, 1), "float32"))
        out.append(dict(zip(TRANSFORMER_FEEDS, vals)))
    return out


MESH_VOCAB, MESH_D, MESH_HEADS, MESH_T = 64, 16, 2, 8


def build_full_mesh(fluid):
    """tests/test_parallel_pkg.py's model with every kind of the slice:
    the batch over dp, a distributed_embedding over ep, ring attention over
    sp; SGD."""
    V, D, H, T = MESH_VOCAB, MESH_D, MESH_HEADS, MESH_T
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, T, 1], dtype="int64",
                                append_batch_size=False)
        label = fluid.layers.data(name="label", shape=[-1, 1], dtype="int64",
                                  append_batch_size=False)
        emb = fluid.layers.distributed_embedding(tok, size=[V, D])
        qkv = fluid.layers.fc(emb, size=3 * D, num_flatten_dims=2, bias_attr=False)
        q, k, v = fluid.layers.split(qkv, 3, dim=2)

        def heads(x):
            r = fluid.layers.reshape(x, [0, 0, H, D // H])
            return fluid.layers.transpose(r, [0, 2, 1, 3])

        att = fluid.layers.ring_attention(heads(q), heads(k), heads(v), causal=True)
        att = fluid.layers.transpose(att, [0, 2, 1, 3])
        att = fluid.layers.reshape(att, [0, 0, D])
        pooled = fluid.layers.reduce_mean(att, dim=[1])
        logits = fluid.layers.fc(pooled, size=4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def full_mesh_batches():
    rng = np.random.RandomState(0)
    return [{"tok": rng.randint(0, MESH_VOCAB, (8, MESH_T, 1)).astype("int64"),
             "label": rng.randint(0, 4, (8, 1)).astype("int64")} for _ in range(4)]


DFM_ROWS, DFM_FIELDS, DFM_DIM = 512, 4, 8


def build_deepfm(fluid, models, distributed):
    """tests/test_deepfm.py's small DeepFM under SGD: dense tables
    (is_sparse=False), or the EmbeddingEngine's row-sharded tables with
    sparse grads (use_distributed=True, is_sparse=True)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[DFM_FIELDS, 1], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss = models.deepfm.deepfm(ids, label, num_features=DFM_ROWS, num_fields=DFM_FIELDS,
                                    embedding_size=DFM_DIM, layer_sizes=(16,),
                                    is_sparse=distributed, use_distributed=distributed)[0]
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def deepfm_batches(n=5, batch=32):
    rng = np.random.RandomState(7)
    return [{"ids": rng.randint(0, DFM_ROWS, (batch, DFM_FIELDS, 1)).astype("int64"),
             "label": (rng.rand(batch, 1) < 0.5).astype("float32")} for _ in range(n)]


# ---------------------------------------------------------------------------
# port helpers
# ---------------------------------------------------------------------------


def _port():
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.models.deepfm  # noqa: F401
    import paddle_tpu_torch.models.se_resnext  # noqa: F401
    import paddle_tpu_torch.models.transformer  # noqa: F401
    from paddle_tpu_torch import models

    return fluid, models


def port_state(fluid, startup, init):
    """A CPU scope holding the port's startup state overwritten by `init`
    (the JAX startup scope's arrays, by name)."""
    from paddle_tpu_torch import convert

    scope = fluid.Scope(seed=3, place=fluid.CPUPlace())
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    if init is not None:
        convert.load_into_scope(scope, init, sorted(init))
    return scope


def pe_losses(fluid, main, loss, scope, batches, strategy=None, mesh_config=None):
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                build_strategy=strategy, mesh_config=mesh_config)
    out = []
    for feed in batches:
        (val,) = pe.run(fetch_list=[loss.name], feed=feed)
        out.append(float(np.asarray(val).reshape(-1)[0]))
    return out, pe


def zero1_strategy(fluid):
    s = fluid.BuildStrategy()
    s.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return s


# ---------------------------------------------------------------------------
# scenarios: scenario(rank, world, payload) -> picklable result
# ---------------------------------------------------------------------------


def sc_mlp(rank, world, p):
    fluid, _ = _port()
    main, startup, loss = build_mlp(fluid)
    losses, pe = pe_losses(fluid, main, loss, port_state(fluid, startup, p["init"]),
                           mlp_batches(20, 0))
    bad = None
    try:
        pe.run(fetch_list=[loss.name], feed=mlp_batches(1, 9, batch=world + 1)[0])
    except ValueError as e:
        bad = str(e)
    return {"losses": losses, "indivisible": bad, "device_count": pe.device_count,
            "topology": pe.topology}


def sc_zero1(rank, world, p):
    fluid, _ = _port()
    out = {}
    for name, strategy in (("allreduce", None), ("zero1", zero1_strategy(fluid))):
        main, startup, loss = build_mlp(fluid, "adam")
        scope = port_state(fluid, startup, p["init"])
        out[name], _ = pe_losses(fluid, main, loss, scope, mlp_batches(6, 7), strategy)
        out[name + "_shards"] = {n: tuple(scope.vars[n].shape) for n in sorted(scope.row_shards)}
    return out


def sc_zero1_ckpt(rank, world, p):
    """3 ZeRO-1 steps, save_persistables (whole variables), a fresh scope
    with load_persistables (resharded), 3 more steps."""
    fluid, _ = _port()
    batches = mlp_batches(6, 11)
    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, p["init"])
    full, _ = pe_losses(fluid, main, loss, scope, batches, zero1_strategy(fluid))

    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, p["init"])
    head, _ = pe_losses(fluid, main, loss, scope, batches[:3], zero1_strategy(fluid))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, p["dir"], main)
    saved = sorted(os.listdir(p["dir"]))

    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, None)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                build_strategy=zero1_strategy(fluid))
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, p["dir"], main)
    tail = []
    for feed in batches[3:]:
        (val,) = pe.run(fetch_list=[loss.name], feed=feed)
        tail.append(float(np.asarray(val).reshape(-1)[0]))
    shapes = {n: tuple(np.load(os.path.join(p["dir"], n + ".npy")).shape)
              for n in sorted(scope.row_shards)}
    return {"full": full, "resumed": head + tail, "saved": saved, "saved_shapes": shapes}


def sc_model(rank, world, p):
    """losses of p["model"] under the PE from the JAX startup state."""
    fluid, models = _port()
    if p["model"] == "se_resnext":
        main, startup, loss = build_se_resnext(fluid, models)
        batches = se_resnext_batches()
    elif p["model"] == "transformer":
        main, startup, loss = build_transformer(fluid, models)
        batches = transformer_batches()
    else:
        main, startup, loss = build_full_mesh(fluid)
        batches = full_mesh_batches()
    from paddle_tpu_torch.parallel import MeshConfig

    mesh_config = MeshConfig(**p["mesh"]) if p.get("mesh") else None
    losses, pe = pe_losses(fluid, main, loss, port_state(fluid, startup, p["init"]), batches,
                           mesh_config=mesh_config)
    return {"losses": losses, "mesh": dict(pe.mesh.shape)}


def sc_deepfm(rank, world, p):
    fluid, models = _port()
    from paddle_tpu_torch.parallel import MeshConfig

    main, startup, loss = build_deepfm(fluid, models, True)
    scope = port_state(fluid, startup, p["init"])
    losses, pe = pe_losses(fluid, main, loss, scope, deepfm_batches(),
                           mesh_config=MeshConfig(dp=1, ep=world))
    tables = {}
    from paddle_tpu_torch.parallel import collectives

    for n in ("fm_emb", "fm_first"):
        tables[n] = collectives.gathered_state(scope, n).numpy()
    shard_rows = {n: int(scope.vars[n].shape[0]) for n in sorted(scope.row_shards)}
    if p.get("dir"):
        from paddle_tpu_torch.embedding import engines_of

        eng = [e for e in engines_of(main) if e.table.name == "fm_emb"][0]
        manifest = eng.save_sharded(scope, p["dir"], num_shards=2, program=main)
        before = collectives.gathered_state(scope, "fm_emb").clone()
        scope.vars["fm_emb"].zero_()
        eng.load_sharded(scope, p["dir"])
        after = collectives.gathered_state(scope, "fm_emb")
        tables["roundtrip_equal"] = bool((before == after).all())
        tables["manifest_shards"] = None if manifest is None else manifest["num_shards"]
    return {"losses": losses, "tables": tables, "shard_rows": shard_rows}


def sc_ring(rank, world, p):
    """ring_attention_sharded at sp = world against the plain form: out and
    the q, k, v grads, causal and not (each rank returns its results)."""
    import torch

    from paddle_tpu_torch.parallel import MeshConfig, make_mesh
    from paddle_tpu_torch.parallel.ring_attention import attention_plain, ring_attention_sharded

    mesh = make_mesh(MeshConfig(dp=1, sp=world), device="cpu")
    out = {}
    for causal in (False, True):
        q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3)
                       for i, a in enumerate(p["qkvdo"]))
        o = ring_attention_sharded(q, k, v, mesh, causal=causal)
        o.backward(do)
        out[causal] = [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]
        qr, kr, vr = (torch.from_numpy(a).requires_grad_() for a in p["qkvdo"][:3])
        ref = attention_plain(qr, kr, vr, causal)
        ref.backward(do)
        out[("plain", causal)] = [t.detach().numpy() for t in (ref, qr.grad, kr.grad, vr.grad)]
    return out


def sc_collectives(rank, world, p):
    """Every wrapper on a dp=2 x sp=2 mesh, with each rank's input its
    global rank."""
    import torch

    from paddle_tpu_torch.parallel import MeshConfig, collectives, make_mesh

    mesh = make_mesh(MeshConfig(dp=2, sp=2), device="cpu")
    x = torch.arange(4, dtype=torch.float32).reshape(4, 1) + 10 * rank
    with mesh:
        return {
            "coords": (collectives.axis_index("dp"), collectives.axis_index("sp"),
                       collectives.axis_size("dp"), collectives.axis_size("sp")),
            "sum_dp": collectives.all_reduce(x, "dp").numpy(),
            "max_sp": collectives.all_reduce(x, "sp", op="max").numpy(),
            "mean_dp": collectives.all_reduce(x, "dp", op="mean").numpy(),
            "gather_sp": collectives.all_gather(x, "sp").numpy(),
            "gather_sp_1": collectives.all_gather(x, "sp", axis=1).numpy(),
            "stack_dp": collectives.all_gather(x, "dp", tiled=False).numpy(),
            "scatter_dp": collectives.reduce_scatter(x, "dp").numpy(),
            "shift_sp": collectives.ppermute_shift(x, "sp").numpy(),
            "bcast_dp": collectives.broadcast(x, "dp", root=1).numpy(),
        }


# ---------------------------------------------------------------------------
# sharding rules (tp / fsdp), the pipeline, steps_per_run
# ---------------------------------------------------------------------------


def _strategy(fluid, p):
    s = fluid.BuildStrategy()
    s.sharding_rules = p.get("rules")
    if p.get("fuse"):
        s.pass_pipeline = "training_fused"
    if p.get("reduce"):
        s.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return s


def _mesh(p, key="mesh"):
    from paddle_tpu_torch.parallel import MeshConfig

    return MeshConfig(**p[key]) if p.get(key) else None


def _stored(scope):
    """{name: (piece shape, layout)} of the scope's sharded state."""
    return {n: (tuple(scope.vars[n].shape), e[1]) for n, e in sorted(scope.row_shards.items())}


def sc_rules(rank, world, p):
    """The MLP (Adam) through the PE under p["mesh"] and p["rules"]: losses,
    the stored pieces, what the fused families dispatched and the
    collectives a step."""
    fluid, _ = _port()
    from paddle_tpu_torch.ops import fused

    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, p["init"])
    fused.reset_stats()
    losses, pe = pe_losses(fluid, main, loss, scope, mlp_batches(p.get("steps", 6), p["seed"]),
                           _strategy(fluid, p), _mesh(p))
    stats = fluid.Executor.stats()
    return {"losses": losses, "stored": _stored(scope), "dispatches": stats["dispatches"],
            "collectives": stats["collectives"], "device_count": pe.device_count}


def sc_rules_ckpt(rank, world, p):
    """3 steps under p["mesh"], save_persistables (whole variables), a
    fresh scope on p["mesh2"] with load_persistables (resharded), 3 more."""
    fluid, _ = _port()
    batches = mlp_batches(6, p["seed"])
    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, p["init"])
    head, _ = pe_losses(fluid, main, loss, scope, batches[:3], _strategy(fluid, p), _mesh(p))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, p["dir"], main)
    head_stored = _stored(scope)
    main, startup, loss = build_mlp(fluid, "adam")
    scope = port_state(fluid, startup, None)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                build_strategy=_strategy(fluid, p), mesh_config=_mesh(p, "mesh2"))
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, p["dir"], main)
    tail = []
    for feed in batches[3:]:
        (val,) = pe.run(fetch_list=[loss.name], feed=feed)
        tail.append(float(np.asarray(val).reshape(-1)[0]))
    return {"losses": head + tail, "head_stored": head_stored, "tail_stored": _stored(scope)}


def build_pp_mlp(fluid, optimizer="sgd", guard=False):
    """tests/test_pp_program.py's MLP: fc 16 -> 48 -> 32 -> 24 relu -> 4,
    every layer a different width; with `guard`, its device_guard form (one
    fc a stage over 4 stages)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        if guard:
            with fluid.device_guard("pp:0"):
                h = fluid.layers.fc(x, size=32, act="relu")
            with fluid.device_guard("pp:1"):
                h = fluid.layers.fc(h, size=24, act="relu")
            with fluid.device_guard("pp:2"):
                h = fluid.layers.fc(h, size=16, act="relu")
            with fluid.device_guard("pp:3"):
                logits = fluid.layers.fc(h, size=4)
                loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        else:
            h = x
            for w in (48, 32, 24):
                h = fluid.layers.fc(h, size=w, act="relu")
            logits = fluid.layers.fc(h, size=4)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        if optimizer == "momentum":
            fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
        else:
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def sc_pp(rank, world, p):
    """The pp MLP through the PE under p["mesh"] (pp > 1), each of
    p["runs"] (schedule, n_micro, optimizer, reduce): losses and the stage
    plan; then a run's fetch of a first-stage value and a steps_per_run > 1
    call, which raise."""
    fluid, _ = _port()
    out = {}
    for schedule, n_micro, opt, reduce in p["runs"]:
        main, startup, loss = build_pp_mlp(fluid, opt, p.get("guard", False))
        scope = port_state(fluid, startup, p["init"][opt])
        es = fluid.ExecutionStrategy()
        es.pipeline_schedule = schedule
        es.num_microbatches = n_micro
        bs = fluid.BuildStrategy()
        if reduce:
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                    build_strategy=bs, exec_strategy=es,
                                    mesh_config=_mesh(p))
        losses = []
        for feed in mlp_batches(p.get("steps", 6), p["seed"]):
            (val,) = pe.run(fetch_list=[loss.name], feed=feed)
            losses.append(float(np.asarray(val).reshape(-1)[0]))
        plan = next(iter(pe._cache.values()))
        plan = getattr(plan, "block", plan).stage_plan
        out[(schedule, n_micro, opt, reduce)] = {"losses": losses, "plan": plan}
    raised = {}
    main, startup, loss = build_pp_mlp(fluid, guard=p.get("guard", False))
    scope = port_state(fluid, startup, p["init"]["sgd"])
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                mesh_config=_mesh(p))
    feed = mlp_batches(1, p["seed"])[0]
    first = main.global_block().ops[0].output_arg_names[0]  # the first op's: stage 0
    for key, call in (
            ("fetch", lambda: pe.run(fetch_list=[loss.name, first], feed=feed)),
            ("multistep", lambda: pe.run(fetch_list=[loss.name], feed={
                n: np.stack([v, v]) for n, v in feed.items()}, steps_per_run=2))):
        try:
            call()
            raised[key] = None
        except (ValueError, NotImplementedError) as e:
            raised[key] = (type(e).__name__, str(e))
    out["raised"] = raised
    return out


def sc_layout_collectives(rank, world, p):
    """The layout collectives on a dp=2 x tp=2 mesh, forward and backward:
    gather_dim / scatter_dim over tp and over (dp, tp), Megatron's
    copy_to_axes / reduce_from_axes, send_recv between dp neighbours; each
    rank's input its global rank."""
    import torch

    from paddle_tpu_torch.parallel import MeshConfig, collectives as C, make_mesh

    mesh = make_mesh(MeshConfig(dp=2, tp=2), device="cpu")
    out = {"coords": (mesh.index("dp"), mesh.index("tp"), mesh.index(("dp", "tp")),
                      mesh.index(("tp", "dp")))}
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank).requires_grad_(True)
    for key, fn in (("gather_tp", lambda t: C.gather_dim(t, "tp", 1, mesh)),
                    ("gather_dptp", lambda t: C.gather_dim(t, ("dp", "tp"), 0, mesh)),
                    ("gather_tpdp", lambda t: C.gather_dim(t, ("tp", "dp"), 0, mesh)),
                    ("scatter_tp", lambda t: C.scatter_dim(t, "tp", 0, mesh)),
                    ("copy_tp", lambda t: C.copy_to_axes(t, "tp", mesh)),
                    ("reduce_tp", lambda t: C.reduce_from_axes(t, "tp", mesh))):
        x.grad = None
        y = fn(x)
        (y * (1 + torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape))).sum().backward()
        out[key] = (y.detach().numpy(), x.grad.numpy())
    peer = 2 * (1 - mesh.index("dp")) + mesh.index("tp")
    (got,) = C.send_recv(sends=[(x.detach() * 2, peer)],
                         recvs=[((2, 3), torch.float32, torch.device("cpu"), peer)])
    out["send_recv"] = got.numpy()
    return out


def sc_pp_ckpt(rank, world, p):
    """The pp MLP under BuildStrategy.pipeline_stages = world (no
    MeshConfig): 6 steps; then 3 steps, save_persistables, a fresh scope of
    another seed with load_persistables, 3 more."""
    fluid, _ = _port()
    batches = mlp_batches(6, 4)
    bs = fluid.BuildStrategy()
    bs.pipeline_stages = world
    exe = fluid.Executor(fluid.CPUPlace())

    def steps(pe, loss, feeds):
        return [float(np.asarray(pe.run(fetch_list=[loss.name], feed=f)[0]).reshape(-1)[0])
                for f in feeds]

    main, startup, loss = build_pp_mlp(fluid)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, build_strategy=bs,
                                scope=port_state(fluid, startup, p["init"]))
    full, mesh = steps(pe, loss, batches), dict(pe.mesh.shape)
    main, startup, loss = build_pp_mlp(fluid)
    scope = port_state(fluid, startup, p["init"])
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, build_strategy=bs,
                                scope=scope)
    steps(pe, loss, batches[:3])
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, p["dir"], main)
    main, startup, loss = build_pp_mlp(fluid)
    scope = fluid.Scope(seed=99, place=fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, p["dir"], main)
    pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, build_strategy=bs,
                                scope=scope)
    return {"full": full, "resumed": steps(pe, loss, batches[3:]), "mesh": mesh}


def sc_gpipe(rank, world, p):
    """parallel.pipeline.gpipe over a stack of tanh(x w + b) stages
    (tests/test_pipeline_parallel.py's) at each (pp, n_micro) of p["cases"]
    (dp fills the rest): its output, the gradients of a mean-square loss
    through it against the stages applied one after the other on this
    rank, an SGD loop's losses, and the error an indivisible stack raises."""
    import torch

    from paddle_tpu_torch.parallel import MeshConfig, make_mesh
    from paddle_tpu_torch.parallel.pipeline import gpipe

    def stage_fn(q, x):
        return torch.tanh(x @ q["w"] + q["b"])

    def sequential(params, x):
        for i in range(params["w"].shape[0]):
            x = stage_fn({k: v[i] for k, v in params.items()}, x)
        return x

    out = {}
    for pp, n_micro in p["cases"]:
        mesh = make_mesh(MeshConfig(dp=-1, pp=pp), device="cpu")
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p["params"].items()}
        x = torch.from_numpy(p["x"])
        y = gpipe(stage_fn, params, x, n_micro, mesh)
        loss = ((y - torch.from_numpy(p["tgt"])) ** 2).mean()
        loss.backward()
        ref_params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p["params"].items()}
        ref = sequential(ref_params, x)
        ((ref - torch.from_numpy(p["tgt"])) ** 2).mean().backward()
        out[(pp, n_micro)] = {
            "y": y.detach().numpy(), "seq": ref.detach().numpy(), "mesh": dict(mesh.shape),
            "grads": {k: v.grad.numpy() for k, v in params.items()},
            "seq_grads": {k: v.grad.numpy() for k, v in ref_params.items()}}
    mesh = make_mesh(MeshConfig(dp=-1, pp=world), device="cpu")
    params = {k: torch.from_numpy(v).clone() for k, v in p["params"].items()}
    losses = []
    for _ in range(8):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        y = gpipe(stage_fn, leaves, torch.from_numpy(p["x"]), 4, mesh)
        loss = ((y - 0.1 * torch.from_numpy(p["tgt"])) ** 2).mean()
        loss.backward()
        losses.append(float(loss))
        params = {k: (v - 0.1 * leaves[k].grad).detach() for k, v in params.items()}
    out["train"] = losses
    try:
        gpipe(stage_fn, {k: v[:6] for k, v in params.items()}, torch.from_numpy(p["x"]), 4,
              mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def sc_transformer_tp(rank, world, p):
    """The small flash Transformer through the PE under p["mesh"] with the
    Megatron rules of tools.profile_training.tp_rules: losses, the head
    counts flash_attention's forward saw, the stored pieces and the
    collectives of the steps."""
    fluid, models = _port()
    from paddle_tpu_torch.ops import flash_attention, fused
    from paddle_tpu_torch.tools import profile_training

    main, startup, loss = build_transformer_flash(fluid, models)
    scope = port_state(fluid, startup, p["init"])
    seen = []
    forward = flash_attention.flash_forward

    def spy(q, *args, **kw):
        seen.append(int(q.shape[1]))
        return forward(q, *args, **kw)

    flash_attention.flash_forward = spy
    try:
        fused.reset_stats()
        strategy = _strategy(fluid, dict(p, rules=profile_training.tp_rules(main)))
        losses, pe = pe_losses(fluid, main, loss, scope, transformer_batches(), strategy,
                               _mesh(p))
    finally:
        flash_attention.flash_forward = forward
    return {"losses": losses, "heads": sorted(set(seen)), "stored": _stored(scope),
            "collectives": fluid.Executor.stats()["collectives"]}


def sc_transformer_pp(rank, world, p):
    """The small flash Transformer through the PE under p["mesh"] (pp > 1)
    and each schedule of p["schedules"], under p["pipeline"] (the fused
    families in the stages' autograd when "training_fused"): losses and the
    stage plan."""
    fluid, models = _port()
    out = {}
    for schedule in p["schedules"]:
        main, startup, loss = build_transformer_flash(fluid, models)
        scope = port_state(fluid, startup, p["init"])
        es = fluid.ExecutionStrategy()
        es.pipeline_schedule = schedule
        es.num_microbatches = p["n_micro"]
        bs = fluid.BuildStrategy()
        bs.pass_pipeline = p.get("pipeline")
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                    build_strategy=bs, exec_strategy=es, mesh_config=_mesh(p))
        losses = []
        for feed in transformer_batches():
            (val,) = pe.run(fetch_list=[loss.name], feed=feed)
            losses.append(float(np.asarray(val).reshape(-1)[0]))
        block = next(iter(pe._cache.values()))
        out[schedule] = {"losses": losses, "plan": getattr(block, "block", block).stage_plan}
    return out


def sc_multistep(rank, world, p):
    """The JAX multi-step tests' MLP through the PE at dp = world: k steps
    in one call (stacked feeds) against k single runs of another PE, losses
    and final parameters."""
    fluid, _ = _port()
    out = {}
    for k in (1, p["k"]):
        main, startup, loss = build_sq_mlp(fluid, p.get("dropout", 0.0))
        scope = port_state(fluid, startup, p["init"])
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
        batches = sq_batches(p["steps"], p["seed"])
        losses = []
        for i in range(0, len(batches), k):
            if k == 1:
                (val,) = pe.run(fetch_list=[loss.name], feed=batches[i])
                losses.append(float(np.asarray(val).reshape(-1)[0]))
            else:
                stacked = {n: np.stack([b[n] for b in batches[i:i + k]]) for n in batches[0]}
                (val,) = pe.run(fetch_list=[loss.name], feed=stacked, steps_per_run=k)
                losses.extend(float(v) for v in np.asarray(val).reshape(-1))
        out[k] = {"losses": losses, "params": {n: scope.vars[n].numpy().copy()
                                               for n in sorted(scope.vars) if n.startswith("fc_")}}
    return out


def sc_multistep_reader(rank, world, p):
    """The multi-step py_reader form through the PE at dp = world: a
    PyReader over the global batches in the program's readers, pulled
    steps_per_run=k at a time to the epoch's end (a shorter tail, then
    EOFException), against the same batches fed as stacked global dicts to
    another PE. The reader stages this rank's rows only."""
    fluid, _ = _port()
    from paddle_tpu_torch.py_reader import EOFException, PyReader

    k = p["k"]
    batches = sq_batches(p["steps"], p["seed"], batch=p["batch"])
    out = {}
    for form in ("dict", "reader"):
        main, startup, loss = build_sq_mlp(fluid)
        scope = port_state(fluid, startup, p["init"])
        reader = None
        if form == "reader":
            reader = PyReader(["x", "y"], capacity=4, place=fluid.CPUPlace())
            reader.decorate_tensor_provider(lambda: iter(batches))
            main._py_readers = [reader]
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)
        losses, shapes = [], []
        if form == "reader":
            reader.start()
            out["staged_rows"] = tuple(reader.next_batch()["x"].shape)
            reader.reset()
            reader.start()
            try:
                while True:
                    (val,) = pe.run(fetch_list=[loss.name], steps_per_run=k)
                    shapes.append(np.asarray(val).shape[0])
                    losses.extend(float(v) for v in np.asarray(val).reshape(-1))
            except EOFException:
                out["eof"] = True
        else:
            for i in range(0, len(batches), k):
                chunk = batches[i:i + k]
                stacked = {n: np.stack([b[n] for b in chunk]) for n in batches[0]}
                (val,) = pe.run(fetch_list=[loss.name], feed=stacked, steps_per_run=len(chunk))
                shapes.append(np.asarray(val).shape[0])
                losses.extend(float(v) for v in np.asarray(val).reshape(-1))
        out[form] = {"losses": losses, "shapes": shapes,
                     "params": {n: scope.vars[n].numpy().copy()
                                for n in sorted(scope.vars) if n.startswith("fc_")}}
    return out


def sc_reader_staging(rank, world, p):
    """The PE's pull at dp = world whatever the reader staged: a reader
    started before the PE (its epoch staged whole and split by the pull), a
    cache_epoch reader whose cached epoch was staged whole (staged again as
    this rank's rows once the PE gives its placement), each against the
    same batches fed as stacked global dicts; and an epoch that ends on a
    batch whose rows dp does not divide, pulled from a reader started
    before and after the PE: the pull raises ValueError, as the dict feed
    of that batch does."""
    fluid, _ = _port()
    from paddle_tpu_torch.py_reader import EOFException, PyReader

    k = p["k"]
    batches = sq_batches(p["steps"], p["seed"], batch=p["batch"])
    odd = {n: v[:p["batch"] - 1] for n, v in batches[0].items()}

    def params(scope):
        return {n: scope.vars[n].numpy().copy() for n in sorted(scope.vars) if n.startswith("fc_")}

    def pe_of(main, loss, scope):
        return fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope)

    out = {}
    main, startup, loss = build_sq_mlp(fluid)
    scope = port_state(fluid, startup, p["init"])
    pe, losses = pe_of(main, loss, scope), []
    for i in range(0, len(batches), k):
        stacked = {n: np.stack([b[n] for b in batches[i:i + k]]) for n in batches[0]}
        (val,) = pe.run(fetch_list=[loss.name], feed=stacked,
                        steps_per_run=len(batches[i:i + k]))
        losses.extend(float(v) for v in np.asarray(val).reshape(-1))
    out["dict"] = {"losses": losses, "params": params(scope)}
    try:
        pe.run(fetch_list=[loss.name], feed=odd)
    except ValueError as e:
        out["dict_odd"] = str(e)

    def reader_of(epoch, cache=False):
        reader = PyReader(["x", "y"], capacity=4, cache_epoch=cache, place=fluid.CPUPlace())
        reader.decorate_tensor_provider(lambda: (reader.sources.append(1), iter(epoch))[1])
        reader.sources = []
        return reader

    for form in ("before", "cached"):
        main, startup, loss = build_sq_mlp(fluid)
        scope = port_state(fluid, startup, p["init"])
        reader = reader_of(batches, cache=form == "cached")
        main._py_readers = [reader]
        reader.start()
        if form == "cached":  # one epoch staged whole and cached
            try:
                while True:
                    reader.next_batch()
            except EOFException:
                pass
        pe = pe_of(main, loss, scope)
        if form == "cached":
            reader.start()
        got = {"whole": reader.staged_on[1] is None, "losses": []}
        try:
            while True:
                (val,) = pe.run(fetch_list=[loss.name], steps_per_run=k)
                got["losses"].extend(float(v) for v in np.asarray(val).reshape(-1))
        except EOFException:
            pass
        got["params"], got["sources"] = params(scope), len(reader.sources)
        out[form] = got
    for form in ("odd_before", "odd_after"):
        main, startup, loss = build_sq_mlp(fluid)
        scope = port_state(fluid, startup, p["init"])
        reader = reader_of(batches[:2] + [odd])
        main._py_readers = [reader]
        if form == "odd_before":
            reader.start()
        pe = pe_of(main, loss, scope)
        if form == "odd_after":
            reader.start()
        for _ in range(2):
            pe.run(fetch_list=[loss.name])
        try:
            pe.run(fetch_list=[loss.name])
        except ValueError as e:
            out[form] = str(e)
        reader.reset()
    return out


def build_sq_mlp(fluid, dropout=0.0, seed=0):
    """tests/test_multistep.py's MLP: fc 8 -> 16 relu [-> dropout] -> 1,
    squared error, SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=dropout)
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = seed
    return main, startup, loss


def sq_batches(k, seed=3, batch=16):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(k):
        x = rng.randn(batch, 8).astype("float32")
        out.append({"x": x, "y": (x.sum(axis=1, keepdims=True) > 0).astype("float32")})
    return out


def sc_elastic_pe(rank, world, p):
    """tests/elastic_runner.py's pe_train on gloo ranks: the elastic MLP
    (SGD) under a ZeRO-1 ParallelExecutor at dp = world, resumed from the
    elastic checkpoints under p["root"] (any saved dp), checkpointing every
    p["every"] steps as host `rank` of `world`; the loss of each step as
    hex."""
    fluid, _ = _port()
    from paddle_tpu_torch.resilience import Supervisor, elastic

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope(seed=1, place=fluid.CPUPlace())
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        start, cursor = elastic.resume_or_init(exe, startup, p["root"], scope=scope,
                                               program=main)
        pe = fluid.ParallelExecutor(loss_name=loss.name, main_program=main, scope=scope,
                                    build_strategy=zero1_strategy(fluid))
        sup = Supervisor(exe, p["root"], program=main, scope=scope, num_hosts=world,
                         host_id=rank, topology=pe.topology, ckpt_every=p["every"])
        sup.step = start
        steps = {}
        with sup:
            for s in range(start, p["steps"]):
                rng = np.random.RandomState(s)
                xb = rng.randn(16, 8).astype(np.float32)
                feed = {"x": xb, "y": np.abs(xb).sum(axis=1, keepdims=True).astype(np.float32)}
                (lv,) = pe.run(fetch_list=[loss.name], feed=feed)
                sup.step += 1
                sup.cursor["batch_index"] += 1
                if p["every"] and sup.step % p["every"] == 0:
                    sup.save()
                steps[s] = float(np.asarray(lv).reshape(-1)[0]).hex()
            sup.checkpointer.wait()
    return {"dp": pe.device_count, "resumed": start, "steps": steps}


SCENARIOS = {f.__name__: f for f in (sc_elastic_pe, sc_multistep_reader, sc_reader_staging, sc_mlp, sc_zero1, sc_zero1_ckpt, sc_model, sc_deepfm,
                                     sc_ring, sc_collectives, sc_rules, sc_rules_ckpt, sc_pp,
                                     sc_layout_collectives, sc_pp_ckpt, sc_gpipe, sc_transformer_tp, sc_transformer_pp,
                                     sc_multistep)}


# ---------------------------------------------------------------------------
# process plumbing
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store_path, scenario, payload, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    try:
        from paddle_tpu_torch.parallel import init_distributed

        init_distributed(store=dist.FileStore(store_path, world), world_size=world, rank=rank,
                         backend="gloo", timeout_s=60)
        result = ("ok", SCENARIOS[scenario](rank, world, payload))
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(path, "wb") as f:
        pickle.dump(result, f)


def spawn(world, scenario, payload, tmp_path):
    """[each rank's result] of `scenario` run by `world` spawned ranks; a
    rank that raised, exited badly or outlived JOIN_TIMEOUT_S fails."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_dir = str(tmp_path / ("ranks_" + scenario))
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, store, scenario, payload, out_dir))
             for r in range(world)]
    for pr in procs:
        pr.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    for pr in procs:
        pr.join(max(1.0, (deadline - datetime.datetime.now()).total_seconds()))
    hung = [r for r, pr in enumerate(procs) if pr.is_alive()]
    for pr in procs:
        if pr.is_alive():
            pr.kill()
            pr.join(10)
    if hung:
        raise AssertionError("ranks %s of %s still running after %d s"
                             % (hung, scenario, JOIN_TIMEOUT_S))
    results = []
    for r, pr in enumerate(procs):
        path = os.path.join(out_dir, "rank%d.pkl" % r)
        if not os.path.exists(path):
            raise AssertionError("rank %d of %s exited %s without a result"
                                 % (r, scenario, pr.exitcode))
        with open(path, "rb") as f:
            status, val = pickle.load(f)
        if status != "ok":
            raise AssertionError("rank %d of %s raised:\n%s" % (r, scenario, val))
        results.append(val)
    return results
