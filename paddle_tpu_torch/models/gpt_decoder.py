"""Decoder-only transformer for autoregressive generation serving.

A deliberately small GPT-style zoo entry whose point is not the model but
the *three program families* it can emit over one shared parameter set
(explicit ``ParamAttr`` names, the machine_translation train/infer sharing
pattern):

  * ``build_forward``  — whole-sequence causal logits ``[b, t, vocab]``.
    Used for training, parity tests, and as the naive
    whole-sequence-per-request serving ablation in ``bench.py generation``.
  * ``build_prefill``  — one prompt *chunk* of bucketed static length ``t``
    (batch 1) starting at an arbitrary position: K/V of every chunk row
    scattered into the paged pool through the slot's page list, then paged
    attention back over the pool (causal by position), logits of one
    selected row. A chunk at start 0 covering the whole prompt is ordinary
    whole-prompt prefill; long prompts run several chunk calls interleaved
    with decode steps, and prefix-cache hits skip the leading chunks
    entirely (serving/generation.py).
  * ``build_decode``   — one token for every slot ``[slots]``: K/V written
    at ``positions`` through per-slot block tables, ``paged_attention``
    over the pool, logits ``[slots, vocab]``.

All three lower through ``executor.aot_serve_lowering``; the
``GenerationEngine`` (serving/generation.py) builds the prefill buckets and
the one decode shape at warmup so the serving hot loop never rebuilds. The
same protocol (``build_prefill`` / ``build_decode`` / ``kv_pool_names`` /
``ensure_params``) is the hook point for other decode-loop models — e.g.
wrapping the NMT infer path's decoder — to ride the engine.

Prefill writes K/V for *padded* positions too (the program is static over
the chunk length): positions beyond the slot's allocated pages (or past
the table's capacity) land in the pool's scratch page 0, and positions
between the prompt length and the chunk end inside allocated pages are
overwritten by the decode step that claims that position before any
attention read reaches them — see docs/serving.md for the lifecycle
argument.
"""

import numpy as np

from .. import framework, unique_name
from .. import layers
from ..executor import Executor
from ..param_attr import ParamAttr

__all__ = ["GPTDecoder"]


class GPTDecoder:
    def __init__(
        self,
        vocab_size=128,
        n_layer=2,
        n_head=2,
        d_model=32,
        d_inner=64,
        max_context=64,
        eos_id=1,
        prefix="gptd",
        kv_dtype="float32",
    ):
        if d_model % n_head:
            raise ValueError("d_model must divide into n_head heads")
        if kv_dtype not in ("float32", "int8"):
            raise ValueError("kv_dtype must be 'float32' or 'int8'")
        self.vocab_size = int(vocab_size)
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_model = int(d_model)
        self.d_head = self.d_model // self.n_head
        self.d_inner = int(d_inner)
        self.max_context = int(max_context)
        self.eos_id = int(eos_id)
        self.prefix = prefix
        # "int8": K/V pools store symmetric per-row int8 levels plus a
        # [pool_rows] f32 scale pool each (kv_scale_names) — half the HBM
        # per cached token, so the same pool budget holds ~2x the slots
        # (ops/generation_ops.py int8 pool mode)
        self.kv_dtype = kv_dtype

    # ---------------------------------------------------------------- names

    def _p(self, *parts):
        return "_".join((self.prefix,) + parts)

    def param_names(self):
        names = [self._p("tok_emb"), self._p("pos_emb")]
        for i in range(self.n_layer):
            li = "l%d" % i
            names += [self._p(li, s) for s in (
                "ln1_w", "ln1_b", "q_w", "k_w", "v_w", "o_w",
                "ln2_w", "ln2_b", "ff1_w", "ff1_b", "ff2_w", "ff2_b",
            )]
        names += [self._p("lnf_w"), self._p("lnf_b"), self._p("head_w")]
        return names

    def kv_pool_names(self):
        """[(k_pool, v_pool)] per layer; each pool row holds n_head*d_head
        features for one cached token."""
        return [
            (self._p("l%d" % i, "kv_k"), self._p("l%d" % i, "kv_v"))
            for i in range(self.n_layer)
        ]

    def kv_scale_names(self):
        """[(k_scales, v_scales)] per layer in int8 mode (each a
        [pool_rows] f32 per-row scale pool, written-state siblings of the
        level pools); [] in float32 mode."""
        if self.kv_dtype != "int8":
            return []
        return [
            (self._p("l%d" % i, "kv_ks"), self._p("l%d" % i, "kv_vs"))
            for i in range(self.n_layer)
        ]

    # ------------------------------------------------------------ submodules

    def _attr(self, i, suffix):
        return ParamAttr(name=self._p("l%d" % i, suffix))

    def _embed(self, tokens, positions):
        tok = layers.embedding(
            tokens,
            size=[self.vocab_size, self.d_model],
            param_attr=ParamAttr(name=self._p("tok_emb")),
        )
        pos = layers.embedding(
            positions,
            size=[self.max_context, self.d_model],
            param_attr=ParamAttr(name=self._p("pos_emb")),
        )
        return layers.elementwise_add(tok, pos)

    def _qkv(self, h, i, nfd):
        mk = lambda s: layers.fc(
            h, size=self.d_model, num_flatten_dims=nfd,
            param_attr=self._attr(i, s), bias_attr=False,
        )
        return mk("q_w"), mk("k_w"), mk("v_w")

    def _mlp_tail(self, x, i, nfd):
        """Residual-add of attention output is done by the caller; this is
        ln2 + ffn + residual."""
        h = layers.layer_norm(
            x, begin_norm_axis=nfd,
            param_attr=self._attr(i, "ln2_w"), bias_attr=self._attr(i, "ln2_b"),
        )
        f = layers.fc(
            h, size=self.d_inner, num_flatten_dims=nfd, act="relu",
            param_attr=self._attr(i, "ff1_w"), bias_attr=self._attr(i, "ff1_b"),
        )
        f = layers.fc(
            f, size=self.d_model, num_flatten_dims=nfd,
            param_attr=self._attr(i, "ff2_w"), bias_attr=self._attr(i, "ff2_b"),
        )
        return layers.elementwise_add(x, f)

    def _dense_block(self, x, i, t):
        """Pre-LN block over [b, t, d_model] with dense causal attention
        (the whole-sequence training/oracle form)."""
        h = layers.layer_norm(
            x, begin_norm_axis=2,
            param_attr=self._attr(i, "ln1_w"), bias_attr=self._attr(i, "ln1_b"),
        )
        q, k, v = self._qkv(h, i, nfd=2)
        split = lambda y: layers.transpose(
            layers.reshape(y, [0, 0, self.n_head, self.d_head]), [0, 2, 1, 3]
        )
        qh, kh, vh = split(q), split(k), split(v)
        scores = layers.matmul(qh, kh, transpose_y=True, alpha=self.d_head**-0.5)
        tri = layers.assign(np.triu(np.full((t, t), -1e9, "float32"), k=1))
        scores = layers.elementwise_add(scores, tri)
        ctx = layers.matmul(layers.softmax(scores), vh)
        ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [0, 0, self.d_model])
        o = layers.fc(
            ctx, size=self.d_model, num_flatten_dims=2,
            param_attr=self._attr(i, "o_w"), bias_attr=False,
        )
        return self._mlp_tail(layers.elementwise_add(x, o), i, nfd=2)

    def _decode_block(self, x, i, pools, scales, block_table, pos, page_size):
        """Pre-LN block over [rows, d_model] — one query token per row:
        write each row's K/V into the pool, then attend through the block
        table ([rows, max_pages] for decode; [max_pages], shared by every
        row, for a prefill chunk). `scales` is the per-layer scale-pool pair
        list in int8 mode, None in float32 mode."""
        h = layers.layer_norm(
            x, begin_norm_axis=1,
            param_attr=self._attr(i, "ln1_w"), bias_attr=self._attr(i, "ln1_b"),
        )
        q, k, v = self._qkv(h, i, nfd=1)
        k_pool, v_pool = pools[i]
        k_sc, v_sc = scales[i] if scales else (None, None)
        layers.kv_cache_write(k_pool, k, block_table, pos, page_size, k_sc)
        layers.kv_cache_write(v_pool, v, block_table, pos, page_size, v_sc)
        att = layers.paged_attention(
            q, k_pool, v_pool, block_table, pos,
            n_head=self.n_head, page_size=page_size,
            k_scales=k_sc, v_scales=v_sc,
        )
        o = layers.fc(
            att, size=self.d_model, num_flatten_dims=1,
            param_attr=self._attr(i, "o_w"), bias_attr=False,
        )
        return self._mlp_tail(layers.elementwise_add(x, o), i, nfd=1)

    def _final(self, x, nfd):
        h = layers.layer_norm(
            x, begin_norm_axis=nfd,
            param_attr=ParamAttr(name=self._p("lnf_w")),
            bias_attr=ParamAttr(name=self._p("lnf_b")),
        )
        return h

    def _head(self, h, nfd):
        return layers.fc(
            h, size=self.vocab_size, num_flatten_dims=nfd,
            param_attr=ParamAttr(name=self._p("head_w")), bias_attr=False,
        )

    def _pool_vars(self, pool_rows):
        block = framework.default_main_program().global_block()
        pools = [
            tuple(
                block.create_var(
                    name=n, shape=[pool_rows, self.d_model],
                    dtype=self.kv_dtype, persistable=True,
                )
                for n in pair
            )
            for pair in self.kv_pool_names()
        ]
        scales = [
            tuple(
                block.create_var(
                    name=n, shape=[pool_rows], dtype="float32",
                    persistable=True,
                )
                for n in pair
            )
            for pair in self.kv_scale_names()
        ]
        return pools, scales or None

    # -------------------------------------------------------------- programs

    def build_forward(self, batch, t):
        """Whole-sequence causal LM: feed fwd_tokens [batch, t, 1] int64,
        fetch logits [batch, t, vocab]. The serving ablation and parity
        oracle. (Token ids carry a trailing 1 dim, the lookup_table LoD
        convention, so rank is stable for any batch/t.)"""
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup), unique_name.guard(
            "%s_fw%dx%d_" % (self.prefix, batch, t)
        ):
            tokens = layers.data(
                "fwd_tokens", [batch, t, 1], append_batch_size=False, dtype="int64"
            )
            positions = layers.assign(np.arange(t, dtype="int64").reshape(1, t, 1))
            x = self._embed(tokens, positions)
            for i in range(self.n_layer):
                x = self._dense_block(x, i, t)
            logits = self._head(self._final(x, nfd=2), nfd=2)
        return main, startup, ["fwd_tokens"], [logits.name]

    def build_prefill(self, t, page_size, max_pages, pool_rows):
        """Paged chunk prefill (batch 1): feed gen_tokens [1, t, 1] int64
        (zero-padded), gen_start [1] int64 (absolute position of the
        chunk's first token), gen_last [1] int64 (in-chunk row whose logits
        to fetch), gen_pages [max_pages] int32 (the slot's page list,
        scratch-0 padded). K/V of all t chunk rows scatter into the pool at
        positions gen_start + [0, t), then every row attends the pool
        through the page list (causal by position) — so a long prompt may
        ingest in several chunk calls, each reading back the pages earlier
        chunks (or a shared prefix-cache hit) already filled. A chunk at
        gen_start 0 with t covering the whole prompt is ordinary
        whole-prompt prefill: one program family serves both. Fetch the
        gen_last row's logits [1, vocab].

        Padded tail rows past the context bound are harmless by
        construction: their kv_cache_write positions are routed to the
        scratch page by the op's capacity guard, and the position-embedding
        lookup is clamped (their logits are never fetched)."""
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup), unique_name.guard(
            "%s_pf%d_" % (self.prefix, t)
        ):
            tokens = layers.data(
                "gen_tokens", [1, t, 1], append_batch_size=False, dtype="int64"
            )
            start = layers.data(
                "gen_start", [1], append_batch_size=False, dtype="int64"
            )
            last = layers.data(
                "gen_last", [1], append_batch_size=False, dtype="int64"
            )
            pages = layers.data(
                "gen_pages", [max_pages], append_batch_size=False, dtype="int32"
            )
            pools, scales = self._pool_vars(pool_rows)
            pos_flat = layers.elementwise_add(
                layers.assign(np.arange(t, dtype="int64")), start
            )
            emb_pos = layers.elementwise_min(
                pos_flat,
                layers.assign(np.full([1], self.max_context - 1, "int64")),
            )
            x = self._embed(tokens, layers.reshape(emb_pos, [1, t, 1]))
            x2 = layers.reshape(x, [t, self.d_model])
            for i in range(self.n_layer):
                x2 = self._decode_block(
                    x2, i, pools, scales, pages, pos_flat, page_size
                )
            h = self._final(x2, nfd=1)
            last_row = layers.gather(h, last)  # [1, d_model]
            logits = self._head(last_row, nfd=1)
        return (
            main,
            startup,
            ["gen_tokens", "gen_start", "gen_last", "gen_pages"],
            [logits.name],
        )

    def build_decode(self, slots, page_size, max_pages, pool_rows):
        """One decode step for every slot: feed dec_tokens [slots, 1] int64,
        dec_positions [slots, 1] int64, dec_block_table [slots, max_pages]
        int32; fetch logits [slots, vocab]. Idle slots carry position 0 and
        a scratch-only block table — their writes land in scratch page 0 and
        their logits are ignored by the scheduler."""
        main, startup = framework.Program(), framework.Program()
        with framework.program_guard(main, startup), unique_name.guard(
            "%s_dec%d_" % (self.prefix, slots)
        ):
            tokens = layers.data(
                "dec_tokens", [slots, 1], append_batch_size=False, dtype="int64"
            )
            positions = layers.data(
                "dec_positions", [slots, 1], append_batch_size=False, dtype="int64"
            )
            block_table = layers.data(
                "dec_block_table", [slots, max_pages],
                append_batch_size=False, dtype="int32",
            )
            pools, scales = self._pool_vars(pool_rows)
            x = self._embed(tokens, positions)
            for i in range(self.n_layer):
                x = self._decode_block(
                    x, i, pools, scales, block_table, positions, page_size
                )
            logits = self._head(self._final(x, nfd=1), nfd=1)
        return (
            main,
            startup,
            ["dec_tokens", "dec_positions", "dec_block_table"],
            [logits.name],
        )

    # ---------------------------------------------------------------- params

    def ensure_params(self, scope, place=None):
        """Initialize the shared parameter set into `scope` if absent (runs
        the forward startup program once, the train/infer sharing idiom)."""
        if all(n in scope.vars for n in self.param_names()):
            return
        _, startup, _, _ = self.build_forward(1, min(8, self.max_context))
        from ..executor import scope_guard

        with scope_guard(scope):
            Executor(place).run(startup)
