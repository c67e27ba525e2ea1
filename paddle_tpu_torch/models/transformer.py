"""Transformer NMT (BASELINE config 3; structural parity with the reference's
fluid Transformer — python/paddle/fluid/tests/unittests/dist_transformer.py /
benchmark model: multi-head attention + FFN encoder/decoder stacks, sinusoid
position encoding, label smoothing, attention-bias tensors fed from the data
pipeline exactly as the reference does).

A copy of paddle_tpu/models/transformer.py: the same builder yields the same
Program in both packages, built from registered ops (mul/matmul/softmax/
layer_norm/dropout/...)."""

import warnings

import numpy as np

from .. import layers
from ..initializer import NumpyArrayInitializer
from ..param_attr import ParamAttr


def position_encoding_init(n_position, d_model):
    """Sinusoid table (reference dist_transformer.py position_encoding_init)."""
    pos = np.arange(n_position)[:, None].astype("float64")
    dim = np.arange(d_model)[None, :].astype("float64")
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    table = np.zeros((n_position, d_model))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype("float32")


def multi_head_attention(
    queries, keys, values, attn_bias, d_key, d_value, d_model, n_head, dropout_rate,
    use_flash=False, causal=False,
):
    """With use_flash=True and no additive bias the score→softmax→context
    chain is emitted as ONE flash_attention op (O(t) in attention memory;
    on the card its lowering launches the flash kernels of
    ops/flash_attention.py). `causal` replaces a triangular attn_bias; it
    is honored on the dense path too."""
    q = layers.fc(queries, size=d_key * n_head, num_flatten_dims=2, bias_attr=False)
    k = layers.fc(keys, size=d_key * n_head, num_flatten_dims=2, bias_attr=False)
    v = layers.fc(values, size=d_value * n_head, num_flatten_dims=2, bias_attr=False)

    def split_heads(x, d):
        b_t = x.shape
        reshaped = layers.reshape(x, [0, 0, n_head, d])
        return layers.transpose(reshaped, [0, 2, 1, 3])  # (b, n, t, d)

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)

    if use_flash and attn_bias is None:
        # attention-weight dropout has no home inside the fused kernel; it is
        # skipped here like every production flash-attention integration
        ctx = layers.flash_attention(q, k, v, causal=causal, sm_scale=d_key ** -0.5)
    else:
        scores = layers.matmul(q, k, transpose_y=True, alpha=d_key ** -0.5)
        if attn_bias is not None:
            scores = layers.elementwise_add(scores, attn_bias)
        if causal:
            # the dense path must honor causal too, or a fallback would
            # silently leak future positions
            t_q, t_k = scores.shape[-2], scores.shape[-1]
            tri = np.triu(np.full((t_q, t_k), -1e9, "float32"), k=1 + t_k - t_q)
            causal_bias = layers.assign(tri)
            scores = layers.elementwise_add(scores, causal_bias)
        weights = layers.softmax(scores)
        if dropout_rate:
            weights = layers.dropout(
                weights, dropout_prob=dropout_rate, dropout_implementation="upscale_in_train"
            )
        ctx = layers.matmul(weights, v)  # (b, n, tq, dv)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, d_value * n_head])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False)


def positionwise_ffn(x, d_inner, d_model, dropout_rate):
    hidden = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu")
    if dropout_rate:
        hidden = layers.dropout(
            hidden, dropout_prob=dropout_rate, dropout_implementation="upscale_in_train"
        )
    return layers.fc(hidden, size=d_model, num_flatten_dims=2)


def pre_post_process(prev, out, cmd, dropout_rate):
    """reference post-process 'da n': dropout, residual add, layer_norm"""
    for c in cmd:
        if c == "d" and dropout_rate:
            out = layers.dropout(
                out, dropout_prob=dropout_rate, dropout_implementation="upscale_in_train"
            )
        elif c == "a" and prev is not None:
            out = layers.elementwise_add(out, prev)
        elif c == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
    return out


def encoder_layer(x, attn_bias, cfg):
    attn = multi_head_attention(
        x, x, x, attn_bias, cfg["d_key"], cfg["d_value"], cfg["d_model"],
        cfg["n_head"], cfg["dropout"],
        use_flash=cfg.get("use_flash", False),
    )
    attn = pre_post_process(x, attn, "dan", cfg["dropout"])
    ffn = positionwise_ffn(attn, cfg["d_inner"], cfg["d_model"], cfg["dropout"])
    return pre_post_process(attn, ffn, "dan", cfg["dropout"])


def decoder_layer(x, enc_out, slf_bias, cross_bias, cfg):
    # Under use_flash the decoder self-attention uses the kernel's causal
    # mask instead of the triangular bias tensor. The kernel carries no
    # key-padding mask, so this is only valid when every sequence in the
    # batch is full-length. cfg["padded"] is tri-state: True keeps the dense
    # bias-masked path for decoder self-attention; False asserts batches are
    # unpadded (flash, no warning); None (unspecified) uses flash but warns
    # so callers who never considered padding find out.
    use_flash_slf = cfg.get("use_flash", False)
    if use_flash_slf:
        padded = cfg.get("padded")
        if padded:
            use_flash_slf = False
            if slf_bias is None:
                # The dense fallback has no implicit causal mask — causality
                # comes entirely from the caller's bias tensor. Flash callers
                # conventionally pass slf_bias=None, which here would silently
                # train with future-token leakage.
                raise ValueError(
                    "transformer decoder with use_flash and padded=True takes "
                    "the dense masked path, which relies on the caller-supplied "
                    "trg_slf_attn_bias for causality — got None. Pass a causal "
                    "(+pad) bias tensor, or padded=False for the flash causal "
                    "kernel on unpadded batches."
                )
        else:
            if padded is None:
                warnings.warn(
                    "transformer decoder self-attention with use_flash drops "
                    "the attention-bias tensor and applies only a causal "
                    "mask; pad positions would be attended. Pass padded=True "
                    "for the dense masked path, or padded=False to assert "
                    "batches are unpadded and silence this warning.",
                    stacklevel=2,
                )
            slf_bias = None
    slf = multi_head_attention(
        x, x, x, slf_bias, cfg["d_key"], cfg["d_value"], cfg["d_model"],
        cfg["n_head"], cfg["dropout"],
        use_flash=use_flash_slf,
        causal=use_flash_slf,
    )
    slf = pre_post_process(x, slf, "dan", cfg["dropout"])
    # cross-attention is never causal; flash applies whenever no additive
    # bias is supplied (multi_head_attention falls back to the dense masked
    # chain when cross_bias is present — same padding contract as encoder
    # self-attention)
    cross = multi_head_attention(
        slf, enc_out, enc_out, cross_bias, cfg["d_key"], cfg["d_value"],
        cfg["d_model"], cfg["n_head"], cfg["dropout"],
        use_flash=cfg.get("use_flash", False),
    )
    cross = pre_post_process(slf, cross, "dan", cfg["dropout"])
    ffn = positionwise_ffn(cross, cfg["d_inner"], cfg["d_model"], cfg["dropout"])
    return pre_post_process(cross, ffn, "dan", cfg["dropout"])


def embed(word, pos, vocab_size, cfg, name):
    w_emb = layers.embedding(
        word,
        size=[vocab_size, cfg["d_model"]],
        param_attr=ParamAttr(name=name + "_word_emb"),
    )
    w_emb = layers.scale(w_emb, scale=cfg["d_model"] ** 0.5)
    p_emb = layers.embedding(
        pos,
        size=[cfg["max_length"], cfg["d_model"]],
        param_attr=ParamAttr(
            name=name + "_pos_emb",
            trainable=False,
            initializer=NumpyArrayInitializer(
                position_encoding_init(cfg["max_length"], cfg["d_model"])
            ),
        ),
    )
    out = layers.elementwise_add(w_emb, p_emb)
    if cfg["dropout"]:
        out = layers.dropout(
            out, dropout_prob=cfg["dropout"], dropout_implementation="upscale_in_train"
        )
    return out


def transformer(
    src_word,
    src_pos,
    trg_word,
    trg_pos,
    src_slf_attn_bias,
    trg_slf_attn_bias,
    trg_src_attn_bias,
    label,
    label_weight,
    src_vocab_size=1000,
    trg_vocab_size=1000,
    n_layer=2,
    n_head=4,
    d_model=64,
    d_inner=128,
    d_key=16,
    d_value=16,
    dropout=0.1,
    max_length=64,
    label_smooth_eps=0.1,
    use_flash=False,
    padded=None,
):
    # padded (tri-state, only meaningful under use_flash): True = batches may
    # contain pad positions, decoder self-attention keeps the dense
    # bias-masked path (the flash kernel carries no key-padding mask);
    # False = caller asserts batches are unpadded, flash runs silently;
    # None = flash runs but decoder_layer warns once
    cfg = dict(
        d_model=d_model, d_inner=d_inner, d_key=d_key, d_value=d_value,
        n_head=n_head, dropout=dropout, max_length=max_length,
        use_flash=use_flash, padded=padded,
    )
    enc = embed(src_word, src_pos, src_vocab_size, cfg, "src")
    for _ in range(n_layer):
        enc = encoder_layer(enc, src_slf_attn_bias, cfg)

    dec = embed(trg_word, trg_pos, trg_vocab_size, cfg, "trg")
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, trg_slf_attn_bias, trg_src_attn_bias, cfg)

    logits = layers.fc(dec, size=trg_vocab_size, num_flatten_dims=2, bias_attr=False)
    # label smoothing (reference: label_smooth(one_hot) + soft_label CE) via
    # the fused smooth_eps CE — same math, no [N, V] one-hot materialized
    # (that tensor dominated loss-path memory at real vocab sizes)
    flat_logits = layers.reshape(logits, [-1, trg_vocab_size])
    flat_label = layers.reshape(label, [-1, 1])
    ce = layers.softmax_with_cross_entropy(
        flat_logits, flat_label, smooth_eps=label_smooth_eps
    )
    w = layers.reshape(label_weight, [-1, 1])
    weighted = layers.elementwise_mul(ce, w)
    loss = layers.elementwise_div(
        layers.reduce_sum(weighted), layers.reduce_sum(w)
    )
    return loss, logits


def make_attn_bias(lens, maxlen, n_head, causal=False, q_maxlen=None):
    """Host-side bias construction, as the reference feeds biases from its
    data pipeline (dist_transformer.py prepare_batch_input). `lens`/`maxlen`
    describe the KEY side; `q_maxlen` the query side for cross-attention
    (defaults to maxlen for self-attention). Returns (b, n_head, q, k)."""
    b = len(lens)
    q_maxlen = q_maxlen if q_maxlen is not None else maxlen
    mask = np.zeros((b, 1, 1, maxlen), dtype="float32")
    for i, l in enumerate(lens):
        mask[i, 0, 0, l:] = -1e9
    bias = np.tile(mask, (1, n_head, q_maxlen, 1))
    if causal:
        if q_maxlen != maxlen:
            raise ValueError("causal bias requires q_maxlen == maxlen")
        tri = np.triu(np.full((maxlen, maxlen), -1e9, dtype="float32"), k=1)
        bias = bias + tri[None, None, :, :]
    return bias


def build_tiny_flash_transformer(t=16, vocab=50, feed_prefix=""):
    """Build a minimal use_flash=True transformer program on the current
    program pair (the JAX package's flash build recipe, which its tests
    share). Returns (feeds dict name->Variable, loss Variable)."""
    from .. import layers

    p = feed_prefix
    feeds = {}
    for name, shape, dtype in [
        (p + "src_word", [t], "int64"),
        (p + "src_pos", [t], "int64"),
        (p + "trg_word", [t], "int64"),
        (p + "trg_pos", [t], "int64"),
        (p + "label", [t], "int64"),
        (p + "label_weight", [t, 1], "float32"),
    ]:
        feeds[name] = layers.data(name=name, shape=shape, dtype=dtype)
    loss, _logits = transformer(
        feeds[p + "src_word"], feeds[p + "src_pos"], feeds[p + "trg_word"],
        feeds[p + "trg_pos"], None, None, None,
        feeds[p + "label"], feeds[p + "label_weight"],
        src_vocab_size=vocab, trg_vocab_size=vocab,
        n_layer=1, n_head=2, d_model=16, d_inner=32, d_key=8, d_value=8,
        dropout=0.0, max_length=t + 1, use_flash=True, padded=False,
    )
    return feeds, loss


def tiny_flash_transformer_feed(b, t=16, vocab=50, feed_prefix="", seed=5):
    """Matching numpy feed dict for build_tiny_flash_transformer."""
    p = feed_prefix
    rng = np.random.RandomState(seed)
    pos = np.tile(np.arange(t), (b, 1)).astype("int64")
    return {
        p + "src_word": rng.randint(0, vocab, (b, t)).astype("int64"),
        p + "src_pos": pos,
        p + "trg_word": rng.randint(0, vocab, (b, t)).astype("int64"),
        p + "trg_pos": pos.copy(),
        p + "label": rng.randint(0, vocab, (b, t)).astype("int64"),
        p + "label_weight": np.ones((b, t, 1), "float32"),
    }
