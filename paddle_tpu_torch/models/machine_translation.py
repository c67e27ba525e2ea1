"""GRU attention seq2seq for NMT (a copy of
paddle_tpu/models/machine_translation.py; reference
benchmark/fluid/machine_translation.py and
tests/book/test_machine_translation.py: bi-GRU encoder, Bahdanau-style
attention decoder trained with a DynamicRNN, beam-search inference).

The decoder's train loop is one recurrent op (DynamicRNN), a loop over
time that captures with its training step. The beam-search loop is an
open-ended While writing id / score / parent tensor arrays
(ops/decode_ops.py), the decoder state gathered by parent_idx each step; it
reads its condition on the host every step, so its block runs op by op."""

import numpy as np

from .. import layers
from ..framework import default_main_program
from ..param_attr import ParamAttr

__all__ = ["encoder", "train_model", "infer_model"]


def _mask_from(src_len_name, maxlen, block=None):
    block = block or default_main_program().current_block()
    lens = block._var_recursive(src_len_name)
    return layers.sequence_mask(lens, maxlen=maxlen, dtype="float32")


def encoder(src_word, dict_size, emb_dim=32, hid_dim=32):
    """bi-GRU encoder over [B, T, 1] ids (ragged via @LEN companion)."""
    emb = layers.embedding(src_word, size=[dict_size, emb_dim])
    emb._len_name = src_word._len_name
    proj_f = layers.fc(emb, size=hid_dim * 3, num_flatten_dims=2)
    proj_b = layers.fc(emb, size=hid_dim * 3, num_flatten_dims=2)
    proj_f._len_name = emb._len_name
    proj_b._len_name = emb._len_name
    fwd = layers.dynamic_gru(proj_f, size=hid_dim)
    bwd = layers.dynamic_gru(proj_b, size=hid_dim, is_reverse=True)
    enc = layers.concat([fwd, bwd], axis=2)  # [B, T, 2H]
    enc._len_name = src_word._len_name
    # decoder boot: backward GRU's first step (summary of the sentence)
    boot = layers.fc(layers.sequence_first_step(bwd), size=hid_dim, act="tanh")
    return enc, boot


def _attention(state, enc, enc_proj, mask, hid_dim):
    """Additive attention: score = v·tanh(W_e enc + W_s st); returns [*, 2H]
    context. `mask` is [*, T] with 1 on valid source positions."""
    st_proj = layers.fc(state, size=hid_dim, bias_attr=False,
                        param_attr=ParamAttr(name="att_state_w"))
    st_exp = layers.unsqueeze(st_proj, [1])  # [*, 1, H]
    mix = layers.elementwise_add(enc_proj, st_exp)
    mix = layers.tanh(mix)
    scores = layers.fc(mix, size=1, num_flatten_dims=2, bias_attr=False,
                       param_attr=ParamAttr(name="att_score_w"))  # [*, T, 1]
    scores = layers.squeeze(scores, [2])
    neg = layers.scale(mask, scale=1e9, bias=-1e9)  # 0 valid, -1e9 invalid
    scores = layers.elementwise_add(scores, neg)
    att = layers.softmax(scores)  # [*, T]
    ctx = layers.reduce_sum(
        layers.elementwise_mul(enc, layers.unsqueeze(att, [2]), axis=0), dim=[1]
    )  # [*, 2H]
    return ctx


def train_model(src_word, trg_word, label, trg_len, dict_size,
                emb_dim=32, hid_dim=32):
    """Teacher-forced training net; label is trg shifted left. Returns the
    length-masked mean cross-entropy."""
    maxlen = src_word.shape[1]
    enc, boot = encoder(src_word, dict_size, emb_dim, hid_dim)
    enc_proj = layers.fc(enc, size=hid_dim, num_flatten_dims=2,
                         bias_attr=False, param_attr=ParamAttr(name="att_enc_w"))
    src_mask = _mask_from(src_word._len_name, maxlen)

    trg_emb = layers.embedding(trg_word, size=[dict_size, emb_dim],
                               param_attr=ParamAttr(name="trg_emb"))
    trg_emb._len_name = trg_len.name

    drnn = layers.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(trg_emb, seq_len=trg_len)
        st = drnn.memory(init=boot)
        ctx = _attention(st, enc, enc_proj, src_mask, hid_dim)
        inp = layers.fc([layers.concat([cur, ctx], axis=1)],
                        size=hid_dim * 3, bias_attr=False,
                        param_attr=ParamAttr(name="dec_in_w"))
        new_st, _, _ = layers.gru_unit(
            inp, st, hid_dim * 3,
            param_attr=ParamAttr(name="dec_gru_w"),
            bias_attr=ParamAttr(name="dec_gru_b"))
        drnn.update_memory(st, new_st)
        drnn.output(new_st)
    hidden = drnn()  # [B, Tt, H]
    logits = layers.fc(hidden, size=dict_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name="dec_out_w"),
                       bias_attr=ParamAttr(name="dec_out_b"))
    cost = layers.softmax_with_cross_entropy(logits, label)  # [B, Tt, 1]
    trg_mask = layers.sequence_mask(trg_len, maxlen=trg_word.shape[1],
                                    dtype="float32")
    cost = layers.elementwise_mul(layers.squeeze(cost, [2]), trg_mask)
    loss = layers.reduce_sum(cost) / layers.reduce_sum(trg_mask)
    return loss


def infer_model(src_word, dict_size, emb_dim=32, hid_dim=32,
                beam_size=4, max_out_len=8, start_id=0, end_id=1):
    """Beam-search decode net sharing parameters with train_model (same
    ParamAttr names). Returns (sentence_ids [B, beam, T], sentence_scores)."""
    maxlen = src_word.shape[1]
    batch = src_word.shape[0]
    n = batch * beam_size
    enc, boot = encoder(src_word, dict_size, emb_dim, hid_dim)
    enc_proj = layers.fc(enc, size=hid_dim, num_flatten_dims=2,
                         bias_attr=False, param_attr=ParamAttr(name="att_enc_w"))
    src_mask = _mask_from(src_word._len_name, maxlen)

    # tile per beam: [B, ...] -> [B*beam, ...]
    def tile_beam(x):
        e = layers.unsqueeze(x, [1])
        tiled = layers.expand(e, [1, beam_size] + [1] * (len(x.shape) - 1))
        return layers.reshape(tiled, [n] + list(x.shape[1:]))

    enc_b = tile_beam(enc)
    enc_proj_b = tile_beam(enc_proj)
    mask_b = tile_beam(src_mask)
    state = tile_beam(boot)

    pre_ids = layers.fill_constant([n, 1], "int64", start_id)
    init_scores = np.zeros((n, 1), np.float32)
    init_scores[np.arange(n) % beam_size != 0] = -1e9  # kInitialScore trick
    pre_scores = layers.assign(init_scores)

    ids_arr = layers.create_array("int64", shape=[max_out_len, n, 1])
    scores_arr = layers.create_array("float32", shape=[max_out_len, n, 1])
    parents_arr = layers.create_array("int32", shape=[max_out_len, n])

    i = layers.fill_constant([1], "int64", 0)
    tmax = layers.fill_constant([1], "int64", max_out_len)
    cond = layers.less_than(i, tmax)
    w = layers.While(cond)
    with w.block():
        emb = layers.embedding(pre_ids, size=[dict_size, emb_dim],
                               param_attr=ParamAttr(name="trg_emb"))
        emb = layers.reshape(emb, [n, emb_dim])
        ctx = _attention(state, enc_b, enc_proj_b, mask_b, hid_dim)
        inp = layers.fc([layers.concat([emb, ctx], axis=1)],
                        size=hid_dim * 3, bias_attr=False,
                        param_attr=ParamAttr(name="dec_in_w"))
        new_st, _, _ = layers.gru_unit(
            inp, state, hid_dim * 3,
            param_attr=ParamAttr(name="dec_gru_w"),
            bias_attr=ParamAttr(name="dec_gru_b"))
        logits = layers.fc(new_st, size=dict_size,
                           param_attr=ParamAttr(name="dec_out_w"),
                           bias_attr=ParamAttr(name="dec_out_b"))
        logp = layers.log_softmax(logits)
        topk_scores, topk_idx = layers.topk(logp, k=beam_size)
        acc = layers.elementwise_add(topk_scores, pre_scores, axis=0)
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, topk_idx, acc,
            beam_size=beam_size, end_id=end_id, return_parent_idx=True)
        layers.array_write(sel_ids, i, array=ids_arr)
        layers.array_write(sel_scores, i, array=scores_arr)
        layers.array_write(parent, i, array=parents_arr)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)
        layers.assign(layers.gather(new_st, parent), state)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, tmax, cond=cond)

    return layers.beam_search_decode(
        ids_arr, scores_arr, beam_size=beam_size, end_id=end_id,
        parents=parents_arr)
