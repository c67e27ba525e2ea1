"""The contrib class-based decoder in the port (paddle_tpu_torch/contrib/
decoder), held to the JAX package on tests/test_contrib_decoder.py's
scenario: an encoder, a StateCell with an fc updater, TrainingDecoder
training it, and BeamSearchDecoder decoding with the same cell, built in
both packages from the same weights (the JAX startup's, carried by
convert.load_into_scope)."""

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools.profile_rnn import build_contrib_decoder, decoder_batch

# tests/test_contrib_decoder.py's widths
CFG = dict(dict_size=40, emb_dim=12, hid_dim=16, seq_len=6, batch=4, lr=5e-3, beam_size=3,
           max_out_len=6, topk=12)
STEPS = 5


def _train(exe, m, feed):
    return [float(np.asarray(exe.run(m["main"], feed=feed, fetch_list=[m["loss"].name])[0])
                  .reshape(-1)[0]) for _ in range(STEPS)]


def _decode(exe, m, feed):
    return [np.asarray(o) for o in exe.run(m["infer"], feed=feed,
                                           fetch_list=[m["ids"].name, m["scores"].name])]


def test_training_and_beam_decoders_match_jax():
    """TrainingDecoder losses at rtol 1e-5, atol 1e-6 over 5 Adam steps from
    the JAX startup's weights (float32 sums in another order); then, from
    the JAX package's trained weights in both, BeamSearchDecoder ids
    exactly and scores at rtol 1e-5."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.contrib import decoder as jdec
    from paddle_tpu.executor import Scope as JScope
    from paddle_tpu.executor import scope_guard as jscope_guard
    from paddle_tpu.param_attr import ParamAttr as JParamAttr

    from paddle_tpu_torch.contrib import decoder as pdec

    feed, dfeed = decoder_batch(CFG, 0)
    jm = build_contrib_decoder(jfluid, jdec, JParamAttr, CFG)
    names = convert.persistable_names(jm["main"])
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = JScope(seed=0)
    with jscope_guard(jscope):
        jexe.run(jm["startup"])
        init = {n: np.array(np.asarray(jscope.vars[n])) for n in names}
        want = _train(jexe, jm, feed)
        trained = {n: np.array(np.asarray(jscope.vars[n])) for n in names}
        want_ids, want_scores = _decode(jexe, jm, dfeed)

    m = build_contrib_decoder(pt, pdec, pt.ParamAttr, CFG)
    assert convert.persistable_names(m["main"]) == names
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(m["startup"])
        convert.load_into_scope(scope, init, names)
        got = _train(exe, m, feed)
        convert.load_into_scope(scope, trained, names)
        got_ids, got_scores = _decode(exe, m, dfeed)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] < got[0]
    assert got_ids.shape[:2] == (CFG["batch"], CFG["beam_size"])
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)
