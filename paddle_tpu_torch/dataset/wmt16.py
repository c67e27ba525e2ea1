"""WMT16 en↔de reader creators (reference python/paddle/dataset/wmt16.py:
train/test/validation yield (src_ids, trg_ids, trg_ids_next) with
configurable src/trg language; get_dict(lang, dict_size))."""

from . import common, wmt14

__all__ = ["train", "test", "validation", "get_dict"]


def get_dict(lang, dict_size, reverse=False):
    src, trg = wmt14.get_dict(dict_size, reverse)
    return src if lang == "en" else trg


def _creator(tag, n, src_dict_size, trg_dict_size, src_lang):
    # direction matters: the stream (and its deterministic seed) differs per
    # source language, and the token mapping inverts, so en->de and de->en
    # callers see genuinely swapped corpora
    mult = 5 if src_lang == "en" else 7

    def reader():
        rng = common.synthetic_rng("wmt16-%s-%s" % (src_lang, tag))
        for _ in range(n):
            length = rng.randint(3, 12)
            src = [int(t) for t in rng.randint(3, src_dict_size, length)]
            trg = [(t * mult + 2) % (trg_dict_size - 3) + 3 for t in reversed(src)]
            yield src, [wmt14.START] + trg, trg + [wmt14.END]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("train", 1000, src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("test", 100, src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("val", 100, src_dict_size, trg_dict_size, src_lang)
