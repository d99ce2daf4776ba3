"""The port's sentence transformers (``bigdl_tpu_torch.dataset.text``)
against the JAX package's on the same text: each stage's output, the
chained pipeline into Samples (one-hot and index features, padded and
truncated to a fixed length)."""
import numpy as np
import pytest

from bigdl_tpu.dataset import text as jtext
from bigdl_tpu_torch.dataset import text as ptext

PARAGRAPHS = [
    "The quick brown fox jumps over the lazy dog. Don't stop!  Really?",
    "  Mr. Smith's cat-dog sat; it's 3 o'clock... Yes.",
    "",
    "One.",
    "a b c d e f g h i j k l m n o p q r s t u v w x y z.",
]


def _run(mod, stages, data):
    out = iter(data)
    for s in stages:
        out = s.apply(out)
    return list(out)


def test_each_stage_equals_jax():
    for name in ("SentenceSplitter", "SentenceTokenizer"):
        got = getattr(ptext, name)()(PARAGRAPHS)
        want = list(getattr(jtext, name)().apply(iter(PARAGRAPHS)))
        assert list(got) == want, name
    toks = list(jtext.SentenceTokenizer().apply(
        jtext.SentenceSplitter().apply(iter(PARAGRAPHS))))
    for kw in ({}, {"start": False}, {"end": False}):
        assert list(ptext.SentenceBiPadding(**kw)(toks)) == \
            list(jtext.SentenceBiPadding(**kw).apply(iter(toks)))
    assert ptext.SENTENCE_START == jtext.SENTENCE_START
    assert ptext.SENTENCE_END == jtext.SENTENCE_END


@pytest.mark.parametrize("one_hot,fixed", [(None, None), (None, 4),
                                           (None, 12), (30, None),
                                           (30, 5)])
def test_the_pipeline_into_samples_equals_jax(one_hot, fixed):
    def pipeline(mod, dictionary):
        return (mod.SentenceSplitter() >> mod.SentenceTokenizer()
                >> mod.SentenceBiPadding()
                >> mod.TextToLabeledSentence(dictionary)
                >> mod.LabeledSentenceToSample(one_hot, fixed))

    sentences = list(jtext.SentenceBiPadding().apply(
        jtext.SentenceTokenizer().apply(
            jtext.SentenceSplitter().apply(iter(PARAGRAPHS)))))
    jd = jtext.Dictionary(sentences, vocab_size=25)
    pd = ptext.Dictionary(sentences, vocab_size=25)
    assert pd.word2index == jd.word2index
    got = list(pipeline(ptext, pd)(PARAGRAPHS))
    want = list(pipeline(jtext, jd).apply(iter(PARAGRAPHS)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_labeled_sentences_drop_what_jax_drops():
    d = ptext.Dictionary([["a", "b"]])
    jd = jtext.Dictionary([["a", "b"]])
    toks = [["a"], ["a", "b", "zz"], []]
    got = list(ptext.TextToLabeledSentence(d)(toks))
    want = list(jtext.TextToLabeledSentence(jd).apply(iter(toks)))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].data, want[0].data)
    np.testing.assert_array_equal(got[0].label, want[0].label)
    assert len(got[0]) == len(want[0]) == 2
