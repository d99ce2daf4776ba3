"""Text layouts (counterpart of ``bigdl_tpu.dataset.text``): the word
tokenizer, the 1-based :class:`Dictionary` (its ``dictionary.json`` is
the JAX package's byte for byte), the PTB reader, the contiguous LM
window layout, and the sentence transformers of dataset/text/ in the
reference (:class:`SentenceSplitter`, :class:`SentenceTokenizer`,
:class:`SentenceBiPadding`, :class:`LabeledSentence`,
:class:`TextToLabeledSentence`, :class:`LabeledSentenceToSample`), which
compose with ``>>`` into Samples for LookupTable language models.
"""
from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

__all__ = ["Dictionary", "LabeledSentence", "LabeledSentenceToSample",
           "SENTENCE_END", "SENTENCE_START", "SentenceBiPadding",
           "SentenceSplitter", "SentenceTokenizer", "TextToLabeledSentence",
           "load_ptb", "ptb_arrays", "read_words", "tokenize"]

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"

_TOKEN_RE = re.compile(r"[A-Za-z0-9'<>$#-]+|[^\sA-Za-z0-9]")


def tokenize(line: str) -> List[str]:
    """Lowercased words (apostrophes and hyphens kept, so "don't"
    survives) and standalone punctuation (SentenceTokenizer.scala:35's
    role)."""
    return _TOKEN_RE.findall(line.lower())


class SentenceSplitter(Transformer):
    """Paragraph strings -> sentence strings (SentenceSplitter.scala):
    split after ``.``, ``!`` or ``?`` and the whitespace that follows."""

    _SPLIT_RE = re.compile(r"(?<=[.!?])\s+")

    def apply(self, it: Iterator[str]) -> Iterator[str]:
        for text in it:
            for s in self._SPLIT_RE.split(text.strip()):
                if s:
                    yield s


class SentenceTokenizer(Transformer):
    """Sentence strings -> token lists (SentenceTokenizer.scala:35); a
    sentence with no token is dropped."""

    def apply(self, it: Iterator[str]) -> Iterator[List[str]]:
        for line in it:
            toks = tokenize(line)
            if toks:
                yield toks


class SentenceBiPadding(Transformer):
    """Token lists wrapped in :data:`SENTENCE_START` / :data:`SENTENCE_END`
    (the reference's SentenceToken and readSentence)."""

    def __init__(self, start: bool = True, end: bool = True):
        self.start, self.end = start, end

    def apply(self, it: Iterator[List[str]]) -> Iterator[List[str]]:
        for toks in it:
            out = list(toks)
            if self.start:
                out = [SENTENCE_START] + out
            if self.end:
                out = out + [SENTENCE_END]
            yield out


class Dictionary:
    """Vocabulary with 1-based indices (Dictionary.scala): the
    ``vocab_size`` most frequent words (ties in first-seen order), every
    other word mapped to one out-of-vocabulary index, the last."""

    def __init__(self, sentences_or_words=None,
                 vocab_size: Optional[int] = None):
        self.word2index: Dict[str, int] = {}
        self.index2word: Dict[int, str] = {}
        if sentences_or_words is not None:
            words: List[str] = []
            for el in sentences_or_words:
                if isinstance(el, str):
                    words.append(el)
                else:
                    words.extend(el)
            for i, (w, _) in enumerate(
                    Counter(words).most_common(vocab_size)):
                self.word2index[w] = i + 1
                self.index2word[i + 1] = w

    def vocab_size(self) -> int:
        """Kept words + 1 unk slot (Dictionary.getVocabSize)."""
        return len(self.word2index) + 1

    def unk_index(self) -> int:
        return len(self.word2index) + 1

    def get_index(self, word: str) -> int:
        return self.word2index.get(word, self.unk_index())

    def get_word(self, index: int) -> str:
        return self.index2word.get(int(index), "<unk>")

    def __contains__(self, word: str) -> bool:
        return word in self.word2index

    def save(self, path: str) -> None:
        """``{"word2index": ...}`` as JSON, the JAX package's file."""
        with open(path, "w") as f:
            json.dump({"word2index": self.word2index}, f)

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        with open(path) as f:
            data = json.load(f)
        d = cls()
        d.word2index = {w: int(i) for w, i in data["word2index"].items()}
        d.index2word = {i: w for w, i in d.word2index.items()}
        return d


def read_words(path: str) -> List[str]:
    """PTB-style text -> a flat word list with ``<eos>`` after each
    non-empty line (PTBWordLM.scala readWords; split on whitespace, so
    ``<unk>`` and ``n't`` stay whole)."""
    words: List[str] = []
    with open(path) as f:
        for line in f:
            toks = line.strip().split()
            if toks:
                words.extend(toks)
                words.append("<eos>")
    return words


def load_ptb(train_path: str, *, vocab_size: int = 10000,
             valid_path: Optional[str] = None,
             test_path: Optional[str] = None):
    """Read PTB text file(s) with the Dictionary built from the training
    split (PTBWordLM.scala:70-88): ``({split: 1-based float32 index
    array}, Dictionary)``."""
    train_words = read_words(train_path)
    dictionary = Dictionary([train_words], vocab_size=vocab_size)
    out = {"train": np.asarray([dictionary.get_index(w)
                                for w in train_words], np.float32)}
    for name, path in (("valid", valid_path), ("test", test_path)):
        if path is not None and os.path.exists(path):
            out[name] = np.asarray(
                [dictionary.get_index(w) for w in read_words(path)],
                np.float32)
    return out, dictionary


def ptb_arrays(words: Sequence[int], batch_size: int, num_steps: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat index stream -> (x, y) of shape [n, num_steps]: the
    contiguous-batch LM layout where the stream position advances within
    each batch row. Returns 1-based index arrays; y is x shifted by one
    word."""
    data = np.asarray(words, np.float32)
    n_batches = (len(data) - 1) // (batch_size * num_steps)
    if n_batches <= 0:
        raise ValueError("corpus too small for batch_size*num_steps")
    span = n_batches * num_steps
    xs = data[:batch_size * span].reshape(batch_size, span)
    ys = data[1:batch_size * span + 1].reshape(batch_size, span)
    x = np.concatenate([xs[:, i * num_steps:(i + 1) * num_steps]
                        for i in range(n_batches)])
    y = np.concatenate([ys[:, i * num_steps:(i + 1) * num_steps]
                        for i in range(n_batches)])
    return x, y


class LabeledSentence:
    """A token-index pair of sequences: ``data[t]`` predicts ``label[t]``
    (LabeledSentence.scala); both float32."""

    def __init__(self, data: Sequence[int], label: Sequence[int]):
        self.data = np.asarray(data, np.float32)
        self.label = np.asarray(label, np.float32)

    def __len__(self) -> int:
        return len(self.data)


class TextToLabeledSentence(Transformer):
    """Token lists -> LabeledSentences of (current, next) indices in
    ``dictionary`` (TextToLabeledSentence.scala); a list of fewer than
    two tokens is dropped."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def apply(self, it: Iterator[List[str]]) -> Iterator[LabeledSentence]:
        for toks in it:
            idx = [self.dictionary.get_index(w) for w in toks]
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentences -> Samples (LabeledSentenceToSample.scala): with
    ``one_hot_size`` the inputs become one-hot rows (a Linear input
    layer), else they stay indices (a LookupTable); ``fixed_length``
    truncates, or pads by repeating the last index."""

    def __init__(self, one_hot_size: Optional[int] = None,
                 fixed_length: Optional[int] = None):
        self.one_hot_size = one_hot_size
        self.fixed_length = fixed_length

    def apply(self, it: Iterator[LabeledSentence]) -> Iterator[Sample]:
        for ls in it:
            data, label = ls.data, ls.label
            if self.fixed_length is not None:
                n = self.fixed_length
                if len(data) >= n:
                    data, label = data[:n], label[:n]
                else:
                    pad = n - len(data)
                    data = np.concatenate(
                        [data, np.full(pad, data[-1], np.float32)])
                    label = np.concatenate(
                        [label, np.full(pad, label[-1], np.float32)])
            if self.one_hot_size is not None:
                eye = np.zeros((len(data), self.one_hot_size), np.float32)
                eye[np.arange(len(data)), data.astype(int) - 1] = 1.0
                yield Sample(eye, label)
            else:
                yield Sample(data, label)
