"""Text layouts (counterpart of ``bigdl_tpu.dataset.text``): the word
tokenizer, the 1-based :class:`Dictionary` (its ``dictionary.json`` is
the JAX package's byte for byte), the PTB reader and the contiguous LM
window layout. Not ported yet: the sentence transformers
(``SentenceSplitter``, ``SentenceTokenizer``, ``SentenceBiPadding``,
``TextToLabeledSentence``, ``LabeledSentenceToSample``; ROADMAP queue
1, item 10).
"""
from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Dictionary", "load_ptb", "ptb_arrays", "read_words",
           "tokenize"]

_TOKEN_RE = re.compile(r"[A-Za-z0-9'<>$#-]+|[^\sA-Za-z0-9]")


def tokenize(line: str) -> List[str]:
    """Lowercased words (apostrophes and hyphens kept, so "don't"
    survives) and standalone punctuation (SentenceTokenizer.scala:35's
    role)."""
    return _TOKEN_RE.findall(line.lower())


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
