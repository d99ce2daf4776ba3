"""Text layouts (counterpart of ``bigdl_tpu.dataset.text``): the
contiguous LM window layout. Not ported yet: the PTB reader,
tokenizers and the Dictionary."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["ptb_arrays"]


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
