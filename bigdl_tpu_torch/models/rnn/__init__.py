"""RNN language models (counterpart of ``bigdl_tpu.models.rnn``; BigDL
models/rnn/SimpleRNN.scala and example/languagemodel/PTBModel.scala;
BASELINE config 5).

Each model function draws its parameters on the CPU from ``generator``,
layer by layer, and moves the model to ``device`` (the card by default;
raises when CUDA is missing). The trees carry the JAX package's keys:
``"0"`` the LookupTable, then each ``Recurrent``'s ``cell``, then the
``TimeDistributed`` head's ``layer``."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["PTBModel", "SimpleRNN", "WordRNN"]


def SimpleRNN(input_size: int, hidden_size: int, output_size: int,
              device="cuda", generator: Optional[torch.Generator] = None
              ) -> nn.Sequential:
    """SimpleRNN.scala:22-34: ``Recurrent(RnnCell)`` then
    ``TimeDistributed(Linear)``."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.Recurrent(nn.RnnCell(input_size, hidden_size, nn.Tanh(), **g)))
    m.add(nn.TimeDistributed(nn.Linear(hidden_size, output_size, **g)))
    return m.to(device)


def WordRNN(vocab_size: int, hidden_size: int, device="cuda",
            generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The rnn recipes' model (Train.scala:104-110): a LookupTable in
    front of the SimpleRNN body."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.LookupTable(vocab_size, hidden_size, **g))
    m.add(nn.Recurrent(nn.RnnCell(hidden_size, hidden_size, nn.Tanh(), **g)))
    m.add(nn.TimeDistributed(nn.Linear(hidden_size, vocab_size, **g)))
    return m.to(device)


def PTBModel(input_size: int, hidden_size: int, output_size: int,
             num_layers: int = 2, keep_prob: float = 2.0, device="cuda",
             generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """PTBModel.scala:23-45: a LookupTable, a ``Dropout`` when
    ``keep_prob < 1`` (built as ``Dropout(keep_prob)``, the JAX
    package's form, so ``keep_prob`` is the drop probability),
    ``num_layers`` ``Recurrent(LSTM)`` and a ``TimeDistributed(Linear)``
    head."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.LookupTable(input_size, hidden_size, **g))
    if keep_prob < 1:
        m.add(nn.Dropout(keep_prob))
    for _ in range(num_layers):
        m.add(nn.Recurrent(nn.LSTM(hidden_size, hidden_size, 0.0, **g)))
    m.add(nn.TimeDistributed(nn.Linear(hidden_size, output_size, **g)))
    return m.to(device)
