"""The MNIST autoencoder (counterpart of ``bigdl_tpu.models.autoencoder``;
reference models/autoencoder/Autoencoder.scala)."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["Autoencoder", "FEATURE_SIZE"]

ROW_N = 28
COL_N = 28
FEATURE_SIZE = ROW_N * COL_N


def Autoencoder(class_num: int = 32, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """784 -> ``class_num`` -> 784 with a ReLU code and a sigmoid
    reconstruction (Autoencoder.scala:25). Parameters are drawn on the
    CPU from ``generator`` and moved to ``device`` (the card by default;
    raises when CUDA is missing)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.Reshape((FEATURE_SIZE,)))
    m.add(nn.Linear(FEATURE_SIZE, class_num, **g))
    m.add(nn.ReLU())
    m.add(nn.Linear(class_num, FEATURE_SIZE, **g))
    m.add(nn.Sigmoid())
    return m.to(device)
