"""LeNet-5 (counterpart of ``bigdl_tpu.models.lenet``; BigDL
models/lenet/LeNet5.scala:23, the Sequential form, and :39, the Graph
form)."""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["LeNet5", "LeNet5_graph"]


def LeNet5(class_num: int = 10, device="cuda",
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """The Sequential LeNet-5 of LeNet5.scala:23-37, layer for layer and
    name for name, so its parameters carry the JAX param tree's keys
    (``"1"`` is ``conv1_5x5``, ``"5"`` ``conv2_5x5``, ``"8"`` ``fc1``,
    ``"10"`` ``fc2``). Parameters are drawn on the CPU from
    ``generator`` and moved to ``device`` (the card by default; raises
    when CUDA is missing)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    model = nn.Sequential()
    model.add(nn.Reshape((1, 28, 28))) \
        .add(nn.SpatialConvolution(1, 6, 5, 5, **g).set_name("conv1_5x5")) \
        .add(nn.Tanh()) \
        .add(nn.SpatialMaxPooling(2, 2, 2, 2)) \
        .add(nn.Tanh()) \
        .add(nn.SpatialConvolution(6, 12, 5, 5, **g).set_name("conv2_5x5")) \
        .add(nn.SpatialMaxPooling(2, 2, 2, 2)) \
        .add(nn.Reshape((12 * 4 * 4,))) \
        .add(nn.Linear(12 * 4 * 4, 100, **g).set_name("fc1")) \
        .add(nn.Tanh()) \
        .add(nn.Linear(100, class_num, **g).set_name("fc2")) \
        .add(nn.LogSoftMax())
    return model.to(device)


def LeNet5_graph(class_num: int = 10, device="cuda",
                 generator: Optional[torch.Generator] = None) -> nn.Graph:
    """The Graph form (LeNet5.scala:39-53): the Sequential's layers,
    wired node by node, with its weights drawn in the same order from
    ``generator`` (so equal to ``LeNet5``'s from an equally seeded
    generator). Its nodes carry the JAX Graph's names (``Input``,
    ``Reshape``, ``conv1_5x5``, ``Tanh``, ..., ``fc1``, ``Tanh_2``,
    ``fc2``, ``LogSoftMax``)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    inp = nn.Input()()
    x = nn.Reshape((1, 28, 28))(inp)
    x = nn.SpatialConvolution(1, 6, 5, 5, **g).set_name("conv1_5x5")(x)
    x = nn.Tanh()(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2)(x)
    x = nn.Tanh()(x)
    x = nn.SpatialConvolution(6, 12, 5, 5, **g).set_name("conv2_5x5")(x)
    x = nn.SpatialMaxPooling(2, 2, 2, 2)(x)
    x = nn.Reshape((12 * 4 * 4,))(x)
    x = nn.Linear(12 * 4 * 4, 100, **g).set_name("fc1")(x)
    x = nn.Tanh()(x)
    x = nn.Linear(100, class_num, **g).set_name("fc2")(x)
    out = nn.LogSoftMax()(x)
    return nn.Graph(inp, out).to(device)
