"""AlexNet (counterpart of ``bigdl_tpu.models.alexnet``; reference
example/loadmodel/AlexNet.scala, the model the load-model example and
DistriOptimizerPerf use).

``AlexNet`` is the original ILSVRC-2012 form: 227 x 227 input, cross-map
LRNs and 2-group convolutions (the dual-GPU split baked into the
weights); ``AlexNet_OWT`` is the one-weird-trick form (224 x 224, no LRN,
no groups). Layer for layer and name for name the JAX package's, so the
parameters carry its tree's keys. The int8 rewrite (:func:`~bigdl_tpu_
torch.nn.quantized.quantize`) leaves the grouped convolutions in float,
as the JAX package's does. Parameters are drawn on the CPU from
``generator`` (None: torch's global generator) and moved to ``device``
(the card by default; raises when CUDA is missing).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["AlexNet", "AlexNet_OWT"]


def _classifier(m: nn.Sequential, class_num: int, has_dropout: bool,
                g) -> nn.Sequential:
    """pool5's features through fc6, fc7 and fc8 (AlexNet.scala:40-49)."""
    m.add(nn.View(256 * 6 * 6).set_num_input_dims(3))
    m.add(nn.Linear(256 * 6 * 6, 4096, **g).set_name("fc6"))
    m.add(nn.ReLU(True))
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **g).set_name("fc7"))
    m.add(nn.ReLU(True))
    if has_dropout:
        m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **g).set_name("fc8"))
    m.add(nn.LogSoftMax())
    return m


def AlexNet_OWT(class_num: int = 1000, has_dropout: bool = True,
                first_layer_propagate_back: bool = False, device="cuda",
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """AlexNet.scala:23-50 (AlexNet_OWT)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(
        3, 64, 11, 11, 4, 4, 2, 2, 1,
        propagate_back=first_layer_propagate_back, **g).set_name("conv1"))
    m.add(nn.ReLU(True).set_name("relu1"))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    m.add(nn.SpatialConvolution(64, 192, 5, 5, 1, 1, 2, 2, **g)
          .set_name("conv2"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    m.add(nn.SpatialConvolution(192, 384, 3, 3, 1, 1, 1, 1, **g)
          .set_name("conv3"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, **g)
          .set_name("conv4"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(256, 256, 3, 3, 1, 1, 1, 1, **g)
          .set_name("conv5"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    return _classifier(m, class_num, has_dropout, g).to(device)


def AlexNet(class_num: int = 1000, has_dropout: bool = True, device="cuda",
            generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """AlexNet.scala:84-112: the original form, cross-map LRNs after
    conv1 and conv2, conv2, conv4 and conv5 in 2 groups, no data
    gradient into conv1."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 96, 11, 11, 4, 4, 0, 0, 1,
                                propagate_back=False, **g)
          .set_name("conv1"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm1"))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool1"))
    m.add(nn.SpatialConvolution(96, 256, 5, 5, 1, 1, 2, 2, 2, **g)
          .set_name("conv2"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75).set_name("norm2"))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool2"))
    m.add(nn.SpatialConvolution(256, 384, 3, 3, 1, 1, 1, 1, **g)
          .set_name("conv3"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(384, 384, 3, 3, 1, 1, 1, 1, 2, **g)
          .set_name("conv4"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialConvolution(384, 256, 3, 3, 1, 1, 1, 1, 2, **g)
          .set_name("conv5"))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).set_name("pool5"))
    return _classifier(m, class_num, has_dropout, g).to(device)
