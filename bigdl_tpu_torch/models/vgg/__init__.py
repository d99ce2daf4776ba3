"""VGG (counterpart of ``bigdl_tpu.models.vgg``; reference
models/vgg/VggForCifar10.scala and the zoo's Vgg_16 / Vgg_19; BASELINE
config 2 is VggForCifar10 on CIFAR-10).

Each function adds the JAX package's layers in its order, so the
parameters and buffers carry the JAX tree's keys. Parameters are drawn
on the CPU from ``generator`` (None: torch's global generator) and
moved to ``device`` (the card by default; raises when CUDA is missing).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["VggForCifar10", "Vgg_16", "Vgg_19"]


def VggForCifar10(class_num: int = 10, has_dropout: bool = True,
                  device="cuda",
                  generator: Optional[torch.Generator] = None
                  ) -> nn.Sequential:
    """VggForCifar10.scala:24-78: conv-BN-ReLU stacks over 32 x 32
    images, dropout between them, a BN classifier."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()

    def conv_bn_relu(cin, cout):
        m.add(nn.SpatialConvolution(cin, cout, 3, 3, 1, 1, 1, 1, **g))
        m.add(nn.SpatialBatchNormalization(cout, 1e-3, **g))
        m.add(nn.ReLU(True))

    def dropout(p):
        if has_dropout:
            m.add(nn.Dropout(p))

    conv_bn_relu(3, 64)
    dropout(0.3)
    conv_bn_relu(64, 64)
    m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    conv_bn_relu(64, 128)
    dropout(0.4)
    conv_bn_relu(128, 128)
    m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    for cin, cout in ((128, 256), (256, 512), (512, 512)):
        conv_bn_relu(cin, cout)
        dropout(0.4)
        conv_bn_relu(cout, cout)
        dropout(0.4)
        conv_bn_relu(cout, cout)
        m.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    m.add(nn.View(512))

    classifier = nn.Sequential()
    if has_dropout:
        classifier.add(nn.Dropout(0.5))
    classifier.add(nn.Linear(512, 512, **g))
    classifier.add(nn.BatchNormalization(512, **g))
    classifier.add(nn.ReLU(True))
    if has_dropout:
        classifier.add(nn.Dropout(0.5))
    classifier.add(nn.Linear(512, class_num, **g))
    classifier.add(nn.LogSoftMax())
    m.add(classifier)
    return m.to(device)


def _vgg_blocks(cfg, class_num, device, generator) -> nn.Sequential:
    """Plain VGG for 224 x 224 ImageNet (DistriOptimizerPerf's vgg16 /
    vgg19): 3 x 3 convs and ReLUs, 2 x 2 max pools at ``"M"``, then the
    three-layer classifier with ``Threshold(0, 1e-6)`` and
    ``Dropout(0.5)`` between its layers."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    cin = 3
    for v in cfg:
        if v == "M":
            m.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            m.add(nn.SpatialConvolution(cin, v, 3, 3, 1, 1, 1, 1, **g))
            m.add(nn.ReLU(True))
            cin = v
    m.add(nn.View(512 * 7 * 7))
    m.add(nn.Linear(512 * 7 * 7, 4096, **g))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, 4096, **g))
    m.add(nn.Threshold(0, 1e-6))
    m.add(nn.Dropout(0.5))
    m.add(nn.Linear(4096, class_num, **g))
    m.add(nn.LogSoftMax())
    return m.to(device)


def Vgg_16(class_num: int = 1000, device="cuda",
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """VGG-16 for ImageNet (models/vgg/Vgg_16.scala)."""
    return _vgg_blocks([64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                        512, 512, 512, "M", 512, 512, 512, "M"], class_num,
                       device, generator)


def Vgg_19(class_num: int = 1000, device="cuda",
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """VGG-19 for ImageNet (models/vgg/Vgg_19.scala)."""
    return _vgg_blocks([64, 64, "M", 128, 128, "M", 256, 256, 256, 256,
                        "M", 512, 512, 512, 512, "M", 512, 512, 512, 512,
                        "M"], class_num, device, generator)
