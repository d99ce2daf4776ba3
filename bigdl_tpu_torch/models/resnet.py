"""ResNet for CIFAR-10 / ImageNet (counterpart of
``bigdl_tpu.models.resnet``; reference models/resnet/ResNet.scala:133).

Depths 20/32/44/56/110 (CIFAR) and 18/34/50/101/152/200 (ImageNet),
shortcut types A/B/C, the MSRA init of ``ResNet.modelInit`` and the JAX
package's bias-free convolutions (``conv_bias=True`` restores the
reference's biases). The tree is built from the port's
:mod:`~bigdl_tpu_torch.nn` containers exactly as the JAX package builds
it, so every parameter and buffer carries the JAX tree's name
(``"4.0.0.0.weight"`` for ``params["4"]["0"]["0"]["0"]["weight"]``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from bigdl_tpu_torch.nn.activation import Identity, ReLU
from bigdl_tpu_torch.nn.container import (Concat, ConcatTable, Sequential)
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.initialization import MsraFiller, Ones, Zeros
from bigdl_tpu_torch.nn.linear import Linear, MulConstant
from bigdl_tpu_torch.nn.norm import SpatialBatchNormalization
from bigdl_tpu_torch.nn.pool import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape import View
from bigdl_tpu_torch.nn.table_ops import CAddTable
from bigdl_tpu_torch.utils.engine import resolve_device

__all__ = ["DatasetType", "ResNet", "ShortcutType"]


class ShortcutType:
    A = "A"
    B = "B"
    C = "C"


class DatasetType:
    CIFAR10 = "CIFAR10"
    ImageNet = "ImageNet"


_IMAGENET = {18: ((2, 2, 2, 2), 512, "basic"),
             34: ((3, 4, 6, 3), 512, "basic"),
             50: ((3, 4, 6, 3), 2048, "bottleneck"),
             101: ((3, 4, 23, 3), 2048, "bottleneck"),
             152: ((3, 8, 36, 3), 2048, "bottleneck"),
             200: ((3, 24, 36, 3), 2048, "bottleneck")}


def ResNet(class_num: int, depth: int = 18,
           shortcut_type: str = ShortcutType.B,
           dataset: str = DatasetType.CIFAR10,
           conv_bias: bool = False,
           device: Optional[Union[str, torch.device]] = None,
           generator: Optional[torch.Generator] = None) -> Sequential:
    """ResNet for CIFAR-10 (depth 20/32/44/56/110) or ImageNet (depth
    18-200) — models/resnet/ResNet.scala:88.

    ``device`` defaults to the card (``None`` → ``"cuda"``, raising when
    CUDA is missing); pass ``device="cpu"`` to run on the CPU.
    Parameters are initialised on the CPU from ``generator`` (None:
    torch's global generator) and then moved, so one seed gives the same
    weights on every device. The model is returned in training mode, as
    a new torch module is; call ``.eval()`` to serve it."""
    device = resolve_device(device)
    channels = [0]

    def conv(cin, cout, kw, kh, sw=1, sh=1, pw=0, ph=0,
             propagate_back=True):
        # every conv feeds a BatchNormalization, whose mean subtraction
        # cancels a conv bias exactly (the JAX package's note)
        return SpatialConvolution(
            cin, cout, kw, kh, sw, sh, pw, ph,
            propagate_back=propagate_back, with_bias=conv_bias,
            init_weight=MsraFiller(var_in_count=False), init_bias=Zeros(),
            generator=generator)

    def bn(n):
        # modelInit: gamma = 1, beta = 0 (ResNet.scala:120-124)
        return SpatialBatchNormalization(n, init_weight=Ones(),
                                         init_bias=Zeros())

    def shortcut(n_in, n_out, stride):
        use_conv = shortcut_type == ShortcutType.C or (
            shortcut_type == ShortcutType.B and n_in != n_out)
        if use_conv:
            return Sequential(conv(n_in, n_out, 1, 1, stride, stride),
                              bn(n_out))
        if n_in != n_out:
            # type A: stride subsample + zero-pad channels via Concat
            return Sequential(
                SpatialAveragePooling(1, 1, stride, stride),
                Concat(2, Identity(), MulConstant(0.0)))
        return Identity()

    def basic_block(n, stride):
        n_in = channels[0]
        channels[0] = n
        s = Sequential(conv(n_in, n, 3, 3, stride, stride, 1, 1), bn(n),
                       ReLU(True), conv(n, n, 3, 3, 1, 1, 1, 1), bn(n))
        return Sequential(ConcatTable(s, shortcut(n_in, n, stride)),
                          CAddTable(True), ReLU(True))

    def bottleneck(n, stride):
        n_in = channels[0]
        channels[0] = n * 4
        s = Sequential(conv(n_in, n, 1, 1, 1, 1, 0, 0), bn(n), ReLU(True),
                       conv(n, n, 3, 3, stride, stride, 1, 1), bn(n),
                       ReLU(True), conv(n, n * 4, 1, 1, 1, 1, 0, 0),
                       bn(n * 4))
        return Sequential(ConcatTable(s, shortcut(n_in, n * 4, stride)),
                          CAddTable(True), ReLU(True))

    def layer(block, features, count, stride=1):
        return Sequential(*[block(features, stride if i == 0 else 1)
                            for i in range(count)])

    model = Sequential()
    if dataset == DatasetType.ImageNet:
        if depth not in _IMAGENET:
            raise ValueError(f"Invalid depth {depth}")
        loop, n_features, kind = _IMAGENET[depth]
        block = bottleneck if kind == "bottleneck" else basic_block
        channels[0] = 64
        # stem conv: propagateBack=false (ResNet.scala:234)
        model.add(conv(3, 64, 7, 7, 2, 2, 3, 3, propagate_back=False)) \
            .add(bn(64)) \
            .add(ReLU(True)) \
            .add(SpatialMaxPooling(3, 3, 2, 2, 1, 1)) \
            .add(layer(block, 64, loop[0])) \
            .add(layer(block, 128, loop[1], 2)) \
            .add(layer(block, 256, loop[2], 2)) \
            .add(layer(block, 512, loop[3], 2)) \
            .add(SpatialAveragePooling(7, 7, 1, 1)) \
            .add(View(n_features).set_num_input_dims(3)) \
            .add(Linear(n_features, class_num, init_bias=Zeros(),
                        generator=generator))
    elif dataset == DatasetType.CIFAR10:
        if (depth - 2) % 6 != 0:
            raise ValueError("depth should be one of 20, 32, 44, 56, 110")
        n = (depth - 2) // 6
        channels[0] = 16
        # stem conv: propagateBack=false (ResNet.scala:252)
        model.add(conv(3, 16, 3, 3, 1, 1, 1, 1, propagate_back=False)) \
            .add(bn(16)) \
            .add(ReLU(True)) \
            .add(layer(basic_block, 16, n)) \
            .add(layer(basic_block, 32, n, 2)) \
            .add(layer(basic_block, 64, n, 2)) \
            .add(SpatialAveragePooling(8, 8, 1, 1)) \
            .add(View(64).set_num_input_dims(3)) \
            .add(Linear(64, class_num, init_bias=Zeros(),
                        generator=generator))
    else:
        raise ValueError(f"unknown dataset {dataset}")
    return model.to(device)
