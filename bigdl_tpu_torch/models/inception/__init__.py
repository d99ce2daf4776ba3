"""GoogLeNet / Inception v1 and BN-Inception v2 (counterpart of
``bigdl_tpu.models.inception``; reference
models/inception/Inception_v1.scala and Inception_v2.scala; BASELINE
config 4 loads the v1 topology from Caffe).

The trees are built layer for layer as the JAX package builds them, with
its layer names (``conv1/7x7_s2``, ``inception_3a/1x1``, ...), so
``find()`` and the module serializer see the JAX package's names and the
parameters carry the JAX tree's keys. The full models concatenate their
three heads ``[main, aux2, aux1]`` on the class dimension, as the JAX
package does. Parameters are drawn on the CPU from ``generator`` (None:
torch's global generator) and moved to ``device`` (the card by default;
raises when CUDA is missing).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import Xavier, Zeros
from bigdl_tpu_torch.utils.engine import resolve_device
from bigdl_tpu_torch.utils.table import T

__all__ = ["Inception_Layer_v1", "Inception_Layer_v2", "Inception_v1",
           "Inception_v1_NoAuxClassifier", "Inception_v2",
           "Inception_v2_NoAuxClassifier"]


def _conv(cin, cout, kw, kh, sw=1, sh=1, pw=0, ph=0, name=None,
          generator=None):
    c = nn.SpatialConvolution(cin, cout, kw, kh, sw, sh, pw, ph,
                              init_weight=Xavier(), init_bias=Zeros(),
                              generator=generator)
    if name:
        c.set_name(name)
    return c


def Inception_Layer_v1(input_size: int, config, name_prefix: str = "",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """The Inception block (Inception_v1.scala:26-63): 1x1, 3x3, 5x5 and
    pool-projection branches concatenated on the channels. ``config`` is
    ``T(T(n1x1), T(n3x3_reduce, n3x3), T(n5x5_reduce, n5x5),
    T(pool_proj))``. Built on the CPU; the model functions move it."""
    g = dict(generator=generator)
    concat = nn.Concat(2)
    conv1 = nn.Sequential()
    conv1.add(_conv(input_size, config[1][1], 1, 1,
                    name=name_prefix + "1x1", **g))
    conv1.add(nn.ReLU(True))
    concat.add(conv1)
    conv3 = nn.Sequential()
    conv3.add(_conv(input_size, config[2][1], 1, 1,
                    name=name_prefix + "3x3_reduce", **g))
    conv3.add(nn.ReLU(True))
    conv3.add(_conv(config[2][1], config[2][2], 3, 3, 1, 1, 1, 1,
                    name=name_prefix + "3x3", **g))
    conv3.add(nn.ReLU(True))
    concat.add(conv3)
    conv5 = nn.Sequential()
    conv5.add(_conv(input_size, config[3][1], 1, 1,
                    name=name_prefix + "5x5_reduce", **g))
    conv5.add(nn.ReLU(True))
    conv5.add(_conv(config[3][1], config[3][2], 5, 5, 1, 1, 2, 2,
                    name=name_prefix + "5x5", **g))
    conv5.add(nn.ReLU(True))
    concat.add(conv5)
    pool = nn.Sequential()
    pool.add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
    pool.add(_conv(input_size, config[4][1], 1, 1,
                   name=name_prefix + "pool_proj", **g))
    pool.add(nn.ReLU(True))
    concat.add(pool)
    concat.set_name(name_prefix + "output")
    return concat


def _v1_stem(m: nn.Sequential, g) -> None:
    """conv1 .. pool2 of Inception_v1.scala:98-107."""
    m.add(_conv(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2", **g))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(_conv(64, 64, 1, 1, name="conv2/3x3_reduce", **g))
    m.add(nn.ReLU(True))
    m.add(_conv(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3", **g))
    m.add(nn.ReLU(True))
    m.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())


#: the v1 blocks' widths and names, in order
_V1 = {"3a": (192, T(T(64), T(96, 128), T(16, 32), T(32))),
       "3b": (256, T(T(128), T(128, 192), T(32, 96), T(64))),
       "4a": (480, T(T(192), T(96, 208), T(16, 48), T(64))),
       "4b": (512, T(T(160), T(112, 224), T(24, 64), T(64))),
       "4c": (512, T(T(128), T(128, 256), T(24, 64), T(64))),
       "4d": (512, T(T(112), T(144, 288), T(32, 64), T(64))),
       "4e": (528, T(T(256), T(160, 320), T(32, 128), T(128))),
       "5a": (832, T(T(256), T(160, 320), T(32, 128), T(128))),
       "5b": (832, T(T(384), T(192, 384), T(48, 128), T(128)))}


def _v1_block(key: str, g) -> nn.Concat:
    size, config = _V1[key]
    return Inception_Layer_v1(size, config, f"inception_{key}/", **g)


def Inception_v1_NoAuxClassifier(class_num: int = 1000,
                                 has_dropout: bool = True, device="cuda",
                                 generator: Optional[torch.Generator] = None
                                 ) -> nn.Sequential:
    """GoogLeNet without the auxiliary heads (Inception_v1.scala:97-132)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = nn.Sequential()
    _v1_stem(m, g)
    m.add(_v1_block("3a", g))
    m.add(_v1_block("3b", g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for key in ("4a", "4b", "4c", "4d", "4e"):
        m.add(_v1_block(key, g))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.add(_v1_block("5a", g))
    m.add(_v1_block("5b", g))
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    if has_dropout:
        m.add(nn.Dropout(0.4))
    m.add(nn.View(1024).set_num_input_dims(3))
    m.add(nn.Linear(1024, class_num, init_weight=Xavier(),
                    init_bias=Zeros(), **g).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m.to(device)


def _v1_aux(m: nn.Sequential, n_in: int, class_num: int, has_dropout,
            loss: str, g) -> nn.Sequential:
    """An auxiliary head (Inception_v1.scala:196-207, 222-233)."""
    m.add(_conv(n_in, 128, 1, 1, name=f"{loss}/conv", **g))
    m.add(nn.ReLU(True))
    m.add(nn.View(128 * 4 * 4).set_num_input_dims(3))
    m.add(nn.Linear(128 * 4 * 4, 1024, **g).set_name(f"{loss}/fc"))
    m.add(nn.ReLU(True))
    if has_dropout:
        m.add(nn.Dropout(0.7))
    m.add(nn.Linear(1024, class_num, **g).set_name(f"{loss}/classifier"))
    m.add(nn.LogSoftMax())
    return m


def _three_heads(feature1, output1, feature2, output2, output3
                 ) -> nn.Sequential:
    """``feature1 -> Concat(feature2 -> Concat(output3, output2),
    output1)``: the heads ``[main, aux2, aux1]`` on the class dim."""
    split2 = nn.Concat(2).set_name("split2")
    split2.add(output3)
    split2.add(output2)
    main_branch = nn.Sequential()
    main_branch.add(feature2)
    main_branch.add(split2)
    split1 = nn.Concat(2).set_name("split1")
    split1.add(main_branch)
    split1.add(output1)
    model = nn.Sequential()
    model.add(feature1)
    model.add(split1)
    return model


def Inception_v1(class_num: int = 1000, has_dropout: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """GoogLeNet with the two auxiliary heads
    (Inception_v1.scala:181-268); the output is ``[B, 3 * class_num]``,
    the heads ``[main, aux2, aux1]``."""
    device = resolve_device(device)
    g = dict(generator=generator)
    feature1 = nn.Sequential()
    _v1_stem(feature1, g)
    feature1.add(_v1_block("3a", g))
    feature1.add(_v1_block("3b", g))
    feature1.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    feature1.add(_v1_block("4a", g))

    output1 = nn.Sequential()
    output1.add(nn.SpatialAveragePooling(5, 5, 3, 3, ceil_mode=True))
    _v1_aux(output1, 512, class_num, has_dropout, "loss1", g)

    feature2 = nn.Sequential()
    for key in ("4b", "4c", "4d"):
        feature2.add(_v1_block(key, g))

    output2 = nn.Sequential()
    output2.add(nn.SpatialAveragePooling(5, 5, 3, 3))
    _v1_aux(output2, 528, class_num, has_dropout, "loss2", g)

    output3 = nn.Sequential()
    output3.add(_v1_block("4e", g))
    output3.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    output3.add(_v1_block("5a", g))
    output3.add(_v1_block("5b", g))
    output3.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    if has_dropout:
        output3.add(nn.Dropout(0.4))
    output3.add(nn.View(1024).set_num_input_dims(3))
    output3.add(nn.Linear(1024, class_num, init_weight=Xavier(),
                          init_bias=Zeros(), **g)
                .set_name("loss3/classifier"))
    output3.add(nn.LogSoftMax())
    return _three_heads(feature1, output1, feature2, output2,
                        output3).to(device)


# ---------------------------------------------------------- Inception v2

def _conv_bn(seq, cin, cout, kw, kh, sw=1, sh=1, pw=0, ph=0, name="",
             propagate_back=True, generator=None):
    """conv -> BN(1e-3) -> ReLU, the v2 unit (Inception_v2.scala:31-40);
    the conv is bias-free, as BN's mean subtraction cancels a bias (the
    JAX package's choice)."""
    seq.add(nn.SpatialConvolution(cin, cout, kw, kh, sw, sh, pw, ph,
                                  propagate_back=propagate_back,
                                  init_weight=Xavier(), init_bias=Zeros(),
                                  with_bias=False, generator=generator)
            .set_name(name))
    seq.add(nn.SpatialBatchNormalization(cout, 1e-3, generator=generator)
            .set_name(name + "/bn"))
    seq.add(nn.ReLU(True))
    return seq


def Inception_Layer_v2(input_size: int, config, name_prefix: str = "",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """The BN-Inception block (Inception_v2.scala:27-107): an optional
    1x1, a 3x3, a double 3x3 and a pool branch; a pool entry ``T("max",
    0)`` marks the stride-2 grid reduction. Built on the CPU."""
    g = dict(generator=generator)
    reduce_grid = config[4][1] == "max" and config[4][2] == 0
    concat = nn.Concat(2)
    if config[1][1] != 0:
        conv1 = nn.Sequential()
        _conv_bn(conv1, input_size, config[1][1], 1, 1,
                 name=name_prefix + "1x1", **g)
        concat.add(conv1)

    s = 2 if reduce_grid else 1
    conv3 = nn.Sequential()
    _conv_bn(conv3, input_size, config[2][1], 1, 1,
             name=name_prefix + "3x3_reduce", **g)
    _conv_bn(conv3, config[2][1], config[2][2], 3, 3, s, s, 1, 1,
             name=name_prefix + "3x3", **g)
    concat.add(conv3)

    conv3xx = nn.Sequential()
    _conv_bn(conv3xx, input_size, config[3][1], 1, 1,
             name=name_prefix + "double3x3_reduce", **g)
    _conv_bn(conv3xx, config[3][1], config[3][2], 3, 3, 1, 1, 1, 1,
             name=name_prefix + "double3x3a", **g)
    _conv_bn(conv3xx, config[3][2], config[3][2], 3, 3, s, s, 1, 1,
             name=name_prefix + "double3x3b", **g)
    concat.add(conv3xx)

    pool = nn.Sequential()
    if config[4][1] == "max":
        if config[4][2] != 0:
            pool.add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
        else:
            pool.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    elif config[4][1] == "avg":
        pool.add(nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1,
                                          ceil_mode=True))
    else:
        raise ValueError(f"unknown pool kind {config[4][1]}")
    if config[4][2] != 0:
        _conv_bn(pool, input_size, config[4][2], 1, 1,
                 name=name_prefix + "pool_proj", **g)
    concat.add(pool)
    return concat.set_name(name_prefix + "output")


def _v2_stem(m: nn.Sequential, g) -> nn.Sequential:
    """conv1 .. pool2 (Inception_v2.scala:187-197); the stem conv takes
    no data gradient."""
    _conv_bn(m, 3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2",
             propagate_back=False, **g)
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    _conv_bn(m, 64, 64, 1, 1, name="conv2/3x3_reduce", **g)
    _conv_bn(m, 64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3", **g)
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    return m


#: the v2 blocks' widths and configurations, in order
_V2 = {"3a": (192, T(T(64), T(64, 64), T(64, 96), T("avg", 32))),
       "3b": (256, T(T(64), T(64, 96), T(64, 96), T("avg", 64))),
       "3c": (320, T(T(0), T(128, 160), T(64, 96), T("max", 0))),
       "4a": (576, T(T(224), T(64, 96), T(96, 128), T("avg", 128))),
       "4b": (576, T(T(192), T(96, 128), T(96, 128), T("avg", 128))),
       "4c": (576, T(T(160), T(128, 160), T(128, 160), T("avg", 96))),
       "4d": (576, T(T(96), T(128, 192), T(160, 192), T("avg", 96))),
       "4e": (576, T(T(0), T(128, 192), T(192, 256), T("max", 0))),
       "5a": (1024, T(T(352), T(192, 320), T(160, 224), T("avg", 128))),
       "5b": (1024, T(T(352), T(192, 320), T(192, 224), T("max", 128)))}


def _v2_block(key: str, g) -> nn.Concat:
    size, config = _V2[key]
    return Inception_Layer_v2(size, config, f"inception_{key}/", **g)


def _v2_head(m: nn.Sequential, class_num: int, g) -> nn.Sequential:
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, ceil_mode=True))
    m.add(nn.View(1024).set_num_input_dims(3))
    m.add(nn.Linear(1024, class_num, **g).set_name("loss3/classifier"))
    m.add(nn.LogSoftMax())
    return m


def Inception_v2_NoAuxClassifier(class_num: int = 1000, device="cuda",
                                 generator: Optional[torch.Generator] = None
                                 ) -> nn.Sequential:
    """BN-GoogLeNet without the auxiliary heads
    (Inception_v2.scala:185-219)."""
    device = resolve_device(device)
    g = dict(generator=generator)
    m = _v2_stem(nn.Sequential(), g)
    for key in ("3a", "3b", "3c", "4a", "4b", "4c", "4d", "4e", "5a",
                "5b"):
        m.add(_v2_block(key, g))
    return _v2_head(m, class_num, g).to(device)


def _v2_aux(m: nn.Sequential, n_in: int, side: int, class_num: int,
            loss: str, g) -> nn.Sequential:
    """An auxiliary head of Inception_v2.scala:297-346."""
    m.add(nn.SpatialAveragePooling(5, 5, 3, 3, ceil_mode=True))
    _conv_bn(m, n_in, 128, 1, 1, name=f"{loss}/conv", **g)
    m.add(nn.View(128 * side * side).set_num_input_dims(3))
    m.add(nn.Linear(128 * side * side, 1024, **g).set_name(f"{loss}/fc"))
    m.add(nn.ReLU(True))
    m.add(nn.Linear(1024, class_num, **g).set_name(f"{loss}/classifier"))
    m.add(nn.LogSoftMax())
    return m


def Inception_v2(class_num: int = 1000, device="cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """BN-GoogLeNet with both auxiliary heads
    (Inception_v2.scala:275-364); the heads ``[main, aux2, aux1]``
    concatenated as :func:`Inception_v1`'s."""
    device = resolve_device(device)
    g = dict(generator=generator)
    features1 = _v2_stem(nn.Sequential(), g)
    for key in ("3a", "3b", "3c"):
        features1.add(_v2_block(key, g))
    output1 = _v2_aux(nn.Sequential(), 576, 4, class_num, "loss1", g)
    features2 = nn.Sequential()
    for key in ("4a", "4b", "4c", "4d", "4e"):
        features2.add(_v2_block(key, g))
    output2 = _v2_aux(nn.Sequential(), 1024, 2, class_num, "loss2", g)
    output3 = nn.Sequential()
    for key in ("5a", "5b"):
        output3.add(_v2_block(key, g))
    _v2_head(output3, class_num, g)
    return _three_heads(features1, output1, features2, output2,
                        output3).to(device)
