"""The port's ResNet layers and models against the JAX package on the
same seeded inputs, with the JAX params (and state: BatchNormalization's
running statistics) carried over by name.

Tolerances (float32): max pooling, ReLU, View, Identity and the table
ops move or select values and are bitwise; the other layers sum in
another order than XLA's CPU kernels, so a layer is held at 1e-5
relative to its output's scale, and a network (CIFAR ResNet-20, or
ResNet-50's stem and first bottleneck) at 1e-4 relative to its output's
largest element."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import (export_params, export_state,
                                     flatten_params, load_jax_params)
from bigdl_tpu_torch.models import ResNet

LAYER_RTOL = 1e-5
NET_RTOL = 1e-4


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _random_state(tree, seed):
    """A JAX state tree with non-trivial running statistics."""
    r = np.random.default_rng(seed)

    def visit(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, val in node.items():
            if key == "running_mean":
                out[key] = jnp.asarray(
                    r.standard_normal(val.shape).astype(np.float32) * 0.1)
            elif key == "running_var":
                out[key] = jnp.asarray(
                    r.uniform(0.5, 1.5, val.shape).astype(np.float32))
            else:
                out[key] = visit(val)
        return out

    return visit(tree)


def _carried(jax_module, torch_module, seed=0, state=True):
    """Initialise the JAX module (seeded), give it random running
    statistics, evaluate both, and carry params and state over."""
    RandomGenerator.set_seed(seed)
    jax_module.ensure_initialized()
    jax_module.evaluate()
    if state:
        jax_module.set_state(_random_state(jax_module.get_state(), seed))
    load_jax_params(torch_module, jax_module.get_parameters(),
                    jax_module.get_state() if state else None)
    return torch_module.eval()


def _both(jax_module, torch_module, x):
    want = np.asarray(jax_module.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x)).numpy()
    return got, want


def _close(got, want, rtol):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("args", [
    (3, 8, 7, 7, 2, 2, 3, 3), (8, 8, 3, 3, 1, 1, 1, 1),
    (8, 16, 1, 1, 2, 2, 0, 0), (4, 6, 3, 2, 1, 2, 0, 1)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_spatial_convolution(args, with_bias):
    jm = jnn.SpatialConvolution(*args, with_bias=with_bias)
    tm = _carried(jm, nn.SpatialConvolution(*args, with_bias=with_bias),
                  state=False)
    got, want = _both(jm, tm, _x(1, 2, args[0], 13, 11))
    _close(got, want, LAYER_RTOL)


def test_grouped_convolution():
    jm = jnn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2)
    tm = _carried(jm, nn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1,
                                            n_group=2), state=False)
    got, want = _both(jm, tm, _x(2, 2, 4, 9, 9))
    _close(got, want, LAYER_RTOL)


@pytest.mark.parametrize("shape", [(5, 6), (2, 6, 4, 3)])
def test_batch_normalization_eval(shape):
    cls_j = jnn.BatchNormalization if len(shape) == 2 \
        else jnn.SpatialBatchNormalization
    cls_t = nn.BatchNormalization if len(shape) == 2 \
        else nn.SpatialBatchNormalization
    jm = cls_j(6)
    tm = _carried(jm, cls_t(6), seed=3)
    got, want = _both(jm, tm, _x(3, *shape))
    _close(got, want, LAYER_RTOL)


def test_batch_normalization_training_mode_raises():
    with pytest.raises(NotImplementedError, match="training mode"):
        nn.SpatialBatchNormalization(4)(torch.zeros(2, 4, 3, 3))


@pytest.mark.parametrize("args,ceil", [
    ((3, 3, 2, 2, 1, 1), False), ((3, 3, 2, 2, 1, 1), True),
    ((2, 2, 2, 2, 0, 0), True), ((3, 2, 1, 2, 1, 0), False)])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (112, 112)])
def test_max_pooling_bitwise(args, ceil, hw):
    jm, tm = jnn.SpatialMaxPooling(*args), nn.SpatialMaxPooling(*args)
    for m in (jm, tm):
        if ceil:
            m.ceil()
        else:
            m.floor()
    got, want = _both(jm, tm, _x(4, 2, 3, *hw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(ceil_mode=True), dict(count_include_pad=False),
    dict(ceil_mode=True, count_include_pad=False), dict(divide=False),
    dict(global_pooling=True)])
@pytest.mark.parametrize("args", [(3, 3, 2, 2, 1, 1), (2, 2, 2, 2, 0, 0)])
def test_average_pooling(kw, args):
    jm = jnn.SpatialAveragePooling(*args, **kw)
    tm = nn.SpatialAveragePooling(*args, **kw)
    got, want = _both(jm, tm, _x(5, 2, 3, 9, 8))
    _close(got, want, LAYER_RTOL)


def test_linear_and_elementwise_layers():
    jm = jnn.Linear(12, 5)
    tm = _carried(jm, nn.Linear(12, 5), state=False)
    got, want = _both(jm, tm, _x(6, 4, 12))
    _close(got, want, LAYER_RTOL)
    got, want = _both(jm, tm, _x(6, 12))             # 1-D input
    _close(got, want, LAYER_RTOL)
    x = _x(7, 2, 3, 4, 5)
    for jl, tl in ((jnn.ReLU(True), nn.ReLU(True)),
                   (jnn.Identity(), nn.Identity()),
                   (jnn.MulConstant(0.0), nn.MulConstant(0.0)),
                   (jnn.MulConstant(-1.5), nn.MulConstant(-1.5)),
                   (jnn.View(60).set_num_input_dims(3),
                    nn.View(60).set_num_input_dims(3))):
        got, want = _both(jl, tl.eval(), x)
        np.testing.assert_array_equal(got, want)


def test_containers_and_table_ops_bitwise():
    x = _x(8, 2, 4, 3, 3)
    jm = (jnn.Sequential()
          .add(jnn.ConcatTable().add(jnn.ReLU()).add(jnn.MulConstant(2.0)))
          .add(jnn.CAddTable(True)))
    tm = nn.Sequential(nn.ConcatTable(nn.ReLU(), nn.MulConstant(2.0)),
                       nn.CAddTable(True))
    got, want = _both(jm, tm, x)
    np.testing.assert_array_equal(got, want)
    jc = jnn.Concat(2).add(jnn.Identity()).add(jnn.MulConstant(0.0))
    tc = nn.Concat(2, nn.Identity(), nn.MulConstant(0.0))
    got, want = _both(jc, tc, x)
    np.testing.assert_array_equal(got, want)
    assert len(tm) == 2 and isinstance(tm[0], nn.ConcatTable)


# ------------------------------------------------------------- models

def _jax_tree(skeleton, flat, prefix=""):
    """The JAX tree of ``skeleton``'s structure (empty dicts of
    parameter-free layers included) with the leaves of the flat
    port-named ``flat``."""
    if isinstance(skeleton, dict):
        return {k: _jax_tree(v, flat, f"{prefix}{k}.")
                for k, v in skeleton.items()}
    return jnp.asarray(flat[prefix[:-1]])


def _port_to_jax(tm, jm, seed):
    """Carry the port model's params into the JAX model of the same
    tree (JAX's eager init of a ResNet takes seconds of op-by-op
    compiles on the CPU; the port's takes milliseconds), give both the
    same random running statistics, put both in evaluation mode, and
    return the port model and the JAX model's jitted forward."""
    skeleton = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jm.set_parameters(_jax_tree(skeleton, flatten_params(export_params(tm))))
    jm.set_state(_random_state(jm.initial_state(), seed))
    jm.evaluate()
    load_jax_params(tm, jm.get_parameters(), jm.get_state())
    fwd = jax.jit(lambda p, s, x: jm.apply(p, s, x, training=False)[0])
    return tm.eval(), lambda x: np.asarray(
        fwd(jm.get_parameters(), jm.get_state(), jnp.asarray(x)))


def _jax_names_and_shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten_params(tree).items()}


def test_resnet50_names_and_shapes_equal_the_jax_tree():
    jm = JaxResNet(1000, depth=50, dataset="ImageNet")
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    state = jm.initial_state()
    tm = ResNet(1000, depth=50, dataset="ImageNet", device="cpu",
                generator=torch.Generator().manual_seed(23))
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} \
        == _jax_names_and_shapes(params)
    assert {k: tuple(b.shape) for k, b in tm.named_buffers()} \
        == _jax_names_and_shapes(state)
    n = sum(p.numel() for p in tm.parameters())
    assert n == 25_557_032                     # ResNet-50 without conv bias


def test_resnet_msra_init_statistics():
    """The port's init draws its own numbers from the generator, with the
    JAX package's distributions: conv weights N(0, 2 / fan_out), BN
    (1, 0), classifier U(+-1/sqrt(2048)) with a zero bias."""
    tm = ResNet(1000, depth=50, dataset="ImageNet", device="cpu",
                generator=torch.Generator().manual_seed(23))
    w = tm[4][0][0][0][3].weight       # 3x3 conv, 64 -> 64
    assert w.shape == (64, 64, 3, 3)
    assert abs(w.std().item() - (2.0 / (64 * 9)) ** 0.5) < 2e-3
    bn = tm[1]
    assert torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
    fc = tm[-1]
    assert fc.weight.abs().max() <= 2048 ** -0.5 and torch.all(fc.bias == 0)
    again = ResNet(1000, depth=50, dataset="ImageNet", device="cpu",
                   generator=torch.Generator().manual_seed(23))
    assert torch.equal(again[-1].weight, fc.weight)


@pytest.mark.parametrize("shortcut", ["A", "B", "C"])
def test_cifar_resnet20_float_forward(shortcut):
    kw = dict(class_num=10, depth=20, shortcut_type=shortcut,
              dataset="CIFAR10")
    tm, jax_forward = _port_to_jax(
        ResNet(device="cpu", generator=torch.Generator().manual_seed(11),
               **kw), JaxResNet(**kw), seed=11)
    x = _x(12, 4, 3, 32, 32)
    want = jax_forward(x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want, NET_RTOL)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_stem_and_one_bottleneck_forward():
    """ResNet-50's stem (7x7/2 conv, BN, ReLU, 3x3/2 max pool) and the
    first bottleneck of layer1 (with its conv shortcut), at 32 x 32."""
    jfull = JaxResNet(1000, depth=50, dataset="ImageNet")
    jm = jnn.Sequential(*jfull.modules[:4], jfull.modules[4].modules[0])
    tfull = ResNet(1000, depth=50, dataset="ImageNet", device="cpu",
                   generator=torch.Generator().manual_seed(13))
    tm, jax_forward = _port_to_jax(
        nn.Sequential(*[tfull[i] for i in range(4)], tfull[4][0]), jm,
        seed=13)
    x = _x(14, 2, 3, 32, 32)
    want = jax_forward(x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 256, 8, 8)
    _close(got, want, NET_RTOL)


def test_export_round_trips_params_and_state():
    tm = ResNet(10, depth=20, dataset="CIFAR10", device="cpu",
                generator=torch.Generator().manual_seed(1)).eval()
    params, state = export_params(tm), export_state(tm)
    other = ResNet(10, depth=20, dataset="CIFAR10", device="cpu",
                   generator=torch.Generator().manual_seed(2)).eval()
    load_jax_params(other, params, state)
    for (a, x), (b, y) in zip(tm.state_dict().items(),
                              other.state_dict().items()):
        assert a == b and torch.equal(x, y)
    bad = dict(state)
    bad.pop("1")
    with pytest.raises(KeyError, match="state tree"):
        load_jax_params(other, params, bad)
