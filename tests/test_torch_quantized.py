"""The port's int8 quantization — primitives, quantized layers,
calibration, the accuracy gate and a quantized ResNet — against the JAX
package on the same seeded inputs and carried weights.

Bitwise where both packages run the same float32 operations in the
same order on the same values: the quantizers, the quantized linear and
convolution (integer products are exact), ``from_float``'s weights and
scales, and the calibrated scale of a layer fed the raw input. A layer
deeper in a float model sees its input through float sums taken in
another order, so its calibrated scale is held at 1e-6 relative (the
input's max-abs moves by an ulp or two). A quantized network runs float
BatchNormalization between int8 layers: an ulp of difference there can
move one activation across a rounding boundary, one int8 step (1/127 of
the layer's calibrated range), and that step propagates. The quantized
CIFAR ResNet-20's logits are held at 2e-2 of their largest magnitude,
with top-1 equal on every row."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.nn.quantized import QuantizedLinear as JaxQuantizedLinear
from bigdl_tpu.nn.quantized import \
    QuantizedSpatialConvolution as JaxQuantizedConv
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu.ops import quant as jq
from bigdl_tpu.precision.calibrate import \
    collect_activation_scales as jax_collect
from bigdl_tpu.precision.gate import AccuracyGate as JaxGate
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch import kernels, nn
from bigdl_tpu_torch.convert import (export_params, flatten_params,
                                     load_jax_params)
from bigdl_tpu_torch.models import ResNet
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.precision import (AccuracyGate, AccuracyGateError,
                                       collect_activation_scales)

NET_RTOL = 2e-2
DEEP_SCALE_RTOL = 1e-6


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------- primitives

@pytest.mark.parametrize("shape,axis", [((8, 32), 0), ((8, 32), 1),
                                        ((6, 3, 5, 5), 0), ((7,), 0)])
def test_quantize_symmetric_bitwise(shape, axis):
    x = _x(sum(shape) + axis, *shape, scale=3.0)
    x.flat[0] = 0.5 * np.abs(x).max()      # a half-way value somewhere
    jqv, jsc = jq.quantize_symmetric(jnp.asarray(x), axis=axis)
    tq, tsc = quant.quantize_symmetric(torch.from_numpy(x), axis=axis)
    _eq(tq.numpy(), jqv)
    _eq(tsc.numpy(), jsc)
    assert tq.dtype == torch.int8


def test_round_half_to_even_like_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0], np.float32)
    _eq(quant.quantize_with_scale(torch.from_numpy(x), 1.0).numpy(),
        jq.quantize_with_scale(jnp.asarray(x), 1.0))


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_linear_bitwise(calibrated, with_bias):
    x, w = _x(1, 20, 48), _x(2, 24, 48, scale=0.1)
    b = _x(3, 24) if with_bias else None
    act = np.float32(0.02) if calibrated else None
    jwq, jws = jq.quantize_symmetric(jnp.asarray(w), axis=0)
    want = jq.quantized_linear(jnp.asarray(x), jwq, jws.reshape(-1),
                               None if b is None else jnp.asarray(b),
                               x_scale=act)
    twq, tws = quant.quantize_symmetric(torch.from_numpy(w), axis=0)
    got = quant.quantized_linear(torch.from_numpy(x), twq, tws.reshape(-1),
                                 None if b is None else torch.from_numpy(b),
                                 x_scale=act)
    _eq(got.numpy(), want)


CONVS = {  # name: (cin, cout, kh, kw, stride, pad, h, w)
    "stem 7x7/2 pad 3": (3, 8, 7, 7, 2, 3, 20, 18),
    "3x3 pad 1": (8, 16, 3, 3, 1, 1, 9, 9),
    "1x1 stride 2": (16, 24, 1, 1, 2, 0, 9, 8),
}


@pytest.mark.parametrize("name", sorted(CONVS))
@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_quantized_conv2d_bitwise(name, calibrated, with_bias):
    cin, cout, kh, kw, s, p, h, w = CONVS[name]
    x = _x(4, 2, cin, h, w, scale=2.0)
    wt = _x(5, cout, cin, kh, kw, scale=0.2)
    b = _x(6, cout) if with_bias else None
    act = np.float32(0.03) if calibrated else None
    jwq, jws = jq.quantize_symmetric(jnp.asarray(wt), axis=0)
    want = jq.quantized_conv2d(
        jnp.asarray(x), jwq, jws.reshape(-1),
        None if b is None else jnp.asarray(b), stride=(s, s),
        padding=[(p, p), (p, p)], x_scale=act)
    twq, tws = quant.quantize_symmetric(torch.from_numpy(wt), axis=0)
    got = quant.quantized_conv2d(
        torch.from_numpy(x), twq, tws.reshape(-1),
        None if b is None else torch.from_numpy(b), stride=(s, s),
        padding=[(p, p), (p, p)], x_scale=act)
    _eq(got.numpy(), want)


def test_grouped_quantized_conv2d_bitwise():
    x, wt = _x(7, 2, 6, 7, 7), _x(8, 9, 2, 3, 3, scale=0.3)
    jwq, jws = jq.quantize_symmetric(jnp.asarray(wt), axis=0)
    want = jq.quantized_conv2d(jnp.asarray(x), jwq, jws.reshape(-1),
                               stride=(1, 1), padding=[(1, 1), (0, 2)],
                               n_group=3)
    twq, tws = quant.quantize_symmetric(torch.from_numpy(wt), axis=0)
    got = quant.quantized_conv2d(torch.from_numpy(x), twq, tws.reshape(-1),
                                 stride=(1, 1), padding=[(1, 1), (0, 2)],
                                 n_group=3)
    _eq(got.numpy(), want)


# -------------------------------------------------------------- layers

def _jax_init(module, seed):
    RandomGenerator.set_seed(seed)
    module.ensure_initialized()
    module.evaluate()
    return module


@pytest.mark.parametrize("act", [None, 0.05])
def test_from_float_linear_bitwise(act):
    jl = _jax_init(jnn.Linear(40, 12), 1)
    tl = load_jax_params(nn.Linear(40, 12), jl.get_parameters())
    jq_l = JaxQuantizedLinear.from_float(jl, jl.get_parameters(),
                                         act).evaluate()
    tq_l = QuantizedLinear.from_float(tl, act).eval()
    for key in ("weight_q", "w_scale", "bias") + (("act_scale",) if act
                                                  else ()):
        _eq(getattr(tq_l, key).numpy(), jq_l._qparams[key])
    assert (tq_l.act_scale is None) == (act is None)
    x = _x(2, 5, 40)
    for cfg in (kernels.KernelConfig.ported(), kernels.KernelConfig.off()):
        with kernels.use(cfg), torch.no_grad():
            got = tq_l(torch.from_numpy(x))
        _eq(got.numpy(), jq_l.forward(jnp.asarray(x)))


@pytest.mark.parametrize("act", [None, 0.05])
def test_from_float_conv_bitwise(act):
    jc = _jax_init(jnn.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1), 2)
    tc = load_jax_params(nn.SpatialConvolution(3, 8, 3, 3, 2, 2, 1, 1),
                         jc.get_parameters())
    jq_c = JaxQuantizedConv.from_float(jc, jc.get_parameters(),
                                       act).evaluate()
    tq_c = QuantizedSpatialConvolution.from_float(tc, act).eval()
    for key in ("weight_q", "w_scale", "bias"):
        _eq(getattr(tq_c, key).numpy(), jq_c._qparams[key])
    x = _x(3, 2, 3, 11, 11)
    with torch.no_grad():
        _eq(tq_c(torch.from_numpy(x)).numpy(), jq_c.forward(jnp.asarray(x)))
        _eq(tq_c(torch.from_numpy(x[0])).numpy(),     # 3-D input
            jq_c.forward(jnp.asarray(x[0])))


def test_dilated_quantized_conv_runs_float_on_dequantized_weight():
    tc = nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 2, 2)
    q = QuantizedSpatialConvolution.from_float(tc).eval()
    q.dilation_w = q.dilation_h = 2
    x = torch.from_numpy(_x(4, 1, 3, 9, 9))
    w = q.weight_q.float() * q.w_scale.reshape(-1, 1, 1, 1)
    want = torch.nn.functional.conv2d(x, w, None, 1, 2, 2) \
        + q.bias.reshape(1, -1, 1, 1)
    with torch.no_grad():
        torch.testing.assert_close(q(x), want, rtol=0, atol=0)


def test_quantized_layers_are_inference_only():
    q = QuantizedLinear.from_float(nn.Linear(4, 2)).train()
    with pytest.raises(RuntimeError, match="inference-only"):
        q(torch.zeros(1, 4))


# ----------------------------------------------- calibration and gate

def _mlp_pair(seed=5):
    jm = _jax_init(jnn.Sequential().add(jnn.Linear(8, 32)).add(jnn.ReLU())
                   .add(jnn.Linear(32, 4)), seed)
    tm = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))
    load_jax_params(tm, jm.get_parameters())
    return jm, tm.eval()


def _calib(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((16, 8)) * scale).astype(np.float32)
            for _ in range(2)]


def test_calibration_scales_equal_jax():
    jm, tm = _mlp_pair()
    calib = _calib(1)
    want = jax_collect(jm, calib)
    got = collect_activation_scales(tm, calib)
    jl = [jm.modules[0], jm.modules[2]]
    tl = [tm[0], tm[2]]
    assert got[id(tl[0])] == want[id(jl[0])]          # fed the raw input
    np.testing.assert_allclose(got[id(tl[1])], want[id(jl[1])],
                               rtol=DEEP_SCALE_RTOL)
    assert tm.training is False and not tm[0]._forward_pre_hooks


def test_calibration_restores_modes_and_hooks_on_error():
    _, tm = _mlp_pair()
    tm.train()
    with pytest.raises(RuntimeError):
        collect_activation_scales(tm, [np.zeros((2, 5), np.float32)])
    assert tm.training and all(not m._forward_pre_hooks
                               for m in tm.modules())
    with pytest.raises(ValueError, match="at least one batch"):
        collect_activation_scales(tm, [])
    with pytest.raises(ValueError, match="no quantizable"):
        collect_activation_scales(nn.Sequential(nn.ReLU()), [np.zeros(3)])


def test_quantize_returns_a_new_tree_and_leaves_the_float_model():
    _, tm = _mlp_pair()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    scales = collect_activation_scales(tm, _calib(2))
    qm = quantize(tm, scales)
    assert isinstance(qm[0], QuantizedLinear) and isinstance(tm[0],
                                                             nn.Linear)
    assert qm[0].act_scale.item() == scales[id(tm[0])]
    assert not qm.training
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k])
    qlin = quantize(nn.Linear(3, 2))
    assert isinstance(qlin, QuantizedLinear) and qlin.act_scale is None


def test_gate_delta_equals_jax():
    jm, tm = _mlp_pair(seed=9)
    calib = _calib(3)
    rows = _calib(4, scale=3.0)[0].repeat(4, axis=0) \
        + _x(5, 64, 8)
    jq_m = jax_quantize(jm, act_scales=jax_collect(jm, calib))
    tq_m = quantize(tm, collect_activation_scales(tm, calib))
    for targets in (None, np.random.default_rng(6).integers(1, 5, 64)):
        want = JaxGate(rows, targets, batch_size=24).evaluate(jm, jq_m)
        got = AccuracyGate(rows, targets, batch_size=24).evaluate(tm, tq_m)
        assert got == want


def test_gate_refuses_above_the_bound():
    _, tm = _mlp_pair()
    bad = quantize(tm, collect_activation_scales(tm, _calib(7, 1e-4)))
    rows = _x(8, 64, 8, scale=50.0)
    gate = AccuracyGate(rows, max_delta=0.02)
    with pytest.raises(AccuracyGateError, match="exceeds the gate"):
        gate.check(tm, bad, label="mlp")
    from bigdl_tpu_torch import telemetry
    assert telemetry.gauge("serving/precision/accuracy_delta") \
        .value(model="mlp") > 0.02


# --------------------------------------------------- quantized network

def _jax_tree(skeleton, flat, prefix=""):
    if isinstance(skeleton, dict):
        return {k: _jax_tree(v, flat, f"{prefix}{k}.")
                for k, v in skeleton.items()}
    return jnp.asarray(flat[prefix[:-1]])


def test_quantized_cifar_resnet20_logits():
    """The port's seeded weights carried into the JAX model (JAX's eager
    init of a ResNet takes seconds of op-by-op compiles on the CPU)."""
    tm = ResNet(10, depth=20, dataset="CIFAR10", device="cpu",
                generator=torch.Generator().manual_seed(21)).eval()
    jm = JaxResNet(10, depth=20, dataset="CIFAR10")
    skeleton = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jm.set_parameters(_jax_tree(skeleton,
                                flatten_params(export_params(tm))))
    jm.set_state(jm.initial_state())
    jm.evaluate()
    r = np.random.default_rng(22)
    calib = [r.random((8, 3, 32, 32), dtype=np.float32) for _ in range(2)]
    x = r.random((6, 3, 32, 32), dtype=np.float32)
    jq_m = jax_quantize(jm, act_scales=jax_collect(jm, calib))
    tq_m = quantize(tm, collect_activation_scales(tm, calib))
    want = np.asarray(jq_m.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = tq_m(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_RTOL * scale)
    assert (got.argmax(1) == want.argmax(1)).all()
    # int8 on and off: the same outputs, bitwise
    with kernels.use(kernels.KernelConfig.off()), torch.no_grad():
        off = tq_m(torch.from_numpy(x)).numpy()
    _eq(got, off)
    n_q = sum(isinstance(m, (QuantizedLinear, QuantizedSpatialConvolution))
              for m in tq_m.modules())
    assert n_q == 22      # 19 convs, 2 shortcut convs, the classifier
