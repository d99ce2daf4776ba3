"""The classic image zoo of the port against the JAX package: VGG,
Inception v1 / v2, AlexNet and the autoencoder, the layers they brought
(the two LRNs, MSE and BCE, Xavier and the other initializers, negative
convolution padding), and the containers' generator hand-off.

Weights are carried from the port to the JAX package with
``set_parameters`` (the JAX package's eager initialization of the
full-size models would cost more than the forward), so both run the
same numbers on the same seeded input.

Tolerances: the full-size evaluation forwards within 1e-5 absolute on
the log-probabilities (measured 2.4e-7); outputs and gradients of the
narrow blocks, the autoencoder, the LRNs and the cropping convolution
within 1e-5 absolute (plus 1e-5 relative for the Inception blocks' BN
gradients; float32, the JAX package's float32 contract);
``VggForCifar10`` with BN in training mode: each package's float32 run
against the exact float64 one (the precedent of
``test_torch_resnet_train.py``; limits at the test); the criterions
within 1e-6 relative (and 1e-6 absolute on gradients); the quantized
convolution bitwise (integer products are exact); initializers exactly
(``BilinearFiller``, ``ConstInitMethod``) or by their bounds and
moments; the generator hand-off and the windowed run bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import bigdl_tpu.nn as jnn
from bigdl_tpu import models as jmodels
from bigdl_tpu.models.inception import Inception_Layer_v1 as JaxLayerV1
from bigdl_tpu.models.inception import Inception_Layer_v2 as JaxLayerV2
from bigdl_tpu.nn import initialization as jinit
from bigdl_tpu.nn.quantized import \
    QuantizedSpatialConvolution as JaxQuantizedConv
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import models, nn, optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.inception import (Inception_Layer_v1,
                                              Inception_Layer_v2)
from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.dropout import keep_mask
from bigdl_tpu_torch.nn.quantized import QuantizedSpatialConvolution
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_parity, flat, jax_eval, to_jax

FORWARD_ATOL = 1e-5
ATOL = 1e-5
RTOL = 1e-5
VGG_OUT_ATOL, VGG_GRAD_RTOL = 2e-4, 5e-3
CRIT_RTOL, CRIT_GRAD_ATOL = 1e-6, 1e-6

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops on one intra-op thread: beside the other test workers,
    a thread team's barriers wait on descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: model -> input side (the JAX tool's sizes: AlexNet takes 227 x 227)
FULL_SIZE = {"Vgg_16": 224, "Vgg_19": 224, "Inception_v1": 224,
             "Inception_v2": 224, "AlexNet": 227, "AlexNet_OWT": 224}


def _x(seed, *shape, dtype=np.float32):
    return np.random.RandomState(seed).standard_normal(shape).astype(dtype)


def _port(name, *args, seed=1, **kw):
    return getattr(models, name)(*args, device="cpu",
                                 generator=torch.Generator().manual_seed(
                                     seed), **kw)


def _carried(port, ref):
    """``ref`` (a JAX module) holding ``port``'s parameters and state."""
    ref.set_parameters(to_jax(port.get_parameters()))
    state = port.get_state()
    if jax.tree_util.tree_leaves(state):
        ref.set_state(to_jax(state))
    return ref


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_full_size_forward_matches_jax(name):
    """Evaluation forward at the model's full input size, batch 1,
    class_num 10: the same log-probabilities as the JAX model with the
    same weights, and the same names where the JAX package sets them."""
    port = _port(name, 10).eval()
    ref = _carried(port, getattr(jmodels, name)(10))
    side = FULL_SIZE[name]
    x = np.random.RandomState(2).rand(1, 3, side, side).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = jax_eval(ref, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)
    for layer in ("conv1", "conv1/7x7_s2", "inception_3a/1x1",
                  "inception_4e/output", "loss1/fc", "loss3/classifier",
                  "norm2", "fc6", "split1"):
        j = ref.find(layer)
        p = port.find(layer)
        assert (j is None) == (p is None), layer
        if p is not None:
            assert type(p).__name__ == type(j).__name__


def _vgg_cifar_port(params, dtype, x, w):
    """The port's ``VggForCifar10`` (no dropout, BN in training mode) in
    ``dtype``: its output and parameter gradients of ``sum(out * w)``."""
    m = models.VggForCifar10(10, has_dropout=False, device="cpu")
    m.set_parameters(params)
    m = m.to(dtype).train()
    out = m(torch.from_numpy(x).to(dtype))
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    return (out.detach().double().numpy(),
            {k: v.astype(np.float64)
             for k, v in flat(m.get_grad_parameters()).items()})


def test_vgg_for_cifar10_trains_as_the_jax_package():
    """``VggForCifar10`` without dropout at 32 x 32, batch 2, BN in
    training mode. BN over 2 rows normalizes the last features to +-1
    and cancels every conv bias (whose gradient is 0 exactly), so
    float32's rounding is the gradients' own error here: as in
    ``test_cifar_recipe_matches_jax``, the port's and the JAX package's
    float32 outputs and gradients are each held to the exact (float64)
    ones, outputs within ``VGG_OUT_ATOL``, gradients within
    ``VGG_GRAD_RTOL`` of each leaf's largest exact element (floored at
    1e-3 of the largest gradient overall; measured 6.2e-4 to 2.7e-3
    port, as the CPU's thread count orders float32 sums, 2.0e-3 JAX)."""
    params = _port("VggForCifar10", 10, has_dropout=False).get_parameters()
    x = _x(3, 2, 3, 32, 32)
    w = _x(19, 2, 10)
    exact_out, exact = _vgg_cifar_port(params, torch.float64, x, w)
    port_out, port_g = _vgg_cifar_port(params, torch.float32, x, w)
    ref = jmodels.VggForCifar10(10, has_dropout=False)
    ref.set_parameters(to_jax(params))
    state = ref.get_state()

    @jax.jit
    def out_and_grads(p, a, weights):
        out, vjp = jax.vjp(
            lambda q: ref.apply(q, state, a, training=True)[0], p)
        return out, vjp(weights)[0]

    out, grads = out_and_grads(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x), jnp.asarray(w))
    jax_out = np.asarray(out, np.float64)
    jax_g = {k: np.asarray(v, np.float64) for k, v in flat(grads).items()}
    assert sorted(jax_g) == sorted(exact) == sorted(port_g)
    overall = max(np.abs(v).max() for v in exact.values())
    for out in (port_out, jax_out):
        np.testing.assert_allclose(out, exact_out, rtol=0,
                                   atol=VGG_OUT_ATOL)
    for grads in (port_g, jax_g):
        for k, want in exact.items():
            scale = max(np.abs(want).max(), 1e-3 * overall)
            assert np.abs(grads[k] - want).max() <= VGG_GRAD_RTOL * scale, k


def _inception_block(kind, jax_side=False):
    """One Inception block at narrow widths: the port's, its weights from
    a generator seeded as ``_port`` seeds, or (``jax_side``) the JAX
    package's of the same configuration."""
    if kind == "v1":
        if jax_side:
            return JaxLayerV1(8, JT(JT(4), JT(4, 6), JT(2, 3), JT(3)),
                              "inception_3a/")
        return Inception_Layer_v1(8, T(T(4), T(4, 6), T(2, 3), T(3)),
                                  "inception_3a/",
                                  generator=torch.Generator().manual_seed(1))
    pool = {"v2_avg": ("avg", 3), "v2_reduce": ("max", 0),
            "v2_max": ("max", 3)}[kind]
    first = 0 if kind == "v2_reduce" else 4
    if jax_side:
        return JaxLayerV2(8, JT(JT(first), JT(4, 6), JT(2, 3), JT(*pool)),
                          "inception_3c/")
    return Inception_Layer_v2(8, T(T(first), T(4, 6), T(2, 3), T(*pool)),
                              "inception_3c/",
                              generator=torch.Generator().manual_seed(1))


def _inception_port_run(kind, dtype, x, w, training):
    """The port's block in ``dtype``: its output, the gradients of
    ``sum(out * w)`` with respect to the input and every parameter, and
    ``w`` (None: seeded normal of the output's shape)."""
    m = _inception_block(kind).to(dtype).train(training)
    xin = torch.from_numpy(x).to(dtype).requires_grad_()
    out = m(xin)
    if w is None:
        w = _x(5, *out.shape)
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    grads = {k: v.astype(np.float64)
             for k, v in flat(m.get_grad_parameters()).items()}
    grads["input"] = xin.grad.double().numpy()
    return out.detach().double().numpy(), grads, w


@pytest.mark.parametrize("kind", ["v1", "v2_avg", "v2_reduce", "v2_max"])
def test_inception_layers_match_jax(kind):
    """One Inception block at narrow widths (BN in training mode for
    v2), its weights seeded as ``_port`` seeds them: the port's and the
    JAX package's float32 outputs and gradients (input and parameters of
    ``sum(out * w)``) are each held to the port's float64 run within
    ``ATOL`` + ``RTOL`` of the float64 value, as
    ``test_vgg_for_cifar10_trains_as_the_jax_package`` holds VGG: at 2
    rows, BN's batch statistics make float32's own rounding as large as
    the gap between the two float32 runs, which a direct port-against-
    JAX bound at the same limit would count twice. The JAX package's
    names too."""
    training = kind != "v1"
    port = _inception_block(kind)
    ref = _carried(port, _inception_block(kind, jax_side=True))
    # 8 x 8: the grid reduction's conv and pool give 4 x 4 alike
    x = _x(4, 2, 8, 8, 8)
    exact_out, exact, w = _inception_port_run(kind, torch.float64, x, None,
                                              training)
    port_out, port_g, _ = _inception_port_run(kind, torch.float32, x, w,
                                              training)
    state = ref.get_state()

    @jax.jit
    def out_and_grads(p, a, weights):
        out, vjp = jax.vjp(lambda q, b: ref.apply(
            q, state, b, training=training)[0], p, a)
        return out, vjp(weights)

    out, (g_p, g_x) = out_and_grads(
        jax.tree.map(jnp.asarray, ref.get_parameters()), jnp.asarray(x),
        jnp.asarray(w))
    jax_g = {k: np.asarray(v, np.float64) for k, v in flat(g_p).items()}
    jax_g["input"] = np.asarray(g_x, np.float64)
    assert sorted(jax_g) == sorted(exact) == sorted(port_g)
    for side, (got, grads) in (("port", (port_out, port_g)),
                               ("jax", (np.asarray(out, np.float64),
                                        jax_g))):
        np.testing.assert_allclose(got, exact_out, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{side} output")
        for k, want in exact.items():
            np.testing.assert_allclose(grads[k], want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{side} grad {k}")
    assert port.get_name() == ref.get_name()


def test_autoencoder_matches_jax():
    port = _port("Autoencoder", 32)
    ref = _carried(port, jmodels.Autoencoder(32))
    assert_parity(ref, port, _x(5, 4, 1, 28, 28), atol=ATOL, jit=True)


# ------------------------------------------------------------- the layers

@pytest.mark.parametrize("cls", ["SpatialCrossMapLRN",
                                 "SpatialWithinChannelLRN"])
@pytest.mark.parametrize("size", [3, 4, 5])
def test_lrn_matches_jax(cls, size):
    """Both LRNs, outputs and input gradients, at odd and even window
    sizes; for the cross-map LRN at the even size the JAX package's
    window is not ``F.local_response_norm``'s."""
    port = getattr(nn, cls)(size, 0.5, 0.75)
    ref = getattr(jnn, cls)(size, 0.5, 0.75)
    x = _x(6, 2, 7, 5, 6)
    assert_parity(ref, port, x, atol=ATOL)
    if cls == "SpatialCrossMapLRN":
        library = F.local_response_norm(torch.from_numpy(x), size, 0.5,
                                        0.75, 1.0).numpy()
        gap = np.abs(library - np.asarray(ref.forward(x))).max()
        assert (gap > 1e-3) == (size % 2 == 0), gap


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("crit", ["MSE", "BCE", "BCE_weighted"])
def test_criterions_match_jax(crit, size_average):
    r = np.random.RandomState(7)
    weights = None
    if crit == "MSE":
        x = r.standard_normal((4, 6)).astype(np.float32)
        t = r.standard_normal((4, 6)).astype(np.float32)
        port, ref = (nn.MSECriterion(size_average),
                     jnn.MSECriterion(size_average))
    else:
        x = r.uniform(0.01, 0.99, (4, 6)).astype(np.float32)
        t = (r.rand(4, 6) > 0.5).astype(np.float32)
        if crit == "BCE_weighted":
            weights = r.uniform(0.5, 2.0, 6).astype(np.float32)
        port = nn.BCECriterion(weights, size_average)
        ref = jnn.BCECriterion(weights, size_average)
    xt = torch.from_numpy(x).requires_grad_()
    loss = port(xt, torch.from_numpy(t))
    loss.backward()
    want = float(ref.apply(jnp.asarray(x), jnp.asarray(t)))
    grad = jax.grad(lambda a: ref.apply(a, jnp.asarray(t)))(jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=CRIT_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad),
                               rtol=CRIT_RTOL, atol=CRIT_GRAD_ATOL)
    np.testing.assert_allclose(
        port.backward(torch.from_numpy(x), t).numpy(), np.asarray(grad),
        rtol=CRIT_RTOL, atol=CRIT_GRAD_ATOL)


def test_bce_clamps_a_certain_prediction_as_the_jax_package():
    """A probability of exactly 0 or 1: the clamp at 1e-12 (1 - 1e-12
    rounds to 1 in float32) gives the JAX package's loss, inf
    included."""
    x = np.array([[0.0, 1.0, 0.5]], np.float32)
    t = np.array([[0.0, 0.0, 1.0]], np.float32)
    got = float(nn.BCECriterion()(torch.from_numpy(x), torch.from_numpy(t)))
    want = float(jnn.BCECriterion().apply(jnp.asarray(x), jnp.asarray(t)))
    assert got == want


def test_initializers():
    """Xavier draws inside Glorot's bound and fills it; RandomNormal's
    moments; ConstInitMethod and BilinearFiller equal the JAX
    package's."""
    shape, fan_in, fan_out = (64, 32, 3, 3), 32 * 9, 64 * 9
    bound = np.sqrt(6.0 / (fan_in + fan_out))
    w = init.Xavier()(shape, fan_in, fan_out,
                      torch.Generator().manual_seed(8)).numpy()
    j = np.asarray(jinit.Xavier()(jax.random.PRNGKey(8), shape, fan_in,
                                  fan_out))
    for a in (w, j):
        assert np.abs(a).max() <= bound
        assert np.abs(a).max() > 0.99 * bound
        assert abs(a.mean()) < 0.01 * bound
        assert abs(a.std() - bound / np.sqrt(3)) < 0.01 * bound
    n = init.RandomNormal(0.5, 2.0)((200, 100), 1, 1,
                                    torch.Generator().manual_seed(9))
    assert abs(float(n.mean()) - 0.5) < 0.05
    assert abs(float(n.std()) - 2.0) < 0.05
    np.testing.assert_array_equal(
        init.ConstInitMethod(0.25)((3, 4), 1, 1).numpy(),
        np.asarray(jinit.ConstInitMethod(0.25)(None, (3, 4), 1, 1)))
    for shape in ((2, 3, 4, 4), (1, 1, 3, 5), (2, 2, 5, 3)):
        np.testing.assert_array_equal(
            init.BilinearFiller()(shape, 1, 1).numpy(),
            np.asarray(jinit.BilinearFiller()(None, shape, 1, 1)))
    with pytest.raises(ValueError, match="4-D"):
        init.BilinearFiller()((3, 3), 1, 1)


@pytest.mark.parametrize("pads,group", [((-1, -1), 1), ((-2, 1), 1),
                                        ((2, -1), 2), ((0, -3), 1)])
def test_negative_padding_crops_as_the_jax_package(pads, group):
    """A negative pad crops the input (``lax.conv_general_dilated``):
    the float layer's outputs and gradients, and the int8 layer
    bitwise (calibrated and dynamic)."""
    pad_w, pad_h = pads
    port = nn.SpatialConvolution(4, 6, 3, 3, 1, 2, pad_w, pad_h, group,
                                 generator=torch.Generator().manual_seed(10))
    ref = jnn.SpatialConvolution(4, 6, 3, 3, 1, 2, pad_w, pad_h, group)
    ref.set_parameters(to_jax(port.get_parameters()))
    x = _x(11, 2, 4, 11, 12)
    out = assert_parity(ref, port, x, atol=ATOL)
    assert out.shape[2:] == ((11 + 2 * pad_h - 3) // 2 + 1,
                             12 + 2 * pad_w - 2)
    if group != 1:
        return
    for act in (None, 0.05):
        q = QuantizedSpatialConvolution.from_float(port, act).eval()
        jq = JaxQuantizedConv.from_float(ref, ref.get_parameters(),
                                         act).evaluate()
        with torch.no_grad():
            got = q(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jq.forward(
            jnp.asarray(x))))


# ------------------------------------------- the containers' generator

def _mlp_with_dropouts():
    """A Sequential whose Dropouts sit at two depths: one a direct
    child, one inside a Concat inside a Sequential."""
    g = torch.Generator().manual_seed(12)
    inner = nn.Sequential(nn.Linear(6, 4, generator=g), nn.Dropout(0.5))
    concat = nn.Concat(2, inner, nn.Linear(6, 3, generator=g))
    return nn.Sequential(nn.Linear(5, 6, generator=g), nn.Dropout(0.3),
                         concat, nn.Linear(7, 3, generator=g),
                         nn.LogSoftMax())


def test_containers_hand_their_generator_to_each_child_in_order():
    """The two Dropouts draw from the one generator, the direct child
    first: the forward equals the same layers applied by hand with
    masks drawn from a twin generator in that order; without a
    generator the Dropout in training mode raises, as alone."""
    model = _mlp_with_dropouts().train()
    x = torch.from_numpy(_x(13, 8, 5))
    got = model(x, generator=torch.Generator().manual_seed(14))
    twin = torch.Generator().manual_seed(14)
    lin0, _, concat, lin3, _ = list(model.children())
    h = lin0(x)
    h = torch.where(keep_mask(h.shape, 0.3, twin), h, 0.0) / 0.7
    inner_lin = concat[0][0]
    a = inner_lin(h)
    a = torch.where(keep_mask(a.shape, 0.5, twin), a, 0.0) / 0.5
    want = torch.log_softmax(lin3(torch.cat([a, concat[1](h)], 1)), -1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="requires a generator"):
        model(x)
    tables = nn.ConcatTable(nn.Dropout(0.5), nn.Dropout(0.5))
    a, b = tables(x, generator=torch.Generator().manual_seed(15))
    assert not torch.equal(a, b)


def _train(k, seed, steps=16):
    RandomGenerator.set_seed(seed)
    model = _mlp_with_dropouts()
    r = np.random.RandomState(16)
    xs = r.standard_normal((steps * 4, 5)).astype(np.float32)
    ys = r.randint(1, 4, steps * 4).astype(np.float32)
    ds = DataSet.array([Sample(xs[i], ys[i]) for i in range(len(xs))]) \
        .transform(SampleToMiniBatch(4))
    opt = optim.LocalOptimizer(model, ds, nn.ClassNLLCriterion(),
                               batch_size=4)
    opt.set_optim_method(optim.SGD(learning_rate=0.1))
    opt.set_end_when(optim.max_iteration(steps))
    if k > 1:
        opt.set_steps_per_sync(k)
    opt.optimize()
    return [h["loss"] for h in opt.history], model


def test_dropout_in_containers_trains_per_step_and_windowed():
    """``build_train_step`` finds ``generator=`` on the top Sequential
    and hands it the step's generator: a K = 8 window and the per-step
    loop give the same losses and parameters, bitwise; another seed
    other losses."""
    step = optim.build_train_step(_mlp_with_dropouts(),
                                  nn.ClassNLLCriterion(),
                                  optim.SGD(learning_rate=0.1))
    assert isinstance(step.generator, torch.Generator)
    l1, m1 = _train(1, 17)
    l8, m8 = _train(8, 17)
    assert len(l1) == 16 and l1 == l8
    for (name, a), (_, b) in zip(m1.named_parameters(),
                                 m8.named_parameters()):
        assert torch.equal(a, b), name
    l_other, _ = _train(1, 18)
    assert l_other != l1
