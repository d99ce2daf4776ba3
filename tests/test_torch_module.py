"""The port's Module contract against the JAX package's
(``bigdl_tpu.nn.module``): Table, argument capture, names, gradient
scales, freezing and regularizers in a train step, the parameter and
gradient trees, eager backward, every activation, Reshape, the
classification criterions, the validation methods and the score / loss
triggers.

Tolerances: 1e-6 absolute on float32 values and gradients of the
criterions, the train step and the layers, plus 1e-6 relative for the
activations (``Exp`` and ``Power`` reach values where one float32 step
exceeds 1e-6); the two packages run the same float32 operations,
reduced in other orders. Counts and accuracies exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.nn.activation as jact
import bigdl_tpu.optim as joptim
from bigdl_tpu.optim.optimizer import build_train_step as jax_build_step
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu.utils.table import T as JaxT
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.nn import activation as act
from bigdl_tpu_torch.nn.module import Module, total_regularization
from bigdl_tpu_torch.optim import build_train_step
from bigdl_tpu_torch.utils.table import T, Table

from _torch_parity import (assert_parity, assert_trees_close, flat, to_jax,
                           to_numpy, to_torch)

ATOL = 1e-6


def _jax_init(module, seed):
    JaxRandomGenerator.set_seed(seed)
    module.ensure_initialized()
    return module


# ------------------------------------------------------------ Table

def test_table_matches_jax():
    got, want = T(1.0, "b", x=3), JaxT(1.0, "b", x=3)
    assert got.to_dict() == want.to_dict()
    for t in (got, want):
        t.insert(7)
        t[9] = "gap"
    assert got.to_dict() == want.to_dict()
    assert got.length() == want.length() == 3
    assert list(got) == list(want) == [1.0, "b", 7]
    assert got.remove(1) == want.remove(1) == 1.0
    assert got.to_list() == want.to_list() == ["b", 7]
    assert got.to_dict() == want.to_dict()
    assert got == T("b", 7, x=3, **{}).update({9: "gap"})
    assert got != T("b")
    assert "x" in got and got.get("y", 4) == 4
    assert repr(T(1)) == repr(JaxT(1))


def test_table_trees_round_trip_through_the_harness():
    r = np.random.RandomState(0)
    tree = {"a": JaxT(r.rand(2, 3).astype(np.float32),
                      k=[r.rand(4).astype(np.float32)]),
            "b": (r.rand(1).astype(np.float32),)}
    port = to_torch(tree)
    assert isinstance(port["a"], Table)
    assert isinstance(port["a"][1], torch.Tensor)
    back = to_numpy(port)
    np.testing.assert_array_equal(back["a"][1], tree["a"][1])
    np.testing.assert_array_equal(back["a"]["k"][0], tree["a"]["k"][0])
    np.testing.assert_array_equal(back["b"][0], tree["b"][0])
    again = to_jax(back)
    np.testing.assert_array_equal(np.asarray(again["a"][1]), tree["a"][1])


# ------------------------------------------------------------ the contract

class _Wide(nn.Linear):
    def __init__(self, n, scale=2):
        super().__init__(n, n * scale, with_bias=False)


class _JaxWide(jnn.Linear):
    def __init__(self, n, scale=2):
        super().__init__(n, n * scale, with_bias=False)


@pytest.mark.parametrize("build", [
    lambda m: m.Linear(4, 3, with_bias=False),
    lambda m: m.SpatialConvolution(3, 8, 3, 3, 2, 2, pad_w=1),
    lambda m: m.Clamp(-0.5, 0.5),
    lambda m: m.Reshape((2, 6), batch_mode=True),
    lambda m: m.Sequential(),
])
def test_constructor_arguments_are_captured_as_in_jax(build):
    got, want = build(nn), build(jnn)
    assert got._init_args == want._init_args
    assert got._init_kwargs == want._init_kwargs


def test_capture_takes_the_outermost_call_of_a_subclass():
    got, want = _Wide(3, scale=4), _JaxWide(3, scale=4)
    assert got._init_args == want._init_args == (3,)
    assert got._init_kwargs == want._init_kwargs == {"scale": 4}
    # a captured Module or Generator is an attribute, not a submodule
    inner = nn.Linear(2, 2)
    seq = nn.Sequential(inner)
    assert seq._init_args == (inner,)
    assert list(dict(seq.named_modules())) == ["", "0"]
    g = torch.Generator().manual_seed(0)
    lin = nn.Linear(2, 2, generator=g)
    assert lin._init_kwargs["generator"] is g
    # the port's criterions are Modules too (the JAX package's are not)
    assert nn.ClassNLLCriterion(size_average=False)._init_kwargs == {
        "size_average": False}


def test_set_name_and_get_name_match_jax():
    for mod in (nn, jnn):
        named = mod.Linear(2, 3).set_name("fc1")
        assert named.get_name() == "fc1"
        assert mod.Tanh().get_name().startswith("Tanh")
    seq = nn.Sequential(nn.Linear(2, 2), nn.Sequential(
        nn.Tanh().set_name("act")))
    assert seq.find("act") is seq[1][0]
    assert seq.find("missing") is None


def test_modes_scales_and_freeze():
    m = nn.Sequential(nn.Linear(3, 4), nn.Tanh(), nn.Linear(4, 2))
    assert m.is_training()
    assert m.evaluate() is m and not m.is_training() \
        and not m[0].is_training()
    m.train()
    m[0].set_scale_w(0.5).set_scale_b(0.25)
    m[2].freeze()
    assert m.param_scales() == {"0.weight": 0.5, "0.bias": 0.25,
                                "2.weight": 0.0, "2.bias": 0.0}
    m.unfreeze()
    assert set(m.param_scales().values()) == {1.0}
    assert isinstance(m, Module) and isinstance(m[0], Module)


@pytest.mark.parametrize("args,shape", [
    ((7, 5), (4, 7)), ((7, 5), (7,)), ((6, 3, False), (2, 6))])
def test_linear_through_the_parity_harness(args, shape):
    x = np.random.RandomState(1).standard_normal(shape).astype(np.float32)
    assert_parity(_jax_init(jnn.Linear(*args), 2), nn.Linear(*args), x,
                  atol=ATOL)


@pytest.mark.parametrize("args,kw,shape", [
    ((3, 4, 3, 3), {}, (2, 3, 9, 9)),
    ((4, 6, 3, 2, 2, 1, 1, 0), {"n_group": 2}, (1, 4, 7, 8)),
    ((2, 3, 5, 5), {"with_bias": False}, (2, 11, 11)),
])
def test_spatial_convolution_through_the_parity_harness(args, kw, shape):
    x = np.random.RandomState(3).standard_normal(shape).astype(np.float32)
    assert_parity(_jax_init(jnn.SpatialConvolution(*args, **kw), 4),
                  nn.SpatialConvolution(*args, **kw), x, atol=1e-5)


def test_parameter_trees_and_eager_backward_match_jax():
    x = np.random.RandomState(5).standard_normal((3, 6)).astype(np.float32)
    g = np.random.RandomState(6).standard_normal((3, 2)).astype(np.float32)
    ref = _jax_init(jnn.Sequential().add(jnn.Linear(6, 5)).add(jnn.Tanh())
                    .add(jnn.Linear(5, 2)), 7)
    port = nn.Sequential(nn.Linear(6, 5), nn.Tanh(), nn.Linear(5, 2))
    assert port.get_grad_parameters() is None
    port.set_parameters(jax.tree.map(np.asarray, ref.get_parameters()))
    assert_trees_close(port.get_parameters(), ref.get_parameters(), 0.0)
    for _ in range(2):          # gradients accumulate, as in JAX
        want_gx = ref.backward(jnp.asarray(x), jnp.asarray(g))
        got_gx = port.backward(x, g)
        np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx),
                                   atol=ATOL, rtol=0)
    assert_trees_close(port.get_grad_parameters(),
                       ref.get_grad_parameters(), ATOL)
    port.zero_grad_parameters()
    assert port.get_grad_parameters() is None


def test_criterion_backward_matches_jax():
    r = np.random.RandomState(8)
    x = r.standard_normal((4, 5)).astype(np.float32)
    t = np.array([1, 5, 2, 3], np.float32)
    want = jnn.CrossEntropyCriterion().backward(jnp.asarray(x),
                                                jnp.asarray(t))
    got = nn.CrossEntropyCriterion().backward(x, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cls,kw", [
    ("L1L2Regularizer", dict(l1=0.01, l2=0.02)),
    ("L1Regularizer", dict(l1=0.3)),
    ("L2Regularizer", dict(l2=0.7))])
def test_regularizers_match_jax(cls, kw):
    w = np.random.RandomState(9).standard_normal((5, 4)).astype(np.float32)
    want = float(getattr(joptim, cls)(**kw).loss(jnp.asarray(w)))
    got = float(getattr(optim, cls)(**kw).loss(torch.from_numpy(w)))
    assert abs(got - want) <= ATOL * max(1.0, abs(want))


def _contract_model(mod, reg):
    return (mod.Sequential()
            .add(mod.Linear(8, 16, w_regularizer=reg.L1L2Regularizer(
                0.01, 0.02), b_regularizer=reg.L2Regularizer(0.05))
                 .set_scale_w(0.5))
            .add(mod.Tanh())
            .add(mod.Linear(16, 16).freeze())
            .add(mod.Tanh())
            .add(mod.Linear(16, 4).set_scale_b(2.0))
            .add(mod.LogSoftMax()))


def test_train_step_honours_scales_freeze_and_regularizers():
    """Two SGD steps with momentum through a Linear with an L1L2 weight
    and an L2 bias regularizer at ``scale_w`` 0.5, a frozen Linear and a
    Linear at ``scale_b`` 2: losses and parameters within 1e-6 of the
    JAX package's ``build_train_step``; the frozen layer unchanged
    bitwise."""
    r = np.random.RandomState(10)
    batches = [(r.standard_normal((6, 8)).astype(np.float32),
                r.randint(1, 5, 6).astype(np.float32)) for _ in range(2)]
    ref = _jax_init(_contract_model(jnn, joptim), 11)
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = _contract_model(nn, optim).set_parameters(params)
    want_reg = float(jnn.module.total_regularization(
        ref, jax.tree.map(jnp.asarray, params)))
    assert abs(float(total_regularization(port).detach()) - want_reg) \
        <= ATOL
    kw = dict(learning_rate=0.1, momentum=0.9)
    j_sgd, p_sgd = joptim.SGD(**kw), optim.SGD(**kw)
    j_step = jax_build_step(ref, jnn.ClassNLLCriterion(), j_sgd)
    p_step = build_train_step(port, nn.ClassNLLCriterion(), p_sgd)
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt, m_state = j_sgd.init_state(j_params), ref.get_state()
    frozen = port[2].weight.detach().clone()
    for x, y in batches:
        lr = j_sgd.update_hyper_parameter()
        assert lr == p_sgd.update_hyper_parameter()
        j_params, j_opt, m_state, j_loss = j_step(
            j_params, j_opt, m_state, jax.random.PRNGKey(0), lr,
            jnp.asarray(x), jnp.asarray(y))
        p_loss = p_step(torch.from_numpy(x), torch.from_numpy(y), lr)
        assert abs(float(p_loss) - float(j_loss)) <= ATOL
    assert_trees_close(port.get_parameters(), j_params, ATOL)
    assert torch.equal(port[2].weight, frozen)
    assert not np.allclose(port.get_parameters()["0"]["weight"],
                           params["0"]["weight"])


def test_optimizer_gradient_clipping_setters():
    opt = optim.LocalOptimizer(nn.Linear(2, 2), None, nn.ClassNLLCriterion())
    assert opt.set_constant_gradient_clipping(-1, 2) is opt
    assert opt._gradient_clip == ("constant", -1.0, 2.0)
    assert opt.set_gradient_clipping_by_l2_norm(3)._gradient_clip == (
        "l2norm", 3.0)
    assert opt.disable_gradient_clipping()._gradient_clip is None
    with pytest.raises(ValueError):
        opt.set_constant_gradient_clipping(1, 0)


# ------------------------------------------------------------ activations

def _normal(shape=(3, 4, 5), scale=2.0):
    return lambda r: (r.standard_normal(shape) * scale).astype(np.float32)


def _positive(shape=(3, 4, 5)):
    return lambda r: (np.abs(r.standard_normal(shape)) + 0.1) \
        .astype(np.float32)


#: name -> (constructor args, input maker); all 34 classes of the file
ACTIVATIONS = {
    "ReLU": ((), _normal()), "ReLU6": ((), _normal(scale=5.0)),
    "Tanh": ((), _normal()), "TanhShrink": ((), _normal()),
    "Sigmoid": ((), _normal()), "LogSigmoid": ((), _normal()),
    "SoftMax": ((), _normal()), "SoftMin": ((), _normal((6, 7))),
    "LogSoftMax": ((), _normal((6, 7))), "SoftPlus": ((2.0,), _normal()),
    "SoftSign": ((), _normal()), "ELU": ((0.7,), _normal()),
    "LeakyReLU": ((0.1,), _normal()), "PReLU": ((4,), _normal()),
    "RReLU": ((0.1, 0.3), _normal()), "SoftShrink": ((0.3,), _normal()),
    "HardShrink": ((0.3,), _normal()),
    "HardTanh": ((-0.5, 0.8), _normal()), "HardSigmoid": ((), _normal()),
    "Threshold": ((0.1, -2.0), _normal()),
    "BinaryThreshold": ((0.1,), _normal()),
    "Clamp": ((-0.3, 0.4), _normal()), "Power": ((2.5, 0.5, 0.2),
                                                  _positive()),
    "Square": ((), _normal()), "Sqrt": ((), _positive()),
    "Log": ((), _positive()), "Log1p": ((), _positive()),
    "Exp": ((), _normal()), "Abs": ((), _normal()),
    "Negative": ((), _normal()), "Identity": ((), _normal()),
    "Echo": ((), _normal()), "GradientReversal": ((0.7,), _normal()),
    # log_var -200: exp(-100) is below float32's resolution at the
    # mean, so both packages return the mean whatever their eps
    "GaussianSampler": ((), lambda r: [
        _normal((3, 4))(r), np.full((3, 4), -200.0, np.float32)]),
}


def test_the_activation_table_covers_the_jax_file():
    import inspect
    jax_classes = {n for n, c in vars(jact).items() if inspect.isclass(c)
                   and issubclass(c, jnn.Module) and c.__module__ ==
                   jact.__name__ and not n.startswith("_")}
    assert jax_classes == set(ACTIVATIONS) == set(act.__all__)
    assert len(jax_classes) == 34


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_jax(name):
    args, make = ACTIVATIONS[name]
    x = make(np.random.RandomState(12))
    ref = getattr(jact, name)(*args)
    port = getattr(act, name)(*args)
    rng = jax.random.PRNGKey(0) if name == "GaussianSampler" else None
    assert_parity(_jax_init(ref, 13), port, x, atol=ATOL, rtol=ATOL,
                  rng=rng)


def test_prelu_shared_slope_and_parameter():
    x = _normal()(np.random.RandomState(14))
    port = act.PReLU()
    assert port.get_parameters()["weight"].tolist() == [0.25]
    assert_parity(_jax_init(jact.PReLU(), 15), port, x, atol=ATOL)


def test_rrelu_training_draws_follow_the_distribution():
    """Training mode draws each negative element's slope from
    U[lower, upper): held to the distribution (and to JAX's draws'
    statistics), not to JAX's numbers."""
    lo, hi = 0.1, 0.3
    x = -np.abs(np.random.RandomState(16).standard_normal(200_000)) \
        .astype(np.float32) - 0.01
    g = torch.Generator().manual_seed(0)
    port = act.RReLU(lo, hi, generator=g).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    out.sum().backward()
    slopes = (out.detach() / xt.detach()).numpy()
    want = np.asarray(jact.RReLU(lo, hi).apply(
        {}, {}, jnp.asarray(x), training=True,
        rng=jax.random.PRNGKey(1))[0]) / x
    for s in (slopes, want):
        assert s.min() >= lo - 1e-6 and s.max() < hi + 1e-6
        assert abs(s.mean() - (lo + hi) / 2) < 2e-3
        assert abs(s.std() - (hi - lo) / np.sqrt(12)) < 2e-3
    np.testing.assert_allclose(xt.grad.numpy(), slopes, rtol=1e-5)
    pos = torch.from_numpy(np.abs(x))
    assert torch.equal(port(pos), pos)
    again = act.RReLU(lo, hi, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again(torch.from_numpy(x)), out.detach())


def test_gaussian_sampler_draws_follow_the_distribution():
    r = np.random.RandomState(17)
    mean = r.standard_normal(100_000).astype(np.float32)
    log_var = r.uniform(-1, 1, 100_000).astype(np.float32)
    port = act.GaussianSampler(generator=torch.Generator().manual_seed(0))
    got = port([torch.from_numpy(mean), torch.from_numpy(log_var)]).numpy()
    want = np.asarray(jact.GaussianSampler().apply(
        {}, {}, JaxT(jnp.asarray(mean), jnp.asarray(log_var)),
        rng=jax.random.PRNGKey(2))[0])
    for out in (got, want):
        eps = (out - mean) / np.exp(0.5 * log_var)
        assert abs(eps.mean()) < 0.02 and abs(eps.std() - 1.0) < 0.02


# ------------------------------------------------------------ Reshape

@pytest.mark.parametrize("size,batch_mode,shape", [
    ((1, 28, 28), None, (4, 784)),       # count differs: batch kept
    ((192,), None, (2, 12, 4, 4)),
    ((6, 4), None, (2, 12)),             # count matches: no batch dim
    ((3, 4), True, (2, 12)),
    ((4, 6), False, (2, 12)),
    ((2, 2, 3), None, (12,))])
def test_reshape_matches_jax(size, batch_mode, shape):
    x = np.random.RandomState(18).standard_normal(shape).astype(np.float32)
    got = assert_parity(jnn.Reshape(size, batch_mode),
                        nn.Reshape(size, batch_mode), x, atol=0.0)
    want = jnn.Reshape(size, batch_mode).forward(jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape)


# ------------------------------------------------------------ criterions

_LABELS = {"in_range": [1, 7, 3, 2, 5],
           # label 0 counts from the end (the last class); C + 1 is NaN
           "edges": [0, 7, 8, 2, 1]}


@pytest.mark.parametrize("labels", sorted(_LABELS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("name", ["ClassNLLCriterion",
                                  "CrossEntropyCriterion"])
def test_criterion_matches_jax(name, size_average, weighted, labels):
    r = np.random.RandomState(19)
    logits = (r.standard_normal((5, 7)) * 2).astype(np.float32)
    x = logits if name == "CrossEntropyCriterion" else np.array(
        jax.nn.log_softmax(logits, axis=-1))
    t = np.asarray(_LABELS[labels], np.float32)
    weights = r.uniform(0.5, 2.0, 7).astype(np.float32) if weighted else None
    ref = getattr(jnn, name)(weights, size_average)
    port = getattr(nn, name)(weights, size_average)
    want = ref.apply(jnp.asarray(x), jnp.asarray(t))
    want_g = jax.grad(lambda i: ref.apply(i, jnp.asarray(t)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, torch.from_numpy(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               atol=ATOL)
    assert np.isnan(float(got.detach())) == (labels == "edges")


def test_class_nll_takes_probabilities_and_one_row():
    r = np.random.RandomState(20)
    p = np.array(jax.nn.softmax(r.standard_normal((4, 6)), axis=-1),
                 np.float32)
    t = np.array([2, 6, 1, 3], np.float32)
    for ref, port, x, y in (
            (jnn.ClassNLLCriterion(logProbAsInput=False),
             nn.ClassNLLCriterion(logProbAsInput=False), p, t),
            (jnn.ClassNLLCriterion(), nn.ClassNLLCriterion(), np.log(p[0]),
             t[:1])):
        want = float(ref.apply(jnp.asarray(x), jnp.asarray(y)))
        got = float(port(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= ATOL


# ------------------------------------------------------------ validation

def _scores(seed, n=37, c=10):
    r = np.random.RandomState(seed)
    out = np.asarray(jax.nn.log_softmax(r.standard_normal((n, c)) * 3,
                                        axis=-1), np.float32)
    return out, r.randint(1, c + 1, n).astype(np.float32)


@pytest.mark.parametrize("name", ["Top1Accuracy", "Top5Accuracy", "Loss",
                                  "MAE"])
def test_validation_methods_match_jax(name):
    (o1, t1), (o2, t2) = _scores(21), _scores(22, n=5)
    if name == "MAE":
        t1 = np.random.RandomState(23).standard_normal(o1.shape) \
            .astype(np.float32)
        t2 = np.random.RandomState(24).standard_normal(o2.shape) \
            .astype(np.float32)
    ref, port = getattr(joptim, name)(), getattr(optim, name)()
    assert port.name == ref.name == name
    want = ref(o1, t1) + ref(o2, t2)
    got = port(o1, t1) + port(o2, t2)
    assert type(got).__name__ == type(want).__name__
    assert got.result()[1] == want.result()[1] == 42
    if name.startswith("Top"):
        assert got.correct == want.correct
        assert got.result() == want.result()
        assert repr(got) == repr(want)
    else:
        assert abs(got.result()[0] - want.result()[0]) <= 1e-6 * abs(
            want.result()[0])


def test_score_and_loss_triggers_match_jax():
    for state in ({}, {"score": 0.5}, {"score": 0.96}, {"Loss": 0.2},
                  {"Loss": 0.01, "score": 0.95}):
        assert optim.max_score(0.95)(state) == joptim.max_score(0.95)(state)
        assert optim.min_loss(0.1)(state) == joptim.min_loss(0.1)(state)


def test_every_port_layer_derives_from_the_contract():
    import inspect

    import bigdl_tpu_torch.models as models
    classes = [c for c in vars(nn).values() if inspect.isclass(c)
               and issubclass(c, torch.nn.Module)]
    classes += [c for c in vars(models).values() if inspect.isclass(c)
                and issubclass(c, torch.nn.Module)]
    assert len(classes) > 40
    assert all(issubclass(c, Module) for c in classes), [
        c for c in classes if not issubclass(c, Module)]
    assert flat({"a": {}, "b": {"c": np.zeros(1)}}).keys() == {"b.c"}
