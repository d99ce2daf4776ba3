"""The linear-algebra layers of the port (``bigdl_tpu_torch/nn/linear.py``:
``Bilinear``, ``CMul``, ``CAdd``, ``Mul``, ``Add``, ``MM``, ``MV``,
``Cosine``, ``Euclidean``, ``DotProduct``, ``PairwiseDistance``,
``CosineDistance``) against the JAX package's (``bigdl_tpu/nn/linear.py``)
on the same seeded inputs: the outputs and the gradients of a seeded
scalar loss with respect to every floating input and every parameter
(the port's parameters carried into the JAX module), Bilinear's
regularizer penalties, each class's spec written alike by both
serializers, and ``Scale`` over the ported ``CMul`` and ``CAdd``: the
same draws as before, its specs loading in either package.

Tolerance (float32): 1e-5 absolute and relative."""
import json

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.optim.regularizer import L1Regularizer as JL1
from bigdl_tpu.optim.regularizer import L2Regularizer as JL2
from bigdl_tpu.utils import module_serializer as jms
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import RandomUniform
from bigdl_tpu_torch.optim.regularizer import L1Regularizer, L2Regularizer
from bigdl_tpu_torch.utils import module_serializer as ms
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_table_parity, to_jax

TOL = 1e-5

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


#: ``{id: ((class name, args, kwargs), input)}``; a class with
#: parameters is built from a seeded generator in the port
CASES = {
    "Bilinear": (("Bilinear", (4, 3, 5), {}), T(_x(6, 4), _x(6, 3, seed=1))),
    "Bilinear-no-bias": (("Bilinear", (4, 3, 2), {"bias_res": False}),
                         [_x(5, 4), _x(5, 3, seed=1)]),
    "CMul": (("CMul", ((1, 4),), {}), _x(3, 4)),
    "CMul-3d": (("CMul", ((2, 1, 4),), {}), _x(2, 3, 4)),
    "CAdd": (("CAdd", ((3, 1),), {}), _x(3, 4)),
    "Mul": (("Mul", (), {}), _x(3, 4)),
    "Add": (("Add", (4,), {}), _x(3, 4)),
    "MM": (("MM", (), {}), T(_x(2, 3, 4), _x(2, 4, 5, seed=1))),
    "MM-trans": (("MM", (True, True), {}), [_x(4, 3), _x(5, 4, seed=1)]),
    "MV": (("MV", (), {}), T(_x(2, 3, 4), _x(2, 4, seed=1))),
    "MV-trans": (("MV", (True,), {}), [_x(4, 3), _x(4, seed=1)]),
    "Cosine": (("Cosine", (5, 3), {}), _x(4, 5)),
    "Cosine-1d": (("Cosine", (5, 3), {}), _x(5)),
    "Euclidean": (("Euclidean", (5, 3), {}), _x(4, 5)),
    "Euclidean-1d": (("Euclidean", (5, 3), {"fast_backward": False}),
                     _x(5)),
    "DotProduct": (("DotProduct", (), {}), T(_x(4, 6), _x(4, 6, seed=1))),
    "PairwiseDistance": (("PairwiseDistance", (), {}),
                         [_x(4, 6), _x(4, 6, seed=1)]),
    "PairwiseDistance-1": (("PairwiseDistance", (1,), {}),
                           [_x(4, 6), _x(4, 6, seed=1)]),
    "PairwiseDistance-3": (("PairwiseDistance", (3,), {}),
                           T(_x(4, 6), _x(4, 6, seed=1))),
    "CosineDistance": (("CosineDistance", (), {}),
                       T(_x(4, 6), _x(4, 6, seed=1))),
}

WITH_PARAMS = {"Bilinear", "CMul", "CAdd", "Mul", "Add", "Cosine",
               "Euclidean"}


def _both(name, args, kw):
    port_kw = dict(kw, generator=_gen()) if name in WITH_PARAMS else kw
    return getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args,
                                                               **port_kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    spec, inp = CASES[case]
    ref, port = _both(*spec)
    assert_table_parity(ref, port, inp, TOL)


@pytest.mark.parametrize("name,shape", [
    ("Bilinear", {"weight": (5, 4, 3), "bias": (5,)}),
    ("Euclidean", {"weight": (4, 3)}),
    ("Mul", {"weight": (1,)}),
    ("Cosine", {"weight": (3, 4)}),
    ("CMul", {"weight": (2, 3)}),
    ("CAdd", {"bias": (2, 3)}),
    ("Add", {"bias": (4,)}),
])
def test_parameter_trees_have_the_jax_layouts(name, shape):
    args = {"Bilinear": (4, 3, 5), "Euclidean": (4, 3), "Mul": (),
            "Cosine": (4, 3), "CMul": ((2, 3),), "CAdd": ((2, 3),),
            "Add": (4,)}[name]
    ref, port = _both(name, args, {})
    ref.ensure_initialized()
    for tree in (port.get_parameters(), ref.get_parameters()):
        assert {k: tuple(np.shape(v)) for k, v in tree.items()} == shape


def test_bilinear_regularizer_penalties_match_jax():
    ref = jnn.Bilinear(4, 3, 5, w_regularizer=JL2(0.1),
                       b_regularizer=JL1(0.05))
    port = nn.Bilinear(4, 3, 5, w_regularizer=L2Regularizer(0.1),
                       b_regularizer=L1Regularizer(0.05), generator=_gen())
    ref.set_parameters(to_jax(port.get_parameters()))
    got = port.regularization_loss()
    got.backward()
    import jax
    params = ref.get_parameters()
    want, grads = jax.value_and_grad(ref.regularization_loss)(params)
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(grads[name]), atol=TOL,
                                   rtol=TOL)
    no_bias = nn.Bilinear(4, 3, 5, False, w_regularizer=L2Regularizer(0.1),
                          b_regularizer=L1Regularizer(0.05),
                          generator=_gen())
    np.testing.assert_allclose(
        no_bias.regularization_loss().item(),
        L2Regularizer(0.1).loss(no_bias.weight).item(), rtol=1e-7)


def test_scale_draws_as_its_private_halves_did():
    """``Scale`` over the ported ``CMul`` and ``CAdd`` draws what its two
    private halves drew before them: ``U(-1/sqrt(n), 1/sqrt(n))`` of the
    size, the weight first then the bias, from the same generator."""
    for size in ((1, 4), (2, 3), (5,)):
        got = nn.Scale(size, generator=_gen(7))
        g = _gen(7)
        stdv = 1.0 / np.sqrt(np.prod(size))
        w = RandomUniform(-stdv, stdv)(size, 1, 1, g)
        b = RandomUniform(-stdv, stdv)(size, 1, 1, g)
        assert isinstance(got.cmul, nn.CMul) and isinstance(got.cadd,
                                                            nn.CAdd)
        assert torch.equal(got.cmul.weight.data, w)
        assert torch.equal(got.cadd.bias.data, b)
        assert [n for n, _ in got.named_parameters()] == ["cmul.weight",
                                                          "cadd.bias"]


def test_scale_specs_load_in_either_package():
    port = nn.Scale((1, 4), generator=_gen(3))
    x = _x(3, 4)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    # the port's spec built by the JAX package, with the port's weights
    ref = jms.from_spec(json.loads(json.dumps(ms.to_spec(port))))
    ref.set_parameters(to_jax(port.get_parameters()))
    np.testing.assert_allclose(np.asarray(ref.forward(x)), want, atol=TOL)
    # the JAX package's spec built by the port
    back = ms.from_spec(json.loads(json.dumps(jms.to_spec(ref))))
    back.set_parameters(port.get_parameters())
    with torch.no_grad():
        np.testing.assert_array_equal(back(torch.from_numpy(x)).numpy(),
                                      want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_equals_jax_and_round_trips(case):
    (name, args, kw), _ = CASES[case]
    ref, port = _both(name, args, kw)
    spec = ms.to_spec(port)
    assert spec == json.loads(json.dumps(jms.to_spec(ref)))
    rebuilt = ms.from_spec(spec)
    assert type(rebuilt) is type(port) and ms.to_spec(rebuilt) == spec
    assert jms.to_spec(jms.from_spec(spec)) == jms.to_spec(ref)
