"""The shape, reduction and table layers, the table containers and
``TemporalConvolution`` of the port against the JAX package
(``bigdl_tpu/nn/shape.py``, ``table_ops.py``, ``container.py``,
``conv.py``): each class on the same seeded numpy input, the outputs
(every entry of a table output) and the gradients of one seeded scalar
loss with respect to every floating input and every parameter; each
class's spec written by both serializers alike and rebuilt; and
``quantize``'s walk into ``ParallelTable``, ``MapTable`` and ``Bottle``
and not into ``NarrowTable`` or ``MixtureTable``, in both packages.

The port's parameters are carried into the JAX module (``set_parameters``)
and the JAX side runs jitted, except ``MaskedSelect`` (its size is the
data's; the JAX package runs it eagerly). Tolerance (float32): 1e-5
absolute and relative, outputs and gradients alike; integer outputs
(``Nms``) exactly."""
import json

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu.utils import module_serializer as jms
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.quantized import quantize
from bigdl_tpu_torch.utils import module_serializer as ms
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_table_parity, to_jax

TOL = 1e-5

torch.set_num_threads(1)


def _x(*shape, seed=0, positive=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _both(name, *args, **kw):
    return getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args, **kw)


def _boxes(n, seed=3):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 10, (n, 2)).astype(np.float32)
    wh = r.uniform(1, 4, (n, 2)).astype(np.float32)
    scores = np.round(r.uniform(0, 1, n), 1).astype(np.float32)  # ties
    return [np.concatenate([xy, xy + wh], 1), scores]


# -------------------------------------------------- rows 1-3, 5: one class

A, B, C = _x(3, 4, seed=1), _x(3, 4, seed=2), _x(3, 4, seed=3)

CASES = {
    # row 1: the table and reduction classes the programs use first
    "SelectTable(1)": (("SelectTable", 1), [A, B, C]),
    "SelectTable(-1)": (("SelectTable", -1), [A, B, C]),
    "Max(2,3)": (("Max", 2, 3), _x(4, 5, 6)),
    "Max(2,3)-ties": (("Max", 2, 3), np.round(_x(2, 6, 3), 0)),
    "Max(1)": (("Max", 1), _x(4, 5)),
    "Min(2)": (("Min", 2), _x(4, 5)),
    "Mean(2)": (("Mean", 2), _x(3, 4, 5)),
    "Mean(1,1,keep)": (("Mean", 1, 1, False), _x(3, 4)),
    "Sum(2)": (("Sum", 2), _x(3, 4, 5)),
    "Sum(1,1,avg)": (("Sum", 1, 1, True), _x(3, 4)),
    "JoinTable(2)": (("JoinTable", 2), [A, _x(3, 2, seed=4)]),
    "JoinTable(1,1)": (("JoinTable", 1, 1), [A, _x(3, 2, seed=4)]),
    "SplitTable(2)": (("SplitTable", 2), _x(3, 4, 5)),
    "SplitTable(1,2)": (("SplitTable", 1, 2), _x(3, 4, 5)),
    "SplitTable(-1)": (("SplitTable", -1), _x(3, 4, 5)),
    "Select(2,3)": (("Select", 2, 3), _x(3, 4, 5)),
    "Select(1,-1)": (("Select", 1, -1), _x(3, 4)),
    "Narrow(2,2,3)": (("Narrow", 2, 2, 3), _x(3, 6)),
    "Narrow(2,-3,2)": (("Narrow", 2, -3, 2), _x(3, 6)),
    "Narrow(2,2,-1)": (("Narrow", 2, 2, -1), _x(3, 6)),
    "FlattenTable": (("FlattenTable",), T(A, T(B, T(C)), _x(2, seed=5))),
    "BifurcateSplitTable(2)": (("BifurcateSplitTable", 2), _x(3, 5, 2)),
    "Pack(2)": (("Pack", 2), [A, B, C]),
    "Pack(1)-tensor": (("Pack", 1), A),
    # row 2: the rest of shape.py
    "InferReshape(0,-1)": (("InferReshape", (0, -1)), _x(3, 4, 5)),
    "InferReshape(2,-1,batch)": (("InferReshape", (2, -1), True),
                                 _x(3, 4, 5)),
    "Squeeze()": (("Squeeze",), _x(3, 1, 4, 1)),
    "Squeeze(2)": (("Squeeze", 2), _x(3, 1, 4)),
    "Squeeze(1,batch)": (("Squeeze", 1, 0, True), _x(3, 1, 4)),
    "Unsqueeze(2)": (("Unsqueeze", 2), _x(3, 4)),
    "Unsqueeze(1,1)": (("Unsqueeze", 1, 1), _x(3, 4)),
    "Transpose": (("Transpose", [(1, 2), (2, 3)]), _x(2, 3, 4)),
    "Contiguous": (("Contiguous",), _x(2, 3)),
    "Replicate(3,2)": (("Replicate", 3, 2), _x(2, 4)),
    "Padding(2,2,2)": (("Padding", 2, 2, 2), _x(3, 4)),
    "Padding(1,-1,1,0.5)": (("Padding", 1, -1, 1, 0.5), _x(3, 4)),
    "Padding(2,3,2,batch)": (("Padding", 2, 3, 2), _x(2, 3, 4)),
    "SpatialZeroPadding(1,2,0,1)": (("SpatialZeroPadding", 1, 2, 0, 1),
                                    _x(2, 3, 4, 5)),
    "SpatialZeroPadding(2)": (("SpatialZeroPadding", 2), _x(1, 2, 3, 3)),
    "Index(2)": (("Index", 2), [_x(3, 5), np.array([2, 5, 1, 2],
                                                    np.float32)]),
    "Index(1)-wrap": (("Index", 1), [_x(4, 2),
                                     np.array([[1, 0], [4, 3]], np.int32)]),
    "Tile(2,3)": (("Tile", 2, 3), _x(2, 3)),
    "Reverse(2)": (("Reverse", 2), _x(3, 4)),
    "ResizeBilinear(5,7)": (("ResizeBilinear", 5, 7), _x(2, 3, 4, 6)),
    "ResizeBilinear(3,3,align)": (("ResizeBilinear", 3, 3, True),
                                  _x(1, 2, 6, 5)),
    "ResizeBilinear(8,9,align)": (("ResizeBilinear", 8, 9, True),
                                  _x(1, 2, 4, 4)),
    "Nms(0.5,6)": (("Nms", 0.5, 6), _boxes(12)),
    "Nms(0.3,20)": (("Nms", 0.3, 20), _boxes(16, seed=4)),
    # row 3: the elementwise table ops
    "CSubTable": (("CSubTable",), [A, B]),
    "CMulTable": (("CMulTable",), [A, B, C]),
    "CDivTable": (("CDivTable",), [A, _x(3, 4, seed=9, positive=True)]),
    "CMaxTable": (("CMaxTable",), [A, B, np.round(C)]),
    "CMinTable": (("CMinTable",), [A, A, B]),
    "CAddTable": (("CAddTable",), [A, B, C]),
    # row 5
    "TemporalConvolution(4,6,3,2)": (("TemporalConvolution", 4, 6, 3, 2),
                                     _x(2, 9, 4)),
    "TemporalConvolution(4,5,2)-2d": (("TemporalConvolution", 4, 5, 2),
                                      _x(7, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_equals_jax(case):
    (name, *args), inp = CASES[case]
    ref, port = _both(name, *args)
    assert_table_parity(ref, port, inp, TOL)


def test_masked_select_equals_jax():
    """The compacted vector of the set entries, in row-major order (its
    length the mask's count); the JAX package runs it eagerly and gives
    it no gradient."""
    x = _x(3, 5)
    mask = (np.random.default_rng(2).uniform(size=(3, 5)) > 0.5)
    ref, port = _both("MaskedSelect")
    got = assert_table_parity(ref, port, [x, mask.astype(np.float32)], TOL,
                              jit=False, grad=False)
    assert got[0].shape == (int(mask.sum()),)


def test_scale_equals_jax():
    """Scale's tree is the JAX ``{"cmul": {"weight"}, "cadd": {"bias"}}``
    and its initial draw is ``U(-1/sqrt(n), 1/sqrt(n))``."""
    ref, port = _both("Scale", (1, 4))
    tree = port.get_parameters()
    assert sorted(tree) == ["cadd", "cmul"]
    assert np.abs(tree["cmul"]["weight"]).max() <= 0.5
    assert_table_parity(ref, port, _x(3, 4), TOL)


def test_nms_keeps_what_the_jax_package_keeps_in_order():
    """The kept indices in descending score order with ties in index
    order (both sorts stable), padded with -1; fewer kept than
    ``max_output`` and more."""
    boxes, scores = _boxes(30, seed=11)
    for thr, cap in ((0.1, 4), (0.5, 40)):
        ref, port = _both("Nms", thr, cap)
        want = np.asarray(ref.forward(JT(boxes, scores)))
        got = port([torch.from_numpy(boxes), torch.from_numpy(scores)])
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


# -------------------------------------------------- row 4: containers

def _containers():
    def pair(build):
        return build(jnn), build(nn)

    gen = torch.Generator().manual_seed(5)
    return {
        "ParallelTable": (pair(lambda m: m.ParallelTable()
                               .add(m.Linear(4, 3)).add(m.Linear(2, 3))),
                          [A, _x(3, 2, seed=4)]),
        "ParallelTable-nested": (pair(lambda m: m.ParallelTable().add(
            m.Sequential().add(m.Linear(4, 2)).add(m.Tanh()))
            .add(m.Identity())), [A, B]),
        "MapTable": (pair(lambda m: m.MapTable(m.Linear(4, 3))), [A, B, C]),
        "Bottle(Linear)": (pair(lambda m: m.Bottle(m.Linear(4, 3))),
                           _x(2, 3, 4)),
        "Bottle(Linear,2,2)-4d": (pair(lambda m: m.Bottle(
            m.Linear(4, 3), 2, 2)), _x(2, 2, 3, 4)),
        "Bottle(Temporal,3,3)": (pair(lambda m: m.Bottle(
            m.TemporalConvolution(4, 2, 2), 3, 3)), _x(2, 3, 5, 4)),
        "NarrowTable(2,2)": (pair(lambda m: m.NarrowTable(2, 2)),
                             [A, B, C, _x(3, 4, seed=8)]),
        "NarrowTable(2,-1)": (pair(lambda m: m.NarrowTable(2, -1)),
                              [A, B, C, _x(3, 4, seed=8)]),
        "MixtureTable-table": (pair(lambda m: m.MixtureTable()),
                               [_x(3, 2, seed=6), T(A, B)]),
        "MixtureTable-tensor": (pair(lambda m: m.MixtureTable()),
                                [_x(3, 3, seed=6), _x(3, 3, 4, seed=7)]),
    }, gen


CONTAINERS = sorted(_containers()[0])


@pytest.mark.parametrize("case", CONTAINERS)
def test_container_equals_jax(case):
    (ref, port), inp = _containers()[0][case]
    assert_table_parity(ref, port, inp, TOL)


def test_containers_hand_the_generator_on():
    """``ParallelTable``, ``MapTable`` and ``Bottle`` pass ``generator=``
    to each child that takes one, in order: a Dropout child draws from
    the one stream."""
    from bigdl_tpu_torch.nn.container import forward_takes_generator
    for cls in (nn.ParallelTable, nn.MapTable, nn.Bottle):
        assert forward_takes_generator(cls)
    drop = nn.MapTable(nn.Dropout(0.5)).train()
    x = torch.ones(4, 8)
    a = drop([x, x], generator=torch.Generator().manual_seed(3))
    b = drop([x, x], generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])


# ------------------------------------------------------- serializer

def _spec_cases():
    out = {case: _both(*CASES[case][0]) for case in sorted(CASES)}
    out["MaskedSelect"] = _both("MaskedSelect")
    out["Scale((1,4))"] = _both("Scale", (1, 4))
    for case, ((ref, port), _) in _containers()[0].items():
        out[case] = (ref, port)
    return out


SPEC_CASES = sorted(_spec_cases())


@pytest.mark.parametrize("case", SPEC_CASES)
def test_spec_round_trips_and_equals_jax(case):
    ref, port = _spec_cases()[case]
    spec = ms.to_spec(port)
    assert json.loads(json.dumps(spec)) == spec
    assert spec == json.loads(json.dumps(jms.to_spec(ref)))
    rebuilt = ms.from_spec(spec)
    assert type(rebuilt) is type(port)
    assert ms.to_spec(rebuilt) == spec
    # the JAX package builds the same tree from the port's spec
    assert jms.to_spec(jms.from_spec(spec)) == jms.to_spec(ref)


# ------------------------------------------------------- quantize's walk

def test_quantize_descends_into_the_new_containers_only():
    """``ParallelTable``, ``MapTable`` and ``Bottle`` are Containers: their
    Linears become QuantizedLinear. ``NarrowTable`` and ``MixtureTable``
    hold no child (the JAX package's are plain Modules too). Both
    packages convert the same layers, and the int8 outputs agree."""
    def build(m):
        return (m.Sequential()
                .add(m.ConcatTable()
                     .add(m.ParallelTable().add(m.Linear(4, 4))
                          .add(m.Linear(4, 4)))
                     .add(m.MapTable(m.Linear(4, 4))))
                .add(m.FlattenTable())
                .add(m.NarrowTable(1, 2))
                .add(m.JoinTable(2))
                .add(m.Bottle(m.Linear(8, 2), 2, 2)))

    def classes(mod, walk):
        return [type(c).__name__ for c in walk(mod)]

    port = build(nn).eval()
    ref = build(jnn)
    ref.set_parameters(to_jax(port.get_parameters()))
    x = [_x(3, 4, seed=1), _x(3, 4, seed=2)]
    q, ref_q = quantize(port), jax_quantize(ref)

    def port_walk(m):
        return [c for c in m.modules() if c is not m]

    def jax_walk(m):
        out = []
        for c in getattr(m, "modules", []):
            out.append(c)
            out.extend(jax_walk(c))
        return out

    got, want = classes(q, port_walk), classes(ref_q, jax_walk)
    assert got == want
    assert got.count("QuantizedLinear") == 4 and "Linear" not in got
    with torch.no_grad():
        out = q([torch.from_numpy(a) for a in x]).numpy()
    want_out = np.asarray(ref_q.forward(JT(*x)))
    np.testing.assert_allclose(out, want_out, atol=1e-4, rtol=1e-4)
    # MixtureTable and NarrowTable are not Containers in either package
    from bigdl_tpu.nn.container import Container as JContainer
    assert not isinstance(jnn.MixtureTable(), JContainer)
    assert not isinstance(jnn.NarrowTable(1), JContainer)
    assert not isinstance(nn.MixtureTable(), nn.Container)
    assert not isinstance(nn.NarrowTable(1), nn.Container)
