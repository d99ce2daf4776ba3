"""Graph and its control flow in the port against the JAX package: the
wiring sugar of ``Module.__call__``, ``DirectedGraph``'s walks, a
branching Graph with table slots and two inputs, Switch/Merge (true and
false, a tensor predicate, the refused wirings: a nested Switch, one
branch twice), ``IfThenElse`` and nested ``IfThenElse``, a K-step window
over a model that holds one (per-step fallback), ``LeNet5_graph``
(bitwise ``LeNet5`` on the port's CPU path, the JAX Graph's names and
outputs), Graph specs through both serializers, and ``lenet -g``.

The port's weights are carried into the JAX modules; the JAX side runs
jitted where it runs a model. Tolerances (float32): 1e-5 absolute and
relative on outputs and gradients; the control ops and LeNet-5's two
forms are bitwise."""
import json
import logging

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.lenet import LeNet5_graph as JaxLeNet5Graph
from bigdl_tpu.utils import directed_graph as jdg
from bigdl_tpu.utils import module_serializer as jms
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import LeNet5, LeNet5_graph
from bigdl_tpu_torch.models.lenet import test as lenet_test
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.utils import directed_graph as dg
from bigdl_tpu_torch.utils import module_serializer as ms
from bigdl_tpu_torch.utils import serialization as ser
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_parity, jax_eval, to_jax

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _parity(ref, port, x):
    ref.set_parameters(to_jax(port.get_parameters()))
    return assert_parity(ref, port, x, atol=ATOL, rtol=ATOL, jit=True)


# ------------------------------------------------------ wiring sugar

def test_module_call_wires_nodes_and_runs_tensors():
    inp = nn.Input()()
    assert isinstance(inp, dg.Node) and inp.prevs == []
    lin = nn.Linear(4, 3)
    node = lin(inp)
    assert isinstance(node, dg.Node) and node.element is lin
    assert node.prevs[0][0] is inp and node.prevs[0][1].from_index is None
    ct = nn.ConcatTable(nn.Identity(), nn.Identity())(node)
    slot = nn.Tanh()((ct, 2))
    assert slot.prevs[0][1].from_index == 2
    x = torch.ones(2, 4)
    assert torch.equal(lin(x), x @ lin.weight.T + lin.bias)
    assert torch.equal(nn.CAddTable()((x, x)), 2 * x)


def _dag(mod):
    """a -> b, a -> c, b -> d, c -> d, d -> e in package ``mod``."""
    n = {k: mod.Node(k) for k in "abcde"}
    n["a"].add(n["b"])
    n["a"].add(n["c"])
    n["b"].add(n["d"])
    n["c"].add(n["d"])
    n["d"].add(n["e"])
    return n


@pytest.mark.parametrize("reverse", [False, True])
def test_directed_graph_walks_equal_jax(reverse):
    got, want = _dag(dg), _dag(jdg)
    src = "e" if reverse else "a"
    g = dg.DirectedGraph(got[src], reverse=reverse)
    w = jdg.DirectedGraph(want[src], reverse=reverse)
    for walk in ("bfs", "dfs", "topology_sort"):
        assert [n.element for n in getattr(g, walk)()] == \
            [n.element for n in getattr(w, walk)()], walk
    assert g.size() == w.size() == 5
    got["e"].add(got["a"])
    with pytest.raises(ValueError, match="cycle"):
        dg.DirectedGraph(got["a"]).topology_sort()


# ------------------------------------------------------------ Graph

def _branching(m):
    """Two inputs; a ConcatTable whose slots feed two branches; a
    CAddTable merge; repeated classes named ``_1``."""
    x1, x2 = m.Input()(), m.Input()()
    ct = m.ConcatTable(m.Linear(5, 4), m.Linear(5, 4))(x1)
    a = m.Tanh()((ct, 1))
    b = m.Tanh()((ct, 2))
    c = m.Linear(3, 4)(x2)
    out = m.LogSoftMax()(m.CAddTable()(a, b, c))
    return m.Graph([x1, x2], out)


def test_branching_graph_equals_jax():
    port, ref = _branching(nn), _branching(jnn)
    assert port.names == [ref.node_names[id(n)] for n in ref.exec_order]
    assert "Tanh_1" in port.names and "Input_1" in port.names
    _parity(ref, port, [_x((2, 5), 1), _x((2, 3), 2)])


def _cond_graph(m):
    """x -> Switch(pred); false: x * 2; true: x + 10; Merge."""
    data, pred = m.Input()(), m.Input()()
    sw = m.SwitchOps()(data, pred)
    f_branch = m.MulConstant(2.0)((sw, 1))
    t_branch = m.AddConstant(10.0)((sw, 2))
    return m.Graph([data, pred], m.MergeOps()(f_branch, t_branch))


@pytest.mark.parametrize("pred", [False, True])
def test_switch_merge_false_and_true_equal_jax(pred):
    x = _x((2, 3))
    want = np.array(_cond_graph(jnn).forward([x, np.asarray(pred)]))
    g = _cond_graph(nn)
    for p in (pred, torch.tensor(pred)):      # a host bool or a tensor
        got = g([torch.from_numpy(x), p])
        assert torch.equal(got, torch.from_numpy(want))
    np.testing.assert_array_equal(want, x + 10 if pred else x * 2)


def test_merge_requires_two_distinct_branches():
    data, pred = nn.Input()(), nn.Input()()
    sw = nn.SwitchOps()(data, pred)
    b1 = nn.MulConstant(2.0)((sw, 1))
    b2 = nn.MulConstant(3.0)((sw, 1))
    with pytest.raises(ValueError, match="distinct branches"):
        nn.Graph([data, pred], nn.MergeOps()(b1, b2))


def test_nested_switch_merge_rejected():
    data, p_out, p_in = nn.Input()(), nn.Input()(), nn.Input()()
    sw_o = nn.SwitchOps()(data, p_out)
    sw_i = nn.SwitchOps()((sw_o, 1), p_in)
    inner = nn.MergeOps()(nn.MulConstant(2.0)((sw_i, 1)),
                          nn.AddConstant(5.0)((sw_i, 2)))
    outer = nn.MergeOps()(inner, nn.AddConstant(10.0)((sw_o, 2)))
    with pytest.raises(ValueError, match="different"):
        nn.Graph([data, p_out, p_in], outer)


@pytest.mark.parametrize("pred", [False, True])
def test_if_then_else_equals_jax(pred):
    port = nn.IfThenElse(nn.Linear(4, 3), nn.Linear(4, 3))
    ref = jnn.IfThenElse(jnn.Linear(4, 3), jnn.Linear(4, 3))
    assert sorted(port.get_parameters()) == ["else", "then"]
    _parity(ref, port, [np.asarray(pred), _x((2, 4))])


def test_nested_if_then_else_equals_jax():
    def build(m):
        return m.IfThenElse(m.IfThenElse(m.MulConstant(3.0),
                                         m.MulConstant(5.0)),
                            m.IfThenElse(m.MulConstant(7.0),
                                         m.AddConstant(1.0)))
    port, ref = build(nn), build(jnn)
    x = _x((2,))
    for p1 in (False, True):
        for p2 in (False, True):
            want = np.array(ref.forward(
                [np.asarray(p1), [np.asarray(p2), x]]))
            got = port([torch.tensor(p1), [torch.tensor(p2),
                                           torch.from_numpy(x)]])
            assert torch.equal(got, torch.from_numpy(want)), (p1, p2)


class _Positive(nn.Module):
    """Whether the batch's sum is positive (the predicate of the window
    test's model)."""

    def forward(self, x):
        return x.sum() > 0


def _if_model():
    torch.manual_seed(3)
    return nn.Sequential(nn.ConcatTable(_Positive(), nn.Identity()),
                         nn.IfThenElse(nn.Linear(4, 3), nn.Linear(4, 3)),
                         nn.LogSoftMax())


def test_a_window_over_if_then_else_falls_back_per_step(caplog):
    """``IfThenElse`` reads its predicate on the host, which a CUDA
    graph cannot capture: ``set_steps_per_sync(4)`` falls back to one
    step a sync, logs why, and trains as K = 1 does."""
    r = np.random.RandomState(0)
    x = r.randn(16, 4).astype(np.float32)
    y = (np.arange(16) % 3 + 1).astype(np.float32)
    runs = []
    for k in (1, 4):
        RandomGenerator.set_seed(5)
        model = _if_model()
        data = DataSet.array([Sample(x[i], y[i]) for i in range(16)]) \
            .transform(SampleToMiniBatch(4))
        opt = optim.LocalOptimizer(model, data, nn.ClassNLLCriterion(),
                                   batch_size=4)
        opt.set_optim_method(optim.SGD(learning_rate=0.1))
        opt.set_end_when(optim.max_iteration(6)).set_steps_per_sync(k)
        with caplog.at_level(logging.INFO):
            opt.optimize()
        runs.append([p.detach().clone() for p in model.parameters()])
    assert "IfThenElse reads its predicate on the host" in caplog.text
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------- LeNet-5

def _lenets(seed=11):
    gen = [torch.Generator().manual_seed(seed) for _ in range(2)]
    return (LeNet5_graph(10, device="cpu", generator=gen[0]),
            LeNet5(10, device="cpu", generator=gen[1]))


def test_lenet5_graph_is_lenet5_bitwise():
    """The same seed draws the same weights; forward and gradients are
    bitwise the Sequential's."""
    graph, seq = _lenets()
    x = torch.from_numpy(_x((4, 1, 28, 28)))
    outs = []
    for m in (graph, seq):
        out = m(x)
        out.sum().backward()
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    for name in ("conv1_5x5", "conv2_5x5", "fc1", "fc2"):
        a, b = graph.find(name), seq.find(name)
        assert torch.equal(a.weight.grad, b.weight.grad), name
        assert torch.equal(a.bias.grad, b.bias.grad), name


def test_lenet5_graph_equals_jax_graph():
    graph, _ = _lenets()
    ref = JaxLeNet5Graph(10)
    ref.set_parameters(to_jax(graph.get_parameters()))
    assert graph.names == [ref.node_names[id(n)] for n in ref.exec_order]
    x = _x((4, 1, 28, 28))
    with torch.no_grad():
        got = graph.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_eval(ref, x), atol=ATOL, rtol=ATOL)


def test_graph_specs_equal_and_round_trip_both_ways(tmp_path):
    """A LeNet5_graph spec written by either package is the other's, and
    a saved Graph module of either loads in the other with equal
    outputs."""
    graph, _ = _lenets()
    graph.find("fc1").set_scale_w(0.5)
    ref = JaxLeNet5Graph(10)
    ref.find("fc1").set_scale_w(0.5)
    spec = ms.to_spec(graph)
    assert spec == json.loads(json.dumps(jms.to_spec(ref)))
    assert ms.to_spec(ms.from_spec(spec)) == spec
    x = _x((3, 1, 28, 28))
    ser.save_module(str(tmp_path / "port"), graph.eval())
    loaded = jser.load_module(str(tmp_path / "port"))
    with torch.no_grad():
        want = graph(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(jax_eval(loaded, x), want, atol=ATOL,
                               rtol=ATOL)
    ref.set_parameters(to_jax(graph.get_parameters()))
    jser.save_module(str(tmp_path / "jax"), ref.evaluate())
    port = ser.load_module(str(tmp_path / "jax"), device="cpu")
    assert type(port).__name__ == "Graph" and not port.training
    assert port.find("fc1").scale_w == 0.5
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lenet_cli_g_trains_the_graph_as_the_sequential(capsys):
    """``lenet.train -g`` trains ``LeNet5_graph`` from the Sequential's
    weights to the Sequential's parameters, bitwise; ``lenet.test -g``
    scores the Graph."""
    argv = ["--synthetic", "64", "-b", "16", "-e", "1", "--device", "cpu"]
    graph = lenet_train.main(argv + ["-g"])
    seq = lenet_train.main(argv)
    assert type(graph).__name__ == "Graph"
    for name in ("conv1_5x5", "conv2_5x5", "fc1", "fc2"):
        assert torch.equal(graph.find(name).weight, seq.find(name).weight)
    got = lenet_test.main(["--synthetic", "32", "-g", "--device", "cpu"])
    want = lenet_test.main(["--synthetic", "32", "--device", "cpu"])
    assert got["Top1Accuracy"].result() == want["Top1Accuracy"].result()
    capsys.readouterr()
