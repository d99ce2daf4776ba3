"""The recurrent family of the port against the JAX package: LookupTable,
every cell through ``Recurrent`` (the projected path and the per-step
path), a cell alone, LSTM dropout with the same masks, BiRecurrent
(concat and ``CAddTable``), RecurrentDecoder, the ConvLSTMs (NCHW and
NCDHW, odd and even kernels), TimeDistributed, TimeDistributedCriterion
(folded and per-step) and ``quantize``'s walk, which converts what the
JAX package's converts and nothing else.

The port's parameters are carried into the JAX module (``set_parameters``;
the JAX package's eager init costs more than the checks); the JAX side
runs jitted. Tolerances (float32): outputs and gradients
within 1e-5 absolute and relative, except where a test says 1e-4
relative for the gradients (the dropout step, the criterions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.lenet import LeNet5_graph as JaxLeNet5Graph
from bigdl_tpu.models.rnn import WordRNN as JaxWordRNN
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import LeNet5, LeNet5_graph, WordRNN
from bigdl_tpu_torch.nn import dropout as pdropout
from bigdl_tpu_torch.nn.quantized import quantize
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_parity, assert_trees_close, to_jax

ATOL = 1e-5
GRAD_RTOL = 1e-4
B, STEPS, I, H = 3, 5, 6, 4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _parity(ref, port, x, **kw):
    # the port's weights into the JAX module: its eager init compiles
    # each draw apart, slower than the checks
    ref.set_parameters(to_jax(port.get_parameters()))
    return assert_parity(ref, port, x, atol=ATOL, rtol=ATOL, jit=True,
                         **kw)


# --------------------------------------------------------- LookupTable

@pytest.mark.parametrize("kw", [{}, {"max_norm": 1.5},
                                {"max_norm": 2.0, "norm_type": 1.0}])
def test_lookup_table_equals_jax(kw):
    ids = np.random.default_rng(1).integers(1, 11, (B, STEPS))
    ref = jnn.LookupTable(10, 4, **kw)
    _parity(ref, nn.LookupTable(10, 4, **kw), ids)


def test_lookup_table_float_ids_padding_row_and_id_zero():
    """Float ids truncate as the JAX cast does; id 0 reads the last row
    (the JAX ``take`` wraps -1); the padding row is zero at init in
    both packages."""
    ref = jnn.LookupTable(10, 4, padding_value=3.0)
    ref.ensure_initialized()
    port = nn.LookupTable(10, 4, padding_value=3.0)
    assert np.all(np.asarray(ref.get_parameters()["weight"])[2] == 0)
    assert torch.all(port.weight[2] == 0)
    port.set_parameters(jax.tree.map(np.asarray, ref.get_parameters()))
    ids = np.array([[1.0, 2.9, 10.0, 0.0]], np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.forward(ids)))


# -------------------------------------------------------------- cells

def _cells(p=0.0):
    return {
        "RnnCell": (jnn.RnnCell(I, H), nn.RnnCell(I, H)),
        "LSTM": (jnn.LSTM(I, H, p), nn.LSTM(I, H, p)),
        "LSTMPeephole": (jnn.LSTMPeephole(I, H, p),
                         nn.LSTMPeephole(I, H, p)),
        "GRU": (jnn.GRU(I, H, p), nn.GRU(I, H, p)),
    }


@pytest.mark.parametrize("name", ["RnnCell", "LSTM", "LSTMPeephole", "GRU"])
def test_recurrent_cell_equals_jax(name):
    ref_cell, port_cell = _cells()[name]
    _parity(jnn.Recurrent(ref_cell), nn.Recurrent(port_cell),
            _x((B, STEPS, I)))


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_per_step_path_equals_projected_path(name):
    """A cell that says it draws takes the per-step path (``step`` for
    every time step); drawing nothing, it gives the projected path's
    output."""
    _, cell = _cells()[name]
    model = nn.Recurrent(cell).train()
    x = torch.from_numpy(_x((B, STEPS, I)))
    want = model(x)
    cell.uses_rng = True
    got = model(x, generator=torch.Generator())
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="requires a generator"):
        model(x)


def test_gru_p_takes_the_per_step_path_and_drops_nothing():
    """The JAX GRU's ``p`` sends it down the per-step path in training
    and draws nothing: the port's equals JAX's training forward."""
    ref, port = _cells(p=0.5)["GRU"]
    ref.set_parameters(to_jax(port.get_parameters()))
    rec = jnn.Recurrent(ref)
    params = {"cell": ref.get_parameters()}
    x = _x((B, STEPS, I))
    want, _ = rec.apply(params, {}, jnp.asarray(x), training=True,
                        rng=jax.random.PRNGKey(0))
    port_rec = nn.Recurrent(port).train()
    port_rec.set_parameters(jax.tree.map(np.asarray, params))
    got = port_rec(torch.from_numpy(x), generator=torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)


def test_cell_alone_maps_a_table():
    ref, port = _cells()["LSTM"]
    ref.set_parameters(to_jax(port.get_parameters()))
    x, h, c = _x((B, I), 1), _x((B, H), 2), _x((B, H), 3)
    want = ref.forward(JT(x, JT(h, c)))
    got = port(T(torch.from_numpy(x), T(torch.from_numpy(h),
                                        torch.from_numpy(c))))
    for g, w in ((got[1], want[1]), (got[2][1], want[2][1]),
                 (got[2][2], want[2][2])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=ATOL)


class _Masks:
    """The two keep masks of a step (the input's, then ``h``'s), handed
    out in turn: the JAX scan traces its body once, so its two draws
    serve every step; the port draws two a step."""

    def __init__(self, p):
        rng = np.random.default_rng(9)
        self.masks = [rng.random((B, I)) >= p, rng.random((B, H)) >= p]
        self.calls = 0

    def next(self):
        m = self.masks[self.calls % 2]
        self.calls += 1
        return m


def test_lstm_dropout_with_the_same_masks_equals_jax(monkeypatch):
    p = 0.3
    jm, pm = _Masks(p), _Masks(p)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p_keep, shape: jnp.asarray(jm.next()))
    monkeypatch.setattr(pdropout, "keep_mask",
                        lambda shape, p_, generator:
                        torch.from_numpy(pm.next()))
    ref_cell, port_cell = _cells(p)["LSTM"]
    ref = jnn.Recurrent(ref_cell)
    ref.set_parameters(to_jax({"cell": port_cell.get_parameters()}))
    params = ref.get_parameters()
    x = _x((B, STEPS, I))
    w = _x((B, STEPS, H), 4)

    def loss(prm, a):
        out, _ = ref.apply(prm, {}, a, training=True,
                           rng=jax.random.PRNGKey(1))
        return jnp.sum(out * w), out
    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        params, jnp.asarray(x))
    port = nn.Recurrent(port_cell).train()
    port.set_parameters(jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, generator=torch.Generator())
    (got * torch.from_numpy(w)).sum().backward()
    assert pm.calls == 2 * STEPS
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=ATOL, rtol=GRAD_RTOL)
    assert_trees_close(port.get_grad_parameters(), gp, ATOL, GRAD_RTOL)
    # evaluation draws nothing and takes the projected path
    with torch.no_grad():
        ev = port.eval()(torch.from_numpy(x))
    assert pm.calls == 2 * STEPS
    want_ev, _ = ref.apply(params, {}, jnp.asarray(x), training=False)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want_ev), atol=ATOL,
                               rtol=ATOL)


# ------------------------------------------------- containers of cells

@pytest.mark.parametrize("merge", [None, "CAddTable"])
def test_birecurrent_equals_jax(merge):
    ref = jnn.BiRecurrent(getattr(jnn, merge)() if merge else None,
                          jnn.LSTM(I, H))
    port = nn.BiRecurrent(getattr(nn, merge)() if merge else None,
                          nn.LSTM(I, H))
    out = _parity(ref, port, _x((B, STEPS, I)))
    assert out.shape == (B, STEPS, H if merge else 2 * H)
    assert port.fwd.cell is not port.bwd.cell


def test_recurrent_decoder_equals_jax():
    _parity(jnn.RecurrentDecoder(STEPS, jnn.LSTM(H, H)),
            nn.RecurrentDecoder(STEPS, nn.LSTM(H, H)), _x((B, H)))


@pytest.mark.parametrize("k", [3, 2])
def test_conv_lstm_peephole_equals_jax(k):
    """NCHW maps of 6 x 6; an even kernel pads unevenly, as the JAX
    package does."""
    _parity(jnn.Recurrent(jnn.ConvLSTMPeephole(2, 3, k, k)),
            nn.Recurrent(nn.ConvLSTMPeephole(2, 3, k, k)),
            _x((2, 3, 2, 6, 6)))


@pytest.mark.parametrize("k", [3, 2])
def test_conv_lstm_peephole_3d_equals_jax(k):
    _parity(jnn.Recurrent(jnn.ConvLSTMPeephole3D(2, 2, k, k)),
            nn.Recurrent(nn.ConvLSTMPeephole3D(2, 2, k, k)),
            _x((2, 2, 2, 4, 4, 4)))


def test_time_distributed_equals_jax():
    _parity(jnn.TimeDistributed(jnn.Linear(I, 7)),
            nn.TimeDistributed(nn.Linear(I, 7)), _x((B, STEPS, I)))


# ------------------------------------------- TimeDistributedCriterion

def _criterion_pair(ref, port, x, target, rtol=ATOL):
    xj = jnp.asarray(x)
    want, gwant = jax.value_and_grad(
        lambda a: ref.apply(a, jnp.asarray(target)))(xj)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant),
                               atol=ATOL, rtol=GRAD_RTOL)
    return float(got)


def _labels(seed=5, classes=7):
    return np.random.default_rng(seed).integers(
        1, classes + 1, (B, STEPS)).astype(np.float32)


@pytest.mark.parametrize("size_average", [False, True])
def test_time_distributed_criterion_folded_equals_jax(size_average):
    _criterion_pair(
        jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(),
                                     size_average),
        nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                    size_average),
        _x((B, STEPS, 7)), _labels())


def test_time_distributed_criterion_loop_with_class_weights():
    """Class weights take the per-step loop (each step divides by its
    own total weight); equal to JAX's, and with unit weights equal to
    the folded path of the unweighted criterion."""
    x, t = _x((B, STEPS, 7)), _labels()
    weights = np.linspace(0.5, 2.0, 7).astype(np.float32)
    _criterion_pair(
        jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion(weights)),
        nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(weights)),
        x, t)
    ones = np.ones(7, np.float32)
    loop = _criterion_pair(
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(ones)),
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion(ones)), x, t)
    with torch.no_grad():
        folded = float(nn.TimeDistributedCriterion(nn.ClassNLLCriterion())(
            torch.from_numpy(x), torch.from_numpy(t)))
    np.testing.assert_allclose(loop, folded, rtol=ATOL)


def test_time_distributed_criterion_mse_and_a_shared_target():
    """MSE over per-step targets folds; a target without the time axis
    is applied at every step through the loop."""
    x = _x((B, STEPS, 3))
    _criterion_pair(jnn.TimeDistributedCriterion(jnn.MSECriterion()),
                    nn.TimeDistributedCriterion(nn.MSECriterion()),
                    x, _x((B, STEPS, 3), 6))
    _criterion_pair(
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(), True),
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion(), True),
        x, np.array([1.0, 3.0, 2.0], np.float32))


# --------------------------------------------------------- quantize

def _classes(modules):
    return [type(m).__name__ for m in modules]


def test_quantize_leaves_a_recurrent_model_float_in_both():
    """The JAX ``convert`` descends only into containers and Graphs:
    ``WordRNN``'s ``Recurrent`` and ``TimeDistributed(Linear)`` stay
    float in both packages, and the int8 forward is the float one."""
    model = WordRNN(20, 8, device="cpu").eval()
    ref = JaxWordRNN(20, 8)
    ref.set_parameters(to_jax(model.get_parameters()))
    ref_q = jax_quantize(ref)
    assert _classes(ref_q.modules) == ["LookupTable", "Recurrent",
                                       "TimeDistributed"]
    assert type(ref_q.modules[2].layer).__name__ == "Linear"
    q = quantize(model)
    assert not any(type(m).__name__.startswith("Quantized")
                   for m in q.modules())
    assert q is not model and q[2].layer is not model[2].layer
    ids = torch.from_numpy(_labels(classes=20))
    with torch.no_grad():
        assert torch.equal(q(ids), model(ids))
    assert torch.equal(model.quantize()(ids), model(ids))


def test_quantize_converts_lenet5_graph_as_jax_does():
    """Over a Graph both packages convert the two convolutions and fc1,
    fc2, and name the new nodes alike; the port's int8 Graph equals its
    int8 Sequential bitwise on the same weights."""
    gen = 21
    graph = LeNet5_graph(10, device="cpu",
                         generator=torch.Generator().manual_seed(gen))
    ref = JaxLeNet5Graph(10)
    ref.set_parameters(to_jax(graph.get_parameters()))
    ref_q = jax_quantize(ref)
    want = [ref_q.node_names[id(n)] for n in ref_q.exec_order]
    q = quantize(graph)
    assert q.names == want
    assert _classes(q._modules[n] for n in q.names) == \
        _classes(n.element for n in ref_q.exec_order)
    assert type(graph._modules["fc1"]).__name__ == "Linear"
    assert type(q._modules["fc1"]).__name__ == "QuantizedLinear"
    seq = quantize(LeNet5(10, device="cpu",
                          generator=torch.Generator().manual_seed(gen)))
    x = torch.from_numpy(_x((4, 1, 28, 28)))
    with torch.no_grad():
        assert torch.equal(q(x), seq(x))
