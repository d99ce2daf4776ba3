"""The sparse feed and the sparse layers of the port against the JAX
package (``bigdl_tpu/dataset/sample.py``, ``transformer.py``,
``bigdl_tpu/nn/sparse.py``, the optimizer's sparse batches, the
Evaluator and Predictor): ``SparseFeature`` and ``HostBatchedCOO``
batching, padding, slicing and ``to_dense``; ``SparseLinear`` against
the dense product and against the JAX ``bcoo_dot_general`` path with
its gradient; ``DenseToSparse`` and ``SparseJoinTable``; 3 SGD steps of
the wide-and-deep model through ``Optimizer.optimize()`` against the JAX
driver; ``steps_per_sync=8`` falling back to per-step once, logged, its
losses bitwise K = 1's; the Evaluator and Predictor on a sparse
dataset; wide-and-deep saved modules across packages; and ``quantize``
of wide-and-deep raising on the sparse input in both packages.

Tolerance (float32): 1e-5 absolute and relative for one forward or
gradient, 1e-4 relative for the driver's three losses and parameters;
the host-side batching exactly."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import PaddingParam as JPaddingParam
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset import SparseFeature as JSparseFeature
from bigdl_tpu.dataset import samples_to_minibatch as j_samples_to_minibatch
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import (DataSet, HostBatchedCOO, MiniBatch,
                                     PaddingParam, Sample,
                                     SampleToMiniBatch, SparseFeature,
                                     minibatch_input_to_device,
                                     samples_to_minibatch)
from bigdl_tpu_torch.examples.wide_and_deep import build_model
from bigdl_tpu_torch.nn.quantized import quantize
from bigdl_tpu_torch.optim.optimizer import _window_stackable
from bigdl_tpu_torch.utils import serialization as ser
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close, to_jax

TOL = 1e-5
RUN_RTOL = 1e-4
WIDE, DEEP = 60, 5

torch.set_num_threads(1)


def _features(n, wide=WIDE, seed=0, max_nnz=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        nnz = rng.randint(0, max_nnz + 1)
        hot = rng.choice(wide, size=nnz, replace=False)
        out.append((hot[:, None], rng.randn(nnz).astype(np.float32)))
    return out


def _samples(sample, feature, n=24, seed=0):
    rng = np.random.RandomState(seed + 100)
    return [sample([feature(i, v, (WIDE,)),
                    rng.randn(DEEP).astype(np.float32)],
                   float(rng.randint(1, 3)))
            for i, v in _features(n, seed=seed)]


def _both_batches(n, padding=None, seed=0):
    feats = _features(n, seed=seed)
    port = samples_to_minibatch(
        [Sample(SparseFeature(i, v, (WIDE,)), 1.0) for i, v in feats],
        feature_padding=padding and PaddingParam(**padding))
    ref = j_samples_to_minibatch(
        [JSample(JSparseFeature(i, v, (WIDE,)), 1.0) for i, v in feats],
        feature_padding=padding and JPaddingParam(**padding))
    return port.get_input(), ref.get_input()


# ----------------------------------------------- rows 6: the host feed

@pytest.mark.parametrize("padding", [None, {"fixed_length": 6}])
def test_host_batched_coo_equals_jax(padding):
    """Indices, values, shape and ``fixed_nnz`` as the JAX package pads
    them (index 0, value 0), ``to_dense`` equal, and the device COO
    equal to the JAX ``to_bcoo().todense()``."""
    port, ref = _both_batches(7, padding)
    assert isinstance(port, HostBatchedCOO)
    np.testing.assert_array_equal(port.indices, ref.indices)
    np.testing.assert_array_equal(port.values, ref.values)
    assert port.shape == ref.shape and port.fixed_nnz == ref.fixed_nnz
    np.testing.assert_array_equal(port.to_dense(), ref.to_dense())
    sp = port.to_sparse()
    assert sp.is_sparse and tuple(sp.shape) == (7, WIDE)
    np.testing.assert_array_equal(sp.to_dense().numpy(),
                                  np.asarray(ref.to_bcoo().todense()))


def test_batching_rules_and_errors_equal_jax():
    """A fixed length shorter than the batch's nnz and mixed shapes raise
    in both; all-empty records pad to nnz 1; a duplicated coordinate
    sums in ``to_dense``; ``SparseFeature.from_dense`` round-trips."""
    feats = [([[1], [2], [3]], [1.0, 2.0, 3.0])]
    for mk, mb, pp in ((SparseFeature, samples_to_minibatch, PaddingParam),
                       (JSparseFeature, j_samples_to_minibatch,
                        JPaddingParam)):
        smp = Sample if mk is SparseFeature else JSample
        with pytest.raises(ValueError, match="fixed nnz"):
            mb([smp(mk(i, np.float32(v), (5,))) for i, v in feats],
               feature_padding=pp(fixed_length=2))
        with pytest.raises(ValueError, match="share a shape"):
            mb([smp(mk([[0]], [1.0], (5,))), smp(mk([[0]], [1.0], (6,)))])
        empty = mb([smp(mk(np.zeros((0, 1)), np.zeros(0, np.float32),
                           (5,)))] * 2).get_input()
        assert empty.indices.shape == (2, 1, 1)
        dup = mk([[2], [2]], np.array([1.5, 2.0], np.float32), (4,))
        coo = mb([smp(dup)]).get_input()
        np.testing.assert_array_equal(coo.to_dense(), [[0, 0, 3.5, 0]])
    dense = np.array([[0, 1.5, 0], [2.0, 0, -1]], np.float32)
    f, jf = SparseFeature.from_dense(dense), JSparseFeature.from_dense(dense)
    np.testing.assert_array_equal(f.indices, jf.indices)
    np.testing.assert_array_equal(f.to_dense(), dense)


def test_minibatch_slice_of_a_sparse_batch_equals_jax():
    port, ref = _both_batches(8)
    p = MiniBatch([port, np.arange(8.0)], np.arange(8.0)).slice(3, 4)
    from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
    j = JMiniBatch([ref, np.arange(8.0)], np.arange(8.0)).slice(3, 4)
    np.testing.assert_array_equal(p.get_input()[0].to_dense(),
                                  j.get_input()[0].to_dense())
    assert p.size() == j.size() == 4
    np.testing.assert_array_equal(p.get_target(), j.get_target())


def test_sample_to_minibatch_padding_and_remainder_equal_jax():
    """``feature_padding`` / ``label_padding`` on variable-length dense
    records and ``drop_remainder``, batch by batch."""
    rng = np.random.RandomState(4)
    rows = [(rng.randn(rng.randint(1, 5)).astype(np.float32),
             rng.randn(rng.randint(1, 3)).astype(np.float32))
            for _ in range(7)]
    kw = dict(feature_padding=PaddingParam(-1.0, 6),
              label_padding=PaddingParam(9.0))
    jkw = dict(feature_padding=JPaddingParam(-1.0, 6),
               label_padding=JPaddingParam(9.0))
    for drop in (False, True):
        got = list(SampleToMiniBatch(3, drop_remainder=drop, **kw)(
            [Sample(x, y) for x, y in rows]))
        want = list(JSampleToMiniBatch(3, drop_remainder=drop, **jkw)(
            [JSample(x, y) for x, y in rows]))
        assert len(got) == len(want) == (2 if drop else 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.get_input(), w.get_input())
            np.testing.assert_array_equal(g.get_target(), w.get_target())


# ------------------------------------------------- row 7: the layers

def _sparse_dense(b=4, n=32, density=0.2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n).astype(np.float32)
    x[rng.rand(b, n) > density] = 0.0
    return x


@pytest.mark.parametrize("padding", [None, {"fixed_length": 6}])
def test_sparse_linear_equals_the_dense_product_and_jax(padding):
    """On a padded batch (entries at index 0 with value 0): the output
    and the weight and bias gradients equal the dense Linear's on
    ``to_dense()`` and the JAX ``bcoo_dot_general`` path's."""
    port_b, ref_b = _both_batches(6, padding, seed=3)
    m = nn.SparseLinear(WIDE, 3, generator=torch.Generator().manual_seed(1))
    ref = jnn.SparseLinear(WIDE, 3)
    ref.set_parameters(to_jax(m.get_parameters()))
    w = np.random.RandomState(2).randn(6, 3).astype(np.float32)

    out = m(port_b.to_sparse())
    (out * torch.from_numpy(w)).sum().backward()
    got_g = m.get_grad_parameters()
    m.zero_grad_parameters()
    dense = m(torch.from_numpy(port_b.to_dense()))
    (dense * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               atol=TOL, rtol=TOL)
    assert_trees_close(got_g, m.get_grad_parameters(), TOL, TOL)

    bcoo = ref_b.to_bcoo()

    def j_loss(p):
        return jnp.sum(ref.forward_fn(p, bcoo) * w)

    params = ref.get_parameters()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref.forward_fn(params, bcoo)),
                               atol=TOL, rtol=TOL)
    assert_trees_close(got_g, jax.grad(j_loss)(params), TOL, TOL)


def test_sparse_linear_takes_dense_input_and_duplicates_sum():
    """A dense input goes through Linear; duplicated coordinates add as
    ``to_dense`` adds them; a 3-d COO contracts its last dim."""
    m = nn.SparseLinear(8, 2)
    x = torch.from_numpy(_sparse_dense(3, 8, seed=4))
    torch.testing.assert_close(m(x), x @ m.weight.T + m.bias, rtol=0,
                               atol=0)
    dup = torch.sparse_coo_tensor([[0, 0, 1], [5, 5, 0]], [1.0, 2.0, 0.0],
                                  (2, 8), check_invariants=True)
    torch.testing.assert_close(m(dup), m(dup.to_dense()), rtol=TOL,
                               atol=TOL)
    x3 = torch.from_numpy(_sparse_dense(6, 8, seed=5).reshape(2, 3, 8))
    torch.testing.assert_close(m(x3.to_sparse()), m(x3), rtol=TOL, atol=TOL)


def test_dense_to_sparse_and_sparse_join_table_equal_jax():
    a, b = _sparse_dense(2, 8, seed=1), _sparse_dense(2, 6, seed=2)
    sa = nn.DenseToSparse()(torch.from_numpy(a))
    assert sa.is_sparse and nn.DenseToSparse()(sa) is sa
    np.testing.assert_array_equal(
        sa.to_dense().numpy(),
        np.asarray(jnn.DenseToSparse().forward(a).todense()))
    for dim in (1, 2):
        bb = b if dim == 2 else _sparse_dense(3, 8, seed=3)
        want = np.asarray(jnn.SparseJoinTable(dim).forward(
            [a, jsparse.BCOO.fromdense(jnp.asarray(bb))]).todense())
        got = nn.SparseJoinTable(dim)(
            [torch.from_numpy(a), torch.from_numpy(bb).to_sparse()])
        assert got.is_sparse
        np.testing.assert_array_equal(got.to_dense().numpy(), want)
    from bigdl_tpu_torch.nn.sparse import to_sparse
    np.testing.assert_array_equal(to_sparse(a).to_dense().numpy(), a)


def test_a_sparse_activation_passes_its_gradient_on():
    """``DenseToSparse`` of an activation that needs a gradient, through
    ``SparseLinear`` and through ``SparseJoinTable``: the input's
    gradient equals the dense path's (``Linear`` on the dense input,
    ``torch.cat``) at the stored entries, and is zero elsewhere (the
    entries are what the COO holds). The JAX package's
    ``BCOO.fromdense`` takes no traced input, so this holds the port to
    its own dense path."""
    a = torch.from_numpy(_sparse_dense(3, 8, seed=6))
    b = torch.from_numpy(_sparse_dense(3, 5, seed=7))
    w = torch.from_numpy(np.random.RandomState(3).randn(3, 2)
                         .astype(np.float32))
    m = nn.SparseLinear(13, 2, generator=torch.Generator().manual_seed(2))
    grads = []
    for sparse in (True, False):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        if sparse:
            joined = nn.SparseJoinTable(2)([nn.DenseToSparse()(x), y])
            assert joined.is_sparse
        else:
            joined = torch.cat([x, y], 1)
        (m(joined) * w).sum().backward()
        grads.append((x.grad, y.grad))
    for g, want, dense in zip(*grads, (a, b)):
        torch.testing.assert_close(g, want * (dense != 0), rtol=TOL,
                                   atol=TOL)


def test_backward_passes_a_sparse_input_untouched():
    """``Module.backward`` runs the forward again under autograd; a
    sparse input passes through to the layers (it has no gradient: its
    entry of the result is None), as the JAX package passes a BCOO
    through ``_to_jax``."""
    m = nn.Sequential().add(nn.SelectTable(1)).add(nn.SparseLinear(8, 2))
    x = torch.from_numpy(_sparse_dense(3, 8)).to_sparse()
    g = m.backward([x, torch.zeros(3)], torch.ones(3, 2))
    assert g[0] is None and g[1] is not None
    assert m.get_grad_parameters() is not None


# --------------------------------------------- row 8: the driver path

def _wd_pair(seed=3):
    port = build_model(WIDE, DEEP,
                       generator=torch.Generator().manual_seed(seed))
    from examples.wide_and_deep import build_model as jax_build
    ref = jax_build(WIDE, DEEP)
    ref.set_parameters(to_jax(port.get_parameters()))
    return ref, port


def _recorder(trigger_cls, record, steps):
    def fn(state):
        record[state["neval"]] = state.get("Loss")
        return state["neval"] > steps
    return trigger_cls(fn)


def _port_run(port, k=1, steps=3, seed=8, record=True):
    """``steps`` SGD steps; with ``record`` an end trigger records each
    step's loss (a plain trigger: the driver then plans no window),
    else ``max_iteration`` ends the run and the losses are the
    driver's history."""
    RandomGenerator.set_seed(seed)
    rec = {}
    ds = DataSet.array(_samples(Sample, SparseFeature)).transform(
        SampleToMiniBatch(8, feature_padding=PaddingParam(fixed_length=5)))
    opt = optim.LocalOptimizer(port, ds, nn.ClassNLLCriterion(),
                               batch_size=8)
    opt.set_optim_method(optim.SGD(learning_rate=0.5))
    opt.set_steps_per_sync(k)
    opt.set_end_when(_recorder(optim.Trigger, rec, steps) if record
                     else optim.max_iteration(steps))
    opt.optimize()
    return (rec if record else [h["loss"] for h in opt.history]), opt


def test_three_sgd_steps_of_wide_and_deep_equal_jax():
    """3 steps at batch 8 over 24 records (the epoch rolls over after
    step 3), fixed nnz 5: each loss and the parameters after within
    1e-4 of the JAX driver's."""
    from bigdl_tpu.optim.trigger import Trigger as JTrigger
    ref, port = _wd_pair()
    JRandomGenerator.set_seed(8)
    j_rec = {}
    ds = JDataSet.array(_samples(JSample, JSparseFeature)).transform(
        JSampleToMiniBatch(8, feature_padding=JPaddingParam(fixed_length=5)))
    j_opt = joptim.LocalOptimizer(ref, ds, jnn.ClassNLLCriterion(),
                                  batch_size=8)
    j_opt.set_optim_method(joptim.SGD(learning_rate=0.5))
    j_opt.set_end_when(_recorder(JTrigger, j_rec, 3))
    j_opt.optimize()
    p_rec, p_opt = _port_run(port)
    assert sorted(p_rec) == sorted(j_rec) == [1, 2, 3, 4]
    for n in (2, 3, 4):
        np.testing.assert_allclose(p_rec[n], j_rec[n], rtol=RUN_RTOL,
                                   err_msg=f"loss {n}")
    assert p_opt.driver_state["epoch"] == j_opt.driver_state["epoch"] == 2
    assert_trees_close(port.get_parameters(), ref.get_parameters(),
                       RUN_RTOL, RUN_RTOL)


def test_steps_per_sync_8_runs_per_step_bitwise(caplog):
    """Sparse batches are not window-stackable: at K = 8 the driver logs
    the fallback once and runs per step, its losses and parameters
    bitwise those at K = 1."""
    port_b, _ = _both_batches(4)
    assert not _window_stackable(MiniBatch([port_b, np.zeros((4, 2))],
                                           np.ones(4)))
    assert _window_stackable(MiniBatch([np.zeros((4, 2))], np.ones(4)))
    _, a = _wd_pair()
    _, b = _wd_pair()
    with caplog.at_level(logging.INFO, "bigdl_tpu_torch.optim.optimizer"):
        rec8, opt8 = _port_run(a, k=8, steps=5, record=False)
    logged = [r for r in caplog.records
              if "not window-stackable" in r.getMessage()]
    assert len(logged) == 1 and "steps_per_sync=8" in logged[0].getMessage()
    assert opt8.window is not None and not opt8.window.shapes
    rec1, _ = _port_run(b, k=1, steps=5, record=False)
    assert len(rec8) == 5 and rec8 == rec1
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_evaluator_and_predictor_on_a_sparse_dataset_equal_jax():
    """``minibatch_input_to_device`` makes the COO; the Predictor pads a
    partial sparse batch (10 records at batch 4) and both packages
    predict and score the same."""
    from bigdl_tpu.optim.predictor import LocalPredictor as JLocalPredictor
    ref, port = _wd_pair(5)
    port.eval()
    rows = (_samples(Sample, SparseFeature, n=10, seed=2),
            _samples(JSample, JSparseFeature, n=10, seed=2))
    ds = DataSet.array(rows[0]).transform(SampleToMiniBatch(4))
    jds = JDataSet.array(rows[1]).transform(JSampleToMiniBatch(4))
    got = np.stack(optim.LocalPredictor(port).predict(ds, batch_size=4))
    want = np.stack(JLocalPredictor(ref).predict(jds, batch_size=4))
    assert got.shape == want.shape == (10, 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert optim.LocalPredictor(port).predict_class(ds, batch_size=4) == \
        JLocalPredictor(ref).predict_class(jds, batch_size=4)
    res = optim.Evaluator(port).test(ds, [optim.Top1Accuracy()],
                                     batch_size=4)
    jres = joptim.Evaluator(ref).test(jds, [joptim.Top1Accuracy()],
                                      batch_size=4)
    assert res["Top1Accuracy"].result() == jres["Top1Accuracy"].result()
    mb = next(ds.data(train=False))
    x = minibatch_input_to_device(mb.get_input(), "cpu")
    assert x[0].is_sparse and not x[1].is_sparse


def test_wide_and_deep_saved_modules_load_across_packages(tmp_path):
    """A wide-and-deep module saved by either package loads in the other
    with its weights and gives its outputs."""
    ref, port = _wd_pair(9)
    port.eval()
    batch = samples_to_minibatch(_samples(Sample, SparseFeature, n=5,
                                          seed=4))
    jbatch = j_samples_to_minibatch(_samples(JSample, JSparseFeature, n=5,
                                             seed=4))
    x = minibatch_input_to_device(batch.get_input(), "cpu")
    jx = JT(jbatch.get_input()[0].to_bcoo(), jbatch.get_input()[1])
    with torch.no_grad():
        want = port(x).numpy()
    ser.save_module(str(tmp_path / "port"), port)
    loaded = jser.load_module(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(loaded.forward(jx)), want,
                               atol=TOL, rtol=TOL)
    ref.evaluate()
    jser.save_module(str(tmp_path / "jax"), ref)
    back = ser.load_module(str(tmp_path / "jax"), device="cpu")
    assert type(back[0][0][1]).__name__ == "SparseLinear"
    with torch.no_grad():
        np.testing.assert_allclose(back(x).numpy(), want, atol=TOL,
                                   rtol=TOL)


def test_quantize_of_wide_and_deep_raises_on_sparse_input_in_both():
    """``quantize`` turns ``SparseLinear`` (a Linear) into a
    QuantizedLinear in both packages; its int8 forward on the sparse
    batch raises in both (the port's names the sparse input) and never
    densifies it."""
    ref, port = _wd_pair(4)
    q, ref_q = quantize(port.eval()), jax_quantize(ref)
    assert type(q[0][0][1]).__name__ == "QuantizedLinear"
    assert type(ref_q.modules[0].modules[0].modules[1]).__name__ == \
        "QuantizedLinear"
    batch = samples_to_minibatch(_samples(Sample, SparseFeature, n=4))
    jbatch = j_samples_to_minibatch(_samples(JSample, JSparseFeature, n=4))
    x = minibatch_input_to_device(batch.get_input(), "cpu")
    with pytest.raises((TypeError, ValueError), match="sparse"):
        with torch.no_grad():
            q(x)
    with pytest.raises((TypeError, ValueError)):
        ref_q.forward(JT(jbatch.get_input()[0].to_bcoo(),
                         jbatch.get_input()[1]))
