"""LeNet-5 end to end, the port against the JAX package on the same
seeded data and weights: the model's tree, forward and gradients, five
SGD steps of ``LocalOptimizer`` with validation every epoch, the
Evaluator and Predictor, the MNIST reader, and the train / test CLIs.

Tolerances: the forward within 1e-5 absolute and the parameter
gradients within 1e-4 relative (float32 convolutions reduced in other
orders); losses and validation scores within 1e-5 relative; accuracies
and predicted classes exactly; the synthetic rows bitwise."""
import argparse
import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.image import load_mnist as jax_load_mnist
from bigdl_tpu.models import _cli as jax_cli
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.image import load_mnist
from bigdl_tpu_torch.models import LeNet5
from bigdl_tpu_torch.models import _cli
from bigdl_tpu_torch.models.lenet import test as lenet_test
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.optim.predictor import pad_rows
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_parity, assert_trees_close, flat

RTOL = 1e-5


def _jax_lenet(seed):
    JaxRandomGenerator.set_seed(seed)
    ref = JaxLeNet5(10)
    ref.ensure_initialized()
    return ref, jax.tree.map(np.asarray, ref.get_parameters())


def _port_lenet(params):
    return LeNet5(10, device="cpu").set_parameters(params)


def _rows(n, seed):
    r = np.random.RandomState(seed)
    return (r.standard_normal((n, 1, 28, 28)).astype(np.float32),
            r.randint(1, 11, n).astype(np.float32))


def test_lenet_tree_names_and_round_trip_match_jax():
    ref, params = _jax_lenet(0)
    port = LeNet5(10, device="cpu")
    assert sorted(flat(port.get_parameters())) == sorted(flat(params))
    for i, name in ((1, "conv1_5x5"), (5, "conv2_5x5"), (8, "fc1"),
                    (10, "fc2")):
        assert port[i].get_name() == ref.modules[i].get_name() == name
        assert port.find(name) is port[i]
    load_jax_params(port, params)
    assert_trees_close(port.get_parameters(), params, atol=0.0)


def test_lenet_default_device_is_the_card():
    if torch.cuda.is_available():
        assert next(LeNet5().parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LeNet5()


def test_lenet_forward_and_gradients_match_jax():
    """The forward within 1e-5; parameter and input gradients within
    1e-4 of the JAX value (plus 1e-6 absolute for gradients near 0)."""
    ref, params = _jax_lenet(1)
    x, _ = _rows(6, 2)
    port = _port_lenet(params)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.apply(jax.tree.map(jnp.asarray, params),
                                ref.get_state(), jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert_parity(ref, port, x, atol=1e-6, rtol=1e-4)


def _samples(sample, x, y):
    return [sample(x[i], y[i]) for i in range(len(x))]


def _recorder(trigger_cls, record, steps):
    """An end trigger that stops after ``steps`` iterations and records,
    at each check, the last step's loss and the last validation score."""
    def fn(state):
        record[state["neval"]] = (state.get("Loss"), state.get("score"))
        return state["neval"] > steps
    return trigger_cls(fn)


def test_five_sgd_steps_with_validation_match_jax():
    """16 rows in batches of 8: an epoch every two steps, so validation
    (Top1, Top5, Loss on 12 held-out rows) runs after steps 2 and 4, and
    steps 3-5 train on reshuffled epochs."""
    ref, params = _jax_lenet(3)
    port = _port_lenet(params)
    (x, y), (vx, vy) = _rows(16, 4), _rows(12, 5)
    kw = dict(learning_rate=0.05, momentum=0.9)

    JaxRandomGenerator.set_seed(6)
    j_rec = {}
    j_opt = joptim.LocalOptimizer(
        ref, JaxDataSet.array(_samples(JaxSample, x, y))
        .transform(JaxSampleToMiniBatch(8)), jnn.ClassNLLCriterion(),
        batch_size=8)
    j_opt.set_optim_method(joptim.SGD(**kw))
    j_opt.set_validation(joptim.every_epoch(),
                         JaxDataSet.array(_samples(JaxSample, vx, vy)),
                         [joptim.Top1Accuracy(), joptim.Top5Accuracy(),
                          joptim.Loss()], batch_size=8)
    j_opt.set_end_when(_recorder(JaxTrigger, j_rec, 5))
    j_opt.optimize()

    RandomGenerator.set_seed(6)
    p_rec = {}
    p_opt = optim.LocalOptimizer(
        port, DataSet.array(_samples(Sample, x, y))
        .transform(SampleToMiniBatch(8)), nn.ClassNLLCriterion(),
        batch_size=8)
    p_opt.set_optim_method(optim.SGD(**kw))
    p_opt.set_validation(optim.every_epoch(),
                         DataSet.array(_samples(Sample, vx, vy)),
                         [optim.Top1Accuracy(), optim.Top5Accuracy(),
                          optim.Loss()], batch_size=8)
    p_opt.set_end_when(_recorder(optim.Trigger, p_rec, 5))
    p_opt.optimize()

    assert sorted(p_rec) == sorted(j_rec) == [1, 2, 3, 4, 5, 6]
    for n in range(2, 7):
        (pl, ps), (jl, js) = p_rec[n], j_rec[n]
        np.testing.assert_allclose(pl, jl, rtol=RTOL, err_msg=f"loss {n}")
        assert (ps is None) == (js is None) == (n < 3)
        if js is not None:
            np.testing.assert_allclose(ps, js, rtol=RTOL)
    assert (p_opt.driver_state["epoch"], p_opt.driver_state["neval"]) == \
        (j_opt.driver_state["epoch"], j_opt.driver_state["neval"]) == (3, 6)
    assert len(p_opt.validation_history) == 2
    assert list(p_opt.validation_history[-1]) == ["Top1Accuracy",
                                                  "Top5Accuracy", "Loss"]
    assert port.is_training()
    assert_trees_close(port.get_parameters(), ref.get_parameters(),
                       atol=1e-5, rtol=1e-4)


def test_max_score_ends_training_after_a_validation():
    _, params = _jax_lenet(7)
    (x, y) = _rows(16, 8)
    opt = optim.LocalOptimizer(
        _port_lenet(params), DataSet.array(_samples(Sample, x, y))
        .transform(SampleToMiniBatch(8)), nn.ClassNLLCriterion(),
        batch_size=8)
    opt.set_validation(optim.every_epoch(), DataSet.array(
        _samples(Sample, x, y)), [optim.Top1Accuracy()])
    opt.set_end_when(optim.max_score(-1.0).or_(optim.max_epoch(5)))
    opt.optimize()
    assert opt.driver_state["neval"] == 3     # the first validation ends it
    assert opt.driver_state["score"] == \
        opt.validation_history[0]["Top1Accuracy"]


@pytest.mark.parametrize("batch_size", [8, 6])
def test_evaluator_and_predictor_match_jax(batch_size):
    """20 rows: the last batch is partial at both sizes, and is padded
    to the batch size by ``pad_rows``."""
    ref, params = _jax_lenet(9)
    port = _port_lenet(params)
    x, y = _rows(20, 10)
    methods = ("Top1Accuracy", "Top5Accuracy", "Loss")
    want = joptim.Evaluator(ref).test(
        _samples(JaxSample, x, y), [getattr(joptim, m)() for m in methods],
        batch_size=batch_size)
    got = optim.Evaluator(port).test(
        _samples(Sample, x, y), [getattr(optim, m)() for m in methods],
        batch_size=batch_size)
    assert list(got) == list(want) == list(methods)
    for m in methods[:2]:
        assert got[m].result() == want[m].result()
    np.testing.assert_allclose(got["Loss"].result()[0],
                               want["Loss"].result()[0], rtol=RTOL)
    j_pred = joptim.LocalPredictor(ref)
    p_pred = optim.LocalPredictor(port)
    got_rows = p_pred.predict(_samples(Sample, x, y), batch_size)
    want_rows = j_pred.predict(_samples(JaxSample, x, y), batch_size)
    assert len(got_rows) == len(want_rows) == 20
    np.testing.assert_allclose(np.stack(got_rows), np.stack(want_rows),
                               atol=1e-5)
    classes = p_pred.predict_class(_samples(Sample, x, y), batch_size)
    assert classes == j_pred.predict_class(_samples(JaxSample, x, y),
                                           batch_size)
    assert classes == [int(np.argmax(r)) + 1 for r in got_rows]
    ds = DataSet.array(_samples(Sample, x, y)).transform(
        SampleToMiniBatch(batch_size))
    assert port.evaluate_on(ds, [optim.Top1Accuracy()], batch_size)[
        "Top1Accuracy"].result() == got["Top1Accuracy"].result()
    assert [int(np.argmax(r)) + 1 for r in port.predict(
        ds, batch_size)] == classes


def test_pad_rows():
    a = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(pad_rows(a, 5)[3:], [[4, 5], [4, 5]])
    assert pad_rows(a, 3) is a
    with pytest.raises(ValueError):
        pad_rows(a, 2)


def _idx(path, arr, dims_type=0x08):
    head = bytes([0, 0, dims_type, arr.ndim]) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_mnist_reader_and_cli_arrays_match_jax(tmp_path, suffix):
    r = np.random.RandomState(11)
    for prefix, n in (("train", 5), ("t10k", 3)):
        _idx(tmp_path / f"{prefix}-images-idx3-ubyte{suffix}",
             r.randint(0, 256, (n, 28, 28)))
        _idx(tmp_path / f"{prefix}-labels-idx1-ubyte{suffix}",
             r.randint(0, 10, n))
    paths = [str(tmp_path / f"train-{k}-ubyte{suffix}")
             for k in ("images-idx3", "labels-idx1")]
    for g, w in zip(load_mnist(*paths), jax_load_mnist(*paths)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for train in (True, False):
        for g, w in zip(_cli.mnist_arrays(str(tmp_path), train),
                        jax_cli.mnist_arrays(str(tmp_path), train)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        _idx(tmp_path / "bad", np.zeros(3), dims_type=0x0D)
        load_mnist(str(tmp_path / "bad"), str(tmp_path / "bad"))


@pytest.mark.parametrize("train", [True, False])
def test_cli_synthetic_rows_are_the_jax_package_bitwise(train):
    got = _cli.mnist_arrays("./", train, synthetic=300)
    want = jax_cli.mnist_arrays("./", train, synthetic=300)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_train_and_test_cli_run_on_cpu(capsys):
    model = lenet_train.main(["--synthetic", "256", "-b", "64", "-e", "1",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "throughput:" in out
    assert "validation: Top1Accuracy" in out
    assert next(model.parameters()).device.type == "cpu"
    loss = float(out.split("final loss:")[1].split()[0])
    assert np.isfinite(loss)
    results = lenet_test.main(["--synthetic", "256", "-b", "64",
                               "--device", "cpu"])
    assert list(results) == ["Top1Accuracy", "Top5Accuracy"]
    assert results["Top1Accuracy"].result()[1] == 256
    assert "Top5Accuracy: Accuracy(" in capsys.readouterr().out


def test_train_and_test_cli_match_jax(monkeypatch):
    """Both recipes' ``train.main`` at ``--synthetic 256 -e 1`` from the
    JAX recipe's initial weights and the same shuffle seed: the final
    loss within 1e-5 relative; then each ``test.main`` on its own
    recipe's trained model: Top1 and Top5 exactly."""
    import bigdl_tpu.optim as jax_optim_pkg
    import bigdl_tpu_torch.optim as port_optim_pkg

    argv = ["--synthetic", "256", "-b", "64", "-e", "1"]
    opts, built = {}, {}

    def recording(pkg, key):
        class Recorded(pkg.LocalOptimizer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                opts[key] = self
        monkeypatch.setattr(pkg, "LocalOptimizer", Recorded)

    def jax_build(args, build):
        model = build().ensure_initialized()
        built["params"] = jax.tree.map(np.asarray, model.get_parameters())
        built["jax"] = model
        JaxRandomGenerator.set_seed(11)
        return model

    def port_build(args, build):
        model = build().set_parameters(built["params"])
        built["port"] = model
        RandomGenerator.set_seed(11)
        return model

    recording(jax_optim_pkg, "jax")
    recording(port_optim_pkg, "port")
    monkeypatch.setattr(jax_cli, "load_model_or", jax_build)
    monkeypatch.setattr(_cli, "load_model_or", port_build)
    from bigdl_tpu.models.lenet import test as jax_lenet_test
    from bigdl_tpu.models.lenet import train as jax_lenet_train
    jax_lenet_train.main(argv)
    lenet_train.main(argv + ["--device", "cpu"])
    j_state, p_state = opts["jax"].driver_state, opts["port"].driver_state
    assert (p_state["epoch"], p_state["neval"]) == \
        (j_state["epoch"], j_state["neval"])
    np.testing.assert_allclose(p_state["Loss"], j_state["Loss"], rtol=RTOL)

    monkeypatch.setattr(jax_cli, "load_model_or",
                        lambda args, build: built["jax"])
    monkeypatch.setattr(_cli, "load_model_or",
                        lambda args, build: built["port"])
    want = jax_lenet_test.main(argv[:4])
    got = lenet_test.main(argv[:4] + ["--device", "cpu"])
    assert list(got) == list(want) == ["Top1Accuracy", "Top5Accuracy"]
    for name in want:
        assert got[name].result() == tuple(want[name].result()), name


@pytest.mark.parametrize("flags", [["-g"]])
def test_cli_unported_flags_raise(flags):
    """``-g`` raised until the Graph was ported; it now trains the
    Graph form of LeNet-5."""
    model = lenet_train.main(["--synthetic", "16", "--device", "cpu"]
                             + flags)
    assert type(model).__name__ == "Graph"


def test_cli_without_mnist_exits_naming_synthetic(tmp_path, monkeypatch):
    # the recipes download a missing corpus: a mirror that has nothing
    # stands in for an offline host (no network is touched)
    from bigdl_tpu_torch.dataset import fetch
    monkeypatch.setattr(fetch, "MNIST_URL",
                        (tmp_path / "no-mirror").as_uri() + "/")
    with pytest.raises(SystemExit, match="--synthetic"):
        lenet_train.main(["-f", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--synthetic"):
        lenet_test.main(["-f", str(tmp_path), "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []     # nothing was downloaded


def test_cli_parsers_take_the_jax_flags():
    args = _cli.base_parser("x").parse_args(
        ["-f", "d", "-b", "3", "-e", "2", "-r", "0.1", "-d", "0.01",
         "--maxIterations", "4", "--synthetic", "9"])
    want = jax_cli.base_parser("x").parse_args(
        ["-f", "d", "-b", "3", "-e", "2", "-r", "0.1", "-d", "0.01",
         "--maxIterations", "4", "--synthetic", "9"])
    for k in ("folder", "batchSize", "maxEpoch", "learningRate",
              "learningRateDecay", "maxIterations", "synthetic"):
        assert getattr(args, k) == getattr(want, k)
    assert args.device == "cuda"
    assert isinstance(args, argparse.Namespace)
