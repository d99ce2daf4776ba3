"""Checkpoints and saved modules, the port against the JAX package: a
run checkpointed by either package resumes in the other, the format-2
checkpoint's integrity rules (the reference cases of
``tests/test_serialization.py`` that apply to local paths), the module
serializer in both directions, ``ModelRegistry.load(path=)`` and the
recipes' snapshot flags.

Tolerances: resumed runs' losses within 1e-5 relative of each other
(float32 LeNet-5, the same steps from the same state); a module loaded
in the other package within 1e-6 of the saving package's output,
relative to the output's largest element (max 1); trees round-trip
bitwise."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.models import LeNet5 as JaxLeNet5
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import LeNet5, ResNet, _cli
from bigdl_tpu_torch.models.lenet import test as lenet_test
from bigdl_tpu_torch.models.lenet import train as lenet_train
from bigdl_tpu_torch.serving import InferenceService
from bigdl_tpu_torch.utils import serialization as ser
from bigdl_tpu_torch.utils.module_serializer import from_spec, to_spec
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close, flat, to_jax

RTOL = 1e-5
MODULE_RTOL = 1e-6
BATCH = 8
#: f16_mixed runs: the scale grows every 2 finite steps, so after 3 steps
#: the state is mid-interval (scale 2048, good_steps 1)
F16_SCALER = dict(init_scale=2.0 ** 10, growth_interval=2)


def _rows(n, seed):
    r = np.random.RandomState(seed)
    return (r.standard_normal((n, 1, 28, 28)).astype(np.float32),
            r.randint(1, 11, n).astype(np.float32))


def _recorder(trigger_cls, record, steps):
    """An end trigger after ``steps`` iterations that records each
    step's loss by ``neval``."""
    def fn(state):
        record[state["neval"]] = state.get("Loss")
        return state["neval"] > steps
    return trigger_cls(fn)


def _jax_run(params, rows, ckdir, every, steps, seed, precision=False):
    JaxRandomGenerator.set_seed(seed)
    model = JaxLeNet5(10)
    model.set_parameters(to_jax(params))
    x, y = rows
    opt = joptim.LocalOptimizer(
        model, JaxDataSet.array([JaxSample(x[i], y[i])
                                 for i in range(len(x))])
        .transform(JaxSampleToMiniBatch(BATCH)), jnn.ClassNLLCriterion(),
        batch_size=BATCH)
    opt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_checkpoint(str(ckdir), joptim.several_iteration(every))
    if precision:
        from bigdl_tpu.precision import DynamicLossScaler
        opt.set_precision("f16_mixed", DynamicLossScaler(**F16_SCALER))
    losses = {}
    opt.set_end_when(_recorder(JaxTrigger, losses, steps))
    opt.optimize()
    return opt, losses


def _port_run(params, rows, ckdir, every, steps, seed, precision=False):
    RandomGenerator.set_seed(seed)
    model = LeNet5(10, device="cpu").set_parameters(params)
    x, y = rows
    opt = optim.LocalOptimizer(
        model, DataSet.array([Sample(x[i], y[i]) for i in range(len(x))])
        .transform(SampleToMiniBatch(BATCH)), nn.ClassNLLCriterion(),
        batch_size=BATCH)
    opt.set_optim_method(optim.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_checkpoint(str(ckdir), optim.several_iteration(every))
    if precision:
        from bigdl_tpu_torch.precision import DynamicLossScaler
        opt.set_precision("f16_mixed", DynamicLossScaler(**F16_SCALER))
    losses = {}
    opt.set_end_when(_recorder(optim.Trigger, losses, steps))
    opt.optimize()
    return opt, losses


def _start_params():
    return LeNet5(10, device="cpu",
                  generator=torch.Generator().manual_seed(3)).get_parameters()


# ----------------------------------------------------- resume, both ways

def test_a_checkpoint_of_either_package_resumes_in_the_other(tmp_path):
    """Each package trains LeNet-5 (SGD with momentum, 32 rows in
    batches of 8) for 4 steps from the same weights, checkpointing every
    2: ``checkpoint.2`` and ``checkpoint.4``. The JAX package's reader
    loads the port's, in the JAX trees' full shape. Then the JAX
    LocalOptimizer resumes from the port's checkpoint and the port from
    the JAX package's, each for steps 4-8 (an epoch rollover and a
    reshuffle from one seed among them): the losses agree step for
    step, and so do the final parameters."""
    params, rows = _start_params(), _rows(32, 4)
    _port_run(params, rows, tmp_path / "p", 2, 4, seed=5)
    _jax_run(params, rows, tmp_path / "j", 2, 4, seed=5)
    for d in ("p", "j"):
        assert sorted(os.listdir(tmp_path / d)) == ["checkpoint.2",
                                                    "checkpoint.4"]
    ck = jser.load_checkpoint(str(tmp_path / "p" / "checkpoint.4"))
    want = jser.load_checkpoint(str(tmp_path / "j" / "checkpoint.4"))
    assert ck["driver_state"]["neval"] == 4
    assert ck["params"].keys() == want["params"].keys()
    assert ck["model_state"] == want["model_state"] == {
        str(i): {} for i in range(12)}
    assert ck["opt_state"].keys() == want["opt_state"].keys() == {"v"}
    assert_trees_close(ck["opt_state"]["v"], want["opt_state"]["v"], 1e-6)
    assert ck["optim_host_state"] == want["optim_host_state"]

    j_opt, j_losses = _jax_run(params, rows, tmp_path / "p", 1000, 8, 6)
    p_opt, p_losses = _port_run(params, rows, tmp_path / "j", 1000, 8, 6)
    assert p_opt.resumed_from["neval"] == 4
    assert sorted(j_losses) == sorted(p_losses) == [4, 5, 6, 7, 8, 9]
    for n in range(5, 10):
        np.testing.assert_allclose(p_losses[n], j_losses[n], rtol=RTOL,
                                   err_msg=f"loss at neval {n}")
    assert p_opt.driver_state["epoch"] == j_opt.driver_state["epoch"] == 3
    assert_trees_close(p_opt.model.get_parameters(),
                       j_opt.model.get_parameters(), atol=1e-5, rtol=1e-4)


def test_resume_continues_a_port_run(tmp_path):
    """Four steps straight against two, a resume and two more, in the
    port: each epoch is one batch of the same 8 rows, so the losses agree
    within 1e-5 relative and the parameters within 1e-6 (the resumed
    run's shuffles, from a fresh seed, order the rows otherwise, and the
    sums round otherwise)."""
    params, rows = _start_params(), _rows(BATCH, 7)
    straight, s_losses = _port_run(params, rows, tmp_path / "a", 1000, 4, 8)
    _port_run(params, rows, tmp_path / "b", 2, 2, 8)
    resumed, r_losses = _port_run(params, rows, tmp_path / "b", 1000, 4, 8)
    assert resumed.resumed_from["path"].endswith("checkpoint.2")
    assert sorted(r_losses) == [2, 3, 4, 5]
    for n in (2, 3, 4, 5):
        np.testing.assert_allclose(r_losses[n], s_losses[n], rtol=RTOL)
    assert_trees_close(resumed.model.get_parameters(),
                       straight.model.get_parameters(), atol=1e-6)


def test_f16_mixed_checkpoints_resume_across_packages(tmp_path):
    """f16_mixed LeNet-5 (3 steps of 8 rows, a checkpoint after step 3)
    in each package: the checkpoints carry the float32 master copy and the
    scaler state under the JAX package's keys, with equal scaler states.
    The JAX package resumes from the port's checkpoint and the port from
    the JAX package's, each for 2 steps, against the writer package's
    own resumed continuation: losses within 1e-3
    relative and parameters within 1e-3 (float16 compute in both; the
    two packages' float16 convolutions round differently)."""
    import shutil

    from bigdl_tpu_torch.precision import MASTER_KEY, SCALER_KEY
    params, rows = _start_params(), _rows(32, 4)
    _port_run(params, rows, tmp_path / "p", 4, 3, seed=5, precision=True)
    _jax_run(params, rows, tmp_path / "j", 4, 3, seed=5, precision=True)
    cks = {d: jser.load_checkpoint(str(tmp_path / d / "checkpoint.4"))
           for d in ("p", "j")}
    for ck in cks.values():
        assert set(ck["opt_state"]) == {"v", MASTER_KEY, SCALER_KEY}
        assert_trees_close(ck["opt_state"][MASTER_KEY], params, atol=0.5)
        master_dtypes = {np.asarray(a).dtype for a in
                         flat(ck["opt_state"][MASTER_KEY]).values()}
        assert master_dtypes == {np.dtype(np.float32)}
        assert {np.asarray(a).dtype for a in flat(ck["params"]).values()} \
            == {np.dtype(np.float16)}
    for k in ("scale", "good_steps", "skipped"):
        assert np.asarray(cks["p"]["opt_state"][SCALER_KEY][k]).tobytes() \
            == np.asarray(cks["j"]["opt_state"][SCALER_KEY][k]).tobytes()
    assert float(cks["p"]["opt_state"][SCALER_KEY]["scale"]) == 2048.0

    runs = {}
    for writer in ("p", "j"):
        for reader, run in (("port", _port_run), ("jax", _jax_run)):
            d = tmp_path / f"{writer}-{reader}"
            shutil.copytree(tmp_path / writer, d)
            runs[(writer, reader)] = run(params, rows, d, 1000, 5, 6,
                                         precision=True)
    for writer, own in (("p", "port"), ("j", "jax")):
        other = "jax" if own == "port" else "port"
        (o_own, l_own), (o_other, l_other) = runs[(writer, own)], \
            runs[(writer, other)]
        assert sorted(l_own) == sorted(l_other) == [4, 5, 6]
        for n in (5, 6):
            np.testing.assert_allclose(l_other[n], l_own[n], rtol=1e-3,
                                       err_msg=f"{writer}: loss {n}")
        assert_trees_close(o_other.model.get_parameters(),
                           o_own.model.get_parameters(), atol=1e-3)
    assert runs[("j", "port")][0].resumed_from["neval"] == 4
    for p in runs[("j", "port")][0].model.parameters():
        assert p.dtype == torch.float32     # the master, at the end


# ------------------------------------------- the format-2 checkpoint rules

def _save_ck(path, neval, val=1.0):
    ser.save_checkpoint(str(path), params={"w": np.full(3, val, np.float32)},
                        opt_state={}, model_state={}, optim_host_state={},
                        driver_state={"neval": neval})


def test_checkpoint_atomic_write_and_manifest(tmp_path):
    _save_ck(tmp_path / "checkpoint.2", 2, 1.0)
    _save_ck(tmp_path / "checkpoint.4", 4, 2.0)
    with open(tmp_path / "checkpoint.4" / ser.MANIFEST) as f:
        manifest = json.load(f)
    assert manifest["format"] == 2 and manifest["neval"] == 4
    assert sorted(manifest["sha256"]) == sorted(manifest["files"])
    assert [n for n in os.listdir(tmp_path)
            if ".tmp-" in n or ".old-" in n] == []
    latest = ser.find_latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint.4")
    assert ser.load_checkpoint(latest)["params"]["w"][0] == 2.0
    # the JAX package reads it, and the port reads the JAX package's
    assert jser.load_checkpoint(latest)["params"]["w"][0] == 2.0
    jser.save_checkpoint(str(tmp_path / "checkpoint.6"),
                         params={"w": np.full(3, 3.0, np.float32)},
                         opt_state={}, model_state={}, optim_host_state={},
                         driver_state={"neval": 6})
    assert ser.load_checkpoint(
        ser.find_latest_checkpoint(str(tmp_path)))["params"]["w"][0] == 3.0


def test_torn_and_stray_dirs(tmp_path):
    """A staging dir without a MANIFEST is never selected; a complete
    one (a crash before the final rename) is."""
    _save_ck(tmp_path / "checkpoint.2", 2, 1.0)
    _save_ck(tmp_path / "checkpoint.6", 6, 3.0)
    (tmp_path / "checkpoint.6" / ser.MANIFEST).unlink()
    (tmp_path / "checkpoint.6").rename(tmp_path / "checkpoint.6.tmp-42")
    assert ser.find_latest_checkpoint(str(tmp_path)).endswith(
        "checkpoint.2")
    _save_ck(tmp_path / "checkpoint.8", 8, 4.0)
    (tmp_path / "checkpoint.8").rename(tmp_path / "checkpoint.8.tmp-999")
    latest = ser.find_latest_checkpoint(str(tmp_path))
    assert ".tmp-999" in latest
    assert ser.load_checkpoint(latest)["driver_state"]["neval"] == 8


@pytest.mark.parametrize("fmt", [0, 1])
def test_format0_and_format1_checkpoints_load(tmp_path, fmt):
    _save_ck(tmp_path / "checkpoint.4", 4, 2.0)
    mpath = tmp_path / "checkpoint.4" / ser.MANIFEST
    if fmt == 0:
        mpath.unlink()              # written before the MANIFEST existed
    else:
        manifest = json.loads(mpath.read_text())
        del manifest["sha256"]      # written before the digests existed
        manifest["format"] = 1
        mpath.write_text(json.dumps(manifest))
    latest = ser.find_latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint.4")
    ser.verify_checkpoint(latest)
    assert ser.load_checkpoint(latest)["params"]["w"][0] == 2.0


def test_overwrite_replaces_complete_with_complete(tmp_path):
    _save_ck(tmp_path / "checkpoint", 2, 1.0)
    _save_ck(tmp_path / "checkpoint", 9, 5.0)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint"]
    ck = ser.load_checkpoint(ser.find_latest_checkpoint(str(tmp_path)))
    assert ck["driver_state"]["neval"] == 9 and ck["params"]["w"][0] == 5.0


def test_overwrite_checkpoint_in_the_driver(tmp_path):
    params, rows = _start_params(), _rows(16, 9)
    RandomGenerator.set_seed(1)
    opt = optim.LocalOptimizer(
        LeNet5(10, device="cpu").set_parameters(params),
        DataSet.array([Sample(rows[0][i], rows[1][i]) for i in range(16)])
        .transform(SampleToMiniBatch(BATCH)), nn.ClassNLLCriterion())
    opt.set_checkpoint(str(tmp_path), optim.several_iteration(1))
    opt.overwrite_checkpoint().set_end_when(optim.max_iteration(3))
    opt.optimize()
    assert os.listdir(tmp_path) == ["checkpoint"]
    assert ser.load_checkpoint(str(tmp_path / "checkpoint"))[
        "driver_state"]["neval"] == 4


def test_a_corrupt_npz_raises_and_loads_with_verify_off(tmp_path):
    """Bit rot after the MANIFEST landed: the digest catches it, and
    ``verify=False`` reads what is there."""
    _save_ck(tmp_path / "checkpoint.2", 2, 1.0)
    with open(tmp_path / "checkpoint.2" / "params.npz", "wb") as f:
        np.savez(f, w=np.full(3, 7.0, np.float32))
    with pytest.raises(ser.CheckpointCorrupt, match="params.npz"):
        ser.load_checkpoint(str(tmp_path / "checkpoint.2"))
    with pytest.raises(jser.CheckpointCorrupt, match="params.npz"):
        jser.load_checkpoint(str(tmp_path / "checkpoint.2"))
    loaded = ser.load_checkpoint(str(tmp_path / "checkpoint.2"),
                                 verify=False)
    assert loaded["params"]["w"][0] == 7.0


def test_a_missing_file_is_corrupt(tmp_path):
    _save_ck(tmp_path / "checkpoint.2", 2)
    (tmp_path / "checkpoint.2" / "opt_state.npz").unlink()
    with pytest.raises(ser.CheckpointCorrupt, match="opt_state.npz"):
        ser.verify_checkpoint(str(tmp_path / "checkpoint.2"))


def test_quarantine_and_walk_back(tmp_path):
    """A corrupt newest checkpoint is quarantined by a fresh
    ``optimize()``, which resumes from the one before; quarantined dirs
    are never selected again."""
    params, rows = _start_params(), _rows(16, 10)
    _port_run(params, rows, tmp_path, 2, 4, seed=11)
    npz = tmp_path / "checkpoint.4" / "params.npz"
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    opt, losses = _port_run(params, rows, tmp_path, 1000, 3, seed=11)
    assert opt.resumed_from["path"].endswith("checkpoint.2")
    assert sorted(losses) == [2, 3, 4]
    quarantined = [n for n in os.listdir(tmp_path) if ".corrupt-" in n]
    assert len(quarantined) == 1 and "checkpoint.4" in quarantined[0]
    assert ser.find_latest_checkpoint(str(tmp_path)).endswith(
        "checkpoint.2")


def test_format3_and_remote_paths_are_not_ported(tmp_path):
    _save_ck(tmp_path / "checkpoint.2", 2)
    mpath = tmp_path / "checkpoint.2" / ser.MANIFEST
    manifest = json.loads(mpath.read_text())
    manifest["format"] = 3
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(NotImplementedError, match="format 3"):
        ser.load_checkpoint(str(tmp_path / "checkpoint.2"))
    with pytest.raises(NotImplementedError, match="remote"):
        ser.load_checkpoint("s3://bucket/checkpoint.2")
    with pytest.raises(NotImplementedError, match="item 12"):
        optim.LocalOptimizer(nn.Linear(2, 2), None, nn.ClassNLLCriterion()) \
            .set_checkpoint(str(tmp_path), optim.every_epoch(), keep_last=2)


# ----------------------------------------------------------- saved modules

def _lenet():
    return LeNet5(10, device="cpu",
                  generator=torch.Generator().manual_seed(12))


def _resnet20():
    return ResNet(10, depth=20, dataset="CIFAR10", device="cpu",
                  generator=torch.Generator().manual_seed(13))


_MODELS = {"lenet5": (_lenet, (4, 1, 28, 28),
                      lambda: JaxLeNet5(10)),
           "resnet20": (_resnet20, (4, 3, 32, 32),
                        lambda: JaxResNet(10, depth=20, dataset="CIFAR10"))}


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_RTOL * scale)


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_a_module_saved_by_the_port_loads_in_the_jax_package(tmp_path, name):
    build, shape, _ = _MODELS[name]
    port = build().eval()
    port[1].set_name("first").set_scale_w(0.5)
    ser.save_module(str(tmp_path / "m"), port)
    loaded = jser.load_module(str(tmp_path / "m"))
    assert type(loaded).__name__ == "Sequential"
    assert loaded.modules[1].get_name() == "first"
    assert loaded.modules[1].scale_w == 0.5
    assert not loaded.train_mode and not loaded.modules[1].train_mode
    assert_trees_close(loaded.get_parameters(), port.get_parameters(), 0.0)
    assert_trees_close(loaded.get_state(), port.get_state(), 0.0)
    x = np.random.RandomState(14).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    _close(np.asarray(loaded.forward(x)), want)


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_a_module_saved_by_the_jax_package_loads_in_the_port(tmp_path, name):
    build, shape, jax_build = _MODELS[name]
    JaxRandomGenerator.set_seed(15)
    ref = jax_build()
    ref.set_parameters(to_jax(build().get_parameters()))
    ref.set_state(to_jax(build().get_state()))
    ref.modules[1].set_name("first")
    ref.evaluate()
    jser.save_module(str(tmp_path / "m"), ref)
    port = ser.load_module(str(tmp_path / "m"), device="cpu")
    assert type(port).__name__ == "Sequential" and not port.training
    assert port[1].get_name() == "first" and not port[1].training
    assert_trees_close(port.get_parameters(), ref.get_parameters(), 0.0)
    assert_trees_close(port.get_state(), ref.get_state(), 0.0)
    x = np.random.RandomState(16).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(ref.forward(x)))


def test_specs_round_trip_and_graphs_are_not_ported():
    """A spec round-trips; a Graph spec (once refused, now ported)
    builds a Graph whose spec is the same."""
    port = _resnet20()
    spec = to_spec(port)
    assert json.loads(json.dumps(spec)) == spec
    assert to_spec(from_spec(spec)) == spec
    assert "generator" not in json.dumps(spec)
    graph = {"class": "Graph", "nodes": [{"class": "Input"},
                                         {"class": "Tanh"}],
             "edges": [[0, 1, None]], "inputs": [0], "outputs": [1]}
    built = from_spec(graph)
    assert type(built).__name__ == "Graph"
    assert to_spec(built) == {**graph, "nodes": [
        {"class": c, "args": [], "kwargs": {}} for c in ("Input", "Tanh")]}


def test_model_registry_serves_a_saved_module(tmp_path):
    saved = _resnet20().eval()
    ser.save_module(str(tmp_path / "r20"), saved)
    svc = InferenceService(device="cpu")
    try:
        servable = svc.load("r20", path=str(tmp_path / "r20"))
        assert not servable.model.training
        x = np.random.RandomState(17).standard_normal(
            (3, 3, 32, 32)).astype(np.float32)
        with torch.no_grad():
            want = saved(torch.from_numpy(x)).numpy()
        _close(svc.predict_batch("r20", x), want)
    finally:
        svc.shutdown()


# ------------------------------------------------------- the recipes' flags

def test_lenet_recipe_snapshot_flags(tmp_path, capsys, monkeypatch):
    """``--checkpoint`` writes a checkpoint every epoch and a second call
    resumes from the newest, printing its neval; ``--model`` starts from
    a saved module (and ``test.main`` scores it); ``--state`` seeds the
    optim method's state from a pickle."""
    opts, starts = [], []

    class Recorded(optim.LocalOptimizer):
        def __init__(self, model, *a, **kw):
            super().__init__(model, *a, **kw)
            opts.append(self)
            starts.append(model.get_parameters())

    monkeypatch.setattr(optim, "LocalOptimizer", Recorded)
    base = ["--synthetic", "32", "-b", "16", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    lenet_train.main(base + ["-e", "1", "--checkpoint", ck])
    assert os.listdir(ck) == ["checkpoint.3"]
    trained = lenet_train.main(base + ["-e", "2", "--checkpoint", ck])
    assert "checkpoint.3 at neval 3" in capsys.readouterr().out
    assert sorted(os.listdir(ck)) == ["checkpoint.3", "checkpoint.5"]
    assert [h["neval"] for h in opts[-1].history] == [3, 4]

    ser.save_module(str(tmp_path / "m"), trained)
    lenet_train.main(base + ["-e", "1", "--model", str(tmp_path / "m")])
    assert_trees_close(starts[-1], trained.get_parameters(), 0.0)
    results = lenet_test.main(base + ["--model", str(tmp_path / "m")])
    want = optim.Evaluator(trained).test(
        _cli.arrays_to_dataset(*_cli.mnist_arrays("", False, 32), 16),
        [optim.Top1Accuracy()], 16)
    assert results["Top1Accuracy"].result() == \
        want["Top1Accuracy"].result()

    with open(tmp_path / "state.pkl", "wb") as f:
        pickle.dump({"evalCounter": 7}, f)
    lenet_train.main(base + ["-e", "1", "--state",
                             str(tmp_path / "state.pkl")])
    assert opts[-1].optim_method.state["evalCounter"] == 9
