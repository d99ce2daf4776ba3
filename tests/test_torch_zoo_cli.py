"""The zoo's command lines on the CPU: the vgg, inception and autoencoder
train and test mains at ``--synthetic`` sizes of a few batches,
``VggForCifar10`` checkpoints across the two packages,
``python -m bigdl_tpu_torch.tools.perf`` against the JAX tool's JSON
tail, and the flags that are not ported yet.

Tolerances: a checkpoint's model loaded by the other package gives the
saving package's evaluation output within 1e-5 absolute
(log-probabilities; the same weights, float32); trees bitwise."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.models import VggForCifar10 as JaxVggForCifar10
from bigdl_tpu.tools import perf as jax_perf
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu_torch.models import VggForCifar10
from bigdl_tpu_torch.models.autoencoder import test as ae_test
from bigdl_tpu_torch.models.autoencoder import train as ae_train
from bigdl_tpu_torch.models.inception import test as inception_test
from bigdl_tpu_torch.models.inception import train as inception_train
from bigdl_tpu_torch.models.resnet import train as resnet_train
from bigdl_tpu_torch.models.vgg import test as vgg_test
from bigdl_tpu_torch.models.vgg import train as vgg_train
from bigdl_tpu_torch.nn.quantized import quantize
from bigdl_tpu_torch.optim import Evaluator, Top1Accuracy
from bigdl_tpu_torch.tools import perf
from bigdl_tpu_torch.utils import serialization as ser

from _torch_parity import assert_trees_close, jax_eval, to_jax

ATOL = 1e-5
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The recipes' many small ops on one intra-op thread: beside the
    other test workers, a thread team's barriers wait on descheduled
    threads (the VGG recipe test took 120 s so, 5 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _final_loss(out: str) -> float:
    line = [x for x in out.splitlines() if x.startswith("final loss:")]
    assert len(line) == 1, out
    return float(line[0].split(":")[1])


def _rows(seed, n=4):
    return np.random.RandomState(seed).rand(n, 3, 32, 32).astype(np.float32)


def _eval(model, x):
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------- the recipes

def test_vgg_recipe_checkpoints_resumes_and_tests(tmp_path, capsys):
    """``vgg.train`` writes a checkpoint an epoch and resumes from the
    newest; ``vgg.test --model`` scores a saved module, float and int8
    (``--quantize`` scores the rewrite: the same Top1 as an Evaluator
    over ``quantize(model)``)."""
    ck = str(tmp_path / "ck")
    base = ["--synthetic", "16", "-b", "8"] + CPU + ["--checkpoint", ck]
    model = vgg_train.main(base + ["-e", "1"])
    out = capsys.readouterr().out
    assert np.isfinite(_final_loss(out))
    assert "validation: Top1Accuracy" in out
    assert os.listdir(ck) == ["checkpoint.3"]
    vgg_train.main(base + ["-e", "2"])
    out = capsys.readouterr().out
    assert f"resumed from {ck}/checkpoint.3 at neval 3" in out
    assert sorted(os.listdir(ck)) == ["checkpoint.3", "checkpoint.5"]

    saved = str(tmp_path / "m")
    ser.save_module(saved, model.eval())
    results = vgg_test.main(["--synthetic", "16", "-b", "8", "--model",
                             saved] + CPU)
    q = vgg_test.main(["--synthetic", "16", "-b", "8", "--model", saved,
                       "--quantize"] + CPU)
    out = capsys.readouterr().out
    assert out.count("Top1Accuracy") == 2 and out.count("Top5Accuracy") == 2
    from bigdl_tpu_torch.models._cli import arrays_to_dataset, cifar10_arrays
    ds = arrays_to_dataset(*cifar10_arrays("./", False, 16), 8)
    want = Evaluator(quantize(ser.load_module(saved, device="cpu")
                              .eval())).test(ds, [Top1Accuracy()], 8)
    assert q["Top1Accuracy"].result() == want["Top1Accuracy"].result()
    assert results["Top1Accuracy"].result()[1] == 16


def test_inception_recipes_run_and_need_synthetic_rows(capsys):
    model = inception_train.main(["--synthetic", "4", "-b", "2", "-e", "1",
                                  "--classNum", "10"] + CPU)
    assert np.isfinite(_final_loss(capsys.readouterr().out))
    assert model.find("inception_5b/output") is not None
    res = inception_test.main(["--synthetic", "4", "-b", "2", "--classNum",
                               "10", "--quantize"] + CPU)
    assert res["Top5Accuracy"].result()[1] == 4
    # without --synthetic the mains read the -f folder, as the JAX
    # package's do: a missing one raises
    for main in (inception_train.main, inception_test.main):
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            main(["-f", "/nonexistent/imagenet"] + CPU)


def test_autoencoder_recipe_loss_falls(capsys):
    ae_train.main(["--synthetic", "600", "-e", "1"] + CPU)
    first = _final_loss(capsys.readouterr().out)
    model = ae_train.main(["--synthetic", "600", "-e", "3"] + CPU)
    assert _final_loss(capsys.readouterr().out) < first
    res = ae_test.main(["--synthetic", "300"] + CPU)
    assert "Loss" in capsys.readouterr().out
    assert 0.0 < res["Loss"].result()[0] < 1.0
    assert model[4].__class__.__name__ == "Sigmoid"


@pytest.mark.parametrize("main,flag", [
    (inception_train.main, ["--quantize"]),
    (inception_train.main, ["--depth", "50"]),
    (inception_train.main, ["--nesterov"]),
    (resnet_train.main, ["--quantize"]),
    (vgg_train.main, ["--quantize"]),
    (ae_train.main, ["--quantize"])])
def test_train_mains_refuse_flags_they_do_not_read(main, flag):
    """Only the test mains take ``--quantize``; ``--depth`` and
    ``--nesterov`` are ResNet's: argparse refuses them."""
    with pytest.raises(SystemExit) as e:
        main(["--synthetic", "4"] + flag + CPU)
    assert e.value.code == 2


# ------------------------------------------------ checkpoints, both ways

def test_a_vgg_checkpoint_of_either_package_loads_in_the_other(tmp_path):
    """The port's recipe checkpoint read by the JAX package's reader
    builds a JAX ``VggForCifar10`` that scores as the port's model; a
    checkpoint the JAX package writes (its trees, the port run's optim
    and loop state) loads in the port and resumes the port's recipe."""
    ck = tmp_path / "p"
    model = vgg_train.main(["--synthetic", "16", "-b", "8", "-e", "1",
                            "--checkpoint", str(ck)] + CPU)
    got = jser.load_checkpoint(str(ck / "checkpoint.3"))
    assert_trees_close(got["params"], model.get_parameters(), 0.0)
    assert_trees_close(got["model_state"], model.get_state(), 0.0)
    # one JAX model, compiled once, runs both checkpoints' trees
    ref = JaxVggForCifar10(10)
    forward = jax.jit(lambda p, s, a: ref.apply(p, s, a, training=False)[0])
    x = _rows(20)
    np.testing.assert_allclose(
        np.asarray(forward(to_jax(got["params"]),
                           to_jax(got["model_state"]), x)),
        _eval(model, x), rtol=0, atol=ATOL)

    other = VggForCifar10(10, device="cpu",
                          generator=torch.Generator().manual_seed(21))
    j_params = to_jax(other.get_parameters())
    j_state = to_jax(other.get_state())
    jck = tmp_path / "j"
    jser.save_checkpoint(str(jck / "checkpoint.3"), params=j_params,
                         opt_state=got["opt_state"], model_state=j_state,
                         optim_host_state=got["optim_host_state"],
                         driver_state=got["driver_state"])
    loaded = ser.load_checkpoint(str(jck / "checkpoint.3"))
    port = VggForCifar10(10, device="cpu")
    port.set_parameters(loaded["params"]).set_state(loaded["model_state"])
    np.testing.assert_allclose(_eval(port, x),
                               np.asarray(forward(j_params, j_state, x)),
                               rtol=0, atol=ATOL)
    resumed = vgg_train.main(["--synthetic", "16", "-b", "8", "-e", "1",
                              "--checkpoint", str(jck)] + CPU)
    # the run resumed at its end: nothing left to train, the JAX weights
    assert_trees_close(resumed.get_parameters(), other.get_parameters(), 0.0)


def test_a_saved_vgg_module_loads_in_the_jax_package(tmp_path):
    port = VggForCifar10(10, device="cpu",
                         generator=torch.Generator().manual_seed(22)).eval()
    port[0].set_name("first")
    ser.save_module(str(tmp_path / "m"), port)
    loaded = jser.load_module(str(tmp_path / "m"))
    assert loaded.modules[0].get_name() == "first"
    x = _rows(23)
    assert not loaded.is_training()
    np.testing.assert_allclose(jax_eval(loaded, x), _eval(port, x), rtol=0,
                               atol=ATOL)
    jser.save_module(str(tmp_path / "j"), loaded)
    back = ser.load_module(str(tmp_path / "j"), device="cpu")
    assert_trees_close(back.get_parameters(), port.get_parameters(), 0.0)
    assert back[0].get_name() == "first" and not back.training


# --------------------------------------------------------------- the tool

def _tail(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_perf_tail_carries_the_jax_tools_keys(capsys):
    argv = ["--model", "lenet", "--batch-size", "8", "--iterations", "2",
            "--warmup", "1", "--dtype", "f32"]
    tail = perf.main(argv + CPU)
    out = capsys.readouterr().out
    assert _tail(out) == json.loads(json.dumps(tail))
    assert out.splitlines()[0].startswith("# lenet train batch=8 dtype=f32")
    assert sum(x.startswith("iter ") for x in out.splitlines()) == 2
    jax_perf.main(argv)
    want = _tail(capsys.readouterr().out)
    # the JAX tool's fields from its compiled program's cost analysis
    # (MFU, HBM bytes) are replaced by the layer-shape FLOPs
    shared = set(want) - {"achieved_tfs", "mfu_vs_peak",
                          "program_hbm_bytes", "program_flops_per_call"}
    assert shared <= set(tail), shared - set(tail)
    for key in ("tool", "model", "mode", "batch_size", "dtype",
                "steps_per_sync"):
        assert tail[key] == want[key], key
    # LeNet-5 at batch 8: 2 convs and 2 linears, forward and backward
    fwd = 2 * 8 * (6 * 24 * 24 * 25 + 12 * 8 * 8 * 150 + 100 * 192
                   + 10 * 100)
    data_grad = fwd - 2 * 8 * 6 * 24 * 24 * 25
    assert tail["flops_per_iteration"] == 2 * fwd + data_grad


def test_perf_inference_quantized_and_windowed(capsys):
    tail = perf.main(["--model", "lenet", "--mode", "inference",
                      "--quantize", "--kernels", "off", "--iterations",
                      "1", "--warmup", "0"] + CPU)
    assert tail["kernels"] == "off" and tail["kernel_label"] == "reference"
    assert "steps_per_sec" not in tail
    tail = perf.main(["--model", "lenet", "--steps-per-sync", "4",
                      "--iterations", "1", "--warmup", "1",
                      "--precision", "bf16_mixed"] + CPU)
    assert tail["steps_per_sync"] == 4 and tail["dtype"] == "bf16_mixed"
    with pytest.raises(SystemExit):
        perf.main(["--model", "lenet", "--quantize"] + CPU)


@pytest.mark.parametrize("flag,item", [(["--zero", "1"], 11),
                                       (["--metrics-jsonl", "m.jsonl"], 12),
                                       (["--sync-compare"], 14),
                                       (["--config", "tuned.json"], 14)])
def test_perf_flags_not_ported_yet_raise(flag, item):
    """``--zero`` is ported (item 11): in a world of one process it
    trains unsharded and its tail carries the JAX tool's ZeRO keys (the
    launched two-rank world is ``test_torch_launch``'s and chip_smoke's
    phase 22); the other flags still raise naming their item."""
    if flag[0] == "--zero":
        tail = perf.main(["--model", "lenet", "--iterations", "1",
                          "--warmup", "1"] + flag + CPU)
        assert (tail["zero_stage"], tail["zero_devices"]) == (1, 1)
        assert tail["params_bytes_per_chip"] > 0
        assert tail["opt_state_bytes_per_chip"] == \
            tail["params_bytes_per_chip"]      # SGD's momentum, unsharded
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        perf.main(["--model", "lenet"] + flag + CPU)


def test_perf_builds_every_model_of_the_port():
    """Each name the JAX tool takes builds the port's model of the same
    kind and input size (the networks are not run)."""
    want = {"lenet": ("Sequential", (1, 28, 28)),
            "vgg16": ("Sequential", (3, 224, 224)),
            "vgg19": ("Sequential", (3, 224, 224)),
            "resnet18": ("Sequential", (3, 224, 224)),
            "alexnet": ("Sequential", (3, 227, 227)),
            "alexnet_owt": ("Sequential", (3, 224, 224)),
            "inception_v1": ("Sequential", (3, 224, 224)),
            "inception_v2": ("Sequential", (3, 224, 224)),
            "transformer": ("TransformerLM", (512,))}
    for name, (cls, shape) in want.items():
        model, in_shape, _ = perf.build_model(name, device="cpu")
        assert type(model).__name__ == cls and in_shape == shape, name
    with pytest.raises(ValueError, match="unknown model"):
        perf.build_model("nope", device="cpu")
    assert jax.default_backend() == "cpu"
