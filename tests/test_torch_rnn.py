"""The RNN language models and their recipes, the port against the JAX
package: ``SimpleRNN``, ``WordRNN`` and ``PTBModel`` (trees, forwards),
one ``LocalOptimizer`` step of ``SimpleRNN`` and of a 2-layer
``PTBModel``, both ``rnn`` CLIs (a synthetic run from one JAX-written
snapshot; a text corpus with ``--checkpoint``'s ``dictionary.json``,
the perplexity, ``--numOfWords`` and ``--quantize``) and saved modules
both ways.

The port's weights are carried into the JAX models; the JAX side runs
jitted. Tolerances (float32): outputs, losses and parameters within
1e-5 (absolute and relative); the CLIs' perplexity within 1e-5
relative; the JSON bytes and the generated ids equal."""
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
from bigdl_tpu.models import rnn as jax_rnn
from bigdl_tpu.models.rnn import test as jax_test_cli
from bigdl_tpu.models.rnn import train as jax_train_cli
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset.text import ptb_arrays
from bigdl_tpu_torch.models import rnn
from bigdl_tpu_torch.models.rnn import test as test_cli
from bigdl_tpu_torch.models.rnn import train as train_cli
from bigdl_tpu_torch.utils import serialization as ser
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close, flat, jax_eval, to_jax

TOL = 1e-5
VOCAB, HIDDEN, STEPS, BATCH = 24, 8, 5, 8
# the model functions' arguments in both packages (the port adds placement)
SHAPES = {"SimpleRNN": (6, HIDDEN, VOCAB), "WordRNN": (VOCAB, HIDDEN),
          "PTBModel": (VOCAB, HIDDEN, VOCAB, 2)}


def _port(name, seed=3):
    return getattr(rnn, name)(*SHAPES[name], device="cpu",
                              generator=torch.Generator().manual_seed(seed))


def _jax_twin(name, port):
    ref = getattr(jax_rnn, name)(*SHAPES[name])
    ref.set_parameters(to_jax(port.get_parameters()))
    return ref


def _input(name, seed=0, rows=4):
    r = np.random.default_rng(seed)
    if name == "SimpleRNN":
        return r.standard_normal((rows, STEPS, 6)).astype(np.float32)
    return r.integers(1, VOCAB + 1, (rows, STEPS)).astype(np.int64)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_model_trees_and_forwards_equal_jax(name):
    port = _port(name).eval()
    ref = _jax_twin(name, port)
    ref.evaluate()
    assert sorted(flat(port.get_parameters())) == \
        sorted(flat(ref.get_parameters()))
    assert port.get_state() == jax.tree.map(np.asarray, ref.get_state())
    x = _input(name)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_eval(ref, x), atol=TOL, rtol=TOL)


def test_ptb_model_keep_prob_builds_a_dropout_as_jax_does():
    """``keep_prob < 1`` adds ``Dropout(keep_prob)`` after the
    LookupTable, in both packages (so ``keep_prob`` is the drop
    probability, the JAX package's form)."""
    port = rnn.PTBModel(VOCAB, HIDDEN, VOCAB, 1, 0.25, device="cpu")
    ref = jax_rnn.PTBModel(VOCAB, HIDDEN, VOCAB, 1, 0.25)
    assert [type(m).__name__ for m in port] == \
        [type(m).__name__ for m in ref.modules]
    assert port[1].p == ref.modules[1].p == 0.25


def _windows(name, rows=16):
    """``rows`` (input, 1-based next-id target) windows."""
    r = np.random.RandomState(2)
    stream = r.randint(1, VOCAB + 1, rows * STEPS + 1).astype(np.float32)
    x, y = ptb_arrays(stream, BATCH, STEPS)
    if name == "SimpleRNN":
        x = r.standard_normal(x.shape + (6,)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name", ["SimpleRNN", "PTBModel"])
def test_one_local_optimizer_step_equals_jax(name):
    """One SGD step (lr 0.1) on ``TimeDistributedCriterion(
    CrossEntropyCriterion())`` through each package's LocalOptimizer:
    the loss and every parameter within 1e-5."""
    port = _port(name)
    ref = _jax_twin(name, port)
    x, y = _windows(name)
    runs = {}
    for pkg, model, o, n, ds, sample, smb, rg in (
            ("jax", ref, joptim, jnn, JaxDataSet, JaxSample,
             JaxSampleToMiniBatch, JaxRandomGenerator),
            ("port", port, optim, nn, DataSet, Sample, SampleToMiniBatch,
             RandomGenerator)):
        rg.set_seed(4)
        data = ds.array([sample(x[i], y[i]) for i in range(len(x))]) \
            .transform(smb(BATCH))
        opt = o.LocalOptimizer(
            model, data, n.TimeDistributedCriterion(
                n.CrossEntropyCriterion()), batch_size=BATCH)
        opt.set_optim_method(o.SGD(learning_rate=0.1))
        opt.set_end_when(o.max_iteration(1))
        opt.optimize()
        runs[pkg] = opt.driver_state["Loss"]
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=TOL)
    assert_trees_close(export_params(port),
                       jax.tree.map(np.asarray, ref.get_parameters()),
                       TOL, TOL)


# -------------------------------------------------------------- the CLIs

WORDS = [f"w{i}" for i in range(30)]


def _write_corpus(folder, seed=0, lines=120):
    r = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    for name, n in (("train.txt", lines), ("test.txt", lines // 3)):
        with open(folder / name, "w") as f:
            for _ in range(n):
                f.write(" ".join(r.choice(WORDS, r.randint(3, 10), p=p))
                        + "\n")


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A seeded corpus and JAX-written snapshots of a WordRNN and a
    2-layer PTBModel at its Dictionary's vocabulary (VOCAB)."""
    root = tmp_path_factory.mktemp("rnn-cli")
    _write_corpus(root)
    snaps = {}
    for name in ("WordRNN", "PTBModel"):
        ref = _jax_twin(name, _port(name, seed=8))
        jser.save_module(str(root / name), ref)
        snaps[name] = root / name
    return root, snaps


def _lines(capsys, prefix):
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(prefix)]


@pytest.mark.parametrize("name", ["WordRNN", "PTBModel"])
def test_train_cli_equals_jax_cli(name, snapshots, capsys):
    """Both train CLIs from one JAX snapshot on the seeded synthetic
    stream: the same printed ``final loss``, a perplexity (exp of the
    loss summed over the window's steps) within 1e-5 relative and
    parameters within 1e-5."""
    root, snaps = snapshots
    argv = ["--synthetic", "400", "--vocabSize", str(VOCAB),
            "--numSteps", str(STEPS), "-b", str(BATCH), "--maxIterations",
            "3", "--model", str(snaps[name])]
    JaxRandomGenerator.set_seed(6)
    want = jax_train_cli.main(argv)
    want_line = _lines(capsys, "final loss")
    RandomGenerator.set_seed(6)
    got = train_cli.main(argv + ["--device", "cpu"])
    got_line = _lines(capsys, "final loss")
    assert len(got_line) == len(want_line) == 1
    got_words, want_words = got_line[0].split(), want_line[0].split()
    assert got_words[:3] == want_words[:3]
    np.testing.assert_allclose(float(got_words[-1]), float(want_words[-1]),
                               rtol=TOL)
    assert_trees_close(export_params(got),
                       jax.tree.map(np.asarray, want.get_parameters()),
                       TOL, TOL)


def _perplexity(capsys):
    line = _lines(capsys, "perplexity")[-1]
    return float(line.split()[-1])


def test_text_clis_equal_jax(snapshots, capsys, monkeypatch):
    """``-f`` with ``--checkpoint``: the same ``dictionary.json`` bytes;
    the test CLI on test.txt through it scores the snapshot at JAX's
    perplexity (1e-5 relative), ``--quantize`` leaves it as it is in
    both packages, and ``--numOfWords 3`` completes the windows with the
    same ids, repeatably.

    The JAX CLI's jitted scorer cannot index the numpy leaves its
    ``load_module`` leaves in a module; here (test-only) its
    ``load_module`` hands back the same weights as JAX arrays."""
    root, snaps = snapshots
    real_load = jser.load_module
    monkeypatch.setattr(jser, "load_module", lambda path: real_load(
        path).set_parameters(jax.tree.map(
            jnp.asarray, real_load(path).get_parameters())))
    common = ["--numSteps", str(STEPS), "-b", str(BATCH),
              "--vocabSize", str(VOCAB - 1)]
    for name, main, extra in (("jax", jax_train_cli.main, []),
                              ("port", train_cli.main,
                               ["--device", "cpu"])):
        main(["-f", str(root), "--checkpoint", str(root / f"ck-{name}"),
              "--maxIterations", "1", "--hiddenSize", str(HIDDEN)]
             + common + extra)
    assert (root / "ck-port" / "dictionary.json").read_bytes() == \
        (root / "ck-jax" / "dictionary.json").read_bytes()
    argv = ["-f", str(root / "test.txt"), "--dictionary",
            str(root / "ck-port" / "dictionary.json"), "--model",
            str(snaps["WordRNN"])] + common
    capsys.readouterr()
    ppl = {}
    for name, main, extra in (("jax", jax_test_cli.main, []),
                              ("port", test_cli.main, ["--device", "cpu"])):
        for quant in ([], ["--quantize"]):
            main(argv + extra + quant)
            ppl[name, bool(quant)] = _perplexity(capsys)
    assert ppl["port", True] == ppl["port", False]
    assert ppl["jax", True] == ppl["jax", False]
    np.testing.assert_allclose(ppl["port", False], ppl["jax", False],
                               rtol=TOL)
    gen = argv + ["--numOfWords", "3"]
    want = jax_test_cli.main(gen)
    got = test_cli.main(gen + ["--device", "cpu"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(test_cli.main(gen + ["--device", "cpu"]),
                                  got)


def test_clis_without_a_corpus_name_synthetic(tmp_path, monkeypatch):
    # the train recipe downloads a missing corpus: a mirror that has
    # nothing stands in for an offline host (no network is touched)
    from bigdl_tpu_torch.dataset import fetch
    monkeypatch.setattr(fetch, "SHAKESPEARE_URL",
                        (tmp_path / "no-mirror.txt").as_uri())
    with pytest.raises(SystemExit, match="--synthetic"):
        train_cli.main(["-f", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--synthetic"):
        test_cli.main(["-f", str(tmp_path), "--device", "cpu"])


# ------------------------------------------------------ saved modules

@pytest.mark.parametrize("name", ["WordRNN", "PTBModel"])
def test_saved_modules_load_both_ways(name, tmp_path):
    port = _port(name, seed=9).eval()
    x = _input(name, seed=1)
    with torch.no_grad():
        want = port(torch.from_numpy(x)).numpy()
    ser.save_module(str(tmp_path / "port"), port)
    loaded = jser.load_module(str(tmp_path / "port"))
    assert not loaded.train_mode
    loaded.set_parameters(jax.tree.map(jnp.asarray,
                                       loaded.get_parameters()))
    np.testing.assert_allclose(jax_eval(loaded, x), want, atol=TOL,
                               rtol=TOL)
    jser.save_module(str(tmp_path / "jax"), loaded)
    back = ser.load_module(str(tmp_path / "jax"), device="cpu")
    assert [type(m).__name__ for m in back] == \
        [type(m).__name__ for m in port]
    with torch.no_grad():
        got = back(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
