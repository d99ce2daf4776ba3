"""The port's example programs (``bigdl_tpu_torch/examples/``) against the
JAX package's (``examples/``): each main with ``--device cpu`` at the
JAX test's sizes (``tests/test_examples.py``) beside the JAX main run in
the same test on the same records and the same starting weights (the
JAX main's model is built with the port's initial weights carried in),
the same shuffles (one seed in both packages): the printed loss within
the stated tolerance and the JAX test's accuracy bar in both. The text
classifier also reads a folder of documents, and its saved module loads
in the other package both ways; a main asked for the card without one
exits naming ``--device``.

Tolerances: wide-and-deep and the text classifier train with the
drivers' float32 steps, the tree example with 120 full-batch SGD steps;
their printed losses (4 decimals) agree within 2e-4 absolute (two units
of the last printed digit), the accuracies within 0.01."""
import os
import re

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
from bigdl_tpu_torch.examples import (language_model, text_classification,
                                      tree_lstm_sentiment, udf_predictor,
                                      wide_and_deep)
from bigdl_tpu_torch.utils import serialization as ser
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import to_jax

import examples.language_model as jax_lm
import examples.text_classification as jax_text
import examples.tree_lstm_sentiment as jax_tree
import examples.udf_predictor as jax_udf
import examples.wide_and_deep as jax_wd

LOSS_ATOL = 2e-4
ACC_ATOL = 0.01
SEED = 11

torch.set_num_threads(1)


def _seed():
    RandomGenerator.set_seed(SEED)
    JRandomGenerator.set_seed(SEED)


def _gen():
    return torch.Generator().manual_seed(SEED)


def _printed(capsys, pattern):
    out = capsys.readouterr().out
    found = re.findall(pattern, out)
    assert found, out
    return [float(v) for v in found[-1]] if isinstance(found[-1], tuple) \
        else float(found[-1])


def _carry(monkeypatch, module, port_build):
    """The JAX example's ``build_model`` builds its tree with the port's
    initial weights (``port_build`` of the same arguments)."""
    jax_build = module.build_model

    def build(*args):
        ref = jax_build(*args)
        ref.set_parameters(to_jax(port_build(*args).get_parameters()))
        return ref

    monkeypatch.setattr(module, "build_model", build)


def test_wide_and_deep_main_equals_jax(capsys, monkeypatch):
    argv = ["-n", "512", "--wideDim", "100", "-e", "3", "-b", "32"]
    _seed()
    acc = wide_and_deep.main(argv + ["--device", "cpu"])
    loss = _printed(capsys, r"final loss: ([0-9.]+)")
    _carry(monkeypatch, jax_wd,
           lambda *a: wide_and_deep.build_model(*a, generator=_gen()))
    _seed()
    j_acc = jax_wd.main(argv)
    j_loss = _printed(capsys, r"final loss: ([0-9.]+)")
    assert acc > 0.8 and j_acc > 0.8, (acc, j_acc)
    assert abs(loss - j_loss) <= LOSS_ATOL, (loss, j_loss)
    assert abs(acc - j_acc) <= ACC_ATOL


def test_tree_lstm_sentiment_main_equals_jax(capsys, monkeypatch):
    argv = ["--trees", "120"]
    _seed()
    acc = tree_lstm_sentiment.main(argv + ["--device", "cpu"])
    loss, p_acc = _printed(capsys, r"final loss ([0-9.]+) TreeNNAccuracy "
                                   r"([0-9.]+)")
    port = tree_lstm_sentiment.TreeSentiment(40, 24, 8, generator=_gen())
    params = port.get_parameters()
    for name, key in (("BinaryTreeLSTM", "tree"), ("LookupTable", "embed"),
                      ("Linear", "head")):
        cls = getattr(jnn, name)

        def make(*a, _cls=cls, _key=key, **k):
            m = _cls(*a, **k)
            m.set_parameters(to_jax(params[_key]))
            return m

        monkeypatch.setattr(jnn, name, make)
    _seed()
    j_acc = jax_tree.main(argv)
    j_loss, _ = _printed(capsys, r"final loss ([0-9.]+) TreeNNAccuracy "
                                 r"([0-9.]+)")
    assert acc > 0.8 and j_acc > 0.8, (acc, j_acc)
    assert abs(p_acc - round(acc, 3)) < 1e-9
    assert abs(loss - j_loss) <= LOSS_ATOL, (loss, j_loss)
    assert abs(acc - j_acc) <= ACC_ATOL


def _text_run(capsys, monkeypatch, argv):
    _seed()
    state = text_classification.main(argv + ["--device", "cpu"])
    loss, score = _printed(capsys, r"final loss ([0-9.]+) val score "
                                   r"([0-9.]+)")
    _carry(monkeypatch, jax_text,
           lambda *a: text_classification.build_model(*a, generator=_gen()))
    _seed()
    j_state = jax_text.main(argv)
    j_loss, j_score = _printed(capsys, r"final loss ([0-9.]+) val score "
                                       r"([0-9.]+)")
    assert abs(loss - j_loss) <= LOSS_ATOL, (loss, j_loss)
    assert abs(score - j_score) <= ACC_ATOL, (score, j_score)
    assert state["epoch"] == j_state["epoch"]
    assert state["neval"] == j_state["neval"]
    return state, j_state


def test_text_classification_main_equals_jax(capsys, monkeypatch):
    state, j_state = _text_run(
        capsys, monkeypatch, ["--synthetic", "200", "--classes", "2", "-e",
                              "6", "-b", "32", "--vocabSize", "200"])
    assert state["score"] > 0.8 and j_state["score"] > 0.8


def test_text_classification_reads_a_folder_as_jax_does(tmp_path, capsys,
                                                        monkeypatch):
    """``-f DIR``: one folder a class (sorted), one document a file; the
    class count comes from the folder."""
    rng = np.random.RandomState(3)
    texts, labels = text_classification.synthetic_corpus(90, 3, rng)
    for i, (t, c) in enumerate(zip(texts, labels)):
        d = tmp_path / f"class_{int(c)}"
        d.mkdir(exist_ok=True)
        (d / f"doc{i:03d}.txt").write_text(t + "\n")
    (tmp_path / "README").write_text("not a class")
    got = text_classification.load_texts(str(tmp_path))
    assert got[2] == 3 and len(got[0]) == 90
    state, _ = _text_run(capsys, monkeypatch,
                         ["-f", str(tmp_path), "-e", "4", "-b", "16",
                          "--seqLen", "30", "--embedDim", "16"])
    assert state["score"] > 0.8


def test_text_classifier_saved_modules_load_across_packages(tmp_path):
    port = text_classification.build_model(51, 8, 3, generator=_gen())
    port.eval()
    ids = np.random.RandomState(2).randint(1, 52, (4, 12)).astype(
        np.float32)
    with torch.no_grad():
        want = port(torch.from_numpy(ids)).numpy()
    ser.save_module(str(tmp_path / "port"), port)
    loaded = jser.load_module(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(loaded.forward(ids)), want,
                               atol=1e-5, rtol=1e-5)
    ref = jax_text.build_model(51, 8, 3)
    ref.set_parameters(to_jax(port.get_parameters()))
    ref.evaluate()
    jser.save_module(str(tmp_path / "jax"), ref)
    back = ser.load_module(str(tmp_path / "jax"), device="cpu")
    assert [type(m).__name__ for m in back] == [
        "LookupTable", "TemporalConvolution", "ReLU", "Max", "Linear",
        "LogSoftMax"]
    with torch.no_grad():
        np.testing.assert_allclose(back(torch.from_numpy(ids)).numpy(),
                                   want, atol=1e-5, rtol=1e-5)


def test_text_classifier_quantizes_its_head_only_as_jax_does():
    """``quantize`` converts the head Linear alone (LookupTable and
    TemporalConvolution stay float) in both packages, and the int8
    logits agree."""
    from bigdl_tpu.nn.quantized import quantize as jax_quantize
    from bigdl_tpu_torch.nn.quantized import quantize
    port = text_classification.build_model(51, 8, 3, generator=_gen())
    ref = jax_text.build_model(51, 8, 3)
    ref.set_parameters(to_jax(port.get_parameters()))
    q, ref_q = quantize(port.eval()), jax_quantize(ref)
    names = [type(m).__name__ for m in q]
    assert names == [type(m).__name__ for m in ref_q.modules]
    assert names[4] == "QuantizedLinear" and names.count("Quantized"
                                                         "Linear") == 1
    ids = np.random.RandomState(5).randint(1, 52, (6, 12)).astype(
        np.float32)
    with torch.no_grad():
        got = q(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_q.forward(ids)),
                               atol=1e-4, rtol=1e-4)


#: the arguments each main runs with when asked for the card
CARDLESS_ARGS = {text_classification.main: ["--synthetic", "8"],
                 language_model.main: ["--synthetic", "400"],
                 udf_predictor.main: ["--demo"]}


@pytest.mark.parametrize("main", [wide_and_deep.main,
                                  tree_lstm_sentiment.main,
                                  text_classification.main,
                                  language_model.main,
                                  udf_predictor.main])
def test_a_main_without_a_card_names_the_device_flag(main):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device runs")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(CARDLESS_ARGS.get(main, []))


def _carry_ptb(monkeypatch):
    """The JAX example's ``PTBModel`` built with the port's initial
    weights (the port's ``PTBModel`` of the same arguments, drawn from
    the seed's generator as the port's main draws them)."""
    import bigdl_tpu.models as jax_models
    from bigdl_tpu_torch.models import PTBModel
    jax_build = jax_models.PTBModel

    def build(*args, **kw):
        ref = jax_build(*args, **kw)
        ref.set_parameters(to_jax(PTBModel(*args, **kw, device="cpu",
                                           generator=_gen())
                                  .get_parameters()))
        return ref

    monkeypatch.setattr(jax_models, "PTBModel", build)


LM_LOSS = r"train loss ([0-9.]+) perplexity ([0-9.]+)"
LM_VALID = r"valid loss ([0-9.]+) perplexity ([0-9.]+)"


def test_language_model_main_equals_jax(capsys, monkeypatch):
    """``--synthetic``: the JAX example's stream over ``min(vocabSize,
    50)`` ids, three Adagrad steps; the printed loss within 2e-4."""
    argv = ["--synthetic", "400", "--hiddenSize", "16", "--numSteps", "5",
            "-b", "4", "--maxIterations", "3"]
    _seed()
    state = language_model.main(argv + ["--device", "cpu"])
    loss, _ = _printed(capsys, LM_LOSS)
    _carry_ptb(monkeypatch)
    _seed()
    j_state = jax_lm.main(argv)
    j_loss, _ = _printed(capsys, LM_LOSS)
    assert abs(loss - j_loss) <= LOSS_ATOL, (loss, j_loss)
    assert state["neval"] == j_state["neval"] == 4
    assert state["Loss"] < np.log(50) + 0.5


def _write_corpus(folder, words, n, seed):
    rng = np.random.RandomState(seed)
    lines = [" ".join(rng.choice(words, rng.randint(3, 12)))
             for _ in range(n)]
    (folder / f"{'train' if seed == 1 else 'valid'}.txt").write_text(
        "\n".join(lines) + "\n")


def test_language_model_reads_a_folder_as_jax_does(tmp_path, capsys,
                                                   monkeypatch):
    """``-f DIR``: PTB text in ``train.txt`` and ``valid.txt`` through the
    port's ``load_ptb``; one epoch with its validation, the printed
    training and validation losses within 2e-4 of the JAX main's."""
    words = [f"w{i}" for i in range(60)]
    _write_corpus(tmp_path, words, 150, 1)
    _write_corpus(tmp_path, words, 40, 2)
    argv = ["-f", str(tmp_path), "--vocabSize", "40", "--hiddenSize", "16",
            "--numSteps", "5", "-b", "4", "-e", "1"]
    _seed()
    language_model.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    _carry_ptb(monkeypatch)
    _seed()
    jax_lm.main(argv)
    j_out = capsys.readouterr().out
    for pattern in (LM_LOSS, LM_VALID):
        got = [float(v) for v in re.findall(pattern, out)[-1]]
        want = [float(v) for v in re.findall(pattern, j_out)[-1]]
        assert abs(got[0] - want[0]) <= LOSS_ATOL, (pattern, got, want)


def test_language_model_without_valid_txt_warns_as_jax_does(tmp_path,
                                                           capsys):
    _write_corpus(tmp_path, [f"w{i}" for i in range(30)], 60, 1)
    state = language_model.main(["-f", str(tmp_path), "--hiddenSize", "8",
                                 "--numSteps", "4", "-b", "2",
                                 "--maxIterations", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "warning: no valid.txt found" in out and "valid loss" not in out
    assert state["neval"] == 3


def test_udf_predictor_demo_equals_jax(capsys, monkeypatch):
    """The demo's 8 predictions equal the JAX main's from the same
    initial weights (the JAX classifier built with the port's), and
    the printed hits agree."""
    _seed()
    preds = udf_predictor.main(["--demo", "--device", "cpu"])
    out = capsys.readouterr().out
    _carry(monkeypatch, jax_text,
           lambda *a: text_classification.build_model(*a, generator=_gen()))
    _seed()
    j_preds = jax_udf.main(["--demo"])
    j_out = capsys.readouterr().out
    assert preds == j_preds and len(preds) == 8
    assert set(preds) <= {1, 2}
    assert re.findall(r"(\d)/8 correct", out) == re.findall(
        r"(\d)/8 correct", j_out)


def test_udf_runs_the_forward_on_the_models_device():
    """``make_text_udf`` feeds the model on its own device and hands back
    plain labels; without ``--demo`` the main prints its help."""
    from bigdl_tpu_torch.dataset import Dictionary, tokenize
    texts, _ = text_classification.synthetic_corpus(
        4, 2, np.random.RandomState(1))
    d = Dictionary([tokenize(t) for t in texts], vocab_size=50)
    model = text_classification.build_model(d.vocab_size() + 1, 8, 2,
                                            generator=_gen())
    udf = udf_predictor.make_text_udf(model, d, 12)
    preds = udf(texts)
    assert not model.training
    assert len(preds) == 4 and all(type(p) is int for p in preds)
    assert udf_predictor.main([]) is None


def test_examples_import_only_the_port():
    """The example modules import ``bigdl_tpu_torch``, never the JAX
    package or ``examples``."""
    root = os.path.dirname(text_classification.__file__)
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            src = open(os.path.join(root, name)).read()
            assert not re.search(r"^\s*(from|import)\s+(jax|bigdl_tpu\b|"
                                 r"bigdl_tpu\.|examples)", src, re.M), name
