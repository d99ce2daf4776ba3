"""The TransformerLM recipes' data and CLIs, the port against the JAX
package: the streaming packers record for record (gauges included), the
Dictionary's JSON both ways, the PTB reader, and both CLIs (``train``
and the perplexity ``test``) on one seeded temporary corpus, each
starting from one JAX-written ``--model`` snapshot.

Tolerances: data bitwise; the CLIs' printed lines equal (four
decimals), the trained parameters within 1e-5 and the perplexity within
1e-5 relative (float32; the packages sum in other orders)."""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bigdl_tpu import telemetry as jax_telemetry
from bigdl_tpu.datapipe import packing as jax_packing
from bigdl_tpu.dataset import text as jax_text
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformer import test as jax_test_cli
from bigdl_tpu.models.transformer import train as jax_train_cli
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import datapipe, telemetry
from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.dataset import text
from bigdl_tpu_torch.models.transformer import test as test_cli
from bigdl_tpu_torch.models.transformer import train as train_cli
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close

SEQ = 16


def _docs(n=40, seed=1):
    r = np.random.default_rng(seed)
    return [r.integers(0, 50, r.integers(1, 70)).astype(np.int32)
            for _ in range(n)]


def _gauges():
    """The padding-efficiency gauge of each package: (port, JAX)."""
    name = "data/packing/padding_efficiency"
    return telemetry.gauge(name).value(), jax_telemetry.gauge(name).value()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g.input, w.input):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g.target, w.target)


# ---------------------------------------------------------- the packers

@pytest.mark.parametrize("drop_remainder", [False, True])
def test_sequence_packer_equals_jax(drop_remainder):
    want_stage = jax_packing.SequencePacker(SEQ, 3,
                                            drop_remainder=drop_remainder)
    got_stage = datapipe.SequencePacker(SEQ, 3,
                                        drop_remainder=drop_remainder)
    for epoch in range(2):           # the stats accumulate over epochs
        want = list(want_stage(iter(_docs(seed=epoch)), epoch))
        got = list(got_stage(iter(_docs(seed=epoch)), epoch))
        _assert_batches_equal(got, want)
        assert got_stage.efficiency == want_stage.efficiency
        got_gauge, want_gauge = _gauges()
        assert got_gauge == want_gauge == want_stage.efficiency


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("bounds", [[8, 16, 32], [SEQ]])
def test_length_bucket_batcher_equals_jax(bounds, drop_remainder):
    want_stage = jax_packing.LengthBucketBatcher(
        bounds, 3, drop_remainder=drop_remainder)
    got_stage = datapipe.LengthBucketBatcher(
        bounds, 3, drop_remainder=drop_remainder)
    want = list(want_stage(iter(_docs()), 0))
    got = list(got_stage(iter(_docs()), 0))
    _assert_batches_equal(got, want)
    assert got_stage.efficiency == want_stage.efficiency
    got_gauge, want_gauge = _gauges()
    assert got_gauge == want_gauge == want_stage.efficiency
    with pytest.raises(ValueError):
        datapipe.LengthBucketBatcher([16, 8], 3)


def test_pack_documents_sets_the_gauge_as_jax_does():
    jax_packing.pack_documents(_docs(seed=3), SEQ)
    datapipe.pack_documents(_docs(seed=3), SEQ)
    got_gauge, want_gauge = _gauges()
    assert got_gauge == want_gauge and 0 < got_gauge < 1


def test_padded_mode_uses_the_bucket_batcher():
    """``--inputMode padded`` is ``LengthBucketBatcher([seqLen],
    documents)``: the JAX CLI's arrays (the port-only padding function is
    gone)."""
    args = argparse.Namespace(synthetic=2000, vocabSize=64, seqLen=SEQ,
                              inputMode="padded", batchSize=4)
    want = jax_train_cli._corpus(args)
    got = train_cli.synthetic_corpus(2000, 64, SEQ, "padded", 4)
    for g, w in zip(jax.tree.leaves(list(got)),
                    jax.tree.leaves(list(want[:-1]))):
        np.testing.assert_array_equal(g, w)
    assert not hasattr(datapipe, "pad_documents")


# -------------------------------------------------------------- the text

WORDS = [f"w{i}" for i in range(40)]


def _write_corpus(folder, seed=0, lines=300):
    """A PTB-style ``train.txt`` and ``test.txt`` of seeded lines over a
    Zipf-ish vocabulary (PTB's files are pre-tokenized, one sentence a
    line)."""
    r = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    for name, n in (("train.txt", lines), ("test.txt", lines // 3)):
        with open(folder / name, "w") as f:
            for _ in range(n):
                f.write(" ".join(r.choice(WORDS, r.randint(3, 12), p=p))
                        + "\n")
    return folder


def test_tokenize_and_read_words_equal_jax(tmp_path):
    line = "Don't stop -- it's 3.5 <unk> $x, a-b!"
    assert text.tokenize(line) == jax_text.tokenize(line)
    _write_corpus(tmp_path)
    assert text.read_words(str(tmp_path / "train.txt")) == \
        jax_text.read_words(str(tmp_path / "train.txt"))


def test_dictionary_json_both_ways(tmp_path):
    """The same Dictionary from the same words (ties in first-seen
    order), the same bytes on disk, and each package loads the other's
    file to the same indices."""
    _write_corpus(tmp_path)
    words = text.read_words(str(tmp_path / "train.txt"))
    got = text.Dictionary([words], vocab_size=25)
    want = jax_text.Dictionary([words], vocab_size=25)
    assert got.word2index == want.word2index
    assert got.vocab_size() == want.vocab_size() == 26
    got.save(str(tmp_path / "port.json"))
    want.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    back = jax_text.Dictionary.load(str(tmp_path / "port.json"))
    fwd = text.Dictionary.load(str(tmp_path / "jax.json"))
    for w in words + ["never-seen"]:
        assert back.get_index(w) == fwd.get_index(w) == got.get_index(w)
    assert fwd.get_word(3) == want.get_word(3)
    assert json.loads((tmp_path / "port.json").read_text()).keys() == \
        {"word2index"}


def test_load_ptb_equals_jax(tmp_path):
    _write_corpus(tmp_path)
    kw = dict(vocab_size=30, test_path=str(tmp_path / "test.txt"))
    got, gd = text.load_ptb(str(tmp_path / "train.txt"), **kw)
    want, wd = jax_text.load_ptb(str(tmp_path / "train.txt"), **kw)
    assert got.keys() == want.keys() == {"train", "test"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert gd.word2index == wd.word2index


# -------------------------------------------------------------- the CLIs

def _cli_args(folder, snap, ck=None):
    # batch 8: the JAX CLI spreads a batch over the 8 host devices the
    # tests' XLA flags make
    argv = ["-f", str(folder), "--model", str(snap), "--seqLen", str(SEQ),
            "-b", "8", "--maxIterations", "3", "--vocabSize", "30"]
    return argv + (["--checkpoint", str(ck)] if ck else [])


@pytest.fixture(scope="module")
def corpus_and_snapshot(tmp_path_factory):
    """The seeded corpus, and a JAX-written snapshot of a 2-layer MoE
    TransformerLM (block 1 of 2 an MoE block of 2 experts) at the
    Dictionary's vocabulary."""
    root = tmp_path_factory.mktemp("lm-cli")
    folder = root / "data"
    folder.mkdir()
    _write_corpus(folder, seed=3)
    _, d = text.load_ptb(str(folder / "train.txt"), vocab_size=30)
    JaxRandomGenerator.set_seed(5)
    ref = JaxTransformerLM(d.vocab_size(), hidden_size=32, num_layers=2,
                           num_heads=2, max_len=SEQ, moe_experts=2)
    ref.ensure_initialized()
    jser.save_module(str(root / "snap"), ref)
    return root, folder, root / "snap"


@pytest.mark.parametrize("mode", ["packed", "contiguous"])
def test_train_cli_equals_jax_cli(mode, corpus_and_snapshot, capsys):
    """Both train CLIs on ``-f`` text from the JAX snapshot: the same
    printed lines (input mode, final loss), parameters within 1e-5, and
    the same ``dictionary.json`` bytes in ``--checkpoint``."""
    root, folder, snap = corpus_and_snapshot
    lines, models = {}, {}
    for name, main, rg in (("jax", jax_train_cli.main, JaxRandomGenerator),
                           ("port", train_cli.main, RandomGenerator)):
        rg.set_seed(7)
        argv = _cli_args(folder, snap, root / f"ck-{name}-{mode}")
        argv += ["--inputMode", mode]
        if name == "port":
            argv += ["--device", "cpu"]
        models[name] = main(argv)
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith(("final loss", "input mode"))]
    assert lines["port"] == lines["jax"] and lines["port"]
    assert_trees_close(export_params(models["port"]),
                       jax.tree.map(np.asarray,
                                    models["jax"].get_parameters()), 1e-5)
    assert (root / f"ck-port-{mode}" / "dictionary.json").read_bytes() == \
        (root / f"ck-jax-{mode}" / "dictionary.json").read_bytes()


@pytest.mark.parametrize("source", ["text", "synthetic"])
def test_test_cli_equals_jax_cli(source, corpus_and_snapshot, capsys,
                                 monkeypatch):
    """The perplexity CLI of each package on the JAX snapshot: the
    ``-f`` test.txt through the train CLI's ``dictionary.json``, or the
    seeded synthetic stream: the same printed line, and perplexities
    within 1e-5 relative.

    The JAX CLI's jitted scorer indexes the parameters with traced token
    ids, which fails on the numpy leaves its ``load_module`` leaves in
    the module; here (test-only) its ``load_module`` hands the CLI the
    same weights as JAX arrays."""
    root, folder, snap = corpus_and_snapshot
    real_load = jser.load_module

    def load_as_jax_arrays(path):
        model = real_load(path)
        return model.set_parameters(jax.tree.map(jnp.asarray,
                                                 model.get_parameters()))
    monkeypatch.setattr(jser, "load_module", load_as_jax_arrays)
    if source == "text":
        ck = root / "ck-test"
        train_cli.main(_cli_args(folder, snap, ck) + ["--device", "cpu"])
        argv = ["-f", str(folder / "test.txt"), "--dictionary",
                str(ck / "dictionary.json")]
    else:
        vocab = text.load_ptb(str(folder / "train.txt"),
                              vocab_size=30)[1].vocab_size()
        argv = ["--synthetic", "700", "--vocabSize", str(vocab)]
    argv += ["--model", str(snap), "--seqLen", str(SEQ), "-b", "8"]
    capsys.readouterr()
    want = jax_test_cli.main(argv)
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = test_cli.main(argv + ["--device", "cpu"])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line == want_line and got_line.startswith("tokens: ")
    assert abs(got - want) <= 1e-5 * want


def test_train_cli_without_a_corpus_names_synthetic(tmp_path,
                                                   monkeypatch):
    # the train CLI downloads a missing corpus: a mirror that has
    # nothing stands in for an offline host (no network is touched)
    from bigdl_tpu_torch.dataset import fetch
    monkeypatch.setattr(fetch, "SHAKESPEARE_URL",
                        (tmp_path / "no-mirror.txt").as_uri())
    with pytest.raises(SystemExit, match="--synthetic"):
        train_cli.main(["-f", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--synthetic"):
        test_cli.main(["-f", str(tmp_path), "--device", "cpu"])
