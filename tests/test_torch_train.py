"""The port's TransformerLM training path against the JAX package's on
the same seeded data and weights: the criterion, packing, the synthetic
corpus, the SGD schedule, three train steps and a four-iteration
``LocalOptimizer`` run, and the train CLI.

Tolerance: float32 atol 1e-5 on losses and parameters — the JAX
package's own float32 contract. The two packages reduce in other orders,
and the port's attention takes the flash kernel's plain version while
the JAX package on the CPU takes its einsum path (kernels off there)."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.datapipe import packing as jax_packing
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformer import train as jax_train
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.optimizer import build_train_step as jax_build_step
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.datapipe import pack_documents, padding_efficiency
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models import transformer_train
from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, build_train_step
from bigdl_tpu_torch.optim import max_iteration
from bigdl_tpu_torch.utils.random import RandomGenerator

ATOL = 1e-5
VOCAB, SEQ, BATCH = 64, 32, 4
GEOM = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
            max_len=SEQ)


def _jax_params(seed):
    JaxRandomGenerator.set_seed(seed)
    ref = JaxTransformerLM(**GEOM)
    ref.ensure_initialized()
    return ref, jax.tree.map(np.asarray, ref.get_parameters())


def _port_model(params):
    return load_jax_params(TransformerLM(**GEOM, device="cpu"), params)


def _assert_trees_close(got, want, atol=ATOL):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _corpus(mode, n=3000):
    return transformer_train.synthetic_corpus(n, VOCAB, SEQ, mode, BATCH)


# ------------------------------------------------------------ criterion

@pytest.mark.parametrize("ignore_index,smoothing", [
    (None, 0.0), (-1, 0.0), (-1, 0.1), (None, 0.2)])
def test_criterion_matches_jax(ignore_index, smoothing):
    r = np.random.default_rng(0)
    logits = r.standard_normal((3, 7, 11)).astype(np.float32) * 3
    target = r.integers(0, 11, (3, 7)).astype(np.int32)
    target[0, :3] = -1          # ignored (or clamped to id 0)
    target[2, 5] = 40           # out of range: clamped to the last id
    want_c = jnn.SequenceCrossEntropyCriterion(
        label_smoothing=smoothing, ignore_index=ignore_index)
    got_c = SequenceCrossEntropyCriterion(label_smoothing=smoothing,
                                          ignore_index=ignore_index)
    want = float(want_c.apply(jnp.asarray(logits), jnp.asarray(target)))
    want_g = np.asarray(jax.grad(lambda x: want_c.apply(
        x, jnp.asarray(target)))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    loss = got_c(x, torch.from_numpy(target))
    loss.backward()
    assert abs(float(loss.detach()) - want) <= ATOL
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=ATOL, rtol=0)


def test_all_ignored_targets_give_zero_loss():
    crit = SequenceCrossEntropyCriterion(ignore_index=-1)
    loss = crit(torch.zeros((2, 3, 5)), torch.full((2, 3), -1))
    assert float(loss) == 0.0


# ------------------------------------------------------------ data

def test_pack_documents_equal_jax_exactly():
    r = np.random.default_rng(1)
    docs = [r.integers(0, 50, r.integers(1, 60)).astype(np.int32)
            for _ in range(40)]
    want = jax_packing.pack_documents(docs, SEQ)
    got = pack_documents(docs, SEQ)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert jax_packing.padding_efficiency([len(d) for d in docs], SEQ) \
        == padding_efficiency([len(d) for d in docs], SEQ)


@pytest.mark.parametrize("mode", ["contiguous", "packed", "padded"])
def test_synthetic_corpus_equals_jax_cli(mode):
    args = argparse.Namespace(synthetic=3000, vocabSize=VOCAB, seqLen=SEQ,
                              inputMode=mode, batchSize=BATCH)
    want = jax_train._corpus(args)
    got = _corpus(mode)
    assert want[-1] == VOCAB
    for g, w in zip(jax.tree.leaves(list(got)), jax.tree.leaves(
            list(want[:-1]))):
        np.testing.assert_array_equal(g, w)


def test_dataset_shuffle_order_equals_jax():
    JaxRandomGenerator.set_seed(3)
    RandomGenerator.set_seed(3)
    want_ds = JaxDataSet.array(list(range(11)))
    got_ds = DataSet.array(list(range(11)))
    for _ in range(3):
        want_ds.shuffle()
        got_ds.shuffle()
        it_w, it_g = want_ds.data(train=True), got_ds.data(train=True)
        assert [next(it_g) for _ in range(15)] == \
            [next(it_w) for _ in range(15)]


def test_sample_to_minibatch_stacks_planes():
    samples = [Sample([np.full(4, i), np.full(4, -i)], np.full(4, 2 * i))
               for i in range(5)]
    batches = list(SampleToMiniBatch(2)(samples))
    assert [b.size() for b in batches] == [2, 2, 1]
    np.testing.assert_array_equal(batches[1].input[1],
                                  [[-2] * 4, [-3] * 4])
    np.testing.assert_array_equal(batches[2].target, [[8] * 4])


def test_packed_forward_matches_jax():
    """The 3-plane packed forward (segment-masked attention, positions
    restarting per document) at the float32 tolerance; the JAX package
    runs its einsum path, the port the flash kernel's plain version."""
    ref, params = _jax_params(seed=6)
    port = _port_model(params)
    x, _ = _corpus("packed")
    planes = [p[:BATCH] for p in x]
    want, _ = ref.apply(jax.tree.map(jnp.asarray, params), ref.get_state(),
                        [jnp.asarray(p) for p in planes])
    with torch.no_grad():
        got = port([torch.from_numpy(p) for p in planes])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# ------------------------------------------------------------ SGD

def test_sgd_default_schedule_values_equal_jax():
    want = JaxSGD(learning_rate=0.1, learning_rate_decay=0.01)
    got = SGD(learning_rate=0.1, learning_rate_decay=0.01)
    for _ in range(6):
        assert got.update_hyper_parameter() == want.update_hyper_parameter()
    assert got.state == want.state


_SGD_CASES = {
    "plain": dict(),
    "momentum_wd": dict(momentum=0.9, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True, dampening=0.0),
}


def _batches(mode):
    x, y = _corpus(mode)
    if mode == "contiguous":
        return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
                for i in range(3)]
    return [([p[i * BATCH:(i + 1) * BATCH] for p in x],
             y[i * BATCH:(i + 1) * BATCH]) for i in range(3)]


@pytest.mark.parametrize("mode", ["packed", "contiguous"])
@pytest.mark.parametrize("case", sorted(_SGD_CASES))
def test_three_train_steps_match_jax(case, mode):
    ref, params = _jax_params(seed=7)
    port = _port_model(params)
    crit_kw = {"ignore_index": -1} if mode == "packed" else {}
    kw = dict(learning_rate=0.1, learning_rate_decay=0.05,
              **_SGD_CASES[case])
    j_sgd, p_sgd = JaxSGD(**kw), SGD(**kw)
    j_step = jax_build_step(ref, jnn.SequenceCrossEntropyCriterion(
        **crit_kw), j_sgd)
    p_step = build_train_step(port, SequenceCrossEntropyCriterion(
        **crit_kw), p_sgd)
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt = j_sgd.init_state(j_params)
    m_state = ref.get_state()
    for x, y in _batches(mode):
        lr_j, lr_p = j_sgd.update_hyper_parameter(), \
            p_sgd.update_hyper_parameter()
        assert lr_j == lr_p
        jx = [jnp.asarray(p) for p in x] if mode == "packed" \
            else jnp.asarray(x)
        j_params, j_opt, m_state, j_loss = j_step(
            j_params, j_opt, m_state, jax.random.PRNGKey(0), lr_j, jx,
            jnp.asarray(y))
        px = [torch.from_numpy(p) for p in x] if mode == "packed" \
            else torch.from_numpy(x)
        p_loss = p_step(px, torch.from_numpy(y), lr_p)
        assert abs(float(p_loss) - float(j_loss)) <= ATOL
    _assert_trees_close(export_params(port),
                        jax.tree.map(np.asarray, j_params))


def test_train_step_einsum_path_matches_kernel_path():
    """One step with flash switched off (the einsum path) gives the
    kernel path's loss and parameters — the check ``chip_smoke.py``
    makes on the card."""
    _, params = _jax_params(seed=8)
    (x, y), = _batches("packed")[:1]
    out = []
    for cfg in (kernels.KernelConfig.ported(),
                kernels.KernelConfig(flash_attention=False,
                                     decode_attention=True)):
        port = _port_model(params)
        step = build_train_step(port, SequenceCrossEntropyCriterion(
            ignore_index=-1), SGD(learning_rate=0.1))
        with kernels.use(cfg):
            loss = step([torch.from_numpy(p) for p in x],
                        torch.from_numpy(y), 0.1)
        out.append((float(loss), export_params(port)))
    assert abs(out[0][0] - out[1][0]) <= ATOL
    _assert_trees_close(out[0][1], out[1][1])


def test_gradient_clipping_kinds():
    _, params = _jax_params(seed=9)
    (x, y), = _batches("contiguous")[:1]
    with pytest.raises(ValueError):
        build_train_step(_port_model(params),
                         SequenceCrossEntropyCriterion(), SGD(), ("nope",))
    for clip in (("constant", -1e-3, 1e-3), ("l2norm", 1e-2)):
        port = _port_model(params)
        before = {k: v.copy() for k, v in
                  jax.tree_util.tree_flatten_with_path(export_params(port))[0]}
        step = build_train_step(port, SequenceCrossEntropyCriterion(),
                                SGD(learning_rate=1.0), gradient_clip=clip)
        step(torch.from_numpy(x), torch.from_numpy(y), 1.0)
        after = dict(jax.tree_util.tree_flatten_with_path(
            export_params(port))[0])
        moved = [np.abs(after[k] - before[k]) for k in before]
        if clip[0] == "constant":
            assert max(m.max() for m in moved) <= 1e-3 + 1e-7
        else:
            total = np.sqrt(sum((m.astype(np.float64) ** 2).sum()
                                for m in moved))
            assert total <= 1e-2 * (1 + 1e-5)


# ------------------------------------------------------------ driver

def test_local_optimizer_matches_jax():
    """Six packed rows in batches of 2: three iterations per epoch, so
    the fourth iteration runs after an epoch rollover's reshuffle."""
    x, y = _corpus("packed")
    samples_j = [JaxSample([p[i] for p in x], y[i]) for i in range(6)]
    samples_p = [Sample([p[i] for p in x], y[i]) for i in range(6)]
    ref, params = _jax_params(seed=11)
    port = _port_model(params)

    JaxRandomGenerator.set_seed(4)
    j_opt = JaxLocalOptimizer(
        ref, JaxDataSet.array(samples_j).transform(JaxSampleToMiniBatch(2)),
        jnn.SequenceCrossEntropyCriterion(ignore_index=-1), batch_size=2)
    j_opt.set_optim_method(JaxSGD(learning_rate=0.1, momentum=0.9))
    j_opt.set_end_when(jax_max_iteration(4))
    j_opt.optimize()

    RandomGenerator.set_seed(4)
    p_opt = LocalOptimizer(
        port, DataSet.array(samples_p).transform(SampleToMiniBatch(2)),
        SequenceCrossEntropyCriterion(ignore_index=-1), batch_size=2)
    p_opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    p_opt.set_end_when(max_iteration(4))
    p_opt.optimize()

    js, ps = j_opt.driver_state, p_opt.driver_state
    assert (ps["neval"], ps["epoch"]) == (js["neval"], js["epoch"]) == (5, 2)
    assert abs(ps["Loss"] - js["Loss"]) <= ATOL
    assert p_opt.optim_method.state["neval"] == \
        j_opt.optim_method.state["neval"]
    assert [h["neval"] for h in p_opt.history] == [1, 2, 3, 4]
    _assert_trees_close(export_params(port),
                        jax.tree.map(np.asarray, ref.get_parameters()))


def test_train_cli_runs_on_cpu(capsys):
    model = transformer_train.main([
        "--synthetic", "3000", "--device", "cpu", "--inputMode", "packed",
        "--vocabSize", str(VOCAB), "--hiddenSize", "32", "--layers", "2",
        "--heads", "2", "--seqLen", str(SEQ), "-b", "4",
        "--maxIterations", "3"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "input mode packed" in out
    assert model.device.type == "cpu"


@pytest.mark.parametrize("flag", [["--pp", "2"], ["--tp", "2"],
                                  ["--sp", "ring"], ["--moeExperts", "2"],
                                  ["--dropout", "0.1"]])
def test_train_cli_unported_options_raise(flag):
    with pytest.raises(NotImplementedError):
        transformer_train.main(["--synthetic", "3000", "--device", "cpu",
                                "--vocabSize", str(VOCAB), "--seqLen",
                                str(SEQ), "--hiddenSize", "32", "--heads",
                                "2", "--layers", "1"] + flag)


def test_packed_input_with_cache_raises():
    _, params = _jax_params(seed=12)
    port = _port_model(params)
    planes = [torch.zeros((1, 4), dtype=torch.long)] * 3
    cache = {"k": torch.zeros((2, 1, 2, 8, 16)),
             "v": torch.zeros((2, 1, 2, 8, 16))}
    with pytest.raises(ValueError, match="packed"):
        port(planes, cache=cache, positions=torch.zeros(1))
