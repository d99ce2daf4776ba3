"""The port's long-context path against the JAX package's, on the same
seeded data and weights: TransformerLM training routed to the blockwise
kernel K2 past the working-set budget, and chunked prefill in the
generation engine and service.

Training: both packages run under a 1 MiB working-set budget, so at
D = 16 and S = 512 (an estimate of 1.28 MB) both route attention to K2
— the JAX package to its Pallas kernel in interpret mode, the port to
K2's plain version. Losses and parameters at float32 atol 1e-5, the JAX
package's own contract; the two reduce in other orders.

Chunked prefill: last-token logits and the written KV rows at atol
1e-5 against the JAX engine's chunked prefill and against the port's
single-shot prefill (the JAX package's own bitwise chunk-boundary test
fails on its seed, so the port holds this path at tolerance); greedy
streams token-identical; the admission rule, the chunk counter and the
one-program-per-rung bound as in tests/test_longctx.py."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu import kernels as jax_kernels
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.generation import GenerationConfig as JaxGenerationConfig
from bigdl_tpu.generation import GenerationService as JaxGenerationService
from bigdl_tpu.generation.engine import DecodeEngine as JaxDecodeEngine
from bigdl_tpu.generation.kv_cache import KVCache as JaxKVCache
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import max_iteration as jax_max_iteration
from bigdl_tpu.optim.optimizer import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim.optimizer import build_train_step as jax_build_step
from bigdl_tpu.serving import Servable as JaxServable
from bigdl_tpu.serving.compile_cache import BucketLadder as JaxBucketLadder
from bigdl_tpu.serving.compile_cache import CompileCache as JaxCompileCache
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.generation import (GenerationConfig, GenerationService,
                                        KVCache)
from bigdl_tpu_torch.generation.engine import DecodeEngine
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, build_train_step
from bigdl_tpu_torch.optim import max_iteration
from bigdl_tpu_torch.serving import Servable
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.utils.random import RandomGenerator

ATOL = 1e-5
dispatch = importlib.import_module("bigdl_tpu_torch.kernels.dispatch")
jax_fa = importlib.import_module("bigdl_tpu.kernels.flash_attention")

# ---------------------------------------------------------------- training

VOCAB, SEQ = 64, 512
TRAIN_GEOM = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                  num_heads=2, max_len=SEQ)
JAX_K2 = jax_kernels.KernelConfig.all_on(interpret=True, vmem_budget_mb=1,
                                         block_q=128, block_k=128)
PORT_K2 = kernels.KernelConfig.ported(vmem_budget_mb=1, block_q=128,
                                      block_k=128)


def _train_params(seed):
    JaxRandomGenerator.set_seed(seed)
    ref = JaxTransformerLM(**TRAIN_GEOM)
    ref.ensure_initialized()
    return ref, jax.tree.map(np.asarray, ref.get_parameters())


def _assert_trees_close(got, want, atol=ATOL):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, np.asarray(flat_w[path]), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _corpus():
    """The train CLI's contiguous synthetic windows at seq 512, batch 1."""
    return transformer_train.synthetic_corpus(4000, VOCAB, SEQ,
                                              "contiguous", 1)


class _Spy:
    """Counts calls through a function and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def test_three_train_steps_through_k2_match_jax(monkeypatch):
    """Three SGD steps at seq 512 from converted weights, both packages
    routing every attention call to K2 (spied): per-step losses and the
    final parameters within 1e-5."""
    x, y = _corpus()
    ref, params = _train_params(seed=3)
    port = load_jax_params(TransformerLM(**TRAIN_GEOM, device="cpu"),
                           params)
    j_spy = _Spy(jax_fa.blockwise_flash_attention)
    p_spy = _Spy(dispatch.blockwise_flash_attention)
    monkeypatch.setattr(jax_fa, "blockwise_flash_attention", j_spy)
    monkeypatch.setattr(dispatch, "blockwise_flash_attention", p_spy)
    j_sgd, p_sgd = JaxSGD(learning_rate=0.1), SGD(learning_rate=0.1)
    with jax_kernels.use(JAX_K2):
        j_step = jax_build_step(ref, jnn.SequenceCrossEntropyCriterion(),
                                j_sgd)
        j_params = jax.tree.map(jnp.asarray, params)
        j_opt, m_state = j_sgd.init_state(j_params), ref.get_state()
        j_losses = []
        for i in range(3):
            j_params, j_opt, m_state, loss = j_step(
                j_params, j_opt, m_state, jax.random.PRNGKey(0), 0.1,
                jnp.asarray(x[i:i + 1]), jnp.asarray(y[i:i + 1]))
            j_losses.append(float(loss))
    p_step = build_train_step(port, SequenceCrossEntropyCriterion(), p_sgd)
    with kernels.use(PORT_K2):
        p_losses = [float(p_step(torch.from_numpy(x[i:i + 1]),
                                 torch.from_numpy(y[i:i + 1]), 0.1))
                    for i in range(3)]
    assert j_spy.calls >= TRAIN_GEOM["num_layers"]     # traced, not run
    assert p_spy.calls == 3 * TRAIN_GEOM["num_layers"]
    np.testing.assert_allclose(p_losses, j_losses, atol=ATOL, rtol=0)
    _assert_trees_close(export_params(port),
                        jax.tree.map(np.asarray, j_params))


def test_local_optimizer_through_k2_matches_jax():
    """``LocalOptimizer`` for 3 iterations over the seeded windows in
    both packages (same shuffle seed): the optimizer's loss and the final
    parameters within 1e-5."""
    x, y = _corpus()
    n = len(y)
    ref, params = _train_params(seed=4)
    port = load_jax_params(TransformerLM(**TRAIN_GEOM, device="cpu"),
                           params)
    JaxRandomGenerator.set_seed(6)
    j_opt = JaxLocalOptimizer(
        ref, JaxDataSet.array([JaxSample(x[i], y[i]) for i in range(n)])
        .transform(JaxSampleToMiniBatch(1)),
        jnn.SequenceCrossEntropyCriterion(), batch_size=1)
    j_opt.set_optim_method(JaxSGD(learning_rate=0.1))
    j_opt.set_end_when(jax_max_iteration(3))
    with jax_kernels.use(JAX_K2):
        j_opt.optimize()

    RandomGenerator.set_seed(6)
    p_opt = LocalOptimizer(
        port, DataSet.array([Sample(x[i], y[i]) for i in range(n)])
        .transform(SampleToMiniBatch(1)),
        SequenceCrossEntropyCriterion(), batch_size=1)
    p_opt.set_optim_method(SGD(learning_rate=0.1))
    p_opt.set_end_when(max_iteration(3))
    with kernels.use(PORT_K2):
        p_opt.optimize()
    assert [h["neval"] for h in p_opt.history] == [1, 2, 3]
    assert abs(p_opt.driver_state["Loss"] - j_opt.driver_state["Loss"]) \
        <= ATOL
    assert all(np.isfinite(h["loss"]) for h in p_opt.history)
    _assert_trees_close(export_params(port),
                        jax.tree.map(np.asarray, ref.get_parameters()))


def test_train_cli_long_sequence_runs_through_k2(monkeypatch, capsys):
    """The train CLI at a long ``--seqLen`` with ``--inputMode
    contiguous -b 1``: past the budget every attention call goes to K2
    (here its plain version), and the positional table holds seqLen."""
    monkeypatch.setenv("BIGDL_VMEM_BUDGET_MB", "1")
    spy = _Spy(dispatch.blockwise_flash_attention)
    monkeypatch.setattr(dispatch, "blockwise_flash_attention", spy)
    model = transformer_train.main([
        "--synthetic", "3000", "--device", "cpu", "--inputMode",
        "contiguous", "-b", "1", "--vocabSize", str(VOCAB),
        "--hiddenSize", "32", "--layers", "2", "--heads", "2",
        "--seqLen", str(SEQ), "--maxIterations", "2"])
    assert "final loss:" in capsys.readouterr().out
    assert spy.calls == 2 * 2
    assert model.pos_embed.shape[0] == SEQ


# ---------------------------------------------------------- chunked prefill

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=64)
BUCKETS, CHUNK, SLOTS, ROWS = (16, 32, 64), 16, 4, 2


@pytest.fixture(scope="module")
def models():
    JaxRandomGenerator.set_seed(42)
    ref = JaxTransformerLM(**GEOM).evaluate()
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = load_jax_params(TransformerLM(**GEOM, device="cpu"), params)
    return ref, port


@pytest.fixture(scope="module")
def jax_engine(models):
    ref, _ = models
    eng = JaxDecodeEngine(JaxCompileCache(),
                          JaxBucketLadder(64, buckets=BUCKETS), slots=SLOTS,
                          prefill_rows=ROWS, prefill_chunk=CHUNK)
    sv = JaxServable("lm", 1, ref, ref.get_parameters(), ref.get_state())
    return eng, sv


def _port_engine(chunk):
    return DecodeEngine(CompileCache(), BucketLadder(64, buckets=BUCKETS),
                        slots=SLOTS, prefill_rows=ROWS, prefill_chunk=chunk)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 64, n).astype(np.int32)


def _port_prefill(port, chunk, prompts, slots):
    kv = KVCache.for_model(port, SLOTS, 64, device="cpu")
    logits, bucket = _port_engine(chunk).prefill(Servable("lm", 1, port),
                                                 kv, prompts, slots)
    return logits, bucket, kv


@pytest.mark.parametrize("plen", [15, 16, 17, 31, 33, 48, 63, 64])
def test_chunked_prefill_matches_jax_and_single_shot(plen, models,
                                                     jax_engine):
    """At every length straddling a chunk boundary: the last-token
    logits and the slot's KV rows of the port's chunked prefill within
    1e-5 of the JAX engine's chunked prefill and of the port's own
    single-shot prefill."""
    _, port = models
    eng, sv = jax_engine
    prompt = _prompt(plen, seed=plen)
    kv_j = JaxKVCache.for_model(sv.model, SLOTS, 64)
    want, bucket_j = eng.prefill(sv, kv_j, [prompt], [1])
    got, bucket, kv_c = _port_prefill(port, CHUNK, [prompt], [1])
    single, _, kv_s = _port_prefill(port, None, [prompt], [1])
    assert bucket == bucket_j
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=0)
    for name in ("k", "v"):
        rows = getattr(kv_c, name)[:, 1, :, :plen].numpy()
        np.testing.assert_allclose(
            rows, np.asarray(getattr(kv_j, name))[:, 1, :, :plen],
            atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(
            rows, getattr(kv_s, name)[:, 1, :, :plen].numpy(), atol=ATOL,
            rtol=0, err_msg=name)
    assert kv_c.lengths[1] == plen


def test_chunked_batch_rows_leave_at_their_last_chunk(models, jax_engine):
    """Two prompts of one rung-64 batch (10 and 60 tokens): the short
    row rides chunk 0 only and takes its logits there, the long row
    from chunk 3 — equal to the JAX engine's batch and to each prompt
    prefilled alone."""
    _, port = models
    eng, sv = jax_engine
    prompts = [_prompt(10, seed=1), _prompt(60, seed=2)]
    kv_j = JaxKVCache.for_model(sv.model, SLOTS, 64)
    want, _ = eng.prefill(sv, kv_j, prompts, [2, 0])
    got, bucket, kv = _port_prefill(port, CHUNK, prompts, [2, 0])
    assert bucket == 64
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    for i, (p, slot) in enumerate(zip(prompts, (2, 0))):
        alone, _, _ = _port_prefill(port, None, [p], [slot])
        np.testing.assert_allclose(got[i], alone[0], atol=ATOL, rtol=0)
    assert list(kv.lengths) == [60, 0, 10, 0]


def test_padding_rows_are_never_written_back(models):
    """One prompt in a two-row batch: the padding row (out-of-range slot
    id, which gathers the last slot) writes nothing, in any chunk; only
    the prompt's slot changes."""
    _, port = models
    _, _, kv = _port_prefill(port, CHUNK, [_prompt(50, seed=9)], [1])
    for buf in (kv.k, kv.v):
        assert torch.count_nonzero(buf[:, [0, 2, 3]]) == 0
        assert torch.count_nonzero(buf[:, 1]) > 0


def test_chunked_prefill_one_program_per_rung(models):
    _, port = models
    eng = _port_engine(CHUNK)
    sv = Servable("lm", 1, port)
    kv = KVCache.for_model(port, SLOTS, 64, device="cpu")
    for i, plen in enumerate((10, 20, 40, 60)):     # rungs 16, 32, 64, 64
        eng.prefill(sv, kv, [_prompt(plen, seed=i)], [0])
    assert eng.compile_count(sv) == 3


@pytest.mark.parametrize("chunk", [0, 5, 8, 12, 16, 24, 32, 64, 100])
def test_prefill_chunk_admission_matches_jax(chunk):
    """The chunk must be >= 1 and divide every larger rung: the port
    accepts or raises ValueError exactly where the JAX engine does."""
    def outcome(make):
        try:
            return make().chunk_for(64)
        except ValueError as e:
            return type(e)

    want = outcome(lambda: JaxDecodeEngine(
        JaxCompileCache(), JaxBucketLadder(64, buckets=BUCKETS), slots=4,
        prefill_rows=2, prefill_chunk=chunk))
    assert outcome(lambda: _port_engine(chunk)) == want
    if want is ValueError:
        with pytest.raises(ValueError):
            GenerationService(config=GenerationConfig(
                slots=2, max_len=64, length_buckets=BUCKETS,
                prefill_chunk=chunk), device="cpu")


def test_chunk_for():
    eng = _port_engine(CHUNK)
    assert [eng.chunk_for(r) for r in BUCKETS] == [16, 16, 16]
    assert _port_engine(32).chunk_for(16) == 16
    assert _port_engine(None).chunk_for(64) == 64


def _serve(svc, prompts):
    """Greedy streams of ``prompts``, one request at a time (so each
    admitted batch is one prompt and the chunk count is fixed), and the
    service's metrics."""
    try:
        out = [list(map(int, svc.generate("lm", p, max_new_tokens=4)
                        .result(timeout=120))) for p in prompts]
        return out, svc.metrics("lm")
    finally:
        svc.shutdown()


@pytest.fixture(scope="module")
def served(models):
    ref, port = models
    prompts = [_prompt(n, seed=30 + n) for n in (60, 12, 33, 47)]
    cfg = dict(slots=2, max_len=64, length_buckets=BUCKETS, prefill_rows=2)
    jsvc = JaxGenerationService(config=JaxGenerationConfig(
        **cfg, prefill_chunk=CHUNK))
    jsvc.load("lm", ref)
    runs = {"jax": _serve(jsvc, prompts)}
    for chunk in (CHUNK, None):
        svc = GenerationService(config=GenerationConfig(
            **cfg, prefill_chunk=chunk), device="cpu")
        svc.load("lm", port)
        runs[chunk] = _serve(svc, prompts)
    return prompts, runs


def test_chunked_service_tokens_identical_to_jax_and_unchunked(served):
    _, runs = served
    assert runs[CHUNK][0] == runs["jax"][0]
    assert runs[CHUNK][0] == runs[None][0]
    assert all(len(t) == 4 for t in runs[CHUNK][0])


def test_prefill_chunks_counted_as_the_jax_service_counts(served):
    """Chunk calls per admitted batch (a chunk runs iff some row still
    has tokens there): ceil(L / 16) for each one-prompt batch here, as
    the JAX service counts; one per batch when chunking is off. The
    program count stays within 2 per rung."""
    prompts, runs = served
    m, m_jax, m_off = runs[CHUNK][1], runs["jax"][1], runs[None][1]
    assert m["prefill_chunks"] == m_jax["prefill_chunks"] \
        == sum(-(-len(p) // CHUNK) for p in prompts)
    assert m_off["prefill_chunks"] == len(prompts)
    assert m["compile_count"] <= 2 * len(BUCKETS)
