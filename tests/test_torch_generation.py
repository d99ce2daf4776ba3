"""The port's GenerationService on the CPU against the JAX package's, on
the same weights and the same seeded ragged prompts.

Greedy streams must be token-identical, and seeded top-k streams too:
sampling is the same host numpy code on both sides, and the logits it
reads agree within float32 reduction order (atol 1e-5, see
test_torch_transformer), far inside the margins these seeds draw at.
Also pinned: the ≤ 2-programs-per-rung bound, admission errors, hot-swap
and unload, preemption, supervised restarts, thread hygiene at
shutdown, and that no device means the card — never a silent run on
the CPU."""
import threading

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.generation import GenerationConfig as JaxGenerationConfig
from bigdl_tpu.generation import GenerationService as JaxGenerationService
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.generation import (GenerationConfig, GenerationService,
                                        KVCache)
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import QueueFull, WorkerDied

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=32)
CFG = dict(slots=4, max_len=32, length_buckets=(16, 32), prefill_rows=2)
MAX_NEW = 8


def _prompts():
    r = np.random.default_rng(21)
    return [r.integers(1, 64, n).astype(np.int32)
            for n in r.integers(2, 24, 6)]


def _run(svc, prompts, **kw):
    streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW, seed=i, **kw)
               for i, p in enumerate(prompts)]
    return [list(map(int, s.result(timeout=120))) for s in streams]


@pytest.fixture(scope="module")
def runs():
    RandomGenerator.set_seed(5)
    ref_model = JaxTransformerLM(**GEOM).evaluate()
    ref_model.ensure_initialized()
    params = jax.tree.map(np.asarray, ref_model.get_parameters())
    port_model = load_jax_params(TransformerLM(**GEOM, device="cpu"),
                                 params)
    prompts = _prompts()

    ref = JaxGenerationService(config=JaxGenerationConfig(**CFG))
    try:
        ref.load("lm", ref_model)
        want_greedy = _run(ref, prompts)
        want_topk = _run(ref, prompts, temperature=0.8, top_k=5)
    finally:
        ref.shutdown()

    port = GenerationService(config=GenerationConfig(**CFG), device="cpu")
    try:
        port.load("lm", port_model)
        got_greedy = _run(port, prompts)
        got_topk = _run(port, prompts, temperature=0.8, top_k=5)
        metrics = port.metrics("lm")
    finally:
        port.shutdown()
    return dict(want_greedy=want_greedy, got_greedy=got_greedy,
                want_topk=want_topk, got_topk=got_topk, metrics=metrics,
                port=port, model=port_model)


def test_greedy_tokens_identical_to_jax(runs):
    assert runs["got_greedy"] == runs["want_greedy"]
    assert all(len(t) == MAX_NEW for t in runs["got_greedy"])


def test_seeded_topk_tokens_identical_to_jax(runs):
    assert runs["got_topk"] == runs["want_topk"]
    assert runs["got_topk"] != runs["got_greedy"]  # sampling really ran


def test_program_count_within_two_per_rung(runs):
    m = runs["metrics"]
    assert m["compile_count"] == 2 * len(CFG["length_buckets"])
    assert m["tokens"] == 2 * len(_prompts()) * MAX_NEW
    assert m["finished"] == 2 * len(_prompts())


def test_shutdown_leaves_no_live_thread(runs):
    port = runs["port"]
    assert all(not loop._thread.is_alive()
               for loop in port._loops.values())
    leaked = [t.name for t in threading.enumerate()
              if t.is_alive() and not t.daemon
              and t is not threading.main_thread()]
    assert leaked == []
    with pytest.raises(RuntimeError, match="shut down"):
        port.generate("lm", [1, 2, 3])


def test_queue_full_and_oversized_prompt(runs):
    svc = GenerationService(config=GenerationConfig(**CFG, max_queue=2),
                            device="cpu")
    try:
        svc.load("lm", runs["model"])
        with pytest.raises(ValueError, match="no room"):
            svc.generate("lm", np.ones(CFG["max_len"], np.int32))
        loop = svc._loop("lm")
        # holding the loop's condition keeps its decode thread from admitting,
        # so the queue fills deterministically
        with loop._cond:
            held = [svc.generate("lm", [1, 2, 3], max_new_tokens=2)
                    for _ in range(2)]
            with pytest.raises(QueueFull):
                svc.generate("lm", [4, 5], max_new_tokens=2)
        assert svc.metrics("lm")["rejected"] == 1
        for s in held:
            assert len(s.result(timeout=60)) == 2
    finally:
        svc.shutdown()


def test_no_device_means_cuda_never_the_cpu():
    if torch.cuda.is_available():
        assert GenerationService().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(**GEOM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVCache(1, 1, 1, 4, 32)


def test_model_on_another_device_is_refused(runs):
    svc = GenerationService(config=GenerationConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        svc.load("lm", TransformerLM(**GEOM, device="cpu").to("meta"))


def _greedy_reference(model, prompt, n):
    """Greedy tokens from full forwards without a cache."""
    toks = [int(t) for t in prompt]
    with torch.no_grad():
        for _ in range(n):
            toks.append(int(model(torch.tensor([toks]))[0, -1].argmax()))
    return toks[len(prompt):]


def test_hot_swap_serves_the_new_version_and_unload_drops_programs(runs):
    v1 = runs["model"]
    v2 = TransformerLM(**GEOM, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    prompt = _prompts()[0]
    svc = GenerationService(config=GenerationConfig(**CFG), device="cpu")
    try:
        svc.load("lm", v1)
        a = svc.generate("lm", prompt, max_new_tokens=MAX_NEW).result(60)
        svc.load("lm", v2)                   # warms v2, then swaps it in
        b = svc.generate("lm", prompt, max_new_tokens=MAX_NEW).result(60)
        assert list(a) == runs["got_greedy"][0] \
            == _greedy_reference(v1, prompt, MAX_NEW)
        assert list(b) == _greedy_reference(v2, prompt, MAX_NEW)
        assert svc.compile_count("lm", 1) == svc.compile_count("lm", 2) == 4
        with pytest.raises(ValueError, match="current"):
            svc.unload("lm", 2)
        svc.unload("lm", 1)
        assert svc.registry.versions("lm") == [2]
        assert svc.compile_count("lm") == 4
    finally:
        svc.shutdown()


def test_preempt_fails_a_queued_generation_typed(runs):
    svc = GenerationService(config=GenerationConfig(**CFG), device="cpu")
    try:
        svc.load("lm", runs["model"])
        loop = svc._loop("lm")
        err = RuntimeError("preempted for a higher-priority request")
        with loop._cond:  # the decode thread cannot admit it
            stream = svc.generate("lm", [1, 2, 3], max_new_tokens=4)
            assert svc.preempt("lm", stream, err) == "queued"
        with pytest.raises(RuntimeError, match="preempted"):
            stream.result(timeout=10)
        assert err.tokens == []
        assert svc.preempt("lm", stream, RuntimeError()) is None
        assert svc.metrics("lm")["queue_depth"] == 0
    finally:
        svc.shutdown()


def test_loop_death_fails_streams_typed_and_restarts(runs):
    svc = GenerationService(config=GenerationConfig(**CFG), device="cpu")
    try:
        svc.load("lm", runs["model"])
        real, calls = svc.engine.decode, []

        def dies_once(*args, **kwargs):
            if not calls:
                calls.append(1)
                raise RuntimeError("injected decode failure")
            return real(*args, **kwargs)

        svc.engine.decode = dies_once
        doomed = svc.generate("lm", [1, 2, 3], max_new_tokens=4)
        with pytest.raises(WorkerDied, match="injected"):
            doomed.result(timeout=30)
        again = svc.generate("lm", [1, 2, 3], max_new_tokens=4)
        assert len(again.result(timeout=30)) == 4
        assert svc.metrics("lm")["worker_restarts"] == 1
    finally:
        svc.shutdown()
