"""Fleet serving, the port against the JAX package (``bigdl_tpu.fleet``)
at the JAX fleet tests' width (vocab 64, hidden 32, 2 layers, 4 heads,
max_len 32), weights carried with ``convert.load_jax_params``:

- prefix/KV reuse: a full-prompt hit's stream is bitwise its cold
  stream and the JAX package's stream; a chunk-boundary partial hit
  prefills only the uncovered chunks and equals a cold service and the
  JAX package; the same LRU evictions, refusals and entries as the JAX
  package's cache under one budget and one sequence of operations;
  ``drop_version`` at unload;
- speculative decoding: greedy streams equal target-only greedy and the
  JAX decoder's tokens (with its proposal and acceptance counts);
  seeded sampling equals the JAX decoder's stream for one seed; the
  ≤ 3 / ≤ 2 program bounds; the size and vocabulary refusals;
- the router: the same placement sequence as the JAX router over
  duck-typed replicas (least-loaded, sticky sessions, drain, breakers,
  a seeded canary split); drain, typed sheds and a rerouted stream
  after a kill over real replicas; a process-hosted replica on the CPU
  serves the thread replica's tokens and dies typed;
- ``apply_tuned_config`` on a ``tuned.json`` the JAX package wrote.

Tolerance: token streams and counts are equal. The port's logits agree
with the JAX package's within float32 reduction order (atol 1e-5,
test_torch_transformer), far inside the top-2 gaps these seeds draw;
the KV rows a hit seeds are copies of the bytes its cold prefill wrote,
so hit and cold streams are bitwise equal within the port."""
import json

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.telemetry as jtelemetry
from bigdl_tpu.autotune.config import Fingerprint as JaxFingerprint
from bigdl_tpu.autotune.config import TunedConfig as JaxTunedConfig
from bigdl_tpu.autotune.config import save_tuned as jax_save_tuned
from bigdl_tpu.fleet import FleetRouter as JaxRouter
from bigdl_tpu.fleet import PrefixCache as JaxPrefixCache
from bigdl_tpu.fleet import SpeculativeConfig as JaxSpecConfig
from bigdl_tpu.fleet import SpeculativeDecoder as JaxSpecDecoder
from bigdl_tpu.generation import GenerationConfig as JaxGenConfig
from bigdl_tpu.generation import GenerationService as JaxGenService
from bigdl_tpu.generation import apply_tuned_config as jax_apply_tuned
from bigdl_tpu.generation.sampling import SamplingParams as JaxSampling
from bigdl_tpu.generation.stream import TokenStream as JaxTokenStream
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving.breaker import CircuitBreaker as JaxBreaker
from bigdl_tpu.serving.breaker import Degraded as JaxDegraded
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.autotune import (Fingerprint, FingerprintMismatchError,
                                      TunedConfigError, load_tuned)
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.fleet import (FleetRouter, PrefixCache, ProcessReplica,
                                   SpeculativeConfig, SpeculativeDecoder,
                                   build_replicas, register_fleet_instruments)
from bigdl_tpu_torch.generation import (GenerationConfig, GenerationService,
                                        apply_tuned_config)
from bigdl_tpu_torch.generation.sampling import SamplingParams
from bigdl_tpu_torch.generation.stream import TokenStream
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.serving import CircuitBreaker, Degraded, QueueFull, \
    WorkerDied

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=32)
DRAFT = dict(GEOM, hidden_size=16, num_layers=1, num_heads=2)
SERVE = dict(slots=4, max_len=32, length_buckets=(32,), prefill_rows=2)
CHUNKED = dict(slots=2, max_len=32, length_buckets=(32,), prefill_rows=2,
               prefill_chunk=8)
PROMPTS = [np.array([3, 7, 1, 4, 9], np.int32), np.array([11, 2], np.int32)]


def _pair(seed, geom):
    """A seeded JAX TransformerLM and its port twin (same weights)."""
    RandomGenerator.set_seed(seed)
    ref = JaxTransformerLM(**geom).evaluate()
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    return ref, load_jax_params(TransformerLM(**geom, device="cpu"), params)


@pytest.fixture(scope="module")
def target():
    return _pair(42, GEOM)


@pytest.fixture(scope="module")
def draft():
    return _pair(7, DRAFT)


def _port_service(model, **cfg):
    svc = GenerationService(config=GenerationConfig(**cfg), device="cpu")
    svc.load("lm", model)
    return svc


def _jax_service(model, **cfg):
    svc = JaxGenService(config=JaxGenConfig(**cfg),
                        metrics_registry=jtelemetry.MetricsRegistry())
    svc.load("lm", model)
    return svc


def _tokens(svc, prompt, **kw):
    return list(map(int, svc.generate("lm", prompt, max_new_tokens=6,
                                      **kw).result(60)))


def _fills(svc):
    return len(svc.metrics_registry.histogram(
        "serving/generation/prefill_fill").samples(model="lm"))


# ------------------------------------------------------- prefix cache

def test_prefix_hit_is_bitwise_the_cold_stream_and_the_jax_stream(target):
    """A full-prompt hit dispatches no prefill and streams the cold
    stream's tokens, greedy and seeded top-k alike; both equal the JAX
    package's, with the same hit, miss and entry counts."""
    ref_model, model = target
    prompt = PROMPTS[0]
    got, want = {}, {}
    for out, svc in ((got, _port_service(model, **SERVE,
                                         prefix_cache_bytes=1 << 20)),
                     (want, _jax_service(ref_model, **SERVE,
                                         prefix_cache_bytes=1 << 20))):
        try:
            out["cold"] = _tokens(svc, prompt)
            fills = _fills(svc)
            out["hit"] = _tokens(svc, prompt)
            out["hit_fills"] = _fills(svc) - fills
            out["sampled"] = [_tokens(svc, prompt, temperature=0.9,
                                      top_k=5, seed=3) for _ in range(2)]
            m = svc.metrics("lm")
            out["counts"] = (m["prefix_hits"], m["prefix_misses"],
                             m["prefix_entries"])
        finally:
            svc.shutdown()
    assert got["hit"] == got["cold"] and got["hit_fills"] == 0
    assert got["sampled"][0] == got["sampled"][1]
    assert got == want
    assert got["counts"] == (3, 1, 1)
    plain = _port_service(model, **SERVE)
    try:
        assert _tokens(plain, prompt) == got["cold"]
    finally:
        plain.shutdown()


def test_a_chunk_boundary_partial_hit_prefills_only_the_rest(target):
    """Two 24-token prompts sharing 16 tokens under 8-token chunks: the
    first inserts its full entry and its first chunk; the second
    partial-hits at 8 tokens and prefills 2 chunks, not 3. Its stream
    equals a service without the cache and the JAX package's, and the
    counters and entries equal the JAX package's."""
    ref_model, model = target
    r = np.random.RandomState(4)
    head = r.randint(1, 64, 16)
    p1, p2 = (np.concatenate([head, r.randint(1, 64, 8)]).astype(np.int32)
              for _ in range(2))
    got, want = {}, {}
    for out, svc in ((got, _port_service(model, **CHUNKED,
                                         prefix_cache_bytes=1 << 20)),
                     (want, _jax_service(ref_model, **CHUNKED,
                                         prefix_cache_bytes=1 << 20))):
        try:
            out["p1"] = _tokens(svc, p1)
            chunks = svc.metrics("lm")["prefill_chunks"]
            out["p2"] = _tokens(svc, p2)
            m = svc.metrics("lm")
            out["chunks"] = (chunks, m["prefill_chunks"] - chunks)
            out["partial"] = svc.metrics_registry.counter(
                "fleet/prefix/partial_hits").value(model="lm")
            out["entries"] = m["prefix_entries"]
        finally:
            svc.shutdown()
    assert got["chunks"] == (3, 2) and got["partial"] == 1
    assert got["entries"] == 3  # p1, p1's first chunk, p2
    assert got == want
    cold = _port_service(model, **CHUNKED)
    try:
        assert _tokens(cold, p2) == got["p2"]
    finally:
        cold.shutdown()


def _entry(mod, n, rung=8, hd=4):
    """One synthetic entry's k, v and logits in package ``mod``'s
    arrays (``torch`` or JAX's numpy)."""
    if mod == "jax":
        import jax.numpy as jnp
        k = jnp.full((1, 2, rung, hd), float(n))
    else:
        k = torch.full((1, 2, rung, hd), float(n))
    return k, k + 1.0, np.full((8,), float(n), np.float32)


def _script(cache, mod, rng_seed=0, steps=300):
    """The JAX tests' refcount/LRU/capacity sequence, then a seeded
    stream of lookups, inserts and releases: every outcome in order."""
    vk = ("m", 1)
    one = 2 * 1 * 2 * 8 * 4 * 4 + 32
    cache.max_bytes = 3 * one
    log = [cache.insert(vk, [i], *_entry(mod, i)) is not None
           for i in range(3)]
    hit = cache.lookup(vk, [0])
    cache.release(hit)
    log.append(cache.insert(vk, [3], *_entry(mod, 3)) is not None)
    log.append(cache.lookup(vk, [1]) is None)
    pins = [cache.lookup(vk, [t]) for t in (0, 2, 3)]
    log.append([p is not None for p in pins])
    log.append(cache.insert(vk, [9], *_entry(mod, 9)) is None)
    for p in pins:
        cache.release(p)
    log.append(cache.insert(vk, [9], *_entry(mod, 9)) is not None)
    rng = np.random.RandomState(rng_seed)
    pinned = {}
    for _ in range(steps):
        t, op = int(rng.randint(0, 12)), rng.rand()
        if op < 0.45:
            entry = cache.lookup(vk, [t])
            log.append(("lookup", t, entry is not None))
            if entry is not None and t not in pinned:
                pinned[t] = entry
            elif entry is not None:
                cache.release(entry)
        elif op < 0.8:
            log.append(("insert", t, cache.insert(
                vk, [t], *_entry(mod, t)) is not None))
        elif pinned:
            cache.release(pinned.pop(min(pinned)))
        log.append((len(cache), cache.nbytes() <= cache.max_bytes,
                    cache.pinned()))
    for entry in pinned.values():
        cache.release(entry)
    return log


def test_lru_evictions_refusals_and_entries_equal_the_jax_caches():
    r_port, r_jax = telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry()
    port = PrefixCache(1 << 20, metrics=r_port)
    ref = JaxPrefixCache(1 << 20, metrics=r_jax)
    assert _script(port, "torch") == _script(ref, "jax")
    for name in ("hits", "misses", "inserts", "evictions"):
        assert r_port.counter(f"fleet/prefix/{name}").value() == \
            r_jax.counter(f"fleet/prefix/{name}").value(), name
    assert r_port.counter("fleet/prefix/evictions").value() > 0
    assert (len(port), port.nbytes()) == (len(ref), ref.nbytes())
    assert PrefixCache.key_for(("lm", 2), [5, 6, 7]) == \
        JaxPrefixCache.key_for(("lm", 2), [5, 6, 7])


def test_extract_copies_rows_and_seed_writes_them_back(target):
    """``extract`` is a copy (a later write to the slot leaves the entry
    as it was); ``seed`` puts the rows and the length back."""
    from bigdl_tpu_torch.generation import KVCache
    kv = KVCache.for_model(target[1], 2, 32)
    kv.k.normal_(generator=torch.Generator().manual_seed(0))
    k, v = PrefixCache.extract(kv, 1, 16)
    want = k.clone()
    kv.k[:, 1].zero_()
    assert torch.equal(k, want)
    cache = PrefixCache(1 << 20, metrics=telemetry.MetricsRegistry())
    entry = cache.insert(("lm", 1), np.arange(10), k, v, None)
    PrefixCache.seed(kv, 0, entry)
    assert torch.equal(kv.k[:, 0, :, :16], want) and kv.lengths[0] == 10


def test_unload_drops_a_versions_entries_as_the_jax_package(target):
    """Per version: v1 and v2 each cache the prompt; unloading v1 drops
    its entry only, unloading the name drops the rest; a pinned entry
    is doomed, never hit again, and drops at its last release."""
    ref_model, model = target
    seen = []
    for svc, m in ((_port_service(model, **SERVE,
                                  prefix_cache_bytes=1 << 20), model),
                   (_jax_service(ref_model, **SERVE,
                                 prefix_cache_bytes=1 << 20), ref_model)):
        counts = []
        try:
            _tokens(svc, PROMPTS[0])
            svc.load("lm", m)
            _tokens(svc, PROMPTS[0])
            counts.append(len(svc.prefix))
            svc.unload("lm", version=1)
            counts.append(len(svc.prefix))
            svc.unload("lm")
            counts.append(len(svc.prefix))
        finally:
            svc.shutdown()
        seen.append(counts)
    assert seen[0] == seen[1] == [2, 1, 0]
    cache = PrefixCache(1 << 20, metrics=telemetry.MetricsRegistry())
    v1, v2 = ("m", 1), ("m", 2)
    cache.insert(v1, [1], *_entry("torch", 1))
    cache.insert(v2, [1], *_entry("torch", 2))
    pinned = cache.lookup(v1, [1])
    assert cache.drop_version(v1) == 0
    assert cache.lookup(v1, [1]) is None
    cache.release(pinned)
    assert len(cache) == 1 and cache.lookup(v2, [1]).version_key == v2


# -------------------------------------------------------- speculative

@pytest.fixture(scope="module")
def spec_runs(target, draft):
    """Target-only greedy references, and the weak-draft decoder's
    greedy and seeded-sampling runs in both packages."""
    (ref_t, t), (ref_d, d) = target, draft
    svc = _port_service(t, **SERVE)
    try:
        refs = [list(map(int, svc.generate("lm", p, max_new_tokens=8)
                         .result(60))) for p in PROMPTS]
    finally:
        svc.shutdown()
    cfg = dict(k=3, slots=4, max_len=32, length_buckets=(32,))
    port = SpeculativeDecoder(t, d, SpeculativeConfig(**cfg),
                              metrics=telemetry.MetricsRegistry(),
                              device="cpu")
    ref = JaxSpecDecoder(ref_t, ref_d, JaxSpecConfig(**cfg),
                         metrics=jtelemetry.MetricsRegistry())
    out = {"refs": refs, "port": port}
    for key, dec, sp in (("port", port, SamplingParams),
                         ("jax", ref, JaxSampling)):
        greedy, stats = dec.generate(PROMPTS, max_new_tokens=8)
        out[f"{key}_greedy"] = [list(map(int, o)) for o in greedy]
        out[f"{key}_stats"] = stats
        out[f"{key}_sampled"] = [
            [list(map(int, o)) for o in dec.generate(
                PROMPTS[:1], max_new_tokens=8,
                sampling=sp(temperature=0.8, top_k=5, seed=13))[0]]
            for _ in range(2)]
    return out


def test_speculative_greedy_equals_target_only_and_the_jax_decoder(
        spec_runs, target):
    assert spec_runs["port_greedy"] == spec_runs["refs"]
    assert spec_runs["jax_greedy"] == spec_runs["refs"]
    assert spec_runs["port_stats"] == spec_runs["jax_stats"]
    t = target[1]
    self_draft = SpeculativeDecoder(t, t, SpeculativeConfig(
        k=3, slots=4, max_len=32, length_buckets=(32,)),
        metrics=telemetry.MetricsRegistry(), device="cpu")
    outs, stats = self_draft.generate(PROMPTS, max_new_tokens=8)
    assert [list(map(int, o)) for o in outs] == spec_runs["refs"]
    assert stats["accept_rate"] == 1.0 and stats["macro_steps"] == 3


def test_seeded_speculative_sampling_equals_the_jax_decoder(spec_runs):
    a, b = spec_runs["port_sampled"]
    assert a == b and len(a[0]) == 8
    assert a == spec_runs["jax_sampled"][0]


def test_program_bounds_three_for_the_target_two_for_the_draft(target,
                                                              draft):
    buckets = (8, 16, 32)
    dec = SpeculativeDecoder(target[1], draft[1], SpeculativeConfig(
        k=2, slots=2, max_len=32, length_buckets=buckets),
        metrics=telemetry.MetricsRegistry(), device="cpu")
    prompts = [np.array([3, 7, 1, 4], np.int32),
               np.array([5, 6], np.int32)]
    dec.generate(prompts, max_new_tokens=6)
    with dec.engine._lock:
        keys = {sv: set(ks) for sv, ks in dec.engine._keys.items()}
    for sv_key, ks in keys.items():
        per_bucket = {}
        for k in ks:
            per_bucket.setdefault(k[-1], set()).add(k[-2])
        bound = 3 if sv_key == dec.target.key else 2
        assert all(len(kinds) <= bound for kinds in per_bucket.values())
    warm = dec.compile_count()
    assert 0 < warm <= 5 * len(buckets)
    dec.generate(prompts, max_new_tokens=6)
    assert dec.compile_count() == warm


def test_size_and_vocabulary_refusals_as_in_the_jax_package(target, draft):
    (ref_t, t), (ref_d, d) = target, draft
    other = TransformerLM(**dict(GEOM, vocab_size=49), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecoder(t, other, device="cpu")
    cfg = dict(k=4, slots=2, max_len=16, length_buckets=(16,))
    long = [np.arange(1, 11, dtype=np.int32)]  # 10 + 8 + 4 > 16
    for dec in (SpeculativeDecoder(t, d, SpeculativeConfig(**cfg),
                                   device="cpu"),
                JaxSpecDecoder(ref_t, ref_d, JaxSpecConfig(**cfg))):
        with pytest.raises(ValueError, match="overruns"):
            dec.generate(long, max_new_tokens=8)
        with pytest.raises(ValueError, match="slots"):
            dec.generate(PROMPTS * 2, max_new_tokens=2)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeDecoder(t, d, SpeculativeConfig(k=0), device="cpu")


def test_a_verify_fault_raises_typed_and_frees_the_slots(spec_runs):
    dec = spec_runs["port"]
    with faults.armed("fleet/verify=nth:1,raise:RuntimeError") as sched:
        with pytest.raises(RuntimeError, match="injected fault"):
            dec.generate(PROMPTS, max_new_tokens=6)
    assert sched.total_fired() == 1
    assert dec._target_kv.allocator.free_count == dec.config.slots
    outs, _ = dec.generate(PROMPTS, max_new_tokens=8)
    assert [list(map(int, o)) for o in outs] == spec_runs["refs"]


# ------------------------------------------------------------- router

class _Fake:
    """A duck-typed replica with a scripted load whose streams finish at
    once with one token (``pkg`` picks the package's stream and
    breaker)."""

    def __init__(self, name, load, pkg):
        self.name, self._load, self.state = name, load, "serving"
        self._stream = JaxTokenStream if pkg == "jax" else TokenStream
        self.breaker = (JaxBreaker if pkg == "jax" else CircuitBreaker)(
            failures=2, cooldown_ms=1e6)

    def accepting(self):
        return self.state == "serving" and self.breaker.allow()

    def load(self):
        return self._load

    def submit(self, prompt, **kw):
        s = self._stream(len(prompt), 1)
        s._push(int(prompt[0]))
        s._finish("max_tokens")
        return s

    def drain(self):
        self.state = "draining"

    def resume(self):
        self.state = "serving"

    def shutdown(self, drain=True):
        self.state = "dead"


def _placements(router_cls, registry, pkg, degraded):
    reps = [_Fake(n, load, pkg) for n, load in
            (("a", 3), ("b", 1), ("c", 2), ("d", 1))]
    router = router_cls(reps, metrics=registry)
    by = {r.name: r for r in reps}
    seq = []

    def place(session=None):
        s = router.submit([5, 6], session=session, max_new_tokens=1)
        seq.append(s._replica.name)

    for i in range(3):
        place()
        place(session=f"u{i}")
    by["b"]._load = 9
    for i in range(3):
        place(session=f"u{i}")
        place()
    router.drain("d")
    place()
    place(session="u0")
    for _ in range(2):
        by["c"].breaker.on_failure()
    place()
    by["d"].resume()
    router.set_split("a", 0.5, seed=3)
    for i in range(12):
        place(session="u1" if i % 3 == 0 else None)
    router.clear_split()
    router.remove("b")
    place(session="u1")
    for r in reps:
        r.state = "draining"
    with pytest.raises(degraded):
        place()
    return seq, router.metrics()


def test_router_placement_equals_the_jax_routers_over_fake_replicas():
    got, gm = _placements(FleetRouter, telemetry.MetricsRegistry(), "torch",
                          Degraded)
    want, wm = _placements(JaxRouter, jtelemetry.MetricsRegistry(), "jax",
                           JaxDegraded)
    assert got == want
    assert gm == wm
    assert len(set(got)) == 4 and "a" in got[-13:]


def test_drain_sheds_and_a_rerouted_stream_after_a_kill():
    metrics = telemetry.MetricsRegistry()
    router = FleetRouter(build_replicas(2, max_queue=8, metrics=metrics,
                                        device="cpu"), metrics=metrics)
    prompt = np.array([3, 7, 1], np.int32)
    try:
        ref = list(router.submit(prompt, max_new_tokens=8).result(60))
        with faults.armed("serving/decode=delay:25,times:1000"):
            router._sessions["x"] = "r0"
            s = router.submit(prompt, session="x", max_new_tokens=8)
            s.first(30)
            next(r for r in router.replicas() if r.name == "r0").kill()
            assert list(s.result(60)) == ref
        assert s._replica.name == "r1"
        m = router.metrics()
        assert (m["evictions"], m["reroutes"]) == (1, 1)
        assert m["states"]["r0"] == "dead"
        router.drain("r1")
        with pytest.raises(Degraded):
            router.submit(prompt, max_new_tokens=2)
        assert router.metrics()["shed"] == 1
        next(r for r in router.replicas() if r.name == "r1").resume()
        with faults.armed("fleet/route=nth:1,raise:OSError"):
            with pytest.raises(OSError):
                router.submit(prompt, max_new_tokens=2)
        assert list(router.submit(prompt, max_new_tokens=8)
                    .result(60)) == ref
    finally:
        router.shutdown()
    assert router.fleet_snapshot() == []
    with pytest.raises(NotImplementedError, match="item 12"):
        FleetRouter([], telemetry_dir="snapshots").fleet_snapshot()


def test_every_accepting_replica_queue_full_rejects_typed():
    metrics = telemetry.MetricsRegistry()
    router = FleetRouter(build_replicas(2, max_queue=1, slots=1,
                                        metrics=metrics, device="cpu"),
                         metrics=metrics)
    try:
        with faults.armed("serving/decode=delay:40,times:1000"):
            streams = []
            with pytest.raises(QueueFull):
                for _ in range(12):
                    streams.append(router.submit(
                        np.array([3, 7, 1], np.int32), max_new_tokens=8))
            for s in streams:
                s.result(60)
    finally:
        router.shutdown()


def test_a_process_replica_serves_the_thread_replicas_tokens_and_dies_typed():
    spec = dict(seed=42, vocab_size=32, hidden_size=16, num_layers=1,
                num_heads=2, max_len=16)
    twin = build_replicas(1, metrics=telemetry.MetricsRegistry(),
                          device="cpu")[0]
    proc = ProcessReplica("p0", spec, slots=2, max_len=16, device="cpu")
    prompt = np.array([3, 7, 1], np.int32)
    try:
        want = twin.submit(prompt, max_new_tokens=4).result(60)
        assert np.array_equal(proc.submit(prompt, max_new_tokens=4)
                              .result(120), want)
        router = FleetRouter([proc, twin],
                             metrics=telemetry.MetricsRegistry())
        s = proc.submit(prompt, max_new_tokens=4)
        proc.kill()
        with pytest.raises(WorkerDied):
            s.result(30)
        via = router.submit(prompt, max_new_tokens=4)
        assert np.array_equal(via.result(60), want)
        assert via._replica.name == "r0"
    finally:
        twin.shutdown()
        proc.shutdown(drain=False)


def test_new_entry_points_need_the_card_unless_given_the_cpu(target):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpeculativeDecoder(target[1], target[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_replicas(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcessReplica("p", {})
    with pytest.raises(NotImplementedError, match="item 12"):
        ProcessReplica("p", {}, telemetry_dir="t", device="cpu")
    inst = register_fleet_instruments(telemetry.MetricsRegistry())
    assert {"hits", "partial_hits", "reroutes", "accept_rate"} <= set(inst)


# -------------------------------------------------------- tuned config

def test_a_jax_tuned_json_gives_equal_configs_in_both_packages(tmp_path):
    fp = dict(device_kind="TPU v5 lite", platform="tpu", device_count=1,
              mesh_shape=[1], package_version="0.1.0")
    winner = {"length_buckets": [32, 64], "slots": 2, "speculation_k": 0,
              "prefix_cache_bytes": 1 << 20, "prefill_chunk": 16}
    path = str(tmp_path / "tuned.json")
    jax_save_tuned(JaxTunedConfig(
        fingerprint=JaxFingerprint.from_dict(fp), seed=0,
        winners={"serving": winner}), path)
    with pytest.raises(FingerprintMismatchError) as err:
        apply_tuned_config(path)
    assert "platform" in err.value.mismatches
    got = apply_tuned_config(
        load_tuned(path, fingerprint=Fingerprint.from_dict(fp)),
        base=GenerationConfig(max_queue=7))
    want = jax_apply_tuned(path, base=JaxGenConfig(max_queue=7),
                           allow_mismatch=True)
    fields = ("slots", "max_len", "length_buckets", "prefill_rows",
              "prefill_chunk", "max_queue", "eos_token", "max_new_tokens",
              "timeout_ms", "prefix_cache_bytes")
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert (got.max_len, got.length_buckets, got.prefill_chunk) == \
        (64, (32, 64), 16)
    assert apply_tuned_config(path, allow_mismatch=True).slots == 2
    raw = json.loads(open(path).read())
    raw["winners"]["serving"]["speculation_k"] = 4
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(raw))
    with pytest.raises(TunedConfigError, match="speculation_k"):
        apply_tuned_config(str(spec_path), allow_mismatch=True)
    with pytest.raises(Exception, match="speculation_k"):
        jax_apply_tuned(str(spec_path), allow_mismatch=True)
    assert Fingerprint.current().platform == (
        "gpu" if torch.cuda.is_available() else "cpu")
